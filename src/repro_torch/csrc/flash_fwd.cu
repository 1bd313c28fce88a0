// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// masks, contiguous GQA, ragged Tq/Tk -> (out, lse).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_kernel
// (launched by _fwd_call, reached from flash_attention and flash_fwd_step).
// It computes what that kernel computes, not its grid walk:
//   * one thread block per (q tile of BQ rows, q head, batch); the KV walk is
//     a loop inside the block over the tile range [lo, hi) of _kv_bounds
//     (block skipping needs the static q_start; q_start < 0 stands for None
//     and walks every tile under the mask, as the serve prefill does);
//   * q head h reads kv head h / g (contiguous GQA, no expanded K/V);
//   * masks come from q_pos; columns >= Tk are dead;
//   * scores, the online softmax and the P.V sum are fp32 for fp32 and bf16
//     inputs alike, with the reference's NEG_INF and max floor, so a fully
//     masked row gives an exact-zero output and lse = -1e25.
//
// What bounds it: at prefill sizes the work is ~4*Tq*Tk*D*Hq/2 FLOPs
// (causal), far above the H100's ~295 FLOP/byte ridge, so it is a compute
// bound kernel; the card's bf16 tensor-core peak (989 TFLOP/s) is the bound
// it is measured against.  This first version runs the products as fp32 FMA
// on the CUDA cores (67 TFLOP/s peak at most): each thread holds an 8x4
// score tile and an 8x(D/16) output tile in registers, K/V tiles are staged
// in shared memory as fp32 (padded rows, no bank conflicts), and the online
// softmax state of a row lives in the same thread as that row's outputs, so
// the rescale needs no shared memory.  Moving the products to mma/wgmma
// with TMA-fed tiles is the next step and belongs to a later change.
#include "common.cuh"

namespace {

using repro::kMFloor;
using repro::kNegInf;

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv rows per tile
constexpr int NT = 128;  // threads per block: 8 row groups x 16 lanes

struct FlashArgs {
  const void* q;      // [B, Hq, Tq, D]
  const void* k;      // [B, Hkv, Tk, D]
  const void* v;      // [B, Hkv, Tk, D]
  const int* qpos;    // [Tq] global positions of the q rows
  void* out;          // [B, Hq, Tq, D], q's dtype
  float* lse;         // [B, Hq, Tq]
  int Hq, Hkv, Tq, Tk, causal, window, q_start;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs a) {
  constexpr int RM = BQ / 8;   // rows per thread: r = ty + 8 * i
  constexpr int CS = BK / 16;  // score columns per thread: c = tx + 16 * j
  constexpr int CO = D / 16;   // output columns per thread: c = tx + 16 * j

  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK + 1]
  __shared__ int qp_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const size_t qrow0 = (size_t)(b * a.Hq + h) * a.Tq;
  const size_t krow0 = (size_t)(b * a.Hkv + hk) * a.Tk;
  const T* q = static_cast<const T*>(a.q) + qrow0 * D;
  const T* k = static_cast<const T*>(a.k) + krow0 * D;
  const T* v = static_cast<const T*>(a.v) + krow0 * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] =
        q0 + r < a.Tq ? repro::to_f32(q[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    const int row = q0 + r;
    // rows past Tq continue the position sequence; their output is dropped
    qp_s[r] = row < a.Tq ? a.qpos[row] : a.qpos[a.Tq - 1] + 1 + (row - a.Tq);
  }

  // [lo, hi) kv tiles of this q tile (_kv_bounds with this kernel's tiles)
  const int nk = (a.Tk + BK - 1) / BK;
  int lo = 0, hi = nk;
  if (a.q_start >= 0 && a.causal) {
    const int last_q = a.q_start + (qt + 1) * BQ - 1;
    hi = max(min(last_q / BK + 1, nk), 1);
  }
  if (a.q_start >= 0 && a.window > 0) {
    const int first_q = a.q_start + qt * BQ;
    lo = min(max((first_q - a.window + 1) / BK, 0), hi - 1);
  }

  float m[RM], l[RM], acc[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // Q staged; the previous tile's K/V/P reads are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < a.Tk;
      const size_t g = (size_t)(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = ok ? repro::to_f32(k[g]) : 0.f;
      Vs[r * D + c] = ok ? repro::to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RM][CS];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[CS];
#pragma unroll
      for (int j = 0; j < CS; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float qv = Qs[(ty + 8 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 8 * i;
      const int qp = qp_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < a.Tk;
        if (a.causal) ok = ok && qp >= col;
        if (a.window > 0) ok = ok && col > qp - a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group hold the row's 64 columns
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float ms_new = fmaxf(m_new, kMFloor);
      const float corr = expf(fmaxf(m[i], kMFloor) - ms_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float p = expf(s[i][j] - ms_new);  // masked entries -> 0
        Ps[r * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CO];
#pragma unroll
      for (int c = 0; c < CO; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = Ps[(ty + 8 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= a.Tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];  // masked row -> zero output
    T* o = static_cast<T*>(a.out) + (qrow0 + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) o[tx + 16 * c] = repro::from_f32<T>(acc[i][c] / ls);
    if (tx == 0) a.lse[qrow0 + row] = fmaxf(m[i], kMFloor) + logf(ls);
  }
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success).  q_start < 0 means "None".
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               const int* qpos, void* out, float* lse, int B,
                               int Hq, int Hkv, int Tq, int Tk, int D,
                               int dtype, int causal, int window, int q_start,
                               float scale, void* stream) {
  FlashArgs a{q, k, v, qpos, out, lse, Hq, Hkv, Tq, Tk,
              causal, window, q_start, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && D == 64) return launch<float, 64>(a, B, st);
  if (dtype == repro::kFloat32 && D == 128) return launch<float, 128>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(a, B, st);
  return cudaErrorInvalidValue;
}
