// Flash-attention backward for Hopper (sm_90a): the dQ pass and the dK/dV
// pass, given the forward's (out, lse) residuals and delta = rowsum(dO * O).
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:_dq_kernel
// (launched by _dq_call) and _dkv_kernel (launched by _dkv_call), reached
// from the _flash custom_vjp on every training step.  They compute what
// those kernels compute, not their grid walk:
//   * dQ: one thread block per (q tile of BQ rows, q head, batch); the KV
//     walk is a loop inside the block over the tile range [lo, hi) of
//     _kv_bounds (the forward's tiles and bounds; q_start < 0 stands for
//     None and walks every tile under the masks).  Per KV tile:
//     p = exp(s * scale - lse), ds = p * (dO . V^T - delta), dq += ds . K.
//   * dK/dV: one thread block per (kv tile of BK rows, kv head, batch); it
//     walks the g q heads of its GQA group and, for each, the q tiles of
//     _q_bounds, accumulating dv += p^T . dO and dk += ds^T . Q in
//     registers.  One block owns each dK/dV tile, so there are no atomics
//     and the result is the same bits run to run.
//   * masks come from q_pos; rows >= Tq and columns >= Tk are dead (they
//     load zeros, contribute p = 0 and are not stored).  A masked entry has
//     p = 0 exactly, as exp(NEG_INF - lse) is in the reference, so a fully
//     masked row (lse = -1e25) gives exact-zero gradients.
//   * fp32 and bf16 inputs alike are staged as fp32, all sums are fp32 and
//     the results are rounded once to the inputs' dtype.
//
// What bounds it: dQ does ~6*D FLOPs and dK/dV ~8*D FLOPs per causal
// (q, k) pair per q head, far above the H100's ~295 FLOP/byte ridge, so
// both are compute bound; the card's bf16 tensor-core peak (989 TFLOP/s) is
// the bound they are measured against.  This first version runs the
// products as fp32 FMA on the CUDA cores (67 TFLOP/s peak at most), like
// flash_fwd.cu: 256 threads in 16 row groups x 16 lanes, each thread holds
// a 4x4 tile of scores and of dO.V^T and a 4x(D/16) tile of each output in
// registers, and the four operand tiles are staged in shared memory as fp32
// with padded rows (no bank conflicts).  At D = 128 the dK/dV block uses
// 165 KB of shared memory, so one block runs per SM.  Moving the products
// to mma/wgmma with TMA-fed tiles is the next step and belongs to a later
// change.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per tile (the forward's)
constexpr int BK = 64;   // kv rows per tile (the forward's)
constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes
constexpr int RM = 4;    // tile rows per thread: r = ty + 16 * i
constexpr int CS = 4;    // score columns per thread: c = tx + 16 * j

struct BwdArgs {
  const void* q;      // [B, Hq, Tq, D]
  const void* k;      // [B, Hkv, Tk, D]
  const void* v;      // [B, Hkv, Tk, D]
  const void* dout;   // [B, Hq, Tq, D], q's dtype
  const float* lse;   // [B, Hq, Tq]
  const float* delta; // [B, Hq, Tq]
  const int* qpos;    // [Tq] global positions of the q rows
  void* dq;           // [B, Hq, Tq, D]
  void* dk;           // [B, Hkv, Tk, D]
  void* dv;           // [B, Hkv, Tk, D]
  int Hq, Hkv, Tq, Tk, causal, window, q_start;
  float scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int col) {
  bool ok = col < a.Tk;
  if (a.causal) ok = ok && qp >= col;
  if (a.window > 0) ok = ok && col > qp - a.window;
  return ok;
}

// rows [row0, row0 + 64) of a [T, D] matrix into dst[64][D + 1] as fp32;
// rows >= T load zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < rows ? repro::to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// the per-row state of q rows [q0, q0 + BQ): positions, lse and delta
__device__ __forceinline__ void stage_rows(const BwdArgs& a, size_t qrow0,
                                           int q0, int* qp_s, float* lse_s,
                                           float* delta_s) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int row = q0 + r;
    const bool live = row < a.Tq;
    qp_s[r] = live ? a.qpos[row] : 0;
    lse_s[r] = live ? a.lse[qrow0 + row] : 0.f;
    delta_s[r] = live ? a.delta[qrow0 + row] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * (BQ + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(BwdArgs a) {
  constexpr int CO = D / 16;  // output columns per thread: c = tx + 16 * j

  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);     // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);     // [BQ][BK + 1]
  __shared__ int qp_s[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const size_t qrow0 = (size_t)(b * a.Hq + h) * a.Tq;
  const size_t krow0 = (size_t)(b * a.Hkv + hk) * a.Tk;

  stage<T, D>(Qs, static_cast<const T*>(a.q) + qrow0 * D, q0, a.Tq);
  stage<T, D>(dOs, static_cast<const T*>(a.dout) + qrow0 * D, q0, a.Tq);
  stage_rows(a, qrow0, q0, qp_s, lse_s, delta_s);
  const T* k = static_cast<const T*>(a.k) + krow0 * D;
  const T* v = static_cast<const T*>(a.v) + krow0 * D;

  // [lo, hi) kv tiles of this q tile (_kv_bounds with these tiles)
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

  float acc[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // Q/dO staged; the previous tile's K/dS reads are done
    stage<T, D>(Ks, k, k0, a.Tk);
    stage<T, D>(Vs, v, k0, a.Tk);
    __syncthreads();

    float s[RM][CS], dp[RM][CS];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[CS], vv[CS];
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float qv = Qs[(ty + 16 * i) * (D + 1) + d];
        const float ov = dOs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          s[i][j] = fmaf(qv, kv[j], s[i][j]);
          dp[i][j] = fmaf(ov, vv[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      const bool live = q0 + r < a.Tq;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int c = tx + 16 * j;
        const float p = live && visible(a, qp_s[r], k0 + c)
                            ? expf(s[i][j] * a.scale - lse_s[r])
                            : 0.f;
        dSs[r * (BK + 1) + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();  // the whole dS tile is written

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[CO];
#pragma unroll
      for (int c = 0; c < CO; ++c) kv[c] = Ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ds = dSs[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Tq) continue;
    T* o = static_cast<T*>(a.dq) + (qrow0 + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c)
      o[tx + 16 * c] = repro::from_f32<T>(acc[i][c] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(BwdArgs a) {
  constexpr int CO = D / 16;  // output columns per thread: c = tx + 16 * j

  extern __shared__ float smem[];
  float* Ks = smem;                   // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);      // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);     // [BQ][D + 1]
  float* Ps = dOs + BQ * (D + 1);     // [BK][BQ + 1], P^T
  float* dSs = Ps + BK * (BQ + 1);    // [BK][BQ + 1], dS^T
  __shared__ int qp_s[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.Hq / a.Hkv;
  const int k0 = kt * BK;
  const size_t krow0 = (size_t)(b * a.Hkv + hk) * a.Tk;

  stage<T, D>(Ks, static_cast<const T*>(a.k) + krow0 * D, k0, a.Tk);
  stage<T, D>(Vs, static_cast<const T*>(a.v) + krow0 * D, k0, a.Tk);

  // [lo, hi) q tiles that touch this kv tile (_q_bounds with these tiles)
  const int nq = (a.Tq + BQ - 1) / BQ;
  int lo = 0, hi = nq;
  if (a.q_start >= 0 && a.causal) {
    lo = min(max((k0 - a.q_start) / BQ, 0), nq - 1);
  }
  if (a.q_start >= 0 && a.window > 0) {
    const int last_kv = k0 + BK - 1;
    hi = max(min((last_kv + a.window - 1 - a.q_start) / BQ + 1, nq), lo + 1);
  }

  float dk[RM][CO], dv[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    const size_t qrow0 = (size_t)(b * a.Hq + h) * a.Tq;
    const T* q = static_cast<const T*>(a.q) + qrow0 * D;
    const T* dout = static_cast<const T*>(a.dout) + qrow0 * D;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // K/V staged; the previous tile's reads are done
      stage<T, D>(Qs, q, q0, a.Tq);
      stage<T, D>(dOs, dout, q0, a.Tq);
      stage_rows(a, qrow0, q0, qp_s, lse_s, delta_s);
      __syncthreads();

      // s[i][j] = K[r] . Q[c] and dp[i][j] = V[r] . dO[c] for kv row
      // r = ty + 16 i and q row c = tx + 16 j of the tiles
      float s[RM][CS], dp[RM][CS];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[CS], ov[CS];
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          qv[j] = Qs[(tx + 16 * j) * (D + 1) + d];
          ov[j] = dOs[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float kv = Ks[(ty + 16 * i) * (D + 1) + d];
          const float vv = Vs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
          for (int j = 0; j < CS; ++j) {
            s[i][j] = fmaf(kv, qv[j], s[i][j]);
            dp[i][j] = fmaf(vv, ov[j], dp[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          const int c = tx + 16 * j;
          const float p = q0 + c < a.Tq && visible(a, qp_s[c], k0 + r)
                              ? expf(s[i][j] * a.scale - lse_s[c])
                              : 0.f;
          Ps[r * (BQ + 1) + c] = p;
          dSs[r * (BQ + 1) + c] = p * (dp[i][j] - delta_s[c]);
        }
      }
      __syncthreads();  // the whole P^T / dS^T tile is written

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float qv[CO], ov[CO];
#pragma unroll
        for (int c = 0; c < CO; ++c) {
          qv[c] = Qs[qq * (D + 1) + tx + 16 * c];
          ov[c] = dOs[qq * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int r = ty + 16 * i;
          const float p = Ps[r * (BQ + 1) + qq];
          const float ds = dSs[r * (BQ + 1) + qq];
#pragma unroll
          for (int c = 0; c < CO; ++c) {
            dv[i][c] = fmaf(p, ov[c], dv[i][c]);
            dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.Tk) continue;
    T* ok = static_cast<T*>(a.dk) + (krow0 + row) * D;
    T* ov = static_cast<T*>(a.dv) + (krow0 + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      ok[tx + 16 * c] = repro::from_f32<T>(dk[i][c] * a.scale);
      ov[tx + 16 * c] = repro::from_f32<T>(dv[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.Hq, B);
  flash_dq_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + BK - 1) / BK, a.Hkv, B);
  flash_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, int B, bool dkv, cudaStream_t stream) {
  return dkv ? launch_dkv<T, D>(a, B, stream) : launch_dq<T, D>(a, B, stream);
}

// picks the (dtype, head dim) instance; anything else is refused
cudaError_t dispatch(const BwdArgs& a, int B, int D, int dtype, bool dkv,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && D == 64)
    return launch<float, 64>(a, B, dkv, st);
  if (dtype == repro::kFloat32 && D == 128)
    return launch<float, 128>(a, B, dkv, st);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(a, B, dkv, st);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(a, B, dkv, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Both entries return a cudaError_t code (0 on success).  q_start < 0
// means "None" (no tile skipping).
extern "C" int repro_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const int* qpos, void* dq,
                              int B, int Hq, int Hkv, int Tq, int Tk, int D,
                              int dtype, int causal, int window, int q_start,
                              float scale, void* stream) {
  BwdArgs a{q,  k,   v,   dout, lse, delta,  qpos,    dq,   nullptr, nullptr,
            Hq, Hkv, Tq, Tk,   causal, window, q_start, scale};
  return dispatch(a, B, D, dtype, /*dkv=*/false, stream);
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, const int* qpos, void* dk,
                               void* dv, int B, int Hq, int Hkv, int Tq,
                               int Tk, int D, int dtype, int causal,
                               int window, int q_start, float scale,
                               void* stream) {
  BwdArgs a{q,  k,   v,   dout, lse, delta,  qpos,    nullptr, dk, dv,
            Hq, Hkv, Tq, Tk,   causal, window, q_start, scale};
  return dispatch(a, B, D, dtype, /*dkv=*/true, stream);
}
