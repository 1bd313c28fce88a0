// Flash-attention backward for Hopper (sm_90a): the dQ pass and the dK/dV
// pass, given the forward's (out, lse) residuals and delta = rowsum(dO * O).
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:_dq_kernel
// (launched by _dq_call) and _dkv_kernel (launched by _dkv_call), reached
// from the _flash custom_vjp on every training step.  They compute what
// those kernels compute, not their grid walk:
//   * dQ: one thread block per (q tile of BQ rows, q head, batch); the KV
//     walk is a loop inside the block.  Per KV tile:
//     p = exp(s * scale - lse), ds = p * (dO . V^T - delta), dq += ds . K.
//   * dK/dV: one thread block per (kv tile of BK rows, kv head, batch); it
//     walks the g q heads of its GQA group and, for each, the q tiles of
//     _q_bounds, accumulating dv += p^T . dO and dk += ds^T . Q in
//     registers.  One block owns each dK/dV tile, so there are no atomics
//     and the result is the same bits run to run.
//   * masks come from q_pos; rows >= Tq and columns >= Tk are dead (they
//     load zeros, contribute p = 0 or ds = 0 and are not stored).  A masked
//     entry has p = 0 exactly, as exp(NEG_INF - lse) is in the reference, so
//     a fully masked row (lse = -1e25) gives exact-zero gradients.
//   * all sums are fp32 and the results are rounded once to the inputs'
//     dtype.  The entries pick a route by dtype.
//
// dQ, bf16 inputs: tensor cores (flash_dq_mma_kernel), flash_dkv_mma_kernel
// with the roles of q and kv swapped.  4 warps, each owning 16 q rows of
// the BQ = 64 tile, with the dQ accumulator in registers for the whole
// walk.  Q, dO and the rows' positions, lse and delta come in once per
// block; at D = 64 the A fragments of Q and dO stay in registers, at D =
// 128 (dQ alone takes 64 registers a thread, S and dP 32 each) they are
// read from shared memory by ldmatrix per k step.  K and V tiles (bf16,
// 16-byte-padded rows) come in by cp.async, double buffered.  Per KV tile,
// on mma.sync m16n8k16 (bf16 in, fp32 sums):
//     S = Q.K^T, dP = dO.V^T (exact bf16 products);
//     P = exp(scale S - lse) under the mask; dS = P o (dP - delta);
//     dQ += dS.K, dS = hi + lo bf16 parts (split_bf16x2), K the B operand
//     by ldmatrix.trans; dQ is scaled and rounded to bf16 once at the end.
// The walk is the forward's: only the KV tiles some row of the block can
// see, from the rows' positions (common.cuh's kv_tile_range; with q_pos =
// q_start + arange it is _kv_bounds), so q_start = None walks the causal
// half too; a skipped tile is masked for every row and adds exactly 0.  The
// linear grid starts the q tiles with the longest causal walks first.  One
// block owns each dQ tile and there are no atomics: two launches give the
// same bits.
//
// dK/dV, bf16 inputs: tensor cores (flash_dkv_mma_kernel).  4 warps, each
// owning 16 kv rows of the BK = 64 tile; the dK and dV accumulators stay in
// registers for the whole walk, and K and V stay in shared memory (their A
// fragments are read by ldmatrix per k step: at D = 128 the accumulators
// take 128 registers a thread and leave no room to hold them).  Q and dO
// tiles (bf16, 16-byte-padded rows) and the tile's positions, lse and delta
// come in by cp.async, double buffered across the flattened (head, q tile)
// walk.  Per q tile, on mma.sync m16n8k16 (bf16 in, fp32 sums):
//     S^T = K.Q^T, P^T = exp(scale S^T - lse[q]) under the mask;
//     dV += P^T.dO;  dP^T = V.dO^T;  dS^T = P^T o (dP^T - delta[q]);
//     dK += dS^T.Q (times scale once at the end).
// P^T and dS^T (and dQ's dS) stay fp32-grade, as the reference's are fp32:
// each is split into hi = bf16(x) and lo = bf16(x - hi) and both go through
// the product (~2^-18 of each term; the gradients are checked relative to
// their largest entry, where this is far below one bf16 rounding), their C
// fragments serving as A fragments in registers (mma.cuh), never in shared
// memory.  The q tile is BQ = 64 at D = 64 and 32 at D = 128, where 64
// would leave dK, dV, S^T and dP^T no room in 255 registers.  The grid is
// linear with the kv tile slowest: under a causal mask the first kv tiles
// walk the most q tiles, so they start first and the short walks fill the
// tail.  It walks the q tiles of _q_bounds (q_start < 0 stands for None and
// walks every q tile under the masks).
//
// What bounds them: dQ does ~6*D FLOPs and dK/dV ~8*D FLOPs per causal
// (q, k) pair per q head, far above the H100's ~295 FLOP/byte ridge, so
// both are compute bound; the card's bf16 tensor-core peak (989 TFLOP/s) is
// the bound they are measured against.  Their tensor cores run mma.sync,
// short of wgmma's rate, each split operand doubling the product it feeds,
// and the exp and masks on the CUDA cores beside them.  fp32 inputs keep the
// first version of both passes: fp32 FMA on the CUDA cores (67 TFLOP/s
// peak at most), 256 threads in 16 row groups x 16 lanes, each thread
// holding a 4x4 tile of scores and of dO.V^T and a 4x(D/16) tile of each
// output in registers, the operand tiles staged in shared memory as fp32
// with padded rows (at D = 128 the fp32 dK/dV block uses 165 KB, one block
// per SM), walking the tile ranges of _kv_bounds / _q_bounds.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// ------------------------------------------------------- bf16: tensor cores
constexpr int MNT = 128;  // threads per block: 4 warps x 16 kv (dK/dV) or q
                          // (dQ) rows

template <int D>
constexpr int kDkvBQ = D == 128 ? 32 : 64;  // q rows per step (see the header)

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K and V, two stages of Q and dO; two stages of qpos, lse and delta
  return sizeof(__nv_bfloat16) * (2 * BK + 4 * kDkvBQ<D>) * (D + 8) +
         sizeof(float) * 3 * 2 * kDkvBQ<D>;
}

template <int D>
__global__ void __launch_bounds__(MNT) flash_dkv_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int QB = kDkvBQ<D>;
  constexpr int LD = D + 8;   // padded shared-memory row (elements)
  constexpr int KD = D / 16;  // k steps over the head dim
  constexpr int NQ = QB / 8;  // n8 tiles of a warp's 16 x QB S^T and dP^T
  constexpr int NO = D / 8;   // n8 tiles of a warp's 16 x D dK and dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);              // [BK][LD]
  bf16* Vs = Ks + BK * LD;                                   // [BK][LD]
  bf16* Qs = Vs + BK * LD;                                   // [2][QB][LD]
  bf16* dOs = Qs + 2 * QB * LD;                              // [2][QB][LD]
  int* qp_s = reinterpret_cast<int*>(dOs + 2 * QB * LD);     // [2][QB]
  float* lse_s = reinterpret_cast<float*>(qp_s + 2 * QB);    // [2][QB]
  float* delta_s = lse_s + 2 * QB;                           // [2][QB]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, tig = lane & 3;
  const int which = lane >> 3, r8 = lane & 7;  // ldmatrix: lanes 8i.. address
                                               // the rows of matrix i
  // the linear grid, kv tile slowest (see the header)
  const int HB = gridDim.x / ((a.Tk + BK - 1) / BK);
  const int kt = blockIdx.x / HB;
  const int hk = blockIdx.x % a.Hkv, b = blockIdx.x % HB / a.Hkv;
  const int g = a.Hq / a.Hkv;
  const int k0 = kt * BK;
  const size_t krow0 = (size_t)(b * a.Hkv + hk) * a.Tk;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  repro::cp_async_rows<BK, D, MNT>(
      Ks, static_cast<const bf16*>(a.k) + krow0 * D, k0, a.Tk);
  repro::cp_async_rows<BK, D, MNT>(
      Vs, static_cast<const bf16*>(a.v) + krow0 * D, k0, a.Tk);

  // [lo, hi) q tiles that touch this kv tile (_q_bounds with these tiles)
  const int nq = (a.Tq + QB - 1) / QB;
  int lo = 0, hi = nq;
  if (a.q_start >= 0 && a.causal) {
    lo = min(max((k0 - a.q_start) / QB, 0), nq - 1);
  }
  if (a.q_start >= 0 && a.window > 0) {
    const int last_kv = k0 + BK - 1;
    hi = max(min((last_kv + a.window - 1 - a.q_start) / QB + 1, nq), lo + 1);
  }
  const int nqt = hi - lo, steps = g * nqt;  // (head, q tile), head outer

  // step s's Q and dO tiles and row scalars into stage buf
  auto stage = [&](int s, int buf) {
    const int h = hk * g + s / nqt, q0 = (lo + s % nqt) * QB;
    const size_t qrow0 = (size_t)(b * a.Hq + h) * a.Tq;
    repro::cp_async_rows<QB, D, MNT>(Qs + buf * QB * LD, q + qrow0 * D, q0,
                                     a.Tq);
    repro::cp_async_rows<QB, D, MNT>(dOs + buf * QB * LD, dout + qrow0 * D,
                                     q0, a.Tq);
    for (int r = threadIdx.x; r < QB; r += MNT) {
      const int row = q0 + r;
      const bool ok = row < a.Tq;
      repro::cp_async4(qp_s + buf * QB + r, ok ? a.qpos + row : a.qpos, ok);
      repro::cp_async4(lse_s + buf * QB + r, ok ? a.lse + qrow0 + row : a.lse,
                       ok);
      repro::cp_async4(delta_s + buf * QB + r,
                       ok ? a.delta + qrow0 + row : a.delta, ok);
    }
  };
  stage(0, 0);
  repro::cp_async_commit();  // K, V and step 0

  // this thread's kv rows: kr0 (registers 0, 1 of a fragment), kr0 + 8
  const int kr0 = k0 + warp * 16 + group;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    repro::cp_async_wait<0>();  // step s has landed
    __syncthreads();  // ... for every thread, and step s - 1 is consumed,
                      // so its stage takes step s + 1 while s computes
    if (s + 1 < steps) stage(s + 1, cur ^ 1);
    repro::cp_async_commit();
    const int q0 = (lo + s % nqt) * QB;
    const bf16* Qc = Qs + cur * QB * LD;
    const bf16* dOc = dOs + cur * QB * LD;
    const int* qp = qp_s + cur * QB;
    const float* lse = lse_s + cur * QB;
    const float* delta = delta_s + cur * QB;

    // S^T = K.Q^T: Q is stored [q][d], the B operand's column-major layout
    float st[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t kf[4];
      repro::ldmatrix_x4(kf, Ks + (warp * 16 + (which & 1) * 8 + r8) * LD +
                                 ks * 16 + (which >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4];
        repro::ldmatrix_x4(qb, Qc + (np * 16 + (which >> 1) * 8 + r8) * LD +
                                   ks * 16 + (which & 1) * 8);
        repro::mma_bf16(st[2 * np], kf, qb[0], qb[1]);
        repro::mma_bf16(st[2 * np + 1], kf, qb[2], qb[3]);
      }
    }

    // a tile that every (kv, q) pair sees needs no mask
    int pmin = qp[lane % QB], pmax = pmin;
    if (QB > 32) {
      pmin = min(pmin, qp[lane + 32]);
      pmax = max(pmax, qp[lane + 32]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    }
    const bool whole = q0 + QB <= a.Tq && k0 + BK <= a.Tk &&
                       (!a.causal || pmin >= k0 + BK - 1) &&
                       (a.window <= 0 || k0 > pmax - a.window);

    // P^T = exp(scale S^T - lse[q]); a masked entry is exactly 0
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tig + (e & 1);
        float p = __expf(st[nt][e] * a.scale - lse[c]);
        if (!whole && !(q0 + c < a.Tq && visible(a, qp[c], kr0 + (e >> 1) * 8)))
          p = 0.f;
        st[nt][e] = p;
      }

    // dV += P^T.dO, P^T = hi + lo: S^T tiles 2 kc and 2 kc + 1 are the A
    // fragment over q rows 16 kc .. 16 kc + 15
#pragma unroll
    for (int kc = 0; kc < QB / 16; ++kc) {
      uint32_t ph[4], pl[4];
      repro::split_bf16x2(st[2 * kc][0], st[2 * kc][1], ph[0], pl[0]);
      repro::split_bf16x2(st[2 * kc][2], st[2 * kc][3], ph[1], pl[1]);
      repro::split_bf16x2(st[2 * kc + 1][0], st[2 * kc + 1][1], ph[2], pl[2]);
      repro::split_bf16x2(st[2 * kc + 1][2], st[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t ob[4];
        repro::ldmatrix_x4_trans(ob, dOc + (kc * 16 + (which & 1) * 8 + r8) * LD
                                         + dp * 16 + (which >> 1) * 8);
        repro::mma_bf16(dv[2 * dp], ph, ob[0], ob[1]);
        repro::mma_bf16(dv[2 * dp], pl, ob[0], ob[1]);
        repro::mma_bf16(dv[2 * dp + 1], ph, ob[2], ob[3]);
        repro::mma_bf16(dv[2 * dp + 1], pl, ob[2], ob[3]);
      }
    }

    // dP^T = V.dO^T, then dS^T = P^T o (dP^T - delta[q]) in place
    float ds[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t vf[4];
      repro::ldmatrix_x4(vf, Vs + (warp * 16 + (which & 1) * 8 + r8) * LD +
                                 ks * 16 + (which >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t ob[4];
        repro::ldmatrix_x4(ob, dOc + (np * 16 + (which >> 1) * 8 + r8) * LD +
                                   ks * 16 + (which & 1) * 8);
        repro::mma_bf16(ds[2 * np], vf, ob[0], ob[1]);
        repro::mma_bf16(ds[2 * np + 1], vf, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = st[nt][e] * (ds[nt][e] - delta[nt * 8 + 2 * tig + (e & 1)]);

    // dK += dS^T.Q, dS^T = hi + lo
#pragma unroll
    for (int kc = 0; kc < QB / 16; ++kc) {
      uint32_t dh[4], dl[4];
      repro::split_bf16x2(ds[2 * kc][0], ds[2 * kc][1], dh[0], dl[0]);
      repro::split_bf16x2(ds[2 * kc][2], ds[2 * kc][3], dh[1], dl[1]);
      repro::split_bf16x2(ds[2 * kc + 1][0], ds[2 * kc + 1][1], dh[2], dl[2]);
      repro::split_bf16x2(ds[2 * kc + 1][2], ds[2 * kc + 1][3], dh[3], dl[3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t qb[4];
        repro::ldmatrix_x4_trans(qb, Qc + (kc * 16 + (which & 1) * 8 + r8) * LD
                                         + dp * 16 + (which >> 1) * 8);
        repro::mma_bf16(dk[2 * dp], dh, qb[0], qb[1]);
        repro::mma_bf16(dk[2 * dp], dl, qb[0], qb[1]);
        repro::mma_bf16(dk[2 * dp + 1], dh, qb[2], qb[3]);
        repro::mma_bf16(dk[2 * dp + 1], dl, qb[2], qb[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* gk = static_cast<bf16*>(a.dk) + krow0 * D;
  bf16* gv = static_cast<bf16*>(a.dv) + krow0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kr0 + 8 * i;
    if (row >= a.Tk) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      const size_t at = (size_t)row * D + d * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(gk + at) = __floats2bfloat162_rn(
          dk[d][2 * i] * a.scale, dk[d][2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(gv + at) =
          __floats2bfloat162_rn(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {  // Q and dO, two stages of K and V
  return sizeof(__nv_bfloat16) * (2 * BQ + 4 * BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MNT) flash_dq_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;    // padded shared-memory row (elements)
  constexpr int KD = D / 16;   // k steps of S = Q.K^T and dP = dO.V^T
  constexpr int NS = BK / 8;   // n8 tiles of a warp's 16 x BK S and dP
  constexpr int NO = D / 8;    // n8 tiles of a warp's 16 x D dQ
  constexpr bool kHold = D == 64;  // Q, dO fragments in registers (header)
  constexpr int KF = kHold ? KD : 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                      // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]
  __shared__ int qp_s[BQ];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, tig = lane & 3;
  const int which = lane >> 3, r8 = lane & 7;  // ldmatrix: lanes 8i.. address
                                               // the rows of matrix i
  // the linear grid, q tile slowest and walked from the last (see the
  // header)
  const int nq = (a.Tq + BQ - 1) / BQ, HB = gridDim.x / nq;
  const int qt = nq - 1 - blockIdx.x / HB;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x % HB / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const size_t qrow0 = (size_t)(b * a.Hq + h) * a.Tq;
  const size_t krow0 = (size_t)(b * a.Hkv + hk) * a.Tk;
  const bf16* k = static_cast<const bf16*>(a.k) + krow0 * D;
  const bf16* v = static_cast<const bf16*>(a.v) + krow0 * D;

  repro::cp_async_rows<BQ, D, MNT>(
      Qs, static_cast<const bf16*>(a.q) + qrow0 * D, q0, a.Tq);
  repro::cp_async_rows<BQ, D, MNT>(
      dOs, static_cast<const bf16*>(a.dout) + qrow0 * D, q0, a.Tq);
  for (int r = threadIdx.x; r < BQ; r += MNT) {
    const int row = q0 + r;
    // rows past Tq continue the position sequence (as the forward's do);
    // their dO and delta are 0, so their dS is 0, and they are not stored
    qp_s[r] = row < a.Tq ? a.qpos[row] : a.qpos[a.Tq - 1] + 1 + (row - a.Tq);
  }
  __syncthreads();
  int qmin = min(qp_s[lane], qp_s[lane + 32]);
  int qmax = max(qp_s[lane], qp_s[lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
  int lo, hi;
  repro::kv_tile_range<BK>(a.Tk, a.causal, a.window, qmin, qmax, lo, hi);
  if (lo < hi) {
    repro::cp_async_rows<BK, D, MNT>(Ks, k, lo * BK, a.Tk);
    repro::cp_async_rows<BK, D, MNT>(Vs, v, lo * BK, a.Tk);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  // this thread's rows: r0 (registers 0, 1 of a fragment) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + group;
  const int qp[2] = {qp_s[r0], qp_s[r0 + 8]};
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lse[i] = row < a.Tq ? a.lse[qrow0 + row] : 0.f;
    dlt[i] = row < a.Tq ? a.delta[qrow0 + row] : 0.f;
  }
  // A fragments of the warp's 16 q rows of Q and dO, all of D (D = 64)
  const bf16* qa_row = Qs + (warp * 16 + (which & 1) * 8 + r8) * LD +
                       (which >> 1) * 8;
  const bf16* oa_row = qa_row + BQ * LD;  // the same row of dOs
  uint32_t qf[KF][4], of[KF][4];
  if constexpr (kHold) {
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      repro::ldmatrix_x4(qf[ks], qa_row + ks * 16);
      repro::ldmatrix_x4(of[ks], oa_row + ks * 16);
    }
  }

  float dq[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;

  for (int jt = lo; jt < hi; ++jt) {
    const int cur = (jt - lo) & 1;
    repro::cp_async_wait<0>();  // tile jt has landed
    __syncthreads();  // ... for every thread, and tile jt - 1 is consumed,
                      // so its stage takes tile jt + 1 while jt computes
    if (jt + 1 < hi) {
      repro::cp_async_rows<BK, D, MNT>(Ks + (cur ^ 1) * BK * LD, k,
                                       (jt + 1) * BK, a.Tk);
      repro::cp_async_rows<BK, D, MNT>(Vs + (cur ^ 1) * BK * LD, v,
                                       (jt + 1) * BK, a.Tk);
    }
    repro::cp_async_commit();
    const bf16* Kc = Ks + cur * BK * LD;
    const bf16* Vc = Vs + cur * BK * LD;
    const int k0 = jt * BK;

    // S = Q.K^T and dP = dO.V^T: K and V are stored [kv][d], the B
    // operand's column-major layout
    float s[NS][4], ds[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t qa[4], oa[4];
      if constexpr (kHold) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = qf[ks][r];
          oa[r] = of[ks][r];
        }
      } else {
        repro::ldmatrix_x4(qa, qa_row + ks * 16);
        repro::ldmatrix_x4(oa, oa_row + ks * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int at = (np * 16 + (which >> 1) * 8 + r8) * LD + ks * 16 +
                       (which & 1) * 8;
        uint32_t kb[4], vb[4];
        repro::ldmatrix_x4(kb, Kc + at);
        repro::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        repro::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        repro::ldmatrix_x4(vb, Vc + at);
        repro::mma_bf16(ds[2 * np], oa, vb[0], vb[1]);
        repro::mma_bf16(ds[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // a tile that every row of the block sees whole needs no mask
    const bool whole = k0 + BK <= a.Tk &&
                       (!a.causal || k0 + BK - 1 <= qmin) &&
                       (a.window <= 0 || k0 > qmax - a.window);
    // P = exp(scale S - lse), exactly 0 where masked; dS = P o (dP - delta)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = __expf(s[nt][e] * a.scale - lse[i]);
        if (!whole && !visible(a, qp[i], k0 + nt * 8 + 2 * tig + (e & 1)))
          p = 0.f;
        ds[nt][e] = p * (ds[nt][e] - dlt[i]);
      }

    // dQ += dS.K, dS = hi + lo: dS tiles 2 kc and 2 kc + 1 are the A
    // fragment over kv rows 16 kc .. 16 kc + 15
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t dh[4], dl[4];
      repro::split_bf16x2(ds[2 * kc][0], ds[2 * kc][1], dh[0], dl[0]);
      repro::split_bf16x2(ds[2 * kc][2], ds[2 * kc][3], dh[1], dl[1]);
      repro::split_bf16x2(ds[2 * kc + 1][0], ds[2 * kc + 1][1], dh[2], dl[2]);
      repro::split_bf16x2(ds[2 * kc + 1][2], ds[2 * kc + 1][3], dh[3], dl[3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t kb[4];
        repro::ldmatrix_x4_trans(kb, Kc + (kc * 16 + (which & 1) * 8 + r8) * LD
                                         + dp * 16 + (which >> 1) * 8);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // the two n8 tiles, small part first
          repro::mma_bf16(dq[2 * dp + h2], dl, kb[2 * h2], kb[2 * h2 + 1]);
          repro::mma_bf16(dq[2 * dp + h2], dh, kb[2 * h2], kb[2 * h2 + 1]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* gq = static_cast<bf16*>(a.dq) + qrow0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d)
      *reinterpret_cast<__nv_bfloat162*>(gq + (size_t)row * D + d * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(dq[d][2 * i] * a.scale,
                                dq[d][2 * i + 1] * a.scale);
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

template <int D>
cudaError_t launch_dq_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ * a.Hq * B);
  flash_dq_mma_kernel<D><<<grid, MNT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + BK - 1) / BK * a.Hkv * B);
  flash_dkv_mma_kernel<D><<<grid, MNT, smem, stream>>>(a);
  return cudaGetLastError();
}

// both passes: FMA for fp32, tensor cores for bf16 (q, k, v, dout 16-byte
// aligned, as cp.async reads them; the wrapper checks)
template <typename T, int D>
cudaError_t launch(const BwdArgs& a, int B, bool dkv, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return dkv ? launch_dkv_mma<D>(a, B, stream)
               : launch_dq_mma<D>(a, B, stream);
  else
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
