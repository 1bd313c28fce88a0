// Mamba2 SSD intra-chunk pass for Hopper (sm_90a): per (batch, chunk) the
// quadratic-within-chunk output Y and the chunk-end state S_c.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:_kernel (launched by
// ssd_intra there).  It computes what that kernel computes, in fp32:
//   * cs = the cumulative sum of log_a within the chunk, per head;
//   * W[i, j] = (C_i . B_j) * exp(cs_i - cs_j) for j <= i, else 0, per head
//     (the difference of the two cumulative sums, as the reference takes
//     it, so both give the same zeros where the decay underflows);
//   * Y[i, h] = sum_j W[i, j] x[j, h];
//   * S_c[h] = sum_j exp(cs_{Q-1} - cs_j) x[j, h] (x) B_j.
// Q is any chunk length from 1 to 256 (the model shrinks the chunk to
// divide T, so no tile size divides Q in general): every tile masks its
// ragged edge with zeros.
//
// What bounds it: at mamba2-1.3b's serve shape (Q 256, H 64, P 64, N 128)
// the products are ~35 GFLOP of useful fp32 work (the causal half of the
// Q x Q products) against ~0.7 GB of inputs and outputs, so on fp32 CUDA
// cores it is bound by operations; with TF32 tensor cores it would be
// bound by the bytes.  This first version runs fp32 FMA on CUDA cores.
//
// Design.  The TPU grid is (B, nc, H / bh) with a whole chunk's Q x Q
// score matrix in VMEM; a Q x Q fp32 matrix (256 KB) exceeds a block's
// 227 KB of shared memory, and the scores C.B do not depend on the head
// (one group), so here one launch holds two sets of blocks:
//   * Y blocks, one per (64-row tile, group of HG heads, batch x chunk),
//     the row tiles with the most columns first.  A Y block computes its
//     rows' scores against all columns j <= its last row once (at most
//     64 x 256 fp32, kept transposed in shared memory) and reuses them for
//     each of its heads: per head it scans cs, then walks the 64-column
//     tiles up to the diagonal, building the decay-weighted tile W and
//     accumulating W x_h in registers (a 4 x 4 tile per thread at P 64).
//   * state blocks, one per (head, 128 state columns, batch x chunk), each
//     a [P x Q] . [Q x N] product of the decay-weighted x_h with B.
// Y and S_c are summed in fp32 in a fixed order and written once, with no
// atomics, so two launches give the same bits.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int TI = 64;         // rows per Y block, and the column (j) tile
constexpr int HG = 16;         // heads per Y block
constexpr int NC = 32;         // state dims staged per score pass
constexpr int SROW = TI + 4;   // padded row (floats) of the transposed tiles
constexpr int SN = 128;        // state columns per state block
constexpr int BROW = SN + 4;   // padded row (floats) of the staged B tile

struct SsdArgs {
  const float* x;       // [BC, Q, H, P]
  const float* log_a;   // [BC, Q, H]
  const float* Bm;      // [BC, Q, N]
  const float* Cm;      // [BC, Q, N]
  float* y;             // [BC, Q, H, P]
  float* s;             // [BC, H, P, N]
  int BC, Q, H, N;
  int Qpad;             // Q rounded up to TI
  int n_row_tiles, n_head_groups, n_y_blocks, n_n_tiles;
};

// cs[0..Qpad) = inclusive cumulative sum of log_a[bc, :, h] over the chunk
// (zeros past Q), by warp 0: each lane sums Qpad / 32 consecutive entries,
// then a shuffle scan adds the lanes before it.  The caller synchronises.
__device__ void chunk_cumsum(const SsdArgs& a, int bc, int h, float* cs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = a.Qpad / 32;                      // 2, 4, 6 or 8
  const float* la = a.log_a + (size_t)bc * a.Q * a.H + h;
  float v[8];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = lane * per + k;
    if (k < per) {
      run += (q < a.Q) ? la[(size_t)q * a.H] : 0.f;
      v[k] = run;
    }
  }
  float tot = run;                                  // inclusive over lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += o;
  }
  float base = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) base = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < per) cs[lane * per + k] = base + v[k];
}

// RI consecutive floats of shared memory into registers (16-byte loads when
// RI is a multiple of 4; the callers' offsets are then 16-byte aligned)
template <int RI>
__device__ __forceinline__ void load_row(const float* src, float* dst) {
  if constexpr (RI % 4 == 0) {
#pragma unroll
    for (int u = 0; u < RI; u += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + u);
      dst[u] = t.x; dst[u + 1] = t.y; dst[u + 2] = t.z; dst[u + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < RI; ++u) dst[u] = src[u];
  }
}

template <int P>
__device__ void y_block(const SsdArgs& a, int bc, int rt, int hg,
                        float* smem) {
  constexpr int TX = P / 4;          // threads along p (4 columns each)
  constexpr int TY = NT / TX;        // threads along i
  constexpr int RI = TI / TY;        // rows per thread
  constexpr int XROW = P + 4;
  const int tid = threadIdx.x;
  const int Q = a.Q, N = a.N, H = a.H;
  const int i0 = rt * TI;
  const int njt = rt + 1;            // column tiles up to the diagonal
  float* St = smem;                  // [Qpad][SROW]: St[j][i] = C_{i0+i}.B_j
  float* cs = St + (size_t)a.Qpad * SROW;   // [Qpad]
  float* work = cs + a.Qpad;

  // 1. the scores of this row tile, once for all heads of the group
  {
    float* Ct = work;                // [NC][SROW]: Ct[n][i]
    float* Bt = work + NC * SROW;    // [NC][SROW]: Bt[n][j]
    const float* C = a.Cm + (size_t)bc * Q * N;
    const float* Bm = a.Bm + (size_t)bc * Q * N;
    const int sy = tid / 16, sx = tid % 16;
    for (int jt = 0; jt < njt; ++jt) {
      const int j0 = jt * TI;
      float acc[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += NC) {
        __syncthreads();             // the previous chunk is consumed
        for (int e = tid; e < NC * TI; e += NT) {
          const int r = e / NC, n = e % NC;
          const bool nok = n0 + n < N;
          Ct[n * SROW + r] = (nok && i0 + r < Q)
              ? C[(size_t)(i0 + r) * N + n0 + n] : 0.f;
          Bt[n * SROW + r] = (nok && j0 + r < Q)
              ? Bm[(size_t)(j0 + r) * N + n0 + n] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int n = 0; n < NC; ++n) {
          float cv[4], bv[4];
          load_row<4>(Ct + n * SROW + 4 * sy, cv);
          load_row<4>(Bt + n * SROW + 4 * sx, bv);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<float4*>(St + (size_t)(j0 + 4 * sx + v) * SROW
                                   + 4 * sy) =
            make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
    }
  }

  // 2. per head: W = scores * decay on and below the diagonal, Y_h = W x_h
  float* xs = work;                  // [TI][XROW]: xs[j][p]
  float* Wt = work + TI * XROW;      // [TI][SROW]: Wt[j][i]
  const int ty = tid / TX, tx = tid % TX;
  const int h_end = min((hg + 1) * HG, H);
  for (int h = hg * HG; h < h_end; ++h) {
    __syncthreads();                 // cs, xs and Wt of the last head used
    chunk_cumsum(a, bc, h, cs);
    __syncthreads();
    const float* xh = a.x + ((size_t)bc * Q * H + h) * P;
    float acc[RI][4] = {};
    for (int jt = 0; jt < njt; ++jt) {
      const int j0 = jt * TI;
      for (int e = tid; e < TI * TX; e += NT) {
        const int r = e / TX, c = e % TX;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + r < Q)
          v = *reinterpret_cast<const float4*>(xh + (size_t)(j0 + r) * H * P
                                               + 4 * c);
        *reinterpret_cast<float4*>(xs + r * XROW + 4 * c) = v;
      }
      for (int e = tid; e < TI * TI; e += NT) {
        const int jj = e / TI, ii = e % TI;
        const int i = i0 + ii, j = j0 + jj;
        float w = 0.f;
        if (j <= i && i < Q)
          w = St[(size_t)j * SROW + ii] * expf(cs[i] - cs[j]);
        Wt[jj * SROW + ii] = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < TI; ++jj) {
        float xv[4], wv[RI];
        load_row<4>(xs + jj * XROW + 4 * tx, xv);
        load_row<RI>(Wt + jj * SROW + ty * RI, wv);
#pragma unroll
        for (int u = 0; u < RI; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(wv[u], xv[v], acc[u][v]);
      }
      __syncthreads();               // xs and Wt are rewritten next tile
    }
#pragma unroll
    for (int u = 0; u < RI; ++u) {
      const int i = i0 + ty * RI + u;
      if (i < Q)
        *reinterpret_cast<float4*>(a.y + (((size_t)bc * Q + i) * H + h) * P
                                   + 4 * tx) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
}

template <int P>
__device__ void s_block(const SsdArgs& a, int bc, int h, int nt,
                        float* smem) {
  constexpr int XROW = P + 4;
  constexpr int RP = P / 8;          // rows (p) per thread: 8 thread rows
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int Q = a.Q, N = a.N, H = a.H, n0 = nt * SN;
  float* cs = smem;                  // [Qpad]
  float* xw = cs + a.Qpad;           // [TI][XROW]: x[j][p] * exp(tail_j)
  float* Bs = xw + TI * XROW;        // [TI][BROW]: B[j][n0 + n]
  chunk_cumsum(a, bc, h, cs);
  __syncthreads();
  const float cs_end = cs[Q - 1];
  const float* xh = a.x + ((size_t)bc * Q * H + h) * P;
  const float* Bm = a.Bm + (size_t)bc * Q * N;
  float acc[RP][4] = {};
  for (int j0 = 0; j0 < Q; j0 += TI) {
    for (int e = tid; e < TI * (P / 4); e += NT) {
      const int r = e / (P / 4), c = e % (P / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + r < Q) {
        v = *reinterpret_cast<const float4*>(xh + (size_t)(j0 + r) * H * P
                                             + 4 * c);
        const float w = expf(cs_end - cs[j0 + r]);
        v.x *= w; v.y *= w; v.z *= w; v.w *= w;
      }
      *reinterpret_cast<float4*>(xw + r * XROW + 4 * c) = v;
    }
    for (int e = tid; e < TI * SN; e += NT) {
      const int r = e / SN, n = e % SN;
      Bs[r * BROW + n] = (j0 + r < Q && n0 + n < N)
          ? Bm[(size_t)(j0 + r) * N + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < TI; ++jj) {
      float xv[RP], bv[4];
      load_row<RP>(xw + jj * XROW + ty * RP, xv);
      load_row<4>(Bs + jj * BROW + 4 * tx, bv);
#pragma unroll
      for (int u = 0; u < RP; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], bv[v], acc[u][v]);
    }
    __syncthreads();                 // xw and Bs are rewritten next tile
  }
  float* sh = a.s + ((size_t)bc * H + h) * P * N;
#pragma unroll
  for (int u = 0; u < RP; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + 4 * tx + v;
      if (n < N) sh[(size_t)(ty * RP + u) * N + n] = acc[u][v];
    }
}

template <int P>
__global__ void __launch_bounds__(NT, 2) ssd_intra_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  int b = blockIdx.x;
  if (b < a.n_y_blocks) {
    const int per_rt = a.BC * a.n_head_groups;
    const int rt = a.n_row_tiles - 1 - b / per_rt;   // most columns first
    const int rem = b % per_rt;
    y_block<P>(a, rem / a.n_head_groups, rt, rem % a.n_head_groups, smem);
  } else {
    b -= a.n_y_blocks;
    const int per_bc = a.H * a.n_n_tiles;
    const int rem = b % per_bc;
    s_block<P>(a, b / per_bc, rem / a.n_n_tiles, rem % a.n_n_tiles, smem);
  }
}

template <int P>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  constexpr int XROW = P + 4;
  const size_t work = std::max(2 * NC * SROW, TI * XROW + TI * SROW);
  const size_t y_smem = ((size_t)a.Qpad * SROW + a.Qpad + work) * sizeof(float);
  const size_t s_smem = ((size_t)a.Qpad + TI * XROW + TI * BROW) * sizeof(float);
  const size_t smem = std::max(y_smem, s_smem);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = a.n_y_blocks + a.BC * a.H * a.n_n_tiles;
  ssd_intra_kernel<P><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success).  x [BC, Q, H, P], log_a
// [BC, Q, H], Bm/Cm [BC, Q, N] fp32 with BC = batch x chunks; writes y
// [BC, Q, H, P] and s [BC, H, P, N] fp32.
extern "C" int repro_ssd_intra(const float* x, const float* log_a,
                               const float* Bm, const float* Cm, float* y,
                               float* s, int BC, int Q, int H, int P, int N,
                               void* stream) {
  if (BC < 1 || Q < 1 || Q > 4 * TI || H < 1 || N < 1)
    return cudaErrorInvalidValue;
  SsdArgs a{x, log_a, Bm, Cm, y, s, BC, Q, H, N};
  a.Qpad = (Q + TI - 1) / TI * TI;
  a.n_row_tiles = a.Qpad / TI;
  a.n_head_groups = (H + HG - 1) / HG;
  a.n_y_blocks = BC * a.n_row_tiles * a.n_head_groups;
  a.n_n_tiles = (N + SN - 1) / SN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {   // mamba2-1.3b's head dim, and its reduced config's
    case 16: return launch<16>(a, st);
    case 64: return launch<64>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
