// Mamba2 SSD intra-chunk pass for Hopper (sm_90a): per (batch, chunk) the
// quadratic-within-chunk output Y and the chunk-end state S_c.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:_kernel (launched by
// ssd_intra there).  It computes what that kernel computes, in fp32:
//   * cs = the cumulative sum of log_a within the chunk, per head;
//   * W[i, j] = (C_i . B_j) * exp(cs_i - cs_j) for j <= i, else exactly 0,
//     per head (the difference of the two cumulative sums, as the
//     reference takes it, so both give the same zeros where the decay
//     underflows);
//   * Y[i, h] = sum_j W[i, j] x[j, h];
//   * S_c[h] = sum_j exp(cs_{Q-1} - cs_j) x[j, h] (x) B_j.
// Q is any chunk length from 1 to 256 (the model shrinks the chunk to
// divide T, so no tile size divides Q in general): every tile masks its
// ragged edge with zeros.
//
// What bounds it: at mamba2-1.3b's serve shape (Q 256, H 64, P 64, N 128)
// the three products are ~35 GFLOP of useful fp32 work (the causal half of
// the Q x Q products) against ~0.7 GB of inputs and outputs: bound by
// operations on the fp32 CUDA cores (67 TFLOP/s), by the bytes on the TF32
// tensor cores (495 TFLOP/s, even at three passes).
//
// Design.  All three products run on the tensor cores as mma.sync m16n8k8
// TF32 with fp32 accumulation.  TF32 keeps 10 mantissa bits, so every
// operand is split into hi = tf32(v) and lo = tf32(v - hi) and each product
// is hi.hi + hi.lo + lo.hi (mma.cuh: split_tf32, mma_tf32x3): one TF32 pass
// misses the check's 1e-4 of max |Y| by 3-8x, three stay well inside it.
// The TPU grid is (B, nc, H / bh) with a whole chunk's Q x Q score
// matrix in VMEM; a Q x Q fp32 matrix (256 KB) exceeds a block's 227 KB of
// shared memory, and the scores C.B do not depend on the head (one group),
// so one launch holds two sets of blocks, 256 threads each:
//   * Y blocks, one per (64-row tile, group of HG heads, batch x chunk),
//     the row tiles with the most columns first.  A Y block computes its
//     rows' scores against all columns j up to its diagonal once (warp
//     tiles of 16 x 32 over N, C and B staged 32 state dims at a time),
//     keeps them in shared memory (64 x 256 fp32) and reuses them for each
//     of its heads, two heads at a time: each warp owns 16 rows of one
//     head and all P columns, builds its W fragments from the scores and
//     cs in registers (the decay, the causal mask and the split) and walks
//     the columns only up to its own rows' diagonal, with x staged 32 rows
//     at a time.
//   * state blocks, one per (head, 128 state columns, batch x chunk), each
//     a [P x Q] . [Q x N] product of the decay-weighted x_h with B, x and B
//     staged 32 rows at a time.
// Operand tiles are staged by 16-byte cp.async (4-byte where N or a base
// breaks 16-byte alignment), double buffered, in rows padded so that each
// fragment load hits 32 distinct banks; the cumulative sums take one
// thread per position.  The outputs (268 MB of Y and 134 MB of S_c at the
// serve shape) would cost more in partly written 32-byte sectors than the
// products take, so each block's tile goes through shared memory and out
// as whole rows.  Y and S_c are summed in fp32 in a fixed order and
// written once, with no atomics, so two launches give the same bits.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 256;          // threads per block (8 warps)
constexpr int TI = 64;           // rows per Y block, and the score column tile
constexpr int HG = 16;           // heads per Y block
constexpr int HP = 2;            // heads per pass of a Y block (4 warps each)
constexpr int JC = 32;           // rows (j) of x and B per staged chunk
constexpr int NC = 32;           // state dims per staged score chunk
constexpr int SN = 128;          // state columns per state block
constexpr int MAXQ = 4 * TI;     // largest chunk
static_assert(MAXQ == NT, "one thread per position in the cumulative sums");
constexpr int SROW = MAXQ + 4;   // score row (floats), = 4 mod 32
constexpr int CROW = NC + 4;     // staged C / B rows of the scores, = 4 mod 32
constexpr int BROW = SN + 8;     // staged B rows of a state block, = 8 mod 32
constexpr int SOROW = SN + 8;    // the state tile on its way out
template <int P> constexpr int kXRow = P + 8;          // staged x rows, = 8 mod 16

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
  bool bc_vec;          // B and C rows can be copied 16 bytes at a time
};

// cs[u * MAXQ + q] = inclusive cumulative sum of log_a[bc, :q + 1, h0 + u]
// over the chunk for u < nh (constant past Q), one thread per position: a
// shuffle scan within each warp, then the totals of the warps before it.
// Every thread of the block calls it; cs is complete when it returns.
template <int NH>
__device__ void block_cumsum(const SsdArgs& a, int bc, int h0, int nh,
                             float* cs) {
  __shared__ float tot[NH][NT / 32];
  const int q = threadIdx.x, lane = q & 31, warp = q >> 5;
  const float* la = a.log_a + ((size_t)bc * a.Q + q) * a.H + h0;
  float v[NH];
#pragma unroll
  for (int u = 0; u < NH; ++u) v[u] = (u < nh && q < a.Q) ? la[u] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
#pragma unroll
    for (int u = 0; u < NH; ++u) {
      const float o = __shfl_up_sync(0xffffffffu, v[u], off);
      if (lane >= off) v[u] += o;
    }
  if (lane == 31)
#pragma unroll
    for (int u = 0; u < NH; ++u) tot[u][warp] = v[u];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    float base = 0.f;
    for (int w = 0; w < warp; ++w) base += tot[u][w];
    if (q < a.Qpad) cs[u * MAXQ + q] = base + v[u];
  }
  __syncthreads();
}

// Rows [0, R) x columns [0, COLS) of a row-major fp32 matrix (row stride
// `ld` floats) into dst (row stride `ldd`) by cp.async over the block;
// rows >= rows_ok and columns >= cols_ok are zero-filled.  vec: 16-byte
// copies (COLS, cols_ok and ld multiples of 4, src 16-byte aligned), else
// 4-byte copies.
template <int R, int COLS>
__device__ __forceinline__ void stage_f32(float* dst, int ldd,
                                          const float* src, size_t ld,
                                          int rows_ok, int cols_ok, bool vec) {
  if (vec) {
    constexpr int PCS = COLS / 4;
#pragma unroll
    for (int i = threadIdx.x; i < R * PCS; i += NT) {
      const int r = i / PCS, c = (i % PCS) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      repro::cp_async16(dst + r * ldd + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < rows_ok && c < cols_ok;
      repro::cp_async4(dst + r * ldd + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

__device__ __forceinline__ void split_tf32_x4(float v0, float v1, float v2,
                                              float v3, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  repro::split_tf32(v0, hi[0], lo[0]);
  repro::split_tf32(v1, hi[1], lo[1]);
  repro::split_tf32(v2, hi[2], lo[2]);
  repro::split_tf32(v3, hi[3], lo[3]);
}

// n stages through two shared-memory buffers: load(k, buf) issues stage k's
// copies, compute(k, buf) consumes them; stage k + 1 is in flight while k
// is computed.  Every thread of the block calls it.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, Load load, Compute compute) {
  load(0, 0);
  repro::cp_async_commit();
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      load(k + 1, (k + 1) & 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    compute(k, k & 1);
    __syncthreads();                 // buffer k & 1 is refilled by stage k + 2
  }
}

template <int P>
__device__ void y_block(const SsdArgs& a, int bc, int rt, int hg,
                        float* smem) {
  constexpr int XROW = kXRow<P>;
  constexpr int NT8 = P / 8;                 // n8 tiles of a warp's Y rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int Q = a.Q, N = a.N, H = a.H;
  const int i0 = rt * TI;
  const int ncols = (rt + 1) * TI;           // score columns up to the diagonal
  float* S = smem;                           // [TI][SROW]: S[i][j] = C_{i0+i}.B_j
  float* cs = S + TI * SROW;                 // [HP][MAXQ]
  float* stg = cs + HP * MAXQ;               // the staging buffers

  // 1. the scores of this row tile, once for all heads of the group: warp
  //    (rs, ch) computes rows 16 rs.. and columns 32 ch.. of each 64-column
  //    tile jt, over N in chunks of NC
  {
    const int rs = warp & 3, ch = warp >> 2;
    const int n_nc = (N + NC - 1) / NC;
    const float* C = a.Cm + ((size_t)bc * Q + i0) * N;
    const float* Bm = a.Bm + (size_t)bc * Q * N;
    float acc[4][4];
    auto load = [&](int k, int buf) {
      const int jt = k / n_nc, n0 = (k % n_nc) * NC;
      float* Cs = stg + buf * 2 * TI * CROW;
      stage_f32<TI, NC>(Cs, CROW, C + n0, N, Q - i0, N - n0, a.bc_vec);
      stage_f32<TI, NC>(Cs + TI * CROW, CROW, Bm + (size_t)jt * TI * N + n0,
                        N, Q - jt * TI, N - n0, a.bc_vec);
    };
    auto compute = [&](int k, int buf) {
      const int jt = k / n_nc, nc = k % n_nc;
      const float* Cs = stg + buf * 2 * TI * CROW;
      const float* Bs = Cs + TI * CROW;
      if (nc == 0)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      // a tile wholly above the diagonal is never read
      const bool live = jt < rt || 32 * ch <= 16 * rs + 15;
      if (live) {
#pragma unroll
        for (int k0 = 0; k0 < NC; k0 += 8) {
          uint32_t ah[4], al[4];
          const float* cr = Cs + (16 * rs + grp) * CROW + k0 + tig;
          split_tf32_x4(cr[0], cr[8 * CROW], cr[4], cr[8 * CROW + 4], ah, al);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float* br = Bs + (32 * ch + 8 * t + grp) * CROW + k0 + tig;
            uint32_t bh[2], bl[2];
            repro::split_tf32(br[0], bh[0], bl[0]);
            repro::split_tf32(br[4], bh[1], bl[1]);
            repro::mma_tf32x3(acc[t], ah, al, bh, bl);
          }
        }
        if (nc == n_nc - 1) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float* out = S + (16 * rs + grp) * SROW + jt * TI + 32 * ch
                + 8 * t + 2 * tig;
            *reinterpret_cast<float2*>(out) = make_float2(acc[t][0], acc[t][1]);
            *reinterpret_cast<float2*>(out + 8 * SROW) =
                make_float2(acc[t][2], acc[t][3]);
          }
        }
      }
    };
    pipeline((rt + 1) * n_nc, load, compute);
  }

  // 2. HP heads a pass: warp (hs, rs) owns rows 16 rs.. of head hs of the
  //    pass, all P columns; W = scores * decay on and below the diagonal,
  //    Y_h = W x_h over the columns up to the warp's own diagonal
  const int hs = warp / 4, rs = warp % 4;
  const int r0 = 16 * rs;
  const int i_a = i0 + r0 + grp, i_b = i_a + 8;      // the lane's two rows
  const int j_end = i0 + r0 + 16;                    // columns this warp needs
  const int h_end = min((hg + 1) * HG, H);
  for (int hb = hg * HG; hb < h_end; hb += HP) {
    const int h = hb + hs;
    // the last pass's write-out ended on a barrier: cs is free
    block_cumsum<HP>(a, bc, hb, min(HP, H - hb), cs);
    const float* csh = cs + hs * MAXQ;
    const float c_a = csh[i_a], c_b = csh[i_b];
    float acc[NT8][4] = {};
    auto load = [&](int k, int buf) {
      const int j0 = k * JC;
      float* xs = stg + buf * HP * JC * XROW;
#pragma unroll
      for (int u = 0; u < HP; ++u) {
        const bool head_ok = hb + u < H;
        stage_f32<JC, P>(xs + u * JC * XROW, XROW,
                         a.x + (((size_t)bc * Q + j0) * H + hb + u) * P,
                         (size_t)H * P, head_ok ? Q - j0 : 0, P, true);
      }
    };
    auto compute = [&](int k, int buf) {
      if (h >= H) return;
      const float* xs = stg + (buf * HP + hs) * JC * XROW;
#pragma unroll
      for (int ks = 0; ks < JC / 8; ++ks) {
        const int j0 = k * JC + 8 * ks;
        if (j0 >= j_end) break;
        const int ja = j0 + tig, jb = ja + 4;
        const float* srow = S + (r0 + grp) * SROW;
        const float ca = csh[ja], cb = csh[jb];
        // W fragment: rows i_a, i_b x columns ja, jb (exact zeros above the
        // diagonal and past Q)
        const float w0 = (ja <= i_a && i_a < Q) ? srow[ja] * expf(c_a - ca) : 0.f;
        const float w1 = (ja <= i_b && i_b < Q)
            ? srow[8 * SROW + ja] * expf(c_b - ca) : 0.f;
        const float w2 = (jb <= i_a && i_a < Q) ? srow[jb] * expf(c_a - cb) : 0.f;
        const float w3 = (jb <= i_b && i_b < Q)
            ? srow[8 * SROW + jb] * expf(c_b - cb) : 0.f;
        uint32_t ah[4], al[4];
        split_tf32_x4(w0, w1, w2, w3, ah, al);
        const float* xr = xs + (8 * ks + tig) * XROW + grp;
#pragma unroll
        for (int t = 0; t < NT8; ++t) {
          uint32_t bh[2], bl[2];
          repro::split_tf32(xr[8 * t], bh[0], bl[0]);
          repro::split_tf32(xr[4 * XROW + 8 * t], bh[1], bl[1]);
          repro::mma_tf32x3(acc[t], ah, al, bh, bl);
        }
      }
    };
    pipeline((min(ncols, Q) + JC - 1) / JC, load, compute);
    // Y of the pass through shared memory (the idle staging buffers), then
    // whole rows out: a row's HP heads are contiguous in y
    float* yo = stg;                         // [HP][TI][YOROW]
    constexpr int YOROW = P + 8;             // = 8 mod 16: no bank conflicts
#pragma unroll
    for (int t = 0; t < NT8; ++t) {
      float* o = yo + (hs * TI + r0 + grp) * YOROW + 8 * t + 2 * tig;
      *reinterpret_cast<float2*>(o) = make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(o + 8 * YOROW) = make_float2(acc[t][2], acc[t][3]);
    }
    __syncthreads();
    const int nh = min(HP, H - hb);
    for (int e = threadIdx.x; e < TI * nh * (P / 4); e += NT) {
      const int r = e / (nh * (P / 4)), rem = e % (nh * (P / 4));
      const int u = rem / (P / 4), c = 4 * (rem % (P / 4));
      if (i0 + r < Q)
        *reinterpret_cast<float4*>(a.y + (((size_t)bc * Q + i0 + r) * H + hb + u)
                                   * P + c) =
            *reinterpret_cast<const float4*>(yo + (u * TI + r) * YOROW + c);
    }
    __syncthreads();                         // yo is the next pass's staging
  }
}

template <int P>
__device__ void s_block(const SsdArgs& a, int bc, int h, int nt,
                        float* smem) {
  constexpr int XROW = kXRow<P>;
  constexpr int WARPS_M = P >= 32 ? 2 : 1;     // warps along p
  constexpr int WARPS_N = 8 / WARPS_M;         // warps along n
  constexpr int MT = P / 16 / WARPS_M;         // m16 tiles a warp
  constexpr int NT8 = SN / 8 / WARPS_N;        // n8 tiles a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int Q = a.Q, N = a.N, H = a.H, n0 = nt * SN;
  const int pm0 = (warp % WARPS_M) * MT * 16;
  const int nm0 = (warp / WARPS_M) * NT8 * 8;
  float* dec = smem;                           // [MAXQ]: exp(cs_end - cs_j)
  float* stg = dec + MAXQ;
  block_cumsum<1>(a, bc, h, 1, dec);
  const float cs_end = dec[Q - 1];
  __syncthreads();                             // every thread has read cs_end
  for (int j = threadIdx.x; j < a.Qpad; j += NT) dec[j] = expf(cs_end - dec[j]);
  // (the pipeline's first barrier publishes dec)
  float acc[MT][NT8][4] = {};
  constexpr int STAGE = JC * XROW + JC * BROW;
  auto load = [&](int k, int buf) {
    const int j0 = k * JC;
    float* xs = stg + buf * STAGE;
    stage_f32<JC, P>(xs, XROW, a.x + (((size_t)bc * Q + j0) * H + h) * P,
                     (size_t)H * P, Q - j0, P, true);
    stage_f32<JC, SN>(xs + JC * XROW, BROW,
                      a.Bm + ((size_t)bc * Q + j0) * N + n0, N, Q - j0,
                      N - n0, a.bc_vec);
  };
  auto compute = [&](int k, int buf) {
    const float* xs = stg + buf * STAGE;
    const float* Bs = xs + JC * XROW;
    const float* dk = dec + k * JC;
#pragma unroll
    for (int ks = 0; ks < JC / 8; ++ks) {
      const int ja = 8 * ks + tig, jb = ja + 4;
      const float da = dk[ja], db = dk[jb];
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // A[p][j] = x[j][p] * decay_j
        const float* xa = xs + ja * XROW + pm0 + 16 * m + grp;
        const float* xb = xs + jb * XROW + pm0 + 16 * m + grp;
        split_tf32_x4(xa[0] * da, xa[8] * da, xb[0] * db, xb[8] * db,
                      ah[m], al[m]);
      }
#pragma unroll
      for (int t = 0; t < NT8; ++t) {
        uint32_t bh[2], bl[2];
        repro::split_tf32(Bs[ja * BROW + nm0 + 8 * t + grp], bh[0], bl[0]);
        repro::split_tf32(Bs[jb * BROW + nm0 + 8 * t + grp], bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          repro::mma_tf32x3(acc[m][t], ah[m], al[m], bh, bl);
      }
    }
  };
  pipeline((Q + JC - 1) / JC, load, compute);
  // the tile through shared memory (the idle staging buffers), then whole
  // rows of S_c out
  float* so = stg;                             // [P][SOROW]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < NT8; ++t) {
      float* o = so + (pm0 + 16 * m + grp) * SOROW + nm0 + 8 * t + 2 * tig;
      *reinterpret_cast<float2*>(o) = make_float2(acc[m][t][0], acc[m][t][1]);
      *reinterpret_cast<float2*>(o + 8 * SOROW) =
          make_float2(acc[m][t][2], acc[m][t][3]);
    }
  __syncthreads();
  float* sh = a.s + ((size_t)bc * H + h) * P * N + n0;
  if (N % 4 == 0) {                            // 16-byte aligned rows
    for (int e = threadIdx.x; e < P * (SN / 4); e += NT) {
      const int r = e / (SN / 4), c = 4 * (e % (SN / 4));
      if (n0 + c < N)
        *reinterpret_cast<float4*>(sh + (size_t)r * N + c) =
            *reinterpret_cast<const float4*>(so + r * SOROW + c);
    }
  } else {
    for (int e = threadIdx.x; e < P * SN; e += NT) {
      const int r = e / SN, c = e % SN;
      if (n0 + c < N) sh[(size_t)r * N + c] = so[r * SOROW + c];
    }
  }
}

template <int P>
__global__ void __launch_bounds__(NT, 2) ssd_intra_mma_kernel(SsdArgs a) {
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
  constexpr int XROW = kXRow<P>;
  constexpr size_t y_stage = std::max(2 * 2 * TI * CROW, 2 * HP * JC * XROW);
  constexpr size_t y_smem = (TI * SROW + HP * MAXQ + y_stage) * sizeof(float);
  constexpr size_t s_smem =
      (MAXQ + 2 * (JC * XROW + JC * BROW)) * sizeof(float);
  constexpr size_t smem = std::max(y_smem, s_smem);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_mma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = a.n_y_blocks + a.BC * a.H * a.n_n_tiles;
  ssd_intra_mma_kernel<P><<<grid, NT, smem, stream>>>(a);
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
  if (BC < 1 || Q < 1 || Q > MAXQ || H < 1 || N < 1)
    return cudaErrorInvalidValue;
  SsdArgs a{x, log_a, Bm, Cm, y, s, BC, Q, H, N};
  a.Qpad = (Q + TI - 1) / TI * TI;
  a.n_row_tiles = a.Qpad / TI;
  a.n_head_groups = (H + HG - 1) / HG;
  a.n_y_blocks = BC * a.n_row_tiles * a.n_head_groups;
  a.n_n_tiles = (N + SN - 1) / SN;
  a.bc_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0
             && reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {   // mamba2-1.3b's head dim, and its reduced config's
    case 16: return launch<16>(a, st);
    case 64: return launch<64>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
