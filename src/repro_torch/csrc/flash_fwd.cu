// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// masks, contiguous GQA, ragged Tq/Tk -> (out, lse).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_kernel
// (launched by _fwd_call, reached from flash_attention and flash_fwd_step).
// It computes what that kernel computes, not its grid walk: one thread
// block per (q tile of BQ = 64 rows, q head, batch) walks its KV tiles
// (BK = 64) in a loop; q head h reads kv head h / g (no expanded K/V);
// masks come from q_pos; columns >= Tk are dead.  Scores, the online
// softmax and the P.V sum are fp32, with the reference's NEG_INF and max
// floor (common.cuh), so a fully masked row gives an exact-zero output and
// lse = -1e25.  The entry picks a route by dtype, as tesseract_mm.cu does.
//
// bf16 inputs: tensor cores (flash_fwd_mma_kernel).
//   * 4 warps, each owning 16 q rows for the whole walk (FlashAttention-2's
//     layout).  The Q fragments are read once with ldmatrix and stay in
//     registers; S = Q.K^T runs on mma.sync m16n8k16 (bf16 in, fp32 sums,
//     so the products are exact and only the summation order differs from
//     the reference's fp32), with each K tile's B fragments read by
//     ldmatrix.
//   * K/V tiles stay bf16: cp.async into 16-byte-padded shared memory,
//     double buffered, so tile j + 1 loads while tile j is computed.
//   * The online softmax runs on the S accumulator fragments: a thread
//     holds two rows, reduced over its quad with __shfl_xor_sync; p is
//     2^(x log2 e - m log2 e) on the SFU.  P stays fp32, as the
//     reference's P and P.V are: each p is cut into three bf16 parts of 8
//     significant bits, hi + mid + lo == p exactly, and O += lo.V + mid.V
//     + hi.V (three mma, V's B fragments by ldmatrix.trans), so only the
//     tensor cores' fp32 sums round.  Two parts (hi = bf16(p), lo =
//     bf16(p - hi), ~2^-18 of p) were tried first: their error flipped the
//     bf16 rounding of one output of |x| > 2 at the serve shape against the
//     plain version (one bf16 ulp there is 2^-6 > chip_smoke.py's 1e-2),
//     and the third part cost no measurable time (the kernel is not bound
//     by its mma, see below).  The C fragments of S are the A fragments
//     of that product register for register (mma.cuh), so P never touches
//     shared memory.
//   * The walk covers only the KV tiles that some row of the block can
//     see, read from the rows' own positions (kv_tile_range; the plain
//     mirror is kernels/flash_attention.py::flash_kv_tiles): causal, the
//     tiles with first column <= the largest position; with a window, those
//     with last column > the smallest position - window; and below Tk.  A
//     skipped tile is masked for every row, so walking it would give p = 0
//     exactly, m_new == m_prev and corr = exp(0) = 1: it adds 0 and
//     multiplies by 1, and skipping it changes no bit.  A block whose rows
//     are all masked walks nothing and writes zeros with lse = -1e25.  So
//     q_start = None (the serve prefill) walks the causal half, and with
//     q_pos = q_start + arange the range is the reference's _kv_bounds
//     (q_start itself is not read: the positions decide).
//     The grid is linear with the q tile slowest, so the longest walks of
//     every head start first and the short ones fill the tail.
//   What bounds it: ~4 D FLOPs per causal (q, k) pair per q head, far above
//   the H100's ~295 FLOP/byte ridge, so the tensor cores (989 TFLOP/s bf16)
//   are the bound it is measured against.  It runs far from it: at D = 128
//   its 236 registers a thread leave 2 blocks (8 warps) per SM, too few to
//   hide the latency of each tile's chain (S mma, max, shuffles, exp,
//   split, P.V mma); cutting the P.V mma to a third left the time unchanged
//   on the card.  TMA-fed tiles and wgmma (warpgroup products issued from
//   shared memory and overlapped with the softmax of the previous tile)
//   are the next step.
//
// fp32 inputs: fp32 FMA on the CUDA cores (flash_fwd_kernel, the first
// version, kept so fp32 parity runs compare like with like): each thread
// holds an 8x4 score tile and an 8x(D/16) output tile in registers, K/V
// tiles are staged as fp32 in padded shared memory, and it walks the tile
// range of _kv_bounds (q_start < 0 stands for None and walks every tile
// under the mask).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::kMFloor;
using repro::kNegInf;

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv rows per tile
constexpr int NT = 128;  // threads per block of the fp32 route: 8 row
                         // groups x 16 lanes

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

// ------------------------------------------------------- bf16: tensor cores
constexpr int MNT = 128;  // threads per block: 4 warps x 16 q rows
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t mma_smem_bytes() {  // Q, and two stages of K and V
  return sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MNT) flash_fwd_mma_kernel(FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;   // padded shared-memory row (elements)
  constexpr int KD = D / 16;  // k steps of S = Q.K^T
  constexpr int NS = BK / 8;  // n8 tiles of a warp's 16 x BK scores
  constexpr int NO = D / 8;   // n8 tiles of a warp's 16 x D output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
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
  for (int r = threadIdx.x; r < BQ; r += MNT) {
    const int row = q0 + r;
    // rows past Tq continue the position sequence; their output is dropped
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

  uint32_t qf[KD][4];  // A fragments of the warp's 16 q rows, all of D
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
    repro::ldmatrix_x4(qf[ks], Qs + (warp * 16 + (which & 1) * 8 + r8) * LD
                                   + ks * 16 + (which >> 1) * 8);

  // this thread's rows: r0 (registers 0, 1 of a fragment) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + group;
  const int qp0 = qp_s[r0], qp1 = qp_s[r0 + 8];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part
  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

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

    // S = Q.K^T: K is stored [kv][d], the B operand's column-major layout
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        repro::ldmatrix_x4(kb, Kc + (np * 16 + (which >> 1) * 8 + r8) * LD
                                   + ks * 16 + (which & 1) * 8);
        repro::mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        repro::mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }

    // a tile that every row of the block sees whole needs no mask
    const bool whole = k0 + BK <= a.Tk &&
                       (!a.causal || k0 + BK - 1 <= qmin) &&
                       (a.window <= 0 || k0 > qmax - a.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (!whole) {
          const int col = k0 + nt * 8 + 2 * tig + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = col < a.Tk;
          if (a.causal) ok = ok && qp >= col;
          if (a.window > 0) ok = ok && col > qp - a.window;
          if (!ok) x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float ms[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      ms[i] = fmaxf(m_new, kMFloor);
      corr[i] = __expf(fmaxf(m[i], kMFloor) - ms[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    // p = exp(x - ms) as 2^(x log2 e - ms log2 e): one FMA per score.  The
    // rounding of ms log2 e scales a row's p and l alike and cancels in
    // O / l; corr above keeps the exact form, so a tile that changes no
    // max multiplies by exactly 1
    const float msl[2] = {ms[0] * kLog2e, ms[1] * kLog2e};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = repro::exp2_approx(
            fmaf(s[nt][e], kLog2e, -msl[e >> 1]));  // masked -> 0
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    if (corr[0] != 1.f || corr[1] != 1.f) {  // x 1 changes no bit
#pragma unroll
      for (int d = 0; d < NO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] *= corr[e >> 1];
    }

    // O += P.V with P = hi + mid + lo exactly: score tiles 2 kc and
    // 2 kc + 1 are the A fragment over kv rows 16 kc .. 16 kc + 15
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ph[4], pm[4], pl[4];
      repro::split3_bf16x2(s[2 * kc][0], s[2 * kc][1], ph[0], pm[0], pl[0]);
      repro::split3_bf16x2(s[2 * kc][2], s[2 * kc][3], ph[1], pm[1], pl[1]);
      repro::split3_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pm[2],
                           pl[2]);
      repro::split3_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pm[3],
                           pl[3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        repro::ldmatrix_x4_trans(vb, Vc + (kc * 16 + (which & 1) * 8 + r8) * LD
                                         + dp * 16 + (which >> 1) * 8);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // the two n8 tiles, small parts first
          repro::mma_bf16(o[2 * dp + h2], pl, vb[2 * h2], vb[2 * h2 + 1]);
          repro::mma_bf16(o[2 * dp + h2], pm, vb[2 * h2], vb[2 * h2 + 1]);
          repro::mma_bf16(o[2 * dp + h2], ph, vb[2 * h2], vb[2 * h2 + 1]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out) + qrow0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);  // the quad's parts
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + 8 * i;
    if (row >= a.Tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];  // masked row -> zero output
#pragma unroll
    for (int d = 0; d < NO; ++d)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + d * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(o[d][2 * i] / ls, o[d][2 * i + 1] / ls);
    if (tig == 0) a.lse[qrow0 + row] = fmaxf(m[i], kMFloor) + logf(ls);
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

template <int D>
cudaError_t launch_mma(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ * a.Hq * B);
  flash_fwd_mma_kernel<D><<<grid, MNT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success).  q_start < 0 means "None".
// fp32 takes the FMA kernel, bf16 the tensor-core kernel (q, k, v 16-byte
// aligned, as cp.async reads them; the wrapper checks).
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
  if (dtype == repro::kBFloat16 && D == 64) return launch_mma<64>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 128) return launch_mma<128>(a, B, st);
  return cudaErrorInvalidValue;
}
