// Paged decode attention for Hopper (sm_90a): one new token per request
// against a block pool, walking each request's block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_kernel
// (launched by paged_attention there).  It computes what that kernel
// computes:
//   * live pages of request b are [lo, hi) with hi = pos // bs + 1 (pos is
//     inclusive: the new token's K/V was written first) and, under a
//     window, lo = max(pos - window + 1, 0) // bs (_page_bounds);
//   * positions > pos and outside the window are masked;
//   * kv_map[h] picks the kv head of q head h (any map, not only the
//     contiguous GQA grouping);
//   * l == 0 gives a zero output; a retired slot (table all scratch,
//     pos = 0) reads exactly one page.
// The TPU kernel gets the table by scalar prefetch into its index maps and
// walks every page of a request in order on one core; here the walk is
// split over the card.
//
// What bounds it: decode attention does ~4 D FLOPs per cached position and
// q head against 2 D elt bytes of K/V per position and kv head, so it is
// bound by the bytes of the live K/V pages over the card's 3.35 TB/s (at
// the serve shape ~15 MB: 4.6 us).  Reaching that needs every SM streaming
// and each page read once, not once per q head.
//
// Design (flash-decoding over the paged pool), two launches on one stream:
//   * split kernel: one block per (position split, kv head, batch).  A
//     split is a fixed span of `pages_per_split` pages, chosen by the
//     wrapper from nb and bs alone (never from pos, which stays on the
//     card).  A split that lies wholly past pos or before the window's
//     first page writes an empty partial (m = -1e30, l = 0) and exits.
//     The block gathers the q heads that kv_map sends to its kv head (any
//     map), takes them GMAX at a time, and streams its live positions CH
//     at a time through shared memory with 16-byte cp.async, double
//     buffered, so each K/V page is read once for up to GMAX q heads.  Per
//     chunk: scores (a thread sums 4 positions x 2 heads over a quarter of
//     D, four lanes add their quarters), an online softmax per head (one
//     warp each, the max floored at -1e25 as the reference's), then P.V
//     with each warp summing its eighth of the chunk's positions for all
//     heads.  The
//     arithmetic is fp32 FMA: at ~4 D FLOPs per 4 D bytes of bf16 K/V the
//     tensor cores would only add a rounding of P.  The partial (m, l,
//     acc[D]) of each (split, q head) goes to fp32 scratch.
//   * combine kernel: one block per (q head, batch) merges the splits in
//     index order: acc = sum_s exp(max(m_s, -1e25) - M) acc_s over the
//     splits with l_s > 0, out = acc / l (0 where l = 0).  No atomics, so
//     two launches give the same bits.
// At the serve shape (8 slots at 144-2016 positions, 4 kv heads, D 128)
// splits of 128 positions put ~250 blocks to work; 64 or 256 were slower
// on the card (chip_smoke.py's split sweep).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::kMFloor;
using repro::kNegInf;

constexpr int NT = 256;         // threads per split block
constexpr int NW = NT / 32;     // warps
constexpr int CH = 64;          // positions staged per chunk
constexpr int GMAX = NW;        // q heads per pass: one warp each
constexpr int PPW = CH / NW;    // positions per warp in P.V (8)
// scores: thread (position group pg, head pair hp, quarter u) sums rows
// 4 pg .. 4 pg + 3 against heads hp and hp + 4 over the 16-byte pieces u,
// u + 4, ... of D (q rows padded by 16 bytes: the two lanes of a quarter
// warp that read q at the same u hit different banks)
constexpr int SU = 4;           // quarters
constexpr int SR = 4;           // rows a thread
constexpr int SH = 2;           // heads a thread
static_assert(SU * (GMAX / SH) * (CH / SR) == NT, "score tiling");
constexpr int MAX_HQ = 256;     // q heads the map scan holds (wrapper checks)
constexpr int PAD16 = 4;        // 16-byte units of padding per staged row
static_assert(CH == 64, "the softmax warp holds a chunk in two lanes' worth");

struct PagedArgs {
  const void* q;        // [B, Hq, D]
  const void* pool_k;   // [P, bs, Hkv, D]
  const void* pool_v;   // [P, bs, Hkv, D]
  const int* table;     // [B, nb] local block ids
  const int* pos;       // [B] inclusive position of the new token
  const int* kv_map;    // [Hq] q head -> kv head
  void* out;            // [B, Hq, D], q's dtype
  float* part_m;        // [B, Hq, S] running max of each split
  float* part_l;        // [B, Hq, S] softmax denominator of each split
  float* part_acc;      // [B, Hq, S, D] unnormalised output of each split
  int Hq, Hkv, bs, nb, window, pps, n_splits;
  float scale;
};

// [lo, hi) live pages of a request (the reference's _page_bounds, with hi
// clamped to the table)
__device__ __forceinline__ void page_bounds(const PagedArgs& a, int pos,
                                            int& lo, int& hi) {
  hi = min(repro::floor_div(pos, a.bs) + 1, a.nb);
  lo = 0;
  if (a.window > 0) lo = min(max(pos - a.window + 1, 0) / a.bs, hi - 1);
}

template <typename T, int D>
struct Smem {
  static constexpr int VEC = 16 / sizeof(T);           // elements per 16 B
  static constexpr int ROW = D + PAD16 * VEC;          // staged row, elements
  int heads[MAX_HQ];                                   // q heads of hk
  alignas(16) float qs[GMAX][D + 4];                   // q of this pass
  alignas(16) float ps[GMAX][CH];                      // scores, then P
  float corr[GMAX];
  alignas(16) T kv[2][2][CH][ROW];                     // [stage][K, V]
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_attention_split_kernel(
    PagedArgs a) {
  using S = Smem<T, D>;
  constexpr int VEC = S::VEC;
  constexpr int PIECES = D / VEC;                      // 16 B units per row
  constexpr int NPC = PIECES / SU;                     // per scoring thread
  constexpr int CPL = D / 32;                          // P.V columns a lane
  static_assert(PIECES % SU == 0 && CH * PIECES % NT == 0, "tiling");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = a.pos[b];
  const size_t S_ = a.n_splits;

  // the q heads this kv head serves, in ascending order (warp 0, a ballot
  // per 32 heads); every warp then reads the count from shared memory
  __shared__ int n_heads;
  if (warp == 0) {
    int n = 0;
    for (int h0 = 0; h0 < a.Hq; h0 += 32) {
      const int h = h0 + lane;
      const bool mine = h < a.Hq && a.kv_map[h] == hk;
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      if (mine) sm.heads[n + __popc(bal & ((1u << lane) - 1))] = h;
      n += __popc(bal);
    }
    if (lane == 0) n_heads = n;
  }
  __syncthreads();
  const int G_all = n_heads;
  if (G_all == 0) return;

  int lo, hi;
  page_bounds(a, pos, lo, hi);
  const int pg_begin = max(split * a.pps, lo);
  const int pg_end = min((split + 1) * a.pps, hi);
  const size_t part = (size_t)b * a.Hq;
  if (pg_begin >= pg_end) {          // nothing live here: an empty partial
    for (int i = tid; i < G_all; i += NT) {
      const size_t at = (part + sm.heads[i]) * S_ + split;
      a.part_m[at] = kNegInf;
      a.part_l[at] = 0.f;
    }
    return;
  }
  const int p_begin = pg_begin * a.bs, p_end = pg_end * a.bs;
  const int n_chunks = (p_end - p_begin + CH - 1) / CH;
  const int* trow = a.table + (size_t)b * a.nb;
  const T* pool[2] = {static_cast<const T*>(a.pool_k),
                      static_cast<const T*>(a.pool_v)};

  // K and V rows of chunk c into stage st: 16-byte copies, rows past the
  // split's live span zero-filled
  auto stage = [&](int c, int st) {
    const int c0 = p_begin + c * CH;
#pragma unroll
    for (int l = 0; l < CH * PIECES / NT; ++l) {
      const int i = tid + l * NT;
      const int r = i / PIECES, piece = i % PIECES;
      const int p = c0 + r;
      const bool ok = p < p_end;
      size_t off = 0;
      if (ok) off = (((size_t)trow[p / a.bs] * a.bs + p % a.bs) * a.Hkv + hk)
                    * D + piece * VEC;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv)
        repro::cp_async16(&sm.kv[st][kv][r][piece * VEC], pool[kv] + off, ok);
    }
    repro::cp_async_commit();
  };

  const int u = tid % SU, hp = (tid / SU) % (GMAX / SH), pg = tid / (SU * GMAX / SH);
  for (int g0 = 0; g0 < G_all; g0 += GMAX) {
    const int G = min(GMAX, G_all - g0);
    __syncthreads();                 // the last pass's shared memory is free
    stage(0, 0);
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      sm.qs[g][d] = repro::to_f32(static_cast<const T*>(a.q)[
          (part + sm.heads[g0 + g]) * D + d]);
    }
    float m = kNegInf, l = 0.f;      // warp `warp`'s head, lane-replicated
    float acc[GMAX][CPL] = {};       // P.V: this warp's positions, all heads
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c & 1;
      if (c + 1 < n_chunks) {
        stage(c + 1, st ^ 1);
        repro::cp_async_wait<1>();
      } else {
        repro::cp_async_wait<0>();
      }
      __syncthreads();               // chunk c (and q) visible to all

      // scores: the four lanes u of (pg, hp) sum interleaved 16-byte
      // pieces of SR rows against SH heads, then add across u (heads past
      // G score zeros and are not written)
      {
        float dot[SR][SH] = {};
#pragma unroll
        for (int k = 0; k < NPC; ++k) {
          const int d0 = (u + k * SU) * VEC;
          float qf[SH][VEC];
#pragma unroll
          for (int e = 0; e < SH; ++e)
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  &sm.qs[hp + e * (GMAX / SH)][d0 + j]);
              qf[e][j] = qv.x; qf[e][j + 1] = qv.y;
              qf[e][j + 2] = qv.z; qf[e][j + 3] = qv.w;
            }
#pragma unroll
          for (int r = 0; r < SR; ++r) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                &sm.kv[st][0][pg * SR + r][d0]);
            const T* e8 = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float kf = repro::to_f32(e8[j]);
#pragma unroll
              for (int e = 0; e < SH; ++e) dot[r][e] = fmaf(qf[e][j], kf, dot[r][e]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < SR; ++r)
#pragma unroll
          for (int e = 0; e < SH; ++e)
#pragma unroll
            for (int off = 1; off < SU; off <<= 1)
              dot[r][e] += __shfl_xor_sync(0xffffffffu, dot[r][e], off);
        // lane u writes row pg * SR + u of both heads
        float mine[SH];
#pragma unroll
        for (int e = 0; e < SH; ++e) {
          mine[e] = dot[0][e];
#pragma unroll
          for (int r = 1; r < SR; ++r) if (u == r) mine[e] = dot[r][e];
        }
        const int r_w = pg * SR + u;
        const int p = p_begin + c * CH + r_w;
        bool ok = p < p_end && p <= pos;
        if (a.window > 0) ok = ok && p > pos - a.window;
#pragma unroll
        for (int e = 0; e < SH; ++e) {
          const int g = hp + e * (GMAX / SH);
          if (g < G) sm.ps[g][r_w] = ok ? mine[e] * a.scale : kNegInf;
        }
      }
      __syncthreads();

      // online softmax: warp g owns head g
      if (warp < G) {
        const float s0 = sm.ps[warp][lane], s1 = sm.ps[warp][lane + 32];
        float cmax = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const float m_new = fmaxf(m, cmax);
        const float ms_new = fmaxf(m_new, kMFloor);
        const float cr = expf(fmaxf(m, kMFloor) - ms_new);
        const float p0 = expf(s0 - ms_new), p1 = expf(s1 - ms_new);
        sm.ps[warp][lane] = p0;
        sm.ps[warp][lane + 32] = p1;
        float psum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l = l * cr + psum;
        m = m_new;
        if (lane == 0) sm.corr[warp] = cr;
      }
      __syncthreads();

      // P.V: warp w sums positions [w PPW, (w + 1) PPW) for every head
      {
        float cr[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) cr[g] = g < G ? sm.corr[g] : 0.f;
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[g][j] *= cr[g];
#pragma unroll
        for (int k0 = 0; k0 < PPW; k0 += 4) {
          float pw[GMAX][4];           // P of 4 positions, 16 bytes a head
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
            if (g < G)
              v4 = *reinterpret_cast<const float4*>(&sm.ps[g][warp * PPW + k0]);
            pw[g][0] = v4.x; pw[g][1] = v4.y; pw[g][2] = v4.z; pw[g][3] = v4.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const T* vrow = &sm.kv[st][1][warp * PPW + k0 + k][lane * CPL];
            float vf[CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j) vf[j] = repro::to_f32(vrow[j]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
#pragma unroll
              for (int j = 0; j < CPL; ++j)
                acc[g][j] = fmaf(pw[g][k], vf[j], acc[g][j]);
          }
        }
      }
      __syncthreads();               // stage st and ps are rewritten next
    }

    // the warps' sums over their positions, added in warp order, through
    // the (now idle) staging buffers
    float* red = reinterpret_cast<float*>(&sm.kv[0][0][0][0]);   // [NW][GMAX][D]
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        red[((size_t)warp * GMAX + g) * D + lane * CPL + j] = acc[g][j];
    if (warp < G && lane == 0) {
      const size_t at = (part + sm.heads[g0 + warp]) * S_ + split;
      a.part_m[at] = m;
      a.part_l[at] = l;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += red[((size_t)w * GMAX + g) * D + d];
      a.part_acc[((part + sm.heads[g0 + g]) * S_ + split) * D + d] = s;
    }
  }
}

// one block of D threads per (q head, batch): the splits merged in index
// order.  The max comes from all splits at once; warp 0 then lists the
// live splits (l > 0) with their weights, so the accumulation loop's
// loads do not wait on one another
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_attention_combine_kernel(
    PagedArgs a) {
  extern __shared__ float cmb[];   // [3][n_splits]: weight, l, index
  float* lw = cmb;
  float* ll = cmb + a.n_splits;
  int* li = reinterpret_cast<int*>(cmb + 2 * a.n_splits);
  __shared__ float red[D / 32];
  __shared__ int n_live;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int warp = d >> 5, lane = d & 31;
  const size_t row = ((size_t)b * a.Hq + h) * a.n_splits;
  float M = kNegInf;
  for (int s = d; s < a.n_splits; s += D) M = fmaxf(M, a.part_m[row + s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (lane == 0) red[warp] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < D / 32; ++w) M = fmaxf(M, red[w]);
  const float Mf = fmaxf(M, kMFloor);
  if (warp == 0) {                 // empty and fully masked splits add 0
    int n = 0;
    for (int s0 = 0; s0 < a.n_splits; s0 += 32) {
      const int s = s0 + lane;
      const float ls = s < a.n_splits ? a.part_l[row + s] : 0.f;
      const bool live = ls > 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int k = n + __popc(bal & ((1u << lane) - 1));
        lw[k] = expf(fmaxf(a.part_m[row + s], kMFloor) - Mf);
        ll[k] = ls;
        li[k] = s;
      }
      n += __popc(bal);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < n_live; ++k) {
    const float w = lw[k];
    l = fmaf(w, ll[k], l);
    acc = fmaf(w, a.part_acc[(row + li[k]) * D + d], acc);
  }
  T* o = static_cast<T*>(a.out) + ((size_t)b * a.Hq + h) * D;
  o[d] = repro::from_f32<T>(acc / (l == 0.f ? 1.f : l));
}

template <typename T, int D>
cudaError_t launch(const PagedArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<T, D>);
  cudaError_t e = cudaFuncSetAttribute(
      paged_attention_split_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  paged_attention_split_kernel<T, D>
      <<<dim3(a.n_splits, a.Hkv, B), NT, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t cmb = 3 * sizeof(float) * a.n_splits;
  if (cmb > 48 * 1024) {
    e = cudaFuncSetAttribute(paged_attention_combine_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cmb);
    if (e != cudaSuccess) return e;
  }
  paged_attention_combine_kernel<T, D><<<dim3(a.Hq, B), D, cmb, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success).  scratch: fp32, B x Hq x
// n_splits x (D + 2) values (the partials), n_splits = ceil(nb /
// pages_per_split).
extern "C" int repro_paged_attention(const void* q, const void* pool_k,
                                     const void* pool_v, const int* table,
                                     const int* pos, const int* kv_map,
                                     void* out, float* scratch, int B, int Hq,
                                     int Hkv, int bs, int nb, int D, int dtype,
                                     int window, int pages_per_split,
                                     float scale, void* stream) {
  if (bs < 1 || nb < 1 || pages_per_split < 1 || Hq < 1 || Hq > MAX_HQ
      || Hkv < 1)
    return cudaErrorInvalidValue;
  const int n_splits = (nb + pages_per_split - 1) / pages_per_split;
  const size_t n_part = (size_t)B * Hq * n_splits;
  PagedArgs a{q, pool_k, pool_v, table, pos, kv_map, out,
              scratch, scratch + n_part, scratch + 2 * n_part,
              Hq, Hkv, bs, nb, window, pages_per_split, n_splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && D == 64) return launch<float, 64>(a, B, st);
  if (dtype == repro::kFloat32 && D == 128) return launch<float, 128>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(a, B, st);
  return cudaErrorInvalidValue;
}
