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
// The TPU kernel gets the table by scalar prefetch into its index maps;
// here each block reads its own table row and walks the positions of the
// live pages only, never all nb entries.
//
// What bounds it: decode attention does ~4*D FLOPs per cached position and
// head against 2*D*elt bytes of K/V per position and kv head, so it is
// bound by the bytes of the live K/V pages over the card's 3.35 TB/s.
// Design: one block per (q head, batch) keeps the online softmax in fp32
// and walks the live positions CH at a time, across page boundaries: thread
// t scores position c0 + t with 16-byte loads of its K row, the chunk's max
// and sum are block reductions, and thread d then accumulates output
// column d over the chunk's V rows (coalesced across threads).  One block
// per (batch, kv head) would read each page once for all g q heads of the
// group instead of g times (the repeats mostly hit L2); that change
// belongs to a later PR.
#include "common.cuh"

namespace {

using repro::kMFloor;
using repro::kNegInf;

constexpr int NT = 128;        // threads per block
constexpr int CH = NT;         // positions scored per iteration
constexpr int NW = NT / 32;

struct PagedArgs {
  const void* q;        // [B, Hq, D]
  const void* pool_k;   // [P, bs, Hkv, D]
  const void* pool_v;   // [P, bs, Hkv, D]
  const int* table;     // [B, nb] local block ids
  const int* pos;       // [B] inclusive position of the new token
  const int* kv_map;    // [Hq] q head -> kv head
  void* out;            // [B, Hq, D], q's dtype
  int Hq, Hkv, bs, nb, window;
  float scale;
};

// q . k for one K row, read 16 bytes at a time (rows are 16-byte aligned:
// the wrapper checks the pool's base and D * sizeof(T) is a multiple of 16)
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* qs, const T* row) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* src = reinterpret_cast<const uint4*>(row);
  float dot = 0.f;
#pragma unroll 4
  for (int i = 0; i < D / VEC; ++i) {
    const uint4 raw = src[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dot = fmaf(qs[i * VEC + j], repro::to_f32(e[j]), dot);
  }
  return dot;
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_attention_kernel(PagedArgs a) {
  __shared__ float qs[D];
  __shared__ float ps[CH];      // the chunk's probabilities
  __shared__ size_t roff[CH];   // element offset of each position's K/V row
  __shared__ float red[NW];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int hk = a.kv_map[h];
  const int pos = a.pos[b];
  const int* trow = a.table + (size_t)b * a.nb;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.Hq + h) * D;
  const T* pk = static_cast<const T*>(a.pool_k);
  const T* pv = static_cast<const T*>(a.pool_v);

  for (int d = tid; d < D; d += NT) qs[d] = repro::to_f32(q[d]);

  const int hi = min(pos / a.bs + 1, a.nb);
  int lo = 0;
  if (a.window > 0) lo = min(max(pos - a.window + 1, 0) / a.bs, hi - 1);
  const int p_begin = lo * a.bs, p_end = hi * a.bs;

  float m = kNegInf, l = 0.f, acc = 0.f;  // acc: output column d = tid
  __syncthreads();
  for (int c0 = p_begin; c0 < p_end; c0 += CH) {
    const int pp = c0 + tid;
    float s = kNegInf;
    if (pp < p_end) {
      const size_t off =
          (((size_t)trow[pp / a.bs] * a.bs + pp % a.bs) * a.Hkv + hk) * D;
      roff[tid] = off;
      bool ok = pp <= pos;
      if (a.window > 0) ok = ok && pp > pos - a.window;
      if (ok) s = dot_row<T, D>(qs, pk + off) * a.scale;
    }
    const float m_new = fmaxf(m, block_reduce<true>(s, red));
    const float ms_new = fmaxf(m_new, kMFloor);
    const float corr = expf(fmaxf(m, kMFloor) - ms_new);
    const float p = expf(s - ms_new);  // masked and past-the-end -> 0
    ps[tid] = p;
    l = l * corr + block_reduce<false>(p, red);  // also publishes ps/roff
    float pvsum = 0.f;
    if (tid < D) {
      const int n = min(CH, p_end - c0);
      for (int t = 0; t < n; ++t)
        pvsum = fmaf(ps[t], repro::to_f32(pv[roff[t] + tid]), pvsum);
    }
    acc = acc * corr + pvsum;
    m = m_new;
    __syncthreads();  // ps / roff are rewritten by the next chunk
  }
  if (tid < D) {
    T* o = static_cast<T*>(a.out) + ((size_t)b * a.Hq + h) * D;
    o[tid] = repro::from_f32<T>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D>
cudaError_t launch(const PagedArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(a.Hq, B);
  paged_attention_kernel<T, D><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success).
extern "C" int repro_paged_attention(const void* q, const void* pool_k,
                                     const void* pool_v, const int* table,
                                     const int* pos, const int* kv_map,
                                     void* out, int B, int Hq, int Hkv, int bs,
                                     int nb, int D, int dtype, int window,
                                     float scale, void* stream) {
  if (bs < 1) return cudaErrorInvalidValue;
  PagedArgs a{q, pool_k, pool_v, table, pos, kv_map, out,
              Hq, Hkv, bs, nb, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && D == 64) return launch<float, 64>(a, B, st);
  if (dtype == repro::kFloat32 && D == 128) return launch<float, 128>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(a, B, st);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(a, B, st);
  return cudaErrorInvalidValue;
}
