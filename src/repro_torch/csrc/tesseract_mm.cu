// The Tesseract SUMMA contraction for Hopper (sm_90a): kernels #1 and #2.
//
// Replaces the TPU kernels of src/repro/kernels/tesseract_mm.py:
//   * tesseract_mm (body _kernel): after the fused all-gathers each rank
//     computes C[e, g] = sum_t sum_f A[t, e, f] B[t, f, g] in fp32 (the
//     paper's inner SUMMA loop);
//   * tesseract_mm_stream (body _stream_kernel): one ring step,
//     C <- C + A B, with the fp32 accumulator C carried in and out in place.
// Both are one kernel here: the stream step is the T = 1 case with the
// accumulator loaded from C before the reduction instead of zeroed.
//
// The TPU kernel folds (t, f) into one sequential grid axis and keeps the
// accumulator in VMEM.  Here one block owns one (E tile, G tile) of C and
// walks the same (t, f) reduction in the same order, t outer and f inner,
// inside the block; the fp32 accumulator stays in registers and C is
// written once, in fp32 or rounded to bf16 in the epilogue (a bf16
// projection's result in its input's dtype, with no separate cast).  No
// split-K and no atomics, so a repeat launch gives the same bits, and two
// stream launches over t = 0, 1 give the bits of one launch over T = 2
// (the accumulator round-trips through fp32 exactly).
//
// What bounds it: a projection of E token rows reads its weight block
// (F x G) once and does 2 E F G FLOPs, so at prefill (E in the thousands)
// it is bound by the tensor cores (989 TFLOP/s bf16) and at decode (E of
// 4 to 8 rows) by the bytes of the weights over 3.35 TB/s.
// Design:
//   * bf16 inputs: mma.sync m16n8k16 (bf16 in, fp32 accumulate) on the
//     tensor cores.  A block of 256 threads (8 warps, 2 along E x 4 along
//     G, each warp a 64 x 32 tile) computes a 128 x 128 tile of C; A and B
//     tiles of depth 32 are staged in shared memory by cp.async, two stages
//     deep, and read into fragments by ldmatrix (B transposed).  Rows of
//     shared memory are padded by 16 bytes so ldmatrix reads no bank twice.
//   * fp32 inputs: fp32 FMA on the CUDA cores (64 x 64 tiles, a 4 x 4
//     register tile per thread), so fp32 runs compare like with like with
//     a TF32-off reference.
//   * any E, F and G: rows and columns past the edge are zero-filled on
//     load and masked on store; when F or G is not a multiple of 8 (or a
//     base is not 16-byte aligned) the tiles are loaded element by element.
//   * decode's few rows (E <= 16) take 16 x 32 tiles, so G / 32 blocks
//     stream the weights through a deeper cp.async ring (see below);
//   * wgmma, TMA and a persistent schedule are left for later.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::smem_u32;

// ---------------------------------------------------------------- bf16
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int NT = 256;                  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;          // warp tile
constexpr int MI = WM / 16, NI = WN / 8; // m16 x n8 fragments per warp
constexpr int A_LD = BK + 8;             // padded smem rows (elements)
constexpr int B_LD = BN + 8;

struct MmArgs {
  const void* a;  // [T, E, F]
  const void* b;  // [T, F, G]
  void* c;        // [E, G] fp32, or bf16 when c_bf16
  int T, E, F, G;
  int accumulate; // 1: C += A B (C loaded first, fp32); 0: C = A B
  int c_bf16;     // 1: the epilogue rounds the fp32 sums to bf16
};

// C's element i: loaded (fp32 only: the accumulator of a ring step) and
// stored in C's type, so a bf16 product leaves the kernel in A's dtype
// with no separate cast.
__device__ __forceinline__ float load_c(const MmArgs& p, size_t i) {
  return static_cast<const float*>(p.c)[i];
}

__device__ __forceinline__ void store_c(const MmArgs& p, size_t i, float v) {
  if (p.c_bf16)
    static_cast<__nv_bfloat16*>(p.c)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.c)[i] = v;
}

// Stage the A tile [BM x BK] of (t, f0) and the B tile [BK x BN] into
// shared memory; out-of-range rows and columns become zeros.
template <bool VEC>
__device__ __forceinline__ void load_tiles(
    const MmArgs& p, int t, int f0, int e0, int g0,
    __nv_bfloat16 (*As)[A_LD], __nv_bfloat16 (*Bs)[B_LD]) {
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    // 16-byte chunks: A has BM * BK / 8 = 512, B has BK * BN / 8 = 512
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int i = tid + l * NT;
      const int ar = i / (BK / 8), ac = (i % (BK / 8)) * 8;
      const bool av = e0 + ar < p.E && f0 + ac < p.F;
      const __nv_bfloat16* asrc =
          av ? A + ((size_t)t * p.E + e0 + ar) * p.F + f0 + ac : A;
      cp_async16(&As[ar][ac], asrc, av);
      const int br = i / (BN / 8), bc = (i % (BN / 8)) * 8;
      const bool bv = f0 + br < p.F && g0 + bc < p.G;
      const __nv_bfloat16* bsrc =
          bv ? B + ((size_t)t * p.F + f0 + br) * p.G + g0 + bc : B;
      cp_async16(&Bs[br][bc], bsrc, bv);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      As[r][c] = (e0 + r < p.E && f0 + c < p.F)
                     ? A[((size_t)t * p.E + e0 + r) * p.F + f0 + c]
                     : zero;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      Bs[r][c] = (f0 + r < p.F && g0 + c < p.G)
                     ? B[((size_t)t * p.F + f0 + r) * p.G + g0 + c]
                     : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
tesseract_mm_bf16_kernel(MmArgs p) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][B_LD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int e0 = blockIdx.y * BM, g0 = blockIdx.x * BN;
  const int group = lane >> 2, tig = lane & 3;

  // fragment (mi, ni), register r: row mi*16 + group + (r >= 2) * 8, column
  // ni*8 + tig*2 + (r & 1) of the warp tile
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = e0 + wm * WM + mi * 16 + group + (r >> 1) * 8;
        const int g = g0 + wn * WN + ni * 8 + tig * 2 + (r & 1);
        acc[mi][ni][r] = (p.accumulate && e < p.E && g < p.G)
                             ? load_c(p, (size_t)e * p.G + g)
                             : 0.f;
      }

  const int nk = (p.F + BK - 1) / BK;
  const int steps = p.T * nk;   // (t, f) in the TPU grid's order
  if (steps > 0) load_tiles<VEC>(p, 0, 0, e0, g0, As[0], Bs[0]);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps)
      load_tiles<VEC>(p, (s + 1) / nk, ((s + 1) % nk) * BK, e0, g0,
                      As[cur ^ 1], Bs[cur ^ 1]);
    cp_async_commit();
    cp_async_wait<1>();           // stage s has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // ldmatrix: lanes 8i..8i+7 address the rows of 8x8 matrix i
      const int which = lane >> 3, r8 = lane & 7;
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], &As[cur][wm * WM + mi * 16 + (which & 1) * 8 + r8]
                               [kk + (which >> 1) * 8]);
      uint32_t bfr[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI; nj += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[cur][kk + (which & 1) * 8 + r8]
                                [wn * WN + (nj + (which >> 1)) * 8]);
        bfr[nj][0] = r[0];
        bfr[nj][1] = r[1];
        bfr[nj + 1][0] = r[2];
        bfr[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();              // stage cur is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = e0 + wm * WM + mi * 16 + group + (r >> 1) * 8;
        const int g = g0 + wn * WN + ni * 8 + tig * 2 + (r & 1);
        if (e < p.E && g < p.G)
          store_c(p, (size_t)e * p.G + g, acc[mi][ni][r]);
      }
}

// ------------------------------------------------------- bf16, decode rows
// At decode E is a handful of rows (4 at q = 2, 8 at one rank), and the
// weights' bytes, not the tensor cores, set the time.  A 128 x 128 tile
// leaves G / 128 blocks to stream them (32 for a 4096-wide projection, far
// from filling the card), so E <= 16 takes 16 x 32 tiles instead: G / 32
// blocks of 4 warps, warp w owning columns 8w .. 8w + 7 for the whole
// reduction, each block streaming its columns of B through a ring of
// SK_STAGES slabs of 128 reduction rows (cp.async; five slabs, 40 KB of B,
// in flight while one is consumed).  The (t, f) order and the fp32
// register accumulator are those of the kernel above.
constexpr int SM_ = 16, SN = 32, SK = 128, SNT = 128, SK_STAGES = 6;
constexpr int SA_LD = SK + 8, SB_LD = SN + 8;          // padded rows
constexpr int SA_STAGE = SM_ * SA_LD, SB_STAGE = SK * SB_LD;
constexpr size_t SKINNY_SMEM =
    (size_t)SK_STAGES * (SA_STAGE + SB_STAGE) * sizeof(__nv_bfloat16);

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void load_skinny(const MmArgs& p, int step, int nk,
                                            int e0, int g0,
                                            __nv_bfloat16* As,
                                            __nv_bfloat16* Bs) {
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  const int t = step / nk, f0 = (step % nk) * SK;
  // A: SM_ x SK = 256 chunks of 16 bytes; B: SK x SN = 512
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int i = threadIdx.x + l * SNT;
    const int r = i / (SK / 8), c = (i % (SK / 8)) * 8;
    const bool v = e0 + r < p.E && f0 + c < p.F;
    cp_async16(&As[r * SA_LD + c],
               v ? A + ((size_t)t * p.E + e0 + r) * p.F + f0 + c : A, v);
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int i = threadIdx.x + l * SNT;
    const int r = i / (SN / 8), c = (i % (SN / 8)) * 8;
    const bool v = f0 + r < p.F && g0 + c < p.G;
    cp_async16(&Bs[r * SB_LD + c],
               v ? B + ((size_t)t * p.F + f0 + r) * p.G + g0 + c : B, v);
  }
}

__global__ void __launch_bounds__(SNT)
tesseract_mm_skinny_kernel(MmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + SK_STAGES * SA_STAGE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = blockIdx.y * SM_, g0 = blockIdx.x * SN;
  const int group = lane >> 2, tig = lane & 3;
  const int gcol = g0 + warp * 8 + tig * 2;

  // register r: row group + (r >= 2) * 8, column gcol + (r & 1)
  float acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = e0 + group + (r >> 1) * 8, g = gcol + (r & 1);
    acc[r] = (p.accumulate && e < p.E && g < p.G)
                 ? load_c(p, (size_t)e * p.G + g)
                 : 0.f;
  }

  const int nk = (p.F + SK - 1) / SK;
  const int steps = p.T * nk;
#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < steps)
      load_skinny(p, s, nk, e0, g0, As + s * SA_STAGE, Bs + s * SB_STAGE);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<SK_STAGES - 2>();   // slab s has landed
    __syncthreads();                  // and slab s - 1 is consumed
    const int nxt = s + SK_STAGES - 1;
    if (nxt < steps)
      load_skinny(p, nxt, nk, e0, g0, As + (nxt % SK_STAGES) * SA_STAGE,
                  Bs + (nxt % SK_STAGES) * SB_STAGE);
    cp_async_commit();
    const __nv_bfloat16* a = As + (s % SK_STAGES) * SA_STAGE;
    const __nv_bfloat16* b = Bs + (s % SK_STAGES) * SB_STAGE;
    const int which = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < SK; kk += 16) {
      uint32_t af[4], b0, b1;
      ldmatrix_x4(af, &a[((which & 1) * 8 + r8) * SA_LD + kk
                         + (which >> 1) * 8]);
      ldmatrix_x2_trans(b0, b1, &b[(kk + (which & 1) * 8 + r8) * SB_LD
                                   + warp * 8]);
      mma_bf16(acc, af, b0, b1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = e0 + group + (r >> 1) * 8, g = gcol + (r & 1);
    if (e < p.E && g < p.G) store_c(p, (size_t)e * p.G + g, acc[r]);
  }
}

// ---------------------------------------------------------------- fp32
constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(NT) tesseract_mm_f32_kernel(MmArgs p) {
  __shared__ float As[FBK][FBM + 4];   // transposed: As[f][e]
  __shared__ float Bs[FBK][FBN];
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int e0 = blockIdx.y * FBM, g0 = blockIdx.x * FBN;

  // thread (tr, tc) owns rows tr + 16 i and columns tc + 16 j of the tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tr + 16 * i, g = g0 + tc + 16 * j;
      acc[i][j] = (p.accumulate && e < p.E && g < p.G)
                      ? load_c(p, (size_t)e * p.G + g)
                      : 0.f;
    }

  for (int t = 0; t < p.T; ++t) {
    for (int f0 = 0; f0 < p.F; f0 += FBK) {
#pragma unroll
      for (int l = 0; l < FBM * FBK / NT; ++l) {
        const int i = tid + l * NT;
        const int r = i / FBK, c = i % FBK;
        As[c][r] = (e0 + r < p.E && f0 + c < p.F)
                       ? A[((size_t)t * p.E + e0 + r) * p.F + f0 + c]
                       : 0.f;
      }
#pragma unroll
      for (int l = 0; l < FBK * FBN / NT; ++l) {
        const int i = tid + l * NT;
        const int r = i / FBN, c = i % FBN;
        Bs[r][c] = (f0 + r < p.F && g0 + c < p.G)
                       ? B[((size_t)t * p.F + f0 + r) * p.G + g0 + c]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FBK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][tr + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tr + 16 * i, g = g0 + tc + 16 * j;
      if (e < p.E && g < p.G) store_c(p, (size_t)e * p.G + g, acc[i][j]);
    }
}

}  // namespace

// C entry of both kernels: accumulate = 0 is tesseract_mm (C = sum_t A_t
// B_t, C fp32 or, c_dtype bf16, rounded once to bf16 in the epilogue),
// accumulate = 1 with T = 1 is tesseract_mm_stream (C += A B, C fp32).
extern "C" int repro_tesseract_mm(const void* a, const void* b, void* c,
                                  int T, int E, int F, int G, int dtype,
                                  int c_dtype, int accumulate, void* stream) {
  if ((c_dtype != repro::kFloat32 && c_dtype != repro::kBFloat16) ||
      (accumulate && c_dtype != repro::kFloat32))
    return static_cast<int>(cudaErrorInvalidValue);
  MmArgs p{a, b, c, T, E, F, G, accumulate, c_dtype == repro::kBFloat16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    const dim3 grid((G + BN - 1) / BN, (E + BM - 1) / BM);
    const bool vec = F % 8 == 0 && G % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    if (vec && E <= SM_) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          tesseract_mm_skinny_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SKINNY_SMEM);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      const dim3 sgrid((G + SN - 1) / SN, 1);
      tesseract_mm_skinny_kernel<<<sgrid, SNT, SKINNY_SMEM, s>>>(p);
    } else if (vec)
      tesseract_mm_bf16_kernel<true><<<grid, NT, 0, s>>>(p);
    else
      tesseract_mm_bf16_kernel<false><<<grid, NT, 0, s>>>(p);
  } else if (dtype == repro::kFloat32) {
    const dim3 grid((G + FBN - 1) / FBN, (E + FBM - 1) / FBM);
    tesseract_mm_f32_kernel<<<grid, NT, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
