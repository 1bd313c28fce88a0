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
// Routes, picked by the entry from dtype, shape and alignment:
//   * bf16, E > 16, F > 0, F and G multiples of 8, a, b and c 16-byte
//     aligned (every prefill and train projection): wgmma fed by TMA
//     (tesseract_mm_wgmma_kernel).  A block of 3 warpgroups owns a 128 x 256
//     tile of C (128 x 128 measured slower on the card at every prefill
//     shape).  Warpgroup 0 is the producer: one thread walks the (t, f)
//     steps and issues TMA loads of A's 128 x 64 box and B's four 64 x 64
//     boxes (3-D tensor maps over a [T, E, F] and b [T, F, G], 128-byte
//     swizzle, zero fill past E, F and G) into a ring of kWgStages shared-
//     memory stages, each guarded by a full and an empty mbarrier.
//     Warpgroups 1 and 2 each own 64 rows of the tile and run
//     wgmma.mma_async m64n256k16 from shared memory: A K-major, B MN-major
//     (G contiguous, read with wgmma's transpose bit, so no copy of the
//     weights is transposed), the fp32 sums in registers; setmaxnreg moves
//     registers from the producer to them.  A stage goes back to the
//     producer once the products of the next stage are issued
//     (wgmma.wait_group 1).  The tensor maps are encoded on the host per
//     launch by cuTensorMapEncodeTiled, resolved through
//     cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
//     It runs at ~60% of the bf16 peak at the one-rank gate/up, beside
//     cuBLAS; at smaller F (smollm's 960, mamba2's 2048) it trails cuBLAS:
//     one block per SM fills its pipeline and writes its tile with nothing
//     overlapping (a persistent schedule and TMA multicast across a
//     cluster are its next steps).
//   * bf16, E <= 16 (decode's few rows): the skinny mma.sync kernel below.
//   * bf16 otherwise (F or G not a multiple of 8, or a base not 16-byte
//     aligned): 128 x 128 tiles on mma.sync, loaded element by element.
//   * fp32: fp32 FMA on the CUDA cores (64 x 64 tiles, a 4 x 4 register
//     tile per thread), so fp32 runs compare like with like with a TF32-off
//     reference.
// Every route zero-fills rows and columns past the edge and masks them on
// store, and keeps the (t outer, f inner) order with one fp32 accumulator
// per element of C: on wgmma, C is loaded into the accumulator fragments
// before the first product (#2), or #1's first product writes them (D = A B,
// the value of 0 + A B), and every later product adds into them, so T
// launches of #2 from a zero C give the values of one launch of #1.
#include <cstdint>

#include <cuda.h>

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

// ------------------------------------------- bf16, element-wise loads
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
// shared memory element by element; out-of-range rows and columns become
// zeros.
__device__ __forceinline__ void load_tiles(
    const MmArgs& p, int t, int f0, int e0, int g0,
    __nv_bfloat16 (*As)[A_LD], __nv_bfloat16 (*Bs)[B_LD]) {
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < BM * BK; i += NT) {
    const int r = i / BK, c = i % BK;
    As[r][c] = (e0 + r < p.E && f0 + c < p.F)
                   ? A[((size_t)t * p.E + e0 + r) * p.F + f0 + c]
                   : zero;
  }
  for (int i = threadIdx.x; i < BK * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    Bs[r][c] = (f0 + r < p.F && g0 + c < p.G)
                   ? B[((size_t)t * p.F + f0 + r) * p.G + g0 + c]
                   : zero;
  }
}

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
  if (steps > 0) load_tiles(p, 0, 0, e0, g0, As[0], Bs[0]);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps)            // stage cur ^ 1 was last read at s - 1
      load_tiles(p, (s + 1) / nk, ((s + 1) % nk) * BK, e0, g0, As[cur ^ 1],
                 Bs[cur ^ 1]);
    __syncthreads();              // stage s is written
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

// ------------------------------------------------------- bf16, wgmma + TMA
// See the header.  Shared memory: kWgStages stages of [A 128 x 64 | B's
// WBN / 64 boxes of 64 x 64], each box 128-byte swizzled by TMA as wgmma's
// 128B layout expects (rows of 128 bytes, 8-row groups of 1024 bytes), so
// the stages start 1024-byte aligned.
constexpr int WBM = 128, WBN = 256, WBK = 64;  // C tile, f per stage
constexpr int WNT = 384;                       // producer + 2 consumer WGs
constexpr int kWgStages = 4;
constexpr uint32_t WA_BYTES = WBM * WBK * 2, WB_BOX = 64 * WBK * 2;
constexpr uint32_t WSTAGE = WA_BYTES + WBN / 64 * WB_BOX;
constexpr size_t WG_SMEM = (size_t)kWgStages * WSTAGE + 1024;  // + alignment

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// box (c0, c1, c2) of a 3-D tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory operand descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.  K-major
// A: stride = 1024 (the next 8 rows), leading unused with this swizzle.
// MN-major B: leading = the next 64 columns (one 64 x 64 box), stride =
// 1024 (the next 8 rows of f).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lead,
                                            uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator register
// across the asynchronous products that own it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A K-major, B MN-major (wgmma's
// transpose bit); scale_d = 0 writes D = A B without reading D
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <bool ACC>
__global__ void __launch_bounds__(WNT, 1)
tesseract_mm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                          const __grid_constant__ CUtensorMap tma_b,
                          MmArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages];
  unsigned char* tiles =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int e0 = blockIdx.x * WBM, g0 = blockIdx.y * WBN;
  const int nk = (p.F + WBK - 1) / WBK;
  const int steps = p.T * nk;   // (t, f) in the TPU grid's order; > 0
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kWgStages;
        // a stage's first use passes at once (the parity of the phase
        // before the barrier's first)
        mbar_wait(&empty[st], ((s / kWgStages) & 1) ^ 1);
        unsigned char* dst = tiles + st * WSTAGE;
        const int t = s / nk, f0 = (s % nk) * WBK;
        mbar_expect_tx(&full[st], WSTAGE);
        tma_load_3d(dst, &tma_a, &full[st], f0, e0, t);
#pragma unroll
        for (int j = 0; j < WBN / 64; ++j)
          tma_load_3d(dst + WA_BYTES + j * WB_BOX, &tma_b, &full[st],
                      g0 + 64 * j, f0, t);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, lane = threadIdx.x & 31;
    // accumulator register 4 j + 2 h + c: row e, column g + c (c = 0, 1)
    const int e = e0 + cw * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const int g = g0 + 2 * (lane & 3);
    // #2 (ACC) loads C into the accumulator; #1's first product writes it
    // (scale_d = 0), so no other instruction defines it and ptxas keeps the
    // products of a stage in flight together
    float acc[WBN / 2];
    if constexpr (ACC) {
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = e + 8 * h, c = g + 8 * j;
          float2 v = make_float2(0.f, 0.f);
          if (r < p.E && c < p.G)
            v = *reinterpret_cast<const float2*>(
                static_cast<const float*>(p.c) + (size_t)r * p.G + c);
          acc[4 * j + 2 * h] = v.x;
          acc[4 * j + 2 * h + 1] = v.y;
        }
#pragma unroll
      for (int i = 0; i < WBN / 2; ++i) fence_operand(acc[i]);
    }

    for (int s = 0; s < steps; ++s) {
      const int st = s % kWgStages;
      mbar_wait(&full[st], (s / kWgStages) & 1);
      const uint32_t a_s = smem_u32(tiles + st * WSTAGE) + cw * 64 * 128;
      const uint32_t b_s = smem_u32(tiles + st * WSTAGE) + WA_BYTES;
      wgmma_fence();
      // k step kk: 32 bytes further along A's rows, 16 rows further down
      // B's boxes
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
        wgmma_m64n256(acc, wg_desc(a_s + kk * 32, 16, 1024),
                      wg_desc(b_s + kk * 16 * 128, WB_BOX, 1024),
                      ACC || s > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the products of step s - 1 have read their stage
      if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % kWgStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < WBN / 2; ++i) fence_operand(acc[i]);

#pragma unroll
    for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = e + 8 * h, c = g + 8 * j;
        if (r >= p.E || c >= p.G) continue;  // G is even: c + 1 < G too
        const size_t i = (size_t)r * p.G + c;
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (p.c_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.c) + i) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.c) + i) =
              make_float2(x, y);
      }
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
// register accumulator are those of the kernels above.
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

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled resolved = nullptr;
  static const cudaError_t err = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && (q != cudaDriverEntryPointSuccess || !f))
      e = cudaErrorSymbolNotFound;
    resolved = reinterpret_cast<EncodeTiled>(f);
    return e;
  }();
  *fn = resolved;
  return err;
}

// a bf16 [T, rows, inner] tensor, inner contiguous, in boxes of
// 64 x box_rows x 1, 128-byte swizzled, zero-filled past every edge
CUresult encode_3d(EncodeTiled fn, CUtensorMap* map, const void* base,
                   int T, int rows, int inner, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool ACC>
cudaError_t wgmma_smem_attr() {
  static const cudaError_t err = cudaFuncSetAttribute(
      tesseract_mm_wgmma_kernel<ACC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  return err;
}

// the wgmma route; a failed resolve or encode returns its code (the
// driver's CUresult for an encode), which the wrapper raises on
int launch_wgmma(const MmArgs& p, cudaStream_t s) {
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb;
  CUresult rc = encode_3d(fn, &ta, p.a, p.T, p.E, p.F, WBM);
  if (rc == CUDA_SUCCESS) rc = encode_3d(fn, &tb, p.b, p.T, p.F, p.G, WBK);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
  err = p.accumulate ? wgmma_smem_attr<true>() : wgmma_smem_attr<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.E + WBM - 1) / WBM, (p.G + WBN - 1) / WBN);
  if (p.accumulate)
    tesseract_mm_wgmma_kernel<true><<<grid, WNT, WG_SMEM, s>>>(ta, tb, p);
  else
    tesseract_mm_wgmma_kernel<false><<<grid, WNT, WG_SMEM, s>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
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
    } else if (vec && F > 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0) {
      return launch_wgmma(p, s);
    } else {
      const dim3 grid((G + BN - 1) / BN, (E + BM - 1) / BM);
      tesseract_mm_bf16_kernel<<<grid, NT, 0, s>>>(p);
    }
  } else if (dtype == repro::kFloat32) {
    const dim3 grid((G + FBN - 1) / FBN, (E + FBM - 1) / FBM);
    tesseract_mm_f32_kernel<<<grid, NT, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
