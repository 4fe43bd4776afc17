// Hopper (sm_90a) building blocks shared by the tensor-core attention
// kernels: mbarriers, TMA tile loads, wgmma descriptors and the
// m64nNk16 bf16 wgmma instructions, and the host-side tensor-map encoder.
//
// Shared-memory tiles. A tile of R rows x D bf16 columns is stored as
// D / CW column chunks of CW = min(D, 64) elements, chunk after chunk;
// inside a chunk the rows are ROWB = 2 * CW bytes wide (128 or 64) and
// swizzled the way TMA's 128- or 64-byte swizzle writes them, so 8 rows
// form one swizzle atom of 8 * ROWB bytes. Every tile starts on a
// 1024-byte boundary. Such a tile serves wgmma both ways:
//   * K-major (the reduction runs along the row): Q, dO, and K or V as
//     the B operand of Q.K^T and dO.V^T. A 16-column k-step starts
//     32 bytes further along the row; 8-row groups are ATOM bytes apart
//     (the descriptor's stride byte offset).
//   * MN-major (the reduction runs down the rows): V in P.V and K in
//     dS.K (wgmma's transposed B, allowed for 16-bit types). A 16-row
//     k-step starts 16 * ROWB bytes further down; 8-row groups are ATOM
//     bytes apart (stride byte offset) and column chunks R * ROWB bytes
//     apart (leading byte offset).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace sm90 {

template <int D>
struct Tile {
  static constexpr int CW = D < 64 ? D : 64;  // columns per chunk
  static constexpr int NCH = D / CW;          // chunks
  static constexpr int ROWB = 2 * CW;         // bytes per row in a chunk
  static constexpr int ATOM = 8 * ROWB;       // bytes per 8-row group
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : 2;  // desc code
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------- TMA

// One box of a 4-D tensor map (dims D, H, S, B, innermost first) into
// shared memory; completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + R) of head h, batch b into the chunked tile at dst
// (rows past the tensor's end arrive as zeros).
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int h,
                                         int b) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
    tma_load_4d(dst + c * R * T::ROWB, map, bar, c * T::CW, h, row0, b);
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swz << 62);
}

// K-major operand: the rows of an R-row tile (R = 64 for A, N for B),
// k-step kk (columns 16 kk .. 16 kk + 15).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using T = Tile<D>;
  const int col = 16 * kk;
  const uint32_t addr = tile + (col / T::CW) * R * T::ROWB + (col % T::CW) * 2;
  return make_desc(addr, 16, T::ATOM, T::SWIZZLE);
}

// MN-major (transposed) B operand: rows 16 kk .. 16 kk + 15 of an R-row
// tile are the reduction, all D columns the N dimension.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using T = Tile<D>;
  return make_desc(tile + 16 * kk * T::ROWB, R * T::ROWB, T::ATOM,
                   T::SWIZZLE);
}

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, subnormals flushed, 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N] in f32, A and B bf16. Accumulator
// layout (thread t of the warpgroup, warp w = t / 32, lane l): d[4i + e]
// holds row 16 w + l / 4 + 8 (e / 2), column 8 i + 2 (l % 4) + e % 2.
// ss: A and B from shared memory; rs: A from registers as the m64k16
// fragment {(r, c..c+1), (r + 8, c..c+1), (r, c + 8..), (r + 8, c + 8..)}
// with r = 16 w + l / 4, c = 2 (l % 4), which is the accumulator's layout
// for columns 16 j .. 16 j + 15 packed to bf16 pairs. TRANS_B = 1 reads B
// MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<64> {
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TRANS_B));
  }
};

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that the library needs no link against libcuda.
inline EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// Errors of the encoder are returned as ENCODE_ERROR + CUresult, beside
// the runtime's cudaError_t values.
constexpr int ENCODE_ERROR = 100000;

// A bf16 [B, S, H, D] view with element strides (sb, ss, sh, 1) as a 4-D
// tensor map whose box is R rows of one head, CW columns wide, swizzled
// to the tile layout above.
template <int D>
int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H,
                long long sb, long long ss, long long sh, int R) {
  using T = Tile<D>;
  EncodeTiledFn fn = encode_fn();
  if (!fn) return ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::CW, 1, (cuuint32_t)R, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

inline const char* error_string(int err) {
  static thread_local char buf[96];
  if (err >= ENCODE_ERROR) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - ENCODE_ERROR);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace sm90
