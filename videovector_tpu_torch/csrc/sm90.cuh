// Hopper building blocks shared by the sm_90a kernels (K1's matmul_sm90.cu
// and matmul_f32_sm90.cu, K2's conv_gemm_sm90.cu): mbarriers, TMA loads and
// tensor maps, wgmma with both operands in 128-byte-swizzled shared memory,
// and K1's deterministic split-K reduction.
//
// Operand layouts, as TMA's 128-byte swizzle writes them (and as K2's
// cp.async gathers write A by hand):
// - A (rows x 64 k, K-major): row r is 128 bytes at r * 128; its 16-byte
//   chunk q sits at chunk q ^ (r % 8). Eight rows form one 1 KB atom, so a
//   tile must start on a 1024-byte boundary.
// - B (64 k x N, MN-major): one box per 64 columns, each 64 rows of 128
//   bytes in the same swizzle, boxes 8 KB apart; wgmma reads it with the
//   transpose bit set.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "gemm_core.cuh"

namespace vv {
namespace sm90 {

constexpr int BK = 64;                  // one 128-byte swizzle row of bf16
constexpr int BOX_N = 64;               // B columns per TMA box (128 bytes)
constexpr int SW_ROW = 128;             // bytes per swizzled row
constexpr int SW_ATOM = 8 * SW_ROW;     // 8 rows: one swizzle pattern
constexpr int BOX_BYTES = BK * SW_ROW;  // one B box: 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 innermost, c1) of `map` into shared memory at dst,
// completing `bytes` of the transaction on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) . B (16 x N, MN-major: transpose bit set), with
// the wgmma accumulator layout: warp w of the group holds rows 16w..16w+15,
// and d[4j + 2h + c] is row lane/4 + 8h, column 8j + 2(lane%4) + c.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

#define VV_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VV_F16(i) VV_F4(i), VV_F4(i + 4), VV_F4(i + 8), VV_F4(i + 12)
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : VV_F16(0), VV_F16(16)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 1;\n"
      "}\n"
      : VV_F16(0), VV_F16(16), VV_F16(32)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : VV_F16(0), VV_F16(16), VV_F16(32), VV_F16(48)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : VV_F16(0), VV_F16(16), VV_F16(32), VV_F16(48), VV_F16(64), VV_F16(80)
      : "l"(da), "l"(db), "r"(1));
}
#undef VV_F16
#undef VV_F4

// cuTensorMapEncodeTiled's signature (CUDA 12.0 driver API), fetched through
// the runtime so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major matrix (rows x cols, row stride in elements) of `type`, whose
// elements are elem_bytes wide, as a TMA map of (box_cols x box_rows) boxes,
// 128-byte swizzle, zero fill outside.
inline int encode(CUtensorMap* map, const void* ptr, int rows, int cols,
                  long long row_stride, int box_rows, int box_cols,
                  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  int elem_bytes = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_stride) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return static_cast<int>(
      fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// out = K1 epilogue (EPI: kEpiK1, or kEpiK1Gelu in splitk_reduce_gelu) of the
// sum over splits of ws (splits, M, N), taken in split order: no atomics, so
// two runs give the same bits.
template <int EPI, typename TO>
__device__ __forceinline__ void splitk_reduce_body(const float* __restrict__ ws,
                                                   const float* __restrict__ bias,
                                                   TO* __restrict__ out, int M, int N,
                                                   int splits, long long som,
                                                   long long son, int relu) {
  const long long total = static_cast<long long>(M) * N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * total + i];
    const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
    out[m * som + n * son] = epilogue<EPI, TO>(acc, bias, n, relu);
  }
}

template <typename TO>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              const float* __restrict__ bias,
                              TO* __restrict__ out, int M, int N, int splits,
                              long long som, long long son, int relu) {
  splitk_reduce_body<kEpiK1, TO>(ws, bias, out, M, N, splits, som, son, relu);
}

template <typename TO>
__global__ void splitk_reduce_gelu(const float* __restrict__ ws,
                                   const float* __restrict__ bias,
                                   TO* __restrict__ out, int M, int N, int splits,
                                   long long som, long long son) {
  splitk_reduce_body<kEpiK1Gelu, TO>(ws, bias, out, M, N, splits, som, son, 0);
}

// Launches splitk_reduce (splitk_reduce_gelu for EPI kEpiK1Gelu) on stream s;
// returns cudaGetLastError() as an int.
template <typename TO, int EPI = kEpiK1>
int launch_splitk_reduce(const float* ws, const float* bias, TO* out, int M,
                         int N, int splits, long long som, long long son,
                         int relu, int sms, cudaStream_t s) {
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(std::min((total + 255) / 256, 8LL * sms));
  if constexpr (EPI == kEpiK1Gelu)
    splitk_reduce_gelu<TO><<<blocks, 256, 0, s>>>(ws, bias, out, M, N, splits, som,
                                                  son);
  else
    splitk_reduce<TO><<<blocks, 256, 0, s>>>(ws, bias, out, M, N, splits, som, son,
                                             relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace vv
