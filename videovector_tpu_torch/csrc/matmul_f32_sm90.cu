// K1 for f32 operands on Hopper: a TMA-fed FFMA GEMM with split-K and the
// bias + ReLU epilogue (sm_90a).
//
// Replaces videovector_tpu/ops/pallas/matmul.py `matmul` (:50, kernel body
// `_matmul_kernel` :26) for f32 operands that TMA can address: x (M, K)
// K-contiguous and w (K, N) N-contiguous, row strides a multiple of 16 bytes,
// 16-byte aligned. This is the route of every INNER_PRODUCT of the port's
// f32 Net. out = round(act(x.w + b)): an f32 sum of exact f32 products (FFMA,
// no TF32), bias and ReLU in f32 on the finished sum, one rounding to the
// output type, as gemm_core.cuh's `epilogue<kEpiK1>` computes it. Within a
// split the products are summed in ascending k with fmaf, as the core does,
// so with one split the result equals the core's bit for bit.
//
// What bounds it on the H100: operations. At the Net's TRAIN shape, (1920 x
// 4096) . (4096 x 4096), 2 M N K = 64.4 GFLOP take 0.96 ms at the 67 TFLOP/s
// FFMA peak, while its 130 MB of operands and output take 0.04 ms at 3.35
// TB/s; at the TEST shape (673 rows) 0.34 ms against 0.02 ms. Each SM must
// issue one FFMA per lane per clock, so everything else a thread issues
// (shared-memory loads, address arithmetic, barrier waits) is taken from
// that budget.
//
// What the design does about it:
// - Loads cost no instructions. One producer warp keeps a ring of STAGES
//   stages in flight through TMA (full/empty mbarriers); each stage is a
//   128 x 32 tile of x and a 32 x 128 tile of w, 32 KB. TMA zero-fills
//   ragged M, N and K, so the loads need no masks, and 32 f32 are one
//   128-byte swizzle row, the widest box TMA swizzles: x's box is 128 rows of
//   32 k, w's four boxes are 32 k rows of 32 columns each.
// - Few shared-memory loads per FFMA. Each of the 256 consumer threads holds
//   an 8 x 8 tile of sums: rows r0 + 4i (i < 8), columns c0 + j and c0 + 32 +
//   j (j < 4). For every 4 k it reads its 8 rows of x along k and 4 rows of
//   its 8 columns of w as float4: 16 LDS.128 feed 256 FFMA (the core's first
//   version: 64 LDS.32).
// - No bank conflicts. TMA's 128-byte swizzle stores 16-byte chunk q of
//   smem row r at chunk q ^ (r % 8). The 8 lanes of a quarter warp read x
//   from one row (a broadcast; the 4 quarters' rows differ mod 8, so the
//   whole warp touches distinct banks) and w from 8 chunks of one 128-byte
//   row: no two lanes of the warp read different words of one bank.
// - A full card. 128 x 128 tiles at 168 registers a thread and 129 KB of
//   shared memory a block run one block per SM, so the time is about the
//   waves of SMs blocks times the K tiles a block walks, and a partly empty
//   last wave is lost. The host plans K splits (`k1_f32_plan`,
//   ops/hopper/matmul.py): the fewest splits s whose T s blocks (T output
//   tiles) fill their waves to 95% or more; one split per BK tile of K when
//   none does. 1920 rows: 480 tiles fill 4 waves of 132 to 91%; 3 splits
//   make 1440 blocks of a third of K in 11 waves, 99% full. 673 rows: 192
//   tiles fill 2 waves to 73%; 2 splits make 384 blocks of half the K in 3
//   waves, 97% full. Each split writes its partial sums to a workspace,
//   and splitk_reduce (sm90.cuh) sums them in split order, adds the bias,
//   applies ReLU and rounds once: no atomics, two runs give the same bits.
#include <cstdint>

#include "gemm_core.cuh"
#include "sm90.cuh"

namespace vv {
namespace f32sm90 {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load;

constexpr int BM = 128;                   // output rows per block
constexpr int BN = 128;                   // output columns per block
constexpr int BK = 32;                    // k per stage: one 128-byte row of f32
constexpr int ROW = BK * 4;               // bytes per swizzled smem row
constexpr int BOX_N = 32;                 // w columns per TMA box (128 bytes)
constexpr int BOX_BYTES = BK * ROW;       // one w box: 32 k rows, 4 KB
constexpr int A_BYTES = BM * ROW;         // x's tile: 16 KB
constexpr int STAGE_BYTES = A_BYTES + (BN / BOX_N) * BOX_BYTES;  // 32 KB
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;            // 8 warps: 4 (rows) x 2 (columns)
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
// ring, full and empty barriers, slack to align the ring to 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// Block (m-tile, n-tile, split): sums x[m0:m0+BM, ks] . w[ks, n0:n0+BN] over
// the split's K tiles [split * k_tiles / splits, (split + 1) * k_tiles /
// splits). PARTIAL: writes the f32 sums to ws[split]; otherwise applies K1's
// epilogue and writes out.
template <typename TO, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_f32(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const float* __restrict__ bias, TO* __restrict__ out,
             float* __restrict__ ws, int M, int N, int k_tiles, int splits,
             long long som, long long son, int relu) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms need 1024 B
  const uint8_t* ring_p = smem_raw + (ring - raw);
  const uint32_t full = ring + STAGES * STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int t_begin = static_cast<int>(static_cast<long long>(split) * k_tiles / splits);
  const int nt =
      static_cast<int>(static_cast<long long>(split + 1) * k_tiles / splits) - t_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS) {
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        const uint32_t a_dst = ring + s * STAGE_BYTES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const int k0 = (t_begin + t) * BK;
        tma_load(a_dst, &tx, full + 8 * s, k0, m0);
#pragma unroll
        for (int j = 0; j < BN / BOX_N; ++j)
          tma_load(a_dst + A_BYTES + j * BOX_BYTES, &tw, full + 8 * s,
                   n0 + j * BOX_N, k0);
      }
    }
    return;
  }

  // consumer thread: warp (wm, wn) of a 4 x 2 grid of 32 x 64 warp tiles;
  // lane (ly, lx) owns rows wm*32 + ly + 4i and columns wn*64 + 4lx + j and
  // wn*64 + 32 + 4lx + j (the second in the next w box)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int ly = lane / 8, lx = lane % 8;
  // byte offsets in a stage: row wm*32 + ly of x (rows 4i further at 4i *
  // ROW); box 2 wn of w, whose row k keeps lx's chunk at lx ^ (k % 8)
  const int a_off = (wm * 32 + ly) * ROW;
  const int b_off = A_BYTES + 2 * wn * BOX_BYTES;
  int b_chunk[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) b_chunk[q] = b_off + ((lx ^ q) << 4);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    const uint8_t* st = ring_p + s * STAGE_BYTES;
#pragma unroll
    for (int g = 0; g < BK / 4; ++g) {
      // x rows r = wm*32 + ly + 4i: r % 8 = ly + 4 (i % 2), so k chunk g of
      // row r sits at chunk g ^ (ly + 4 (i % 2))
      const int ca = (g ^ ly) << 4, cb = (g ^ (ly + 4)) << 4;
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(st + a_off + i * 4 * ROW +
                                                (i % 2 ? cb : ca));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * g + kk;
        const uint8_t* brow = st + b_chunk[k % 8] + k * ROW;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BOX_BYTES);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm * 32 + ly + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + wn * 64 + (j / 4) * 32 + 4 * lx + j % 4;
      if (n >= N) continue;
      if constexpr (PARTIAL)
        ws[(static_cast<long long>(split) * M + m) * N + n] = acc[i][j];
      else
        out[m * som + n * son] = epilogue<kEpiK1, TO>(acc[i][j], bias, n, relu);
    }
  }
}

template <typename TO, bool PARTIAL>
int launch_gemm(const CUtensorMap& tx, const CUtensorMap& tw, const float* bias,
                TO* out, float* ws, int M, int N, int k_tiles, int splits,
                long long som, long long son, int relu, cudaStream_t s) {
  auto kernel = gemm_f32<TO, PARTIAL>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, SMEM, s>>>(tx, tw, bias, out, ws, M, N, k_tiles, splits,
                                     som, son, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int run(const void* x, const void* w, const float* bias, TO* out, float* ws,
        int M, int N, int K, long long sxm, long long swk, int splits,
        long long som, long long son, int relu, int sms, cudaStream_t s) {
  CUtensorMap tx, tw;
  int rc = sm90::encode(&tx, x, M, K, sxm, BM, BK, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
  if (rc == 0)
    rc = sm90::encode(&tw, w, K, N, swk, BK, BOX_N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
  if (rc != 0) return rc;
  const int k_tiles = (K + BK - 1) / BK;
  if (splits == 1)
    return launch_gemm<TO, false>(tx, tw, bias, out, nullptr, M, N, k_tiles, 1, som,
                                  son, relu, s);
  rc = launch_gemm<TO, true>(tx, tw, bias, out, ws, M, N, k_tiles, splits, som, son,
                             relu, s);
  if (rc != 0) return rc;
  return sm90::launch_splitk_reduce<TO>(ws, bias, out, M, N, splits, som, son, relu,
                                        sms, s);
}

}  // namespace f32sm90
}  // namespace vv

// x (M, K) and w (K, N) f32 with unit inner stride, row strides a multiple
// of 4 elements, 16-byte aligned; out (M, N) f32 or bf16; ws: f32 (splits,
// M, N) when splits > 1. splits comes from the wrapper's plan. Returns a
// CUDA error code as an int.
extern "C" int vv_matmul_f32_sm90(const void* x, const void* w, const void* bias,
                                  void* out, void* ws, int M, int N, int K,
                                  long long sxm, long long swk, long long som,
                                  long long son, int splits, int dtype_out,
                                  int relu, int device, void* stream) {
  using namespace vv::f32sm90;
  const int k_tiles = (K + BK - 1) / BK;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 && sxm % 4 == 0 &&
                       swk % 4 == 0 && sxm >= K && swk >= N;
  if (M <= 0 || N <= 0 || K <= 0 || !aligned || (N + BN - 1) / BN > 65535 ||
      splits < 1 || splits > k_tiles || splits > 65535 ||
      (splits > 1 && ws == nullptr) ||
      (dtype_out != vv::kF32 && dtype_out != vv::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  if (dtype_out == vv::kBF16)
    return run(x, w, b, static_cast<vv::bf16*>(out), wsf, M, N, K, sxm, swk, splits,
               som, son, relu, sms, s);
  return run(x, w, b, static_cast<float*>(out), wsf, M, N, K, sxm, swk, splits, som,
             son, relu, sms, s);
}
