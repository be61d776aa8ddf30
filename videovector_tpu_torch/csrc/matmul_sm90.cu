// K1 on Hopper's own units: a TMA + wgmma GEMM with split-K, bias + ReLU or
// bias + GELU epilogue (sm_90a).
//
// Replaces videovector_tpu/ops/pallas/matmul.py `matmul` (:50, kernel body
// `_matmul_kernel` :26) for bf16 operands that TMA can address: x (M, K)
// K-contiguous and w (K, N) N-contiguous, row strides a multiple of 16 bytes,
// 16-byte aligned. out = round(act(x.w + b)) with an f32 sum and one rounding
// at the end, as the Pallas kernel computes it. f32 operands that TMA can
// address take matmul_f32_sm90.cu; every other K1 call (other strides)
// stays on the core of gemm_core.cuh (matmul.cu). The wrapper
// ops/hopper/matmul.py picks the route from the operands.
//
// What bounds it on the H100. At the serving path's M = 50 each weight is
// used by 50 rows only, so the GEMM streams w: fc6's 75.5 MB of bf16 take
// 22.5 us at 3.35 TB/s, fc7's or the tower's 33.6 MB 10 us, and the tensor
// cores are nearly idle. At M = 256, fc6 is 19.3 GFLOP over 75.5 MB, about
// 256 FLOP/byte, just under the card's ridge of about 295: both bounds are
// near, 19.5 us of bf16 tensor-core time against 22.5 us of HBM time.
//
// What the design does about it:
// - Bytes in flight. One producer warp keeps a ring of STAGES tiles loading
//   through TMA (full/empty mbarriers), so each block has 64 KB of weights
//   in flight, where Little's law at HBM latency needs some tens of KB per
//   SM. TMA zero-fills everything outside the tensors, so M = 50 is one
//   64-row tile with no padding copy and a ragged K or N needs no masks in
//   the loads; the epilogue masks its stores.
// - Filling the card at small M. fc6 at M = 50 has only 32 output tiles of
//   64x128. The host splits K (K1's plan, ops/hopper/matmul.py) so that
//   tiles x splits come as close to one block per SM as whole splits allow
//   (4 splits at M = 50, 2 at M = 256): on the H100 more blocks streamed no
//   faster, and each split adds M x N f32 partial sums to the traffic. Each
//   split writes its partial sums to a workspace, and `splitk_reduce`
//   (sm90.cuh) sums them in a fixed order, adds the bias, applies ReLU and
//   rounds once. No atomics: two runs give the same bits. With one split
//   (the output tiles already fill the card, e.g. M = 1920) the epilogue
//   runs in the GEMM kernel.
// - Tensor cores. Consumer warpgroups (one for BM = 64, two for BM = 128)
//   issue wgmma m64n128k16 with both operands in shared memory, A K-major and
//   B (w's N-contiguous rows) MN-major through the transpose bit, both in
//   the 128-byte swizzle that TMA writes. Sums stay in registers.
// - GELU (TimeSformer's fc1, 18,816 x 768 x 3,072 a clip: 3,528 output
//   tiles, one split). Exact erf on the f32 sum plus bias, then the one
//   rounding, in twins of the kernels (`gemm_tma_wgmma_gelu`,
//   `splitk_reduce_gelu`), so that the ReLU and no-activation kernels are
//   the same code as without it. Without it fc1 would write its 115.6 MB
//   and aten would read them back for the activation.
#include <cstdint>

#include "gemm_core.cuh"
#include "sm90.cuh"

namespace vv {
namespace sm90 {

constexpr int BN = 128;                 // output columns per block
constexpr int B_BYTES = BK * BN * 2;    // one stage of w: 16 KB

// NC consumer warpgroups of 64 rows each, then one producer warp.
template <int NC>
struct Tile {
  static constexpr int BM = 64 * NC;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = 4;  // 64 KB of w in flight
  static constexpr int THREADS = 128 * NC + 32;
  // ring, full and empty barriers, slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// Block (m-tile, n-tile, split): sums x[m0:m0+BM, ks] . w[ks, n0:n0+BN] over
// the split's K tiles [split * k_tiles / splits, (split + 1) * k_tiles /
// splits). PARTIAL: writes the f32 sums to ws[split]; otherwise applies K1's
// epilogue EPI (gemm_core.cuh: kEpiK1, bias + ReLU or none, in
// gemm_tma_wgmma; kEpiK1Gelu in gemm_tma_wgmma_gelu) and writes out.
template <int NC, typename TO, bool PARTIAL, int EPI>
__device__ __forceinline__ void gemm_body(const CUtensorMap* tx, const CUtensorMap* tw,
                                          const float* __restrict__ bias,
                                          TO* __restrict__ out, float* __restrict__ ws,
                                          int M, int N, int k_tiles, int splits,
                                          long long som, long long son, int relu) {
  using T = Tile<NC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms need 1024 B
  const uint32_t full = ring + T::STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + T::STAGES * 8;

  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int t_begin = static_cast<int>(static_cast<long long>(split) * k_tiles / splits);
  const int nt =
      static_cast<int>(static_cast<long long>(split + 1) * k_tiles / splits) - t_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, NC);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {  // producer warp: one thread issues every load
    if (threadIdx.x == 128 * NC) {
      for (int t = 0; t < nt; ++t) {
        const int s = t % T::STAGES;
        const uint32_t a_dst = ring + s * T::STAGE_BYTES;
        const uint32_t b_dst = a_dst + T::A_BYTES;
        mbar_wait(empty + 8 * s, ((t / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, T::STAGE_BYTES);
        const int k0 = (t_begin + t) * BK;
        tma_load(a_dst, tx, full + 8 * s, k0, m0);
        tma_load(b_dst, tw, full + 8 * s, n0, k0);
        tma_load(b_dst + BOX_BYTES, tw, full + 8 * s, n0 + BOX_N, k0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int t = 0; t < nt; ++t) {
    const int s = t % T::STAGES;
    const uint32_t a_tile = ring + s * T::STAGE_BYTES + wg * 64 * SW_ROW;
    const uint32_t b_tile = ring + s * T::STAGE_BYTES + T::A_BYTES;
    mbar_wait(full + 8 * s, (t / T::STAGES) & 1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 k = 32 bytes along a swizzled row; rows in 8-row atoms.
      // B: 16 k = 16 rows of 128 bytes; n 64..127 in the second box.
      wgmma<BN>(d, sw128_desc(a_tile + kk * 32, 16, SW_ATOM),
                sw128_desc(b_tile + kk * 16 * SW_ROW, BOX_BYTES, SW_ATOM));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
  }

  // the wgmma accumulator layout (sm90.cuh)
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = col0 + 8 * j + c;
        if (n >= N) continue;
        const float v = d[4 * j + 2 * h + c];
        if constexpr (PARTIAL)
          ws[(static_cast<long long>(split) * M + m) * N + n] = v;
        else
          out[m * som + n * son] = epilogue<EPI, TO>(v, bias, n, relu);
      }
    }
  }
}

template <int NC, typename TO, bool PARTIAL>
__global__ void __launch_bounds__(Tile<NC>::THREADS)
    gemm_tma_wgmma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ bias, TO* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int k_tiles,
                   int splits, long long som, long long son, int relu) {
  gemm_body<NC, TO, PARTIAL, kEpiK1>(&tx, &tw, bias, out, ws, M, N, k_tiles, splits,
                                     som, son, relu);
}

// K1 with the GELU epilogue (the partial sums of a split product take
// gemm_tma_wgmma<..., true> and splitk_reduce_gelu)
template <int NC, typename TO>
__global__ void __launch_bounds__(Tile<NC>::THREADS)
    gemm_tma_wgmma_gelu(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const float* __restrict__ bias, TO* __restrict__ out,
                        float* __restrict__ ws, int M, int N, int k_tiles,
                        int splits, long long som, long long son, int relu) {
  gemm_body<NC, TO, false, kEpiK1Gelu>(&tx, &tw, bias, out, ws, M, N, k_tiles,
                                       splits, som, son, relu);
}

template <int NC, typename TO, bool PARTIAL, bool GELU = false>
int launch_gemm(const CUtensorMap& tx, const CUtensorMap& tw, const float* bias,
                TO* out, float* ws, int M, int N, int k_tiles, int splits,
                long long som, long long son, int relu, cudaStream_t s) {
  using T = Tile<NC>;
  auto kernel = gemm_tma_wgmma<NC, TO, PARTIAL>;
  if constexpr (GELU) kernel = gemm_tma_wgmma_gelu<NC, TO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + T::BM - 1) / T::BM, (N + BN - 1) / BN, splits);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(tx, tw, bias, out, ws, M, N, k_tiles,
                                           splits, som, son, relu);
  return static_cast<int>(cudaGetLastError());
}

// act: 0 none, 1 ReLU (kEpiK1, whose kernels read it as their relu flag),
// 2 GELU (kEpiK1Gelu)
template <int NC, typename TO>
int run(const void* x, const void* w, const float* bias, TO* out, float* ws,
        int M, int N, int K, long long sxm, long long swk, int splits,
        long long som, long long son, int act, int sms, cudaStream_t s) {
  CUtensorMap tx, tw;
  int rc = encode(&tx, x, M, K, sxm, Tile<NC>::BM, BK);
  if (rc == 0) rc = encode(&tw, w, K, N, swk, BK, BOX_N);
  if (rc != 0) return rc;
  const int k_tiles = (K + BK - 1) / BK;
  const bool gelu = act == 2;
  if (splits == 1)
    return gelu ? launch_gemm<NC, TO, false, true>(tx, tw, bias, out, nullptr, M, N,
                                                   k_tiles, 1, som, son, 0, s)
                : launch_gemm<NC, TO, false>(tx, tw, bias, out, nullptr, M, N,
                                             k_tiles, 1, som, son, act, s);
  rc = launch_gemm<NC, TO, true>(tx, tw, bias, out, ws, M, N, k_tiles, splits,
                                 som, son, act, s);
  if (rc != 0) return rc;
  return gelu ? launch_splitk_reduce<TO, kEpiK1Gelu>(ws, bias, out, M, N, splits, som,
                                                     son, 0, sms, s)
              : launch_splitk_reduce<TO>(ws, bias, out, M, N, splits, som, son, act,
                                         sms, s);
}

}  // namespace sm90
}  // namespace vv

// x (M, K) and w (K, N) bf16 with unit inner stride; out (M, N) f32 or bf16;
// ws: f32 (splits, M, N) when splits > 1. block_m 64 or 128 and splits come
// from the wrapper's plan; act 0 (no activation), 1 (ReLU) or 2 (exact-erf
// GELU). Returns a CUDA error code as an int.
extern "C" int vv_matmul_sm90(const void* x, const void* w, const void* bias,
                              void* out, void* ws, int M, int N, int K,
                              long long sxm, long long swk, long long som,
                              long long son, int block_m, int splits,
                              int dtype_out, int act, int device, void* stream) {
  using namespace vv::sm90;
  const int k_tiles = (K + BK - 1) / BK;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 && sxm % 8 == 0 &&
                       swk % 8 == 0;
  if (M <= 0 || N <= 0 || K <= 0 || !aligned || (block_m != 64 && block_m != 128) ||
      splits < 1 || splits > k_tiles || (splits > 1 && ws == nullptr) ||
      act < 0 || act > 2 ||
      (dtype_out != vv::kF32 && dtype_out != vv::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  if (dtype_out == vv::kBF16) {
    vv::bf16* o = static_cast<vv::bf16*>(out);
    return block_m == 64
               ? run<1>(x, w, b, o, wsf, M, N, K, sxm, swk, splits, som, son, act, sms, s)
               : run<2>(x, w, b, o, wsf, M, N, K, sxm, swk, splits, som, son, act, sms, s);
  }
  float* o = static_cast<float*>(out);
  return block_m == 64
             ? run<1>(x, w, b, o, wsf, M, N, K, sxm, swk, splits, som, son, act, sms, s)
             : run<2>(x, w, b, o, wsf, M, N, K, sxm, swk, splits, som, son, act, sms, s);
}
