// K2's sm90 kernel: the implicit-GEMM convolution with cp.async im2col
// gathers, TMA weights and wgmma (sm_90a), shared by conv_gemm_sm90.cu (2D
// convs over NHWC, DEEP = false) and conv3d_gemm_sm90.cu (3D convs over
// NDHWC, DEEP = true). The sources' notes say what each computes and what
// bounds it; DEEP only adds a depth axis to the gathers' addresses and
// masks, so the 2D instantiation compiles to the same code as before it.
#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>

#include "gemm_core.cuh"
#include "sm90.cuh"

namespace vv {
namespace conv90 {

using namespace vv::sm90;

constexpr int PRODUCERS = 128;  // one warpgroup gathers A; its thread 0 loads B

template <int NC, int BN>
struct Tile {
  static constexpr int BM = 64 * NC;
  static constexpr int A_BYTES = BM * SW_ROW;  // BM rows of 64 k
  static constexpr int B_BOXES = (BN + BOX_N - 1) / BOX_N;
  static constexpr int B_BYTES = B_BOXES * BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // Two blocks share an SM where their registers allow it (one consumer
  // warpgroup, or two with BN <= 96: 58-122 registers a thread); their
  // rings then take at most half the SM's shared memory. Otherwise one
  // block a SM, with a ring of 4 stages.
  static constexpr bool TWO_PER_SM = NC == 1 || (NC == 2 && BN <= 96);
  static constexpr int STAGES =
      TWO_PER_SM && 4 * STAGE_BYTES > 113 * 1024 ? 113 * 1024 / STAGE_BYTES : 4;
  static constexpr int THREADS = 128 * NC + PRODUCERS;
  // each producer thread copies chunk (thread % 8) of ROWS rows per stage
  static constexpr int ROWS = BM * (SW_ROW / 16) / PRODUCERS;
  // ring, full and empty barriers, slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The conv as a GEMM per group: M = N (OT) OH OW rows, K = (KT) KH KW Cg,
// Og columns. x strides in elements (channel stride 1); out is contiguous
// (N, (OT,) OH, OW, O). The depth fields (T, OT, ST, PT, KHW = KH KW, sxt)
// are read only by the DEEP instantiation.
struct Geom {
  int M, K, Cg, Og, O, H, W, KW, SH, SW, PH, PW, OH, OW;
  long long sxn, sxh, sxw;
  int T, OT, ST, PT, KHW;
  long long sxt;
};

// 16 bytes from global src to shared dst; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// One arrival on bar once all this thread's earlier cp.async have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, TO a, TO b);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int NC, int BN, typename TO, bool DEEP>
__global__ void __launch_bounds__(Tile<NC, BN>::THREADS, 1)
    conv_wgmma(const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x,
               const float* __restrict__ bias, TO* __restrict__ out, const Geom g,
               int relu) {
  using T = Tile<NC, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms need 1024 B
  const uint32_t full = ring + T::STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + T::STAGES * 8;

  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * BN;  // within the group
  const int grp = blockIdx.z;
  const int k_tiles = (g.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      // every producer's cp.async arrival, and thread 0's expect_tx for B
      mbar_init(full + 8 * s, PRODUCERS + 1);
      mbar_init(empty + 8 * s, NC);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {  // producer warpgroup
    const int p = threadIdx.x - 128 * NC;
    const int q = p % 8;  // this thread's 16-byte chunk of each row's 64 k
    long long off[T::ROWS];  // x offset of the row's first tap, group's channels
    int y0[T::ROWS], x0[T::ROWS];
    int t0[DEEP ? T::ROWS : 1];  // the row's first frame (DEEP)
#pragma unroll
    for (int r = 0; r < T::ROWS; ++r) {
      const int m = m0 + p / 8 + 16 * r;
      const int ox = m % g.OW, t = m / g.OW;
      const int oy = t % g.OH;
      int n = t / g.OH;
      long long toff = 0;
      if constexpr (DEEP) {
        const int ot = n % g.OT;
        n /= g.OT;
        t0[r] = ot * g.ST - g.PT;
        toff = static_cast<long long>(t0[r]) * g.sxt;
      }
      y0[r] = m < g.M ? oy * g.SH - g.PH : INT_MIN / 2;  // rows past M: all pad
      x0[r] = ox * g.SW - g.PW;
      off[r] = n * g.sxn + toff + static_cast<long long>(oy * g.SH - g.PH) * g.sxh +
               static_cast<long long>(x0[r]) * g.sxw + static_cast<long long>(grp) * g.Cg;
    }
    for (int t = 0; t < k_tiles; ++t) {
      const int s = t % T::STAGES;
      const uint32_t a_dst = ring + s * T::STAGE_BYTES;
      mbar_wait(empty + 8 * s, ((t / T::STAGES) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(full + 8 * s, T::B_BYTES);
#pragma unroll
        for (int b = 0; b < T::B_BOXES; ++b)
          tma_load(a_dst + T::A_BYTES + b * BOX_BYTES, &tw, full + 8 * s,
                   grp * g.Og + n0 + b * BOX_N, t * BK);
      }
      const int k = t * BK + q * 8;
      int tap = k / g.Cg;
      const int c = k - tap * g.Cg;
      int d = 0;  // the tap's frame (DEEP)
      if constexpr (DEEP) {
        d = tap / g.KHW;
        tap -= d * g.KHW;
      }
      const int i = tap / g.KW;
      const int j = tap - i * g.KW;
      const long long koff = (DEEP ? d * g.sxt : 0LL) + i * g.sxh + j * g.sxw + c;
#pragma unroll
      for (int r = 0; r < T::ROWS; ++r) {
        const int row = p / 8 + 16 * r;
        bool ok = k < g.K && static_cast<unsigned>(y0[r] + i) < static_cast<unsigned>(g.H) &&
                  static_cast<unsigned>(x0[r] + j) < static_cast<unsigned>(g.W);
        if constexpr (DEEP)
          ok = ok && static_cast<unsigned>(t0[r] + d) < static_cast<unsigned>(g.T);
        cp_async_16(a_dst + row * SW_ROW + ((q ^ (row & 7)) << 4),
                    ok ? x + off[r] + koff : x, ok ? 16 : 0);
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int t = 0; t < k_tiles; ++t) {
    const int s = t % T::STAGES;
    const uint32_t a_tile = ring + s * T::STAGE_BYTES + wg * 64 * SW_ROW;
    const uint32_t b_tile = ring + s * T::STAGE_BYTES + T::A_BYTES;
    mbar_wait(full + 8 * s, (t / T::STAGES) & 1);
    // the gathers wrote A through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<BN>(d, sw128_desc(a_tile + kk * 32, 16, SW_ATOM),
                sw128_desc(b_tile + kk * 16 * SW_ROW, BOX_BYTES, SW_ATOM));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // hand the stage back as soon as its products are done (keeping one
    // wgmma group in flight instead measured no faster)
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
  }

  // the wgmma accumulator layout (sm90.cuh); columns in pairs
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const float* bg = bias ? bias + grp * g.Og : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= g.M) continue;
    TO* orow = out + static_cast<long long>(m) * g.O + grp * g.Og;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col0 + 8 * j;
      if (n >= g.Og) continue;  // Og % 8 == 0: n + 1 is in range too
      store2<TO>(orow + n, epilogue<kEpiConv, TO>(d[4 * j + 2 * h], bg, n, relu),
                 epilogue<kEpiConv, TO>(d[4 * j + 2 * h + 1], bg, n + 1, relu));
    }
  }
}

template <int NC, int BN, typename TO, bool DEEP>
int launch(const CUtensorMap& tw, const bf16* x, const float* bias, TO* out,
           const Geom& g, int groups, int relu, cudaStream_t s) {
  using T = Tile<NC, BN>;
  auto kernel = conv_wgmma<NC, BN, TO, DEEP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.M + T::BM - 1) / T::BM, (g.Og + BN - 1) / BN, groups);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(tw, x, bias, out, g, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, typename TO, bool DEEP>
int launch_bn(const CUtensorMap& tw, const bf16* x, const float* bias, TO* out,
              const Geom& g, int groups, int block_n, int relu, cudaStream_t s) {
  switch (block_n) {
    case 64: return launch<NC, 64, TO, DEEP>(tw, x, bias, out, g, groups, relu, s);
    case 96: return launch<NC, 96, TO, DEEP>(tw, x, bias, out, g, groups, relu, s);
    case 128: return launch<NC, 128, TO, DEEP>(tw, x, bias, out, g, groups, relu, s);
    default: return launch<NC, 192, TO, DEEP>(tw, x, bias, out, g, groups, relu, s);
  }
}

template <typename TO, bool DEEP>
int run(const CUtensorMap& tw, const bf16* x, const float* bias, void* out,
        const Geom& g, int groups, int block_m, int block_n, int relu,
        cudaStream_t s) {
  TO* o = static_cast<TO*>(out);
  return block_m == 64
             ? launch_bn<1, TO, DEEP>(tw, x, bias, o, g, groups, block_n, relu, s)
             : launch_bn<2, TO, DEEP>(tw, x, bias, o, g, groups, block_n, relu, s);
}

}  // namespace conv90
}  // namespace vv
