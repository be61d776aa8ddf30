// K2 on Hopper's own units: a one-launch implicit-GEMM convolution, with
// cp.async im2col gathers, TMA weights and wgmma (sm_90a).
//
// Replaces videovector_tpu/ops/pallas/conv_gemm.py `conv2d_im2col_gemm`
// (:18; im2col, then the Pallas GEMM through `matmul_padded` :31) for bf16
// NHWC/HWIO operands the gathers can address: channels contiguous, Cg (the
// channels of a group) and Og (its output channels) multiples of 8, 16-byte
// aligned data. For each group g, output pixel m = (n, oy, ox) and output
// channel o of the group:
//   out[m, g Og + o] = conv_epilogue(sum_{i,j,c} x[n, oy s - p + i,
//                                   ox s - p + j, g Cg + c] w[i, j, c, g Og + o])
// with an f32 sum, padding read as zero, and K2's epilogue (gemm_core.cuh
// kEpiConv: round, add the rounded bias, round, ReLU). Every other K2 call
// (f32 operands, odd strides) stays on the core (conv_gemm.cu); the wrapper
// ops/hopper/conv_gemm.py picks the route from the operands, and repacks
// CaffeNet's conv1 (3 channels: 6 bytes a pixel, which neither a 16-byte
// copy nor TMA can address) by space-to-depth into a 3x3 conv over 48.
//
// What bounds it on the H100. At batch 50 CaffeNet's convs are 66.6 GFLOP
// over about 110 MB of HBM traffic (inputs, weights and outputs each once):
// conv2..conv5 are bound by the tensor cores (7.6 to 22.6 us each at 989
// TFLOP/s bf16), conv1 by memory (13.3 us at 3.35 TB/s). The implicit A
// matrix is K/C times the image (9 to 25 taps), so the gathers read every
// pixel several times; those reads hit L2 (the largest image, conv1's
// repacked input, is 15.6 MB against 50 MB of L2).
//
// What the design does about it:
// - Tensor cores. Consumer warpgroups (BM = 64 rows each, one or two) issue
//   wgmma m64nBNk16 with both operands in 128-byte-swizzled shared memory
//   and f32 sums in registers. BN divides Og where it can (96, 128, 192 on
//   CaffeNet), so no column of a tile belongs to another group.
// - B (the weights). HWIO weights are a row-major (KH KW Cg, O) matrix in the
//   same (i, j, c) reduction order as the gathers; group g's tile is that
//   matrix at column g Og + n0. One thread loads it through TMA, 64-column
//   boxes, zero fill past K and O.
// - A (the implicit im2col) through cp.async, not TMA's im2col mode: each
//   16-byte chunk is 8 channels of one pixel and one tap (Cg % 8 == 0, so no
//   chunk straddles a tap), written by a producer warpgroup straight to its
//   128-byte-swizzled address; padding and rows past M are src-size-0
//   copies, which fill zeros. The copies complete on the stage's mbarrier
//   (cp.async.mbarrier.arrive.noinc), together with B's TMA bytes, so a ring
//   of STAGES stages stays in flight with no __syncthreads in the K loop.
//   This keeps every address computation in plain integer code, the same
//   (n, oy, ox, i, j, c) decomposition the CPU tests check, with one map for
//   any geometry; TMA's im2col mode would need a map per conv and per
//   group, and its traversal of the bounding box cannot be rehearsed
//   without the card.
// - One launch per conv: blockIdx = (M tile, N tile of the group, group),
//   so all groups share one grid and the card fills once. There is no
//   split-K: the smallest M on the path is 8,450 rows.
// - The epilogue applies kEpiConv in registers and writes NHWC with paired
//   (4-byte bf16, 8-byte f32) stores, masked at M and at the group's Og.
// - conv1's space-to-depth repack is one more launch (`space_to_depth`
//   below) that writes x and w in the repacked layouts, 16 bytes a thread.
// PERF.md (section 6) has the measured times against these bounds and what
// holds the kernel back from them.
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

// The conv as a GEMM per group: M = N OH OW rows, K = KH KW Cg, Og columns.
// x strides in elements (channel stride 1); out is contiguous (N, OH, OW, O).
struct Geom {
  int M, K, Cg, Og, O, H, W, KW, SH, SW, PH, PW, OH, OW;
  long long sxn, sxh, sxw;
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

template <int NC, int BN, typename TO>
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
#pragma unroll
    for (int r = 0; r < T::ROWS; ++r) {
      const int m = m0 + p / 8 + 16 * r;
      const int ox = m % g.OW, t = m / g.OW;
      const int oy = t % g.OH, n = t / g.OH;
      y0[r] = m < g.M ? oy * g.SH - g.PH : INT_MIN / 2;  // rows past M: all pad
      x0[r] = ox * g.SW - g.PW;
      off[r] = n * g.sxn + static_cast<long long>(oy * g.SH - g.PH) * g.sxh +
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
      const int tap = k / g.Cg;
      const int c = k - tap * g.Cg;
      const int i = tap / g.KW;
      const int j = tap - i * g.KW;
      const long long koff = i * g.sxh + j * g.sxw + c;
#pragma unroll
      for (int r = 0; r < T::ROWS; ++r) {
        const int row = p / 8 + 16 * r;
        const bool ok = k < g.K && static_cast<unsigned>(y0[r] + i) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(x0[r] + j) < static_cast<unsigned>(g.W);
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

template <int NC, int BN, typename TO>
int launch(const CUtensorMap& tw, const bf16* x, const float* bias, TO* out,
           const Geom& g, int groups, int relu, cudaStream_t s) {
  using T = Tile<NC, BN>;
  auto kernel = conv_wgmma<NC, BN, TO>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.M + T::BM - 1) / T::BM, (g.Og + BN - 1) / BN, groups);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(tw, x, bias, out, g, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, typename TO>
int launch_bn(const CUtensorMap& tw, const bf16* x, const float* bias, TO* out,
              const Geom& g, int groups, int block_n, int relu, cudaStream_t s) {
  switch (block_n) {
    case 64: return launch<NC, 64>(tw, x, bias, out, g, groups, relu, s);
    case 96: return launch<NC, 96>(tw, x, bias, out, g, groups, relu, s);
    case 128: return launch<NC, 128>(tw, x, bias, out, g, groups, relu, s);
    default: return launch<NC, 192>(tw, x, bias, out, g, groups, relu, s);
  }
}

template <typename TO>
int run(const CUtensorMap& tw, const bf16* x, const float* bias, void* out,
        const Geom& g, int groups, int block_m, int block_n, int relu,
        cudaStream_t s) {
  TO* o = static_cast<TO*>(out);
  return block_m == 64 ? launch_bn<1, TO>(tw, x, bias, o, g, groups, block_n, relu, s)
                       : launch_bn<2, TO>(tw, x, bias, o, g, groups, block_n, relu, s);
}

// The space-to-depth repack of an unpadded stride-s conv (the wrapper's
// `space_to_depth`, whose plain version says what it computes), in one
// launch: threads [0, x_chunks) write one 16-byte chunk of xs each, the rest
// one element of ws. xs[n, bi, bj, (a s + b) C + c] = x[n, bi s + a,
// bj s + b, c] and ws[bi, bj, (a s + b) C + c, o] = w[bi s + a, bj s + b, c,
// o], zero past the image or the kernel. All four tensors contiguous bf16.
__global__ void space_to_depth(const bf16* __restrict__ x, const bf16* __restrict__ w,
                               bf16* __restrict__ xs, bf16* __restrict__ ws, int H,
                               int W, int C, int O, int k, int s, int HB, int WB,
                               int KB, long long x_chunks, long long total) {
  const int E = s * s * C;  // channels of a repacked pixel, a multiple of 8
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < x_chunks) {
      const long long p = i / (E / 8);  // repacked pixel (n, bi, bj)
      const int e0 = static_cast<int>(i - p * (E / 8)) * 8;
      const int bj = static_cast<int>(p % WB);
      const long long t = p / WB;
      const int bi = static_cast<int>(t % HB);
      const long long n = t / HB;
      alignas(16) bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = (e0 + u) % C, ab = (e0 + u) / C;
        const int y = bi * s + ab / s, xx = bj * s + ab % s;
        v[u] = y < H && xx < W ? x[((n * H + y) * W + xx) * C + c] : zero<bf16>();
      }
      *reinterpret_cast<uint4*>(xs + p * E + e0) = *reinterpret_cast<const uint4*>(v);
    } else {
      const long long j = i - x_chunks;  // ws element (bi, bj, e, o)
      const int o = static_cast<int>(j % O);
      const long long t = j / O;
      const int e = static_cast<int>(t % E);
      const int bj = static_cast<int>(t / E % KB), bi = static_cast<int>(t / E / KB);
      const int c = e % C, ab = e / C;
      const int y = bi * s + ab / s, xx = bj * s + ab % s;
      ws[j] = y < k && xx < k ? w[((y * k + xx) * C + c) * O + o] : zero<bf16>();
    }
  }
}

}  // namespace conv90
}  // namespace vv

// x (N, H, W, C) bf16 with unit channel stride and element strides sxn, sxh,
// sxw; w (KH, KW, C / groups, O) bf16, contiguous; bias f32 (O) or null; out
// (N, OH, OW, O) contiguous, f32 or bf16. block_m (64 or 128) and block_n
// (64, 96, 128 or 192) come from the wrapper's plan. Returns a CUDA error
// code as an int.
extern "C" int vv_conv_gemm_sm90(const void* x, const void* w, const void* bias,
                                 void* out, int N, int H, int W, int C, int O,
                                 int KH, int KW, int SH, int SW, int PH, int PW,
                                 int OH, int OW, int groups, long long sxn,
                                 long long sxh, long long sxw, int block_m,
                                 int block_n, int dtype_out, int relu, int device,
                                 void* stream) {
  using namespace vv::conv90;
  if (groups < 1 || C % groups != 0 || O % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.Cg = C / groups;
  g.Og = O / groups;
  g.O = O;
  g.M = N * OH * OW;
  g.K = KH * KW * g.Cg;
  g.H = H;
  g.W = W;
  g.KW = KW;
  g.SH = SH;
  g.SW = SW;
  g.PH = PH;
  g.PW = PW;
  g.OH = OH;
  g.OW = OW;
  g.sxn = sxn;
  g.sxh = sxh;
  g.sxw = sxw;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 8 == 0 && sxn % 8 == 0 &&
                       sxh % 8 == 0 && sxw % 8 == 0;
  const bool bn_ok = block_n == 64 || block_n == 96 || block_n == 128 || block_n == 192;
  if (N <= 0 || OH <= 0 || OW <= 0 || KH <= 0 || KW <= 0 || SH <= 0 || SW <= 0 ||
      g.Cg % 8 != 0 || g.Og % 8 != 0 || !aligned || !bn_ok ||
      (block_m != 64 && block_m != 128) ||
      (dtype_out != vv::kF32 && dtype_out != vv::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tw;
  const int rc = encode(&tw, w, g.K, O, O, BK, BOX_N);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const vv::bf16* xb = static_cast<const vv::bf16*>(x);
  const float* b = static_cast<const float*>(bias);
  return dtype_out == vv::kBF16
             ? run<vv::bf16>(tw, xb, b, out, g, groups, block_m, block_n, relu, s)
             : run<float>(tw, xb, b, out, g, groups, block_m, block_n, relu, s);
}

// x (N, H, W, C) and w (k, k, C, O) contiguous bf16 -> xs (N, HB, WB, s s C)
// and ws (KB, KB, s s C, O), KB = ceil(k / s), HB = (H + KB s - k) / s (WB
// likewise); needs (H - k) % s == (W - k) % s == 0 and s s C % 8 == 0.
// Returns a CUDA error code as an int.
extern "C" int vv_space_to_depth(const void* x, const void* w, void* xs, void* ws,
                                 int N, int H, int W, int C, int O, int k, int s,
                                 int device, void* stream) {
  if (N <= 0 || C <= 0 || O <= 0 || k <= 0 || s <= 0 || H < k || W < k ||
      (H - k) % s != 0 || (W - k) % s != 0 || (s * s * C) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(xs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int kb = (k + s - 1) / s, pad = kb * s - k;
  const int hb = (H + pad) / s, wb = (W + pad) / s;
  const long long x_chunks = static_cast<long long>(N) * hb * wb * (s * s * C / 8);
  const long long total = x_chunks + static_cast<long long>(kb) * kb * s * s * C * O;
  const int blocks = static_cast<int>(std::min((total + 255) / 256, 16LL * sms));
  vv::conv90::space_to_depth<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vv::bf16*>(x), static_cast<const vv::bf16*>(w),
      static_cast<vv::bf16*>(xs), static_cast<vv::bf16*>(ws), H, W, C, O, k, s, hb, wb,
      kb, x_chunks, total);
  return static_cast<int>(cudaGetLastError());
}
