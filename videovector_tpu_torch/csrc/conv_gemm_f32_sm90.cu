// K2 for f32 operands on Hopper: a one-launch implicit-GEMM convolution on
// FFMA, with cp.async im2col gathers, TMA weights and split-K (sm_90a).
//
// Replaces videovector_tpu/ops/pallas/conv_gemm.py `conv2d_im2col_gemm`
// (:18; im2col, then the Pallas GEMM through `matmul_padded` :31) for f32
// NHWC/HWIO operands the gathers can address: channels contiguous, Cg (the
// channels of a group) and Og (its output channels) multiples of 4, pixel
// strides multiples of 4 elements, 16-byte-aligned data, f32 output. This is
// the route of every CONVOLUTION of the port's f32 Net. For each group g,
// output pixel m = (n, oy, ox) and output channel o of the group:
//   out[m, g Og + o] = act(sum_{i,j,c} x[n, oy s - p + i, ox s - p + j,
//                          g Cg + c] w[i, j, c, g Og + o] + b[g Og + o])
// an f32 sum of exact f32 products (FFMA, no TF32), padding read as zero,
// bias and ReLU in f32 on the finished sum: gemm_core.cuh's epilogue for an
// f32 output, where kEpiConv and kEpiK1 agree. Within a split the products
// are summed in ascending k (tap by tap, channel innermost) with fmaf.
//
// What bounds it on the H100: operations. At batch 50 CaffeNet's convs are
// 66.6 GFLOP, 0.99 ms at the 67 TFLOP/s FFMA peak, against about 110 MB of
// HBM traffic (0.03 ms). Every SM must issue one FFMA per lane per clock, so
// whatever else a thread issues is taken from that budget. The implicit A
// matrix is K/C times the image, so the gathers read each pixel 9 to 25
// times; those reads hit L2 (the largest input, conv1's repacked image, is
// 31 MB at f32 against 50 MB of L2).
//
// What the design does about it:
// - The consumers only multiply, as K1's f32 route's (matmul_f32_sm90.cu):
//   32 x 64 warp tiles, each lane an 8 x 8 tile of f32 sums (rows ly + 4i,
//   columns 4lx + j and 32 + 4lx + j), read as float4 from shared memory:
//   16 LDS.128 feed 256 FFMA.
// - A (the implicit im2col) through cp.async from producer warps: each
//   16-byte chunk is 4 channels of one pixel at one tap (Cg % 4 == 0, so no
//   chunk straddles a tap), written to its 128-byte-swizzled address
//   (chunk q of row r at q ^ (r % 8), the layout TMA's swizzle gives B), so
//   the FFMA readers hit no bank twice. Padding and rows past M are
//   src-size-0 copies, which fill zeros. Each producer thread computes its
//   rows' offsets once into registers and keeps the tap of its chunk,
//   stepped forward tap by tap, so no element costs a div or mod and the
//   gathers add no shared-memory load to the consumers' stream. The copies
//   complete on the stage's mbarrier (cp.async.mbarrier.arrive.noinc)
//   together with B's TMA bytes: a ring of STAGES stages in flight and no
//   __syncthreads in the K loop. The gathers are the kernel's price: on the
//   H100 one producer warp held a 128 x 128 block to 42% of the FFMA peak
//   against K1's 69% on the same GEMM, four reach 63%, and none (A not
//   loaded, a timing-only variant) 67% (scripts/torch_k2_f32_variants.py).
// - B (the weights) through TMA: HWIO is a row-major (KH KW Cg, O) matrix in
//   the gathers' (i, j, c) order; 32-k x 32-column boxes in the 128-byte
//   swizzle, zero fill past K and O.
// - Groups in the grid: blockIdx = (M tile, N tile of the group, group x
//   split), one launch per conv. A tile never reaches into the next group:
//   its columns past Og are masked. Tiles are 64 or 128 columns wide, since
//   a warp tile is 64: a 96-wide tile (conv1's Og) has six consumer warps,
//   which leave two of the SM's four warp schedulers a warp short, and ran
//   conv1 slower than a 128-wide tile that wastes a quarter of its columns.
// - A full card: the host plan (`k2_f32_plan`, ops/hopper/conv_gemm.py)
//   picks the tile and a deterministic split-K that fill the waves of SMs;
//   each split writes its partial sums to a workspace and sm90.cuh's
//   splitk_reduce sums them in split order, adds the bias and applies
//   ReLU: no atomics, two runs give the same bits.
#include <climits>
#include <cstdint>

#include "gemm_core.cuh"
#include "sm90.cuh"

namespace vv {
namespace convf32 {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load;

constexpr int BK = 32;               // k per stage: one 128-byte row of f32
constexpr int ROW = BK * 4;          // bytes per swizzled smem row
constexpr int BOX_N = 32;            // w columns per TMA box (128 bytes)
constexpr int BOX_BYTES = BK * ROW;  // one w box: 32 k rows, 4 KB
constexpr int STAGES = 4;

// A BM x BN block: (BM / 32) x (BN / 64) consumer warps of 32 x 64 tiles,
// and PW producer warps. BLOCKS blocks share an SM (the plan's table,
// F32_TILES, says the same): 128 x 64 and 64 x 128 run two a SM, so that
// eight consumer warps share each SM, as in a 128 x 128 block.
template <int BM_, int BN_, int BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BLOCKS = BLOCKS_;
  static constexpr int NBOX = BN / BOX_N;
  static constexpr int WARPS = (BM / 32) * (BN / 64);
  static constexpr int CONSUMERS = 32 * WARPS;
  // producer warps: four beside a block's eight consumer warps (three warps
  // for each of the SM's four schedulers), two where two blocks share an SM
  // (the registers allow no more)
  static constexpr int PW = BLOCKS == 1 ? 4 : 2;
  static constexpr int PRODUCERS = 32 * PW;
  static constexpr int PROWS = BM * 8 / PRODUCERS;  // rows a producer gathers
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE_BYTES = A_BYTES + NBOX * BOX_BYTES;
  // ring, full and empty barriers, slack to align the ring to 1024 bytes
  // (the swizzle's atom)
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(BM % 32 == 0 && BN % 64 == 0, "warp tiles");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "shared memory of one SM");
};

// The conv as a GEMM per group: M = N OH OW rows, K = KH KW Cg, Og columns
// of each group, O in all. x strides in elements (channel stride 1); out and
// the workspace are (M, O) row-major.
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

// Block (m-tile, n-tile of the group, group * splits + split): sums the
// group's A rows [m0, m0 + BM) against w's columns g Og + [n0, n0 + BN) over
// the split's K tiles [split * k_tiles / splits, (split + 1) * k_tiles /
// splits). PARTIAL: writes the f32 sums to ws[split]; otherwise applies the
// epilogue and writes out.
template <class T, bool PARTIAL>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS)
    conv_f32(const __grid_constant__ CUtensorMap tw, const float* __restrict__ x,
             const float* __restrict__ bias, float* __restrict__ out,
             float* __restrict__ ws, const Geom g, int splits, int relu) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint8_t* ring_p = smem_raw + (ring - raw);
  const uint32_t full = ring + STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;

  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;  // within the group
  const int grp = blockIdx.z / splits;
  const int split = blockIdx.z - grp * splits;
  const int k_tiles = (g.K + BK - 1) / BK;
  const int t_begin = static_cast<int>(static_cast<long long>(split) * k_tiles / splits);
  const int nt =
      static_cast<int>(static_cast<long long>(split + 1) * k_tiles / splits) - t_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // every producer's cp.async arrival, and producer 0's expect_tx for B
      mbar_init(full + 8 * s, T::PRODUCERS + 1);
      mbar_init(empty + 8 * s, T::WARPS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::CONSUMERS) {  // the producer warps
    // this thread copies chunk q (channels 4q..4q+3 of the stage's 32 k) of
    // rows p / 8 + (PRODUCERS / 8) r; each row's gather origin (the x offset
    // of its first tap at the group's first channel, and the tap's top-left
    // pixel; y0 = INT_MIN / 2 past M, which every tap reads as padding)
    // stays in registers. (i, j, c) is the tap and channel of its k.
    const int p = threadIdx.x - T::CONSUMERS;
    const int q = p % 8;
    long long off[T::PROWS];
    int y0[T::PROWS], x0[T::PROWS];
#pragma unroll
    for (int r = 0; r < T::PROWS; ++r) {
      const int m = m0 + p / 8 + (T::PRODUCERS / 8) * r;
      const int ox = m % g.OW, t = m / g.OW;
      const int oy = t % g.OH, n = t / g.OH;
      y0[r] = m < g.M ? oy * g.SH - g.PH : INT_MIN / 2;
      x0[r] = ox * g.SW - g.PW;
      off[r] = n * g.sxn + static_cast<long long>(oy * g.SH - g.PH) * g.sxh +
               static_cast<long long>(x0[r]) * g.sxw +
               static_cast<long long>(grp) * g.Cg;
    }
    int k = t_begin * BK + 4 * q;
    int tap = k / g.Cg;
    int c = k - tap * g.Cg;
    int i = tap / g.KW;
    int j = tap - i * g.KW;
    for (int t = 0; t < nt; ++t) {
      const int s = t % STAGES;
      const uint32_t a_dst = ring + s * T::STAGE_BYTES;
      mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(full + 8 * s, T::NBOX * BOX_BYTES);
#pragma unroll
        for (int b = 0; b < T::NBOX; ++b)
          tma_load(a_dst + T::A_BYTES + b * BOX_BYTES, &tw, full + 8 * s,
                   grp * g.Og + n0 + b * BOX_N, (t_begin + t) * BK);
      }
      const bool k_in = k < g.K;
      const long long koff = i * g.sxh + j * g.sxw + c;
#pragma unroll
      for (int r = 0; r < T::PROWS; ++r) {
        const int row = p / 8 + (T::PRODUCERS / 8) * r;
        const bool ok = k_in &&
                        static_cast<unsigned>(y0[r] + i) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(x0[r] + j) < static_cast<unsigned>(g.W);
        cp_async_16(a_dst + row * ROW + ((q ^ (row & 7)) << 4),
                    x + (ok ? off[r] + koff : 0), ok ? 16 : 0);
      }
      cp_async_arrive(full + 8 * s);
      // the next stage's k is 32 further: step the tap forward
      k += BK;
      c += BK;
      while (c >= g.Cg) {
        c -= g.Cg;
        if (++j == g.KW) {
          j = 0;
          ++i;
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warp (wm, wn): rows wm*32 .. +31, columns wn*64 .. +63; lane
  // (ly, lx) owns rows wm*32 + ly + 4i (i < 8), whose swizzle rows are ly
  // and ly + 4, and columns wn*64 + 4lx + j and wn*64 + 32 + 4lx + j (j <
  // 4): chunk lx of the rows of w boxes 2 wn and 2 wn + 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (T::BN / 64), wn = warp % (T::BN / 64);
  const int ly = lane / 8, lx = lane % 8;
  const int a_off = (wm * 32 + ly) * ROW;
  // w row k keeps chunk lx at lx ^ (k % 8)
  int b_chunk[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    b_chunk[q] = T::A_BYTES + 2 * wn * BOX_BYTES + ((lx ^ q) << 4);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    const uint8_t* st = ring_p + s * T::STAGE_BYTES;
#pragma unroll
    for (int gq = 0; gq < BK / 4; ++gq) {
      // k chunk gq of row ly + 4i sits at chunk gq ^ (ly + 4 (i % 2))
      const int ca = (gq ^ ly) << 4, cb = (gq ^ (ly + 4)) << 4;
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(st + a_off + i * 4 * ROW +
                                                (i % 2 ? cb : ca));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * gq + kk;
        const int off = b_chunk[k % 8] + k * ROW;
        const float4 b0 = *reinterpret_cast<const float4*>(st + off);
        const float4 b1 = *reinterpret_cast<const float4*>(st + off + BOX_BYTES);
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

  const float* bg = bias ? bias + grp * g.Og : nullptr;
  float* dst = PARTIAL ? ws + static_cast<long long>(split) * g.M * g.O : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm * 32 + ly + 4 * i;
    if (m >= g.M) continue;
    float* orow = dst + static_cast<long long>(m) * g.O + grp * g.Og;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn * 64 + 32 * h + 4 * lx;
      if (n >= g.Og) continue;  // Og % 4 == 0: n + 3 is in range too
      float4 v;
      if constexpr (PARTIAL) {
        v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
        v = make_float4(epilogue<kEpiK1, float>(acc[i][4 * h], bg, n, relu),
                        epilogue<kEpiK1, float>(acc[i][4 * h + 1], bg, n + 1, relu),
                        epilogue<kEpiK1, float>(acc[i][4 * h + 2], bg, n + 2, relu),
                        epilogue<kEpiK1, float>(acc[i][4 * h + 3], bg, n + 3, relu));
      }
      *reinterpret_cast<float4*>(orow + n) = v;
    }
  }
}

template <class T, bool PARTIAL>
int launch(const CUtensorMap& tw, const float* x, const float* bias, float* out,
           float* ws, const Geom& g, int groups, int splits, int relu,
           cudaStream_t s) {
  auto kernel = conv_f32<T, PARTIAL>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.M + T::BM - 1) / T::BM, (g.Og + T::BN - 1) / T::BN,
                  groups * splits);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(tw, x, bias, out, ws, g, splits, relu);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int run(const CUtensorMap& tw, const float* x, const float* bias, float* out,
        float* ws, const Geom& g, int groups, int splits, int relu, int sms,
        cudaStream_t s) {
  if (splits == 1)
    return launch<T, false>(tw, x, bias, out, nullptr, g, groups, 1, relu, s);
  const int rc = launch<T, true>(tw, x, bias, out, ws, g, groups, splits, relu, s);
  if (rc != 0) return rc;
  return sm90::launch_splitk_reduce<float>(ws, bias, out, g.M, g.O, splits, g.O, 1,
                                           relu, sms, s);
}

}  // namespace convf32
}  // namespace vv

// x (N, H, W, C) f32 with unit channel stride and element strides sxn, sxh,
// sxw; w (KH, KW, C / groups, O) f32, contiguous; bias f32 (O) or null; out
// (N, OH, OW, O) f32, contiguous; ws f32 (splits, N OH OW, O) when splits >
// 1. (block_m, block_n) is one of the plan's tiles (128 x 128, 128 x 64,
// 64 x 128) and splits comes from the plan. Returns a CUDA error code as an
// int.
extern "C" int vv_conv_gemm_f32_sm90(const void* x, const void* w, const void* bias,
                                     void* out, void* ws, int N, int H, int W, int C,
                                     int O, int KH, int KW, int SH, int SW, int PH,
                                     int PW, int OH, int OW, int groups, long long sxn,
                                     long long sxh, long long sxw, int block_m,
                                     int block_n, int splits, int relu, int device,
                                     void* stream) {
  using namespace vv::convf32;
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
  const int k_tiles = (g.K + BK - 1) / BK;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(ws) % 16 == 0 && sxn % 4 == 0 &&
                       sxh % 4 == 0 && sxw % 4 == 0;
  const int tile = block_m * 1000 + block_n;
  const bool tile_ok = tile == 128128 || tile == 128064 || tile == 64128;
  if (N <= 0 || OH <= 0 || OW <= 0 || KH <= 0 || KW <= 0 || SH <= 0 || SW <= 0 ||
      g.Cg % 4 != 0 || g.Og % 4 != 0 || !aligned || !tile_ok || splits < 1 ||
      splits > k_tiles || static_cast<long long>(groups) * splits > 65535 ||
      (g.Og + block_n - 1) / block_n > 65535 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  CUtensorMap tw;
  const int rc = vv::sm90::encode(&tw, w, g.K, O, O, BK, BOX_N,
                                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* wsf = static_cast<float*>(ws);
  switch (tile) {
    case 128128: return run<Tile<128, 128, 1>>(tw, xf, b, o, wsf, g, groups, splits, relu, sms, s);
    case 128064: return run<Tile<128, 64, 2>>(tw, xf, b, o, wsf, g, groups, splits, relu, sms, s);
    default: return run<Tile<64, 128, 2>>(tw, xf, b, o, wsf, g, groups, splits, relu, sms, s);
  }
}
