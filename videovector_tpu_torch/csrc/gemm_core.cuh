// Shared GEMM core of the two Hopper kernels (K1 matmul.cu, K2 conv_gemm.cu).
//
// out[m, n] = epilogue( sum_k A[m, k] * B[k, n] ), accumulated in f32.
//
// A and B are never materialised: a geometry object turns (m, k) and (k, n)
// into element offsets from the strides the wrapper passes, so the same core
// reads a row-major matrix (MatGeom, K1) or gathers convolution patches
// straight from the input image (ConvGeom, K2's implicit GEMM). Ragged edges
// (m >= M, n >= N, k >= K, and the conv's zero padding) are masked while a
// tile is loaded, so no caller pads or copies.
//
// Two compute paths, picked by the operand type:
// - bf16 operands: tensor cores through WMMA 16x16x16 (mma.sync), f32 sums;
// - f32 operands: FMA register tiles in f32, so f32 results keep f32 accuracy.
//
// Epilogue, in f32 arithmetic with rounding to the output type TO, in one of
// two modes (`Epilogue`), which agree for an f32 output (act(x.w + b)):
// - kEpiK1 (K1): round(act(acc + bias[n])), one rounding at the end, as the
//   Pallas `_matmul_kernel` does;
// - kEpiConv (K2): v = round(acc); if bias: v = round(v + round(bias[n]));
//   then act: the bf16 conv of models/mednet.py, which emits bf16 and adds
//   the bias and applies ReLU in bf16.
//
// This first version is simple on purpose: one tile in shared memory and
// the next in registers, no cp.async/TMA pipeline and no wgmma. Tile sizes
// are two fixed configurations; the host picks the larger one only when it
// gives at least one block per SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace vv {

enum DType { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to what TO can hold, staying in f32 arithmetic.
template <typename TO> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<TO>(v));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

// Per output row: offset of the row's first A element and of its output.
struct RowInfo {
  long long a;
  long long o;
  int y0;
  int x0;
};

// Per reduction index: offset into A (relative to a row) and into B.
struct KInfo {
  long long a;
  long long b;
  int i;
  int j;
};

// K1: A (M, K) and B (K, N) with arbitrary element strides.
struct MatGeom {
  int M, N, K;
  long long sam, sak, sbk, sbn, som, son;

  __device__ RowInfo row(int m) const { return {m * sam, m * som, 0, 0}; }
  __device__ KInfo kinfo(int k) const { return {k * sak, k * sbk, 0, 0}; }
  __device__ bool a_in(const RowInfo&, const KInfo&) const { return true; }
};

// K2: implicit im2col. Rows m = (n, oy, ox); reduction k = (i, j, c) with the
// channel innermost, so that an NHWC image is read along its contiguous axis.
// The order of k is internal: A and B are indexed with the same (i, j, c).
// x is addressed as (n, c, y, x) and w as (o, c, i, j) through strides, so
// NCHW/OIHW and NHWC/HWIO tensors (and channel-slice views of them, one per
// group) are read in place.
struct ConvGeom {
  int M, N, K;
  int C, H, W, KW, SH, SW, PH, PW, OH, OW;
  long long sxn, sxc, sxh, sxw;
  long long swc, swh, sww, sbn;  // sbn: stride of w's output channel
  long long son_batch, son, soh, sow;  // son: stride of out's channel

  __device__ RowInfo row(int m) const {
    const int ox = m % OW;
    const int t = m / OW;
    const int oy = t % OH;
    const int n = t / OH;
    const int y0 = oy * SH - PH;
    const int x0 = ox * SW - PW;
    return {n * sxn + y0 * sxh + x0 * sxw, n * son_batch + oy * soh + ox * sow,
            y0, x0};
  }
  __device__ KInfo kinfo(int k) const {
    const int c = k % C;
    const int t = k / C;
    const int j = t % KW;
    const int i = t / KW;
    return {c * sxc + i * sxh + j * sxw, c * swc + i * swh + j * sww, i, j};
  }
  __device__ bool a_in(const RowInfo& r, const KInfo& k) const {
    const int y = r.y0 + k.i;
    const int x = r.x0 + k.j;
    return (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
  }
};

// Tile configuration. WM x WN warps; for the FMA path each thread owns a
// TM x TN register tile, strided across the block tile.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int TM_, int TN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int TM = TM_, TN = TN_;
  static constexpr int NWARPS = WM * WN;
  static constexpr int NT = NWARPS * 32;
  static_assert(NT % BK == 0 && NT % BN == 0, "loader mapping");
  static_assert((BM / TM) * (BN / TN) == NT, "FMA thread tiles");
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0, "warp tiles");
};

using BigCfg = Cfg<128, 128, 32, 2, 4, 8, 8>;
using SmallCfg = Cfg<64, 32, 32, 2, 2, 4, 4>;

// One thread's share of a BM x BK tile of A and a BK x BN tile of B, held in
// registers between the global loads and the shared-memory stores, so that
// the next tile's loads are in flight while the current tile is multiplied.
template <class C, typename T>
struct TileRegs {
  static constexpr int NA = C::BM / (C::NT / C::BK);
  static constexpr int NB = C::BK / (C::NT / C::BN);
  T a[NA];
  T b[NB];
};

// Global -> registers for the tile at k0, zero-filling everything outside
// the problem. rows[] and ks[] hold the per-row and per-k offsets.
template <class C, class G, typename T>
__device__ __forceinline__ void fetch(TileRegs<C, T>& r,
                                      const T* __restrict__ a,
                                      const T* __restrict__ b, const G& g,
                                      const RowInfo* rows, const KInfo* ks,
                                      int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  const int a_kk = tid % C::BK;
  const bool a_k_ok = k0 + a_kk < g.K;
  const KInfo ka = ks[a_kk];
#pragma unroll
  for (int i = 0; i < TileRegs<C, T>::NA; ++i) {
    const int row = tid / C::BK + i * (C::NT / C::BK);
    const RowInfo ri = rows[row];
    r.a[i] = (a_k_ok && m0 + row < g.M && g.a_in(ri, ka)) ? a[ri.a + ka.a]
                                                           : zero<T>();
  }
  const int b_n = tid % C::BN;
  const bool b_n_ok = n0 + b_n < g.N;
  const long long b_col = (long long)(n0 + b_n) * g.sbn;
#pragma unroll
  for (int i = 0; i < TileRegs<C, T>::NB; ++i) {
    const int kk = tid / C::BN + i * (C::NT / C::BN);
    r.b[i] = (b_n_ok && k0 + kk < g.K) ? b[ks[kk].b + b_col] : zero<T>();
  }
}

// Registers -> shared memory (row strides AS and BS).
template <class C, typename T, int AS, int BS>
__device__ __forceinline__ void stash(const TileRegs<C, T>& r, T* As, T* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < TileRegs<C, T>::NA; ++i)
    As[(tid / C::BK + i * (C::NT / C::BK)) * AS + tid % C::BK] = r.a[i];
#pragma unroll
  for (int i = 0; i < TileRegs<C, T>::NB; ++i)
    Bs[(tid / C::BN + i * (C::NT / C::BN)) * BS + tid % C::BN] = r.b[i];
}

// The K loop shared by both kernels: one tile in shared memory, the next
// one in registers. `compute()` multiplies the tile in As/Bs.
template <class C, class G, typename T, int AS, int BS, class Compute>
__device__ __forceinline__ void k_loop(const T* __restrict__ a,
                                       const T* __restrict__ b, const G& g,
                                       const RowInfo* rows, KInfo (*ks)[C::BK],
                                       int m0, int n0, T* As, T* Bs,
                                       Compute compute) {
  const int tid = threadIdx.x;
  const int nk = (g.K + C::BK - 1) / C::BK;
  if (nk == 0) {
    __syncthreads();  // rows[] ready for the epilogue
    return;
  }
  if (tid < C::BK) ks[0][tid] = g.kinfo(min(tid, g.K - 1));
  __syncthreads();  // rows[] and ks[0] ready
  TileRegs<C, T> regs;
  fetch<C, G, T>(regs, a, b, g, rows, ks[0], m0, n0, 0);
  for (int t = 0; t < nk; ++t) {
    stash<C, T, AS, BS>(regs, As, Bs);
    const int k1 = (t + 1) * C::BK;
    const bool more = t + 1 < nk;
    if (more && tid < C::BK) ks[(t + 1) & 1][tid] = g.kinfo(min(k1 + tid, g.K - 1));
    __syncthreads();  // tile t in As/Bs, ks for tile t + 1 ready
    if (more) fetch<C, G, T>(regs, a, b, g, rows, ks[(t + 1) & 1], m0, n0, k1);
    compute();
    __syncthreads();  // done reading As/Bs before the next stash
  }
}

enum Epilogue { kEpiK1 = 0, kEpiConv = 1 };

// The epilogue of output column n on its f32 sum (modes above).
template <int EPI, typename TO>
__device__ __forceinline__ TO epilogue(float acc, const float* __restrict__ bias,
                                       int n, int relu) {
  float v;
  if (EPI == kEpiK1) {
    v = bias ? acc + bias[n] : acc;
  } else {
    v = round_to<TO>(acc);
    if (bias) v = round_to<TO>(v + round_to<TO>(bias[n]));
  }
  if (relu && v < 0.f) v = 0.f;  // keeps NaN, as max(x, 0) does
  return from_f32<TO>(v);
}

template <int EPI, typename TO, class G>
__device__ __forceinline__ void store_one(TO* __restrict__ out,
                                          const float* __restrict__ bias,
                                          const G& g, const RowInfo& ri, int n,
                                          float acc, int relu) {
  out[ri.o + n * g.son] = epilogue<EPI, TO>(acc, bias, n, relu);
}

// bf16 operands, tensor cores.
template <int EPI, class C, class G, typename TO>
__global__ void __launch_bounds__(C::NT)
    gemm_mma(const bf16* __restrict__ a, const bf16* __restrict__ b,
             const float* __restrict__ bias, TO* __restrict__ out, G g,
             int relu) {
  using namespace nvcuda;
  constexpr int AS = C::BK + 8;  // +8 bf16 keeps rows 16-byte aligned
  constexpr int BS = C::BN + 8;
  constexpr int FM = C::BM / C::WM / 16;
  constexpr int FN = C::BN / C::WN / 16;
  __shared__ __align__(128) bf16 As[C::BM * AS];
  __shared__ __align__(128) bf16 Bs[C::BK * BS];
  __shared__ __align__(128) float stage[C::NWARPS][16 * 16];
  __shared__ RowInfo rows[C::BM];
  __shared__ KInfo ks[2][C::BK];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  for (int r = tid; r < C::BM; r += C::NT) rows[r] = g.row(min(m0 + r, g.M - 1));

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  k_loop<C, G, bf16, AS, BS>(a, b, g, rows, ks, m0, n0, As, Bs, [&]() {
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * FM * 16 + i * 16) * AS + kk, AS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * BS + wn * FN * 16 + j * 16, BS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  });

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int lr = wm * FM * 16 + i * 16 + e / 16;
        const int n = n0 + wn * FN * 16 + j * 16 + e % 16;
        if (m0 + lr < g.M && n < g.N) store_one<EPI, TO>(out, bias, g, rows[lr], n, st[e], relu);
      }
      __syncwarp();
    }
  }
}

// f32 operands, FMA register tiles.
template <int EPI, class C, class G, typename TO>
__global__ void __launch_bounds__(C::NT)
    gemm_fma(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ bias, TO* __restrict__ out, G g,
             int relu) {
  constexpr int AS = C::BK + 1;  // odd row stride: rows fall in distinct banks
  constexpr int BS = C::BN + 4;
  constexpr int RS = C::BM / C::TM;  // row stride between a thread's rows
  constexpr int CS = C::BN / C::TN;  // column stride between its columns
  __shared__ float As[C::BM * AS];
  __shared__ float Bs[C::BK * BS];
  __shared__ RowInfo rows[C::BM];
  __shared__ KInfo ks[2][C::BK];

  const int tid = threadIdx.x;
  const int tx = tid % CS, ty = tid / CS;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  for (int r = tid; r < C::BM; r += C::NT) rows[r] = g.row(min(m0 + r, g.M - 1));

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  k_loop<C, G, float, AS, BS>(a, b, g, rows, ks, m0, n0, As, Bs, [&]() {
#pragma unroll 8
    for (int kk = 0; kk < C::BK; ++kk) {
      float av[C::TM], bv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) av[i] = As[(ty + i * RS) * AS + kk];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) bv[j] = Bs[kk * BS + tx + j * CS];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  });

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int lr = ty + i * RS;
    if (m0 + lr >= g.M) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int n = n0 + tx + j * CS;
      if (n < g.N) store_one<EPI, TO>(out, bias, g, rows[lr], n, acc[i][j], relu);
    }
  }
}

template <int EPI, class C, class G>
void launch_cfg(const void* a, const void* b, const float* bias, void* out,
                const G& g, int dtype_in, int dtype_out, int relu,
                cudaStream_t s) {
  const dim3 grid((g.M + C::BM - 1) / C::BM, (g.N + C::BN - 1) / C::BN);
  if (dtype_in == kBF16) {
    const bf16* pa = static_cast<const bf16*>(a);
    const bf16* pb = static_cast<const bf16*>(b);
    if (dtype_out == kBF16)
      gemm_mma<EPI, C, G, bf16><<<grid, C::NT, 0, s>>>(pa, pb, bias, static_cast<bf16*>(out), g, relu);
    else
      gemm_mma<EPI, C, G, float><<<grid, C::NT, 0, s>>>(pa, pb, bias, static_cast<float*>(out), g, relu);
  } else {
    const float* pa = static_cast<const float*>(a);
    const float* pb = static_cast<const float*>(b);
    if (dtype_out == kBF16)
      gemm_fma<EPI, C, G, bf16><<<grid, C::NT, 0, s>>>(pa, pb, bias, static_cast<bf16*>(out), g, relu);
    else
      gemm_fma<EPI, C, G, float><<<grid, C::NT, 0, s>>>(pa, pb, bias, static_cast<float*>(out), g, relu);
  }
}

// Launches the core on `stream` with epilogue mode EPI and returns
// cudaGetLastError() as an int.
template <int EPI, class G>
int launch(const void* a, const void* b, const float* bias, void* out,
           const G& g, int dtype_in, int dtype_out, int relu, int device,
           void* stream) {
  if ((dtype_in != kF32 && dtype_in != kBF16) ||
      (dtype_out != kF32 && dtype_out != kBF16) || g.M <= 0 || g.N <= 0 ||
      g.K < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long big_blocks = (long long)((g.M + BigCfg::BM - 1) / BigCfg::BM) *
                               ((g.N + BigCfg::BN - 1) / BigCfg::BN);
  if (big_blocks >= sms)
    launch_cfg<EPI, BigCfg>(a, b, bias, out, g, dtype_in, dtype_out, relu, s);
  else
    launch_cfg<EPI, SmallCfg>(a, b, bias, out, g, dtype_in, dtype_out, relu, s);
  return (int)cudaGetLastError();
}

}  // namespace vv
