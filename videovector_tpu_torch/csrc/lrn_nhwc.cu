// Caffe's cross-channel LRN on NHWC activations, in one pass over x.
//
// Replaces no TPU kernel: the JAX package computes the LRN with XLA's
// elementwise ops and shifted adds (videovector_tpu/ops/lrn.py
// `lrn_cross_channel`). The port's plain version (ops/lrn.py
// `lrn_nhwc_plain`) squares x, pads a copy of the squares with zeros along
// C (F.pad), adds `size` channel-shifted views of it (strided, so aten's
// non-vectorised loop), then scales, raises to -beta and multiplies: on
// the serving path (GoogLeNet's two LRNs, CaffeNet's two) some ten passes
// over the tensor, each rounding to x's type. This kernel is Caffe's
// lrn_layer.cpp, for pixel p and channel c:
//   s = sum over j in [c - size/2, c + size - 1 - size/2] ∩ [0, C) of x[p, j]^2
//   y[p, c] = x[p, c] * (1 + (alpha / size) s)^-beta
// in f32: the squares, the sum (in the window's order, as the plain
// version adds its shifted views; a clipped channel adds nothing) and the
// scale are the plain version's f32 operations, rounded as it rounds them;
// the power is exp2(-beta log2(scale)) on the SFU; y is rounded to x's
// type once.
//
// What bounds it on the H100: bytes. Each input byte is read once and each
// output byte written once (GoogLeNet's two at 50 frames: 80.3 MB in, 80.3
// MB out, 0.048 ms at 3.35 TB/s). What the design does about it:
// - A block holds whole pixels, one 16-byte chunk of channels (8 bf16 or
//   f16, 4 f32) a thread, chunks fastest, so a warp's loads and stores are
//   whole 16-byte vectors on contiguous addresses, and x is read once.
// - A chunk's window reaches size/2 channels into each neighbouring chunk
//   of its pixel: each thread leaves its chunk in a shared-memory row and
//   takes its neighbours' from there, so no chunk is read twice from
//   device memory. This holds while size/2 is at most a chunk (size up to
//   17 in bf16 and f16, 9 in f32).
// - The window's size is a template argument (every odd size up to that
//   limit, picked at launch), so the window's squares stay in registers
//   and its sums unroll: a handful of instructions an element and two SFU
//   operations, far below what the card issues at the bytes' rate.
// - Anything else (C not a multiple of the chunk, a misaligned base or
//   pixel stride, a channel stride other than 1, a larger window, 2^31
//   pixels or more): a scalar kernel, one element a thread, its window read
//   from x (the rereads hit L1), 64-bit indices throughout.
// - No padded copy, no intermediate tensor, no allocation; it launches on
//   the caller's stream.
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace vv {
namespace lrn {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;

struct Geom {
  int H, W, C;
  long long sxn, sxh, sxw, sxc;  // x's element strides
  float a;                       // alpha / size
  float nbeta;                   // -beta
};

// y = x * (1 + a s)^-beta, with 1 + a s rounded as the plain version's two
// f32 operations round it.
__device__ __forceinline__ float normalized(float x, float s, const Geom& g) {
  const float scale = __fadd_rn(1.f, __fmul_rn(g.a, s));
  return __fmul_rn(x, exp2f(g.nbeta * __log2f(scale)));
}

__device__ __forceinline__ float square(float v) { return __fmul_rn(v, v); }

// A 16-byte chunk as V values in f32 and back, rounded once to T.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 p) { return __bfloat1622float2(p); }
__device__ __forceinline__ float2 to_float2(__half2 p) { return __half22float2(p); }
template <typename P> __device__ __forceinline__ P from_floats(float a, float b);
template <> __device__ __forceinline__ __nv_bfloat162 from_floats(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ __half2 from_floats(float a, float b) {
  return __floats2half2_rn(a, b);
}
// bf16 and f16: four 32-bit words of two values each.
template <typename P> struct PairChunk {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& q, float* f) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      P p;
      memcpy(&p, &w[k], 4);
      const float2 v = to_float2(p);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const P p = from_floats<P>(f[2 * k], f[2 * k + 1]);
      memcpy(&w[k], &p, 4);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Chunk<__nv_bfloat16> : PairChunk<__nv_bfloat162> {};
template <> struct Chunk<__half> : PairChunk<__half2> {};

// Thread t of a block of P pixels x cv chunks writes chunk j = t % cv of
// pixel blockIdx.x P + t / cv. sq holds the squares of its window's
// channels: HALF of the chunk before, the chunk's V, HALF of the chunk
// after (zeros past either end of the pixel's channels, as the plain
// version's zero pad).
template <typename T, int SIZE>
__global__ void __launch_bounds__(kThreads)
    lrn_nhwc_chunks(const T* __restrict__ x, T* __restrict__ out, Geom g, int cv, int pixels,
                    unsigned npix) {
  using K = Chunk<T>;
  constexpr int V = K::V, HALF = SIZE / 2;
  __shared__ uint4 row[kThreads];
  const int t = threadIdx.x;
  const int p = t / cv, j = t - p * cv;
  const unsigned pix = blockIdx.x * static_cast<unsigned>(pixels) + p;
  const bool live = pix < npix;
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    const unsigned hw = static_cast<unsigned>(g.H) * g.W;
    const unsigned n = pix / hw, r = pix - n * hw;
    const unsigned h = r / g.W, w = r - h * g.W;
    q = __ldg(reinterpret_cast<const uint4*>(x + n * g.sxn + h * g.sxh + w * g.sxw) + j);
  }
  row[t] = q;
  __syncthreads();
  if (!live) return;
  float xs[V], sq[HALF + V + HALF];
  K::unpack(q, xs);
#pragma unroll
  for (int k = 0; k < V; ++k) sq[HALF + k] = square(xs[k]);
  if constexpr (HALF > 0) {
    float nb[V];
    if (j > 0) {
      K::unpack(row[t - 1], nb);
#pragma unroll
      for (int k = 0; k < HALF; ++k) sq[k] = square(nb[V - HALF + k]);
    } else {
#pragma unroll
      for (int k = 0; k < HALF; ++k) sq[k] = 0.f;
    }
    if (j < cv - 1) {
      K::unpack(row[t + 1], nb);
#pragma unroll
      for (int k = 0; k < HALF; ++k) sq[HALF + V + k] = square(nb[k]);
    } else {
#pragma unroll
      for (int k = 0; k < HALF; ++k) sq[HALF + V + k] = 0.f;
    }
  }
  float y[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float s = sq[k];
#pragma unroll
    for (int o = 1; o < SIZE; ++o) s += sq[k + o];
    y[k] = normalized(xs[k], s, g);
  }
  reinterpret_cast<uint4*>(out + static_cast<long long>(pix) * g.C)[j] = K::pack(y);
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_as(float v, __half* p) { *p = __float2half_rn(v); }

// One element a thread, grid-strided: element e of the contiguous output
// sums its clipped window, read from x by its strides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrn_nhwc_scalar(const T* __restrict__ x, T* __restrict__ out, Geom g, int size,
                    long long total) {
  const long long hw = static_cast<long long>(g.H) * g.W;
  const int half = size / 2;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long pix = e / g.C;
    const int c = static_cast<int>(e - pix * g.C);
    const long long n = pix / hw, r = pix - n * hw;
    const long long h = r / g.W, w = r - h * g.W;
    const T* base = x + n * g.sxn + h * g.sxh + w * g.sxw;
    float s = 0.f;
    for (int o = 0; o < size; ++o) {
      const int ch = c - half + o;
      if (ch >= 0 && ch < g.C) s += square(as_f32(base[ch * g.sxc]));
    }
    store_as(normalized(as_f32(base[c * g.sxc]), s, g), out + e);
  }
}

// The chunk kernel at window size SIZE, or the next odd size up to the
// chunk's limit.
template <typename T, int SIZE>
cudaError_t launch_chunks(const T* x, T* out, const Geom& g, int size, unsigned npix,
                          cudaStream_t st) {
  if constexpr (SIZE < 2 * Chunk<T>::V + 1) {
    if (size != SIZE) return launch_chunks<T, SIZE + 2>(x, out, g, size, npix, st);
  }
  const int cv = g.C / Chunk<T>::V;
  const int pixels = kThreads / cv;
  const unsigned blocks = (npix + pixels - 1) / pixels;
  lrn_nhwc_chunks<T, SIZE><<<blocks, pixels * cv, 0, st>>>(x, out, g, cv, pixels, npix);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, void* outv, const Geom& g, int N, int size, cudaStream_t st) {
  constexpr int V = Chunk<T>::V;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const long long npix = static_cast<long long>(N) * g.H * g.W;
  const bool chunks = g.C % V == 0 && g.C / V <= kThreads && size <= 2 * V + 1 &&
                      g.sxc == 1 && g.sxn % V == 0 && g.sxh % V == 0 && g.sxw % V == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 && npix <= INT_MAX;
  if (chunks) return launch_chunks<T, 1>(x, out, g, size, static_cast<unsigned>(npix), st);
  const long long total = npix * g.C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  lrn_nhwc_scalar<T><<<static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20)), kThreads,
                       0, st>>>(x, out, g, size, total);
  return cudaGetLastError();
}

}  // namespace lrn
}  // namespace vv

// x (N, H, W, C) of `dtype` (0 f32, 1 bf16, 2 f16) with element strides
// sxn, sxh, sxw, sxc; out (N, H, W, C) contiguous, of the same type. `size`
// is the window (odd), `alpha_over_size` alpha / size and `beta` the power,
// as Caffe's LRNParameter gives them. Returns a CUDA error code as an int.
extern "C" int vv_lrn_nhwc(const void* x, void* out, int N, int H, int W, int C,
                           long long sxn, long long sxh, long long sxw, long long sxc, int size,
                           float alpha_over_size, float beta, int dtype, int device,
                           void* stream) {
  using namespace vv::lrn;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || size <= 0 || size % 2 != 1 ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom g{H, W, C, sxn, sxh, sxw, sxc, alpha_over_size, -beta};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(x, out, g, N, size, st));
  if (dtype == kF16) return static_cast<int>(launch<__half>(x, out, g, N, size, st));
  return static_cast<int>(launch<float>(x, out, g, N, size, st));
}
