// Caffe's MAX pooling on NHWC activations, padding handled in the kernel.
//
// Replaces no TPU kernel: the JAX package pools with XLA's reduce_window
// (videovector_tpu/ops/pooling.py `max_pool`). The port's plain version
// (ops/pooling.py `max_pool_nhwc_plain`) pads a copy of the input with
// -inf (F.pad), then runs aten's max_pool2d, which also writes an int64
// index per output. On the serving path (GoogLeNet's 13 pools, CaffeNet's
// 3) that chain moved about 4x the bytes the pool needs; this kernel is the
// pool alone. For output pixel (n, oh, ow) and channel c:
//   out[n, oh, ow, c] = max over y in [oh SH - PH, oh SH - PH + KH) ∩ [0, H),
//                                x in [ow SW - PW, ow SW - PW + KW) ∩ [0, W)
//                       of x[n, y, x, c]
// with (OH, OW) Caffe's ceil geometry (the wrapper's `_pool_geometry`), so
// every window starts inside the padded image and the padded region, read
// as -inf by the plain version, never exists. The scan is row-major over
// the window, from -inf, taking v when v > m or v is NaN: aten's rule, so
// the result is the plain version's bit for bit (NaN, -0.0 and all).
//
// What bounds it on the H100: bytes. Each input byte is needed once and
// each output byte written once (GoogLeNet at 50 frames: 287.6 MB in,
// 141.7 MB out, 0.128 ms at 3.35 TB/s). What the design does about it:
// - 16-byte chunks of channels (8 bf16 or f16, 4 f32), neighbouring
//   threads on neighbouring chunks, so a warp's loads and stores are whole
//   16-byte vectors on contiguous addresses. A chunk stays four 32-bit
//   registers from load to store: bf16 and f16 pairs are compared packed
//   (two values an instruction) and selected by mask, so the kernel does
//   few instructions a byte; a thread finds its place with 32-bit
//   divisions.
// - A 3x3 window at stride 1 or 2 (every pool on the serving path) goes by
//   strips: a thread writes one chunk of R consecutive output rows of one
//   column, reads each input row of the strip once (three pixels, all
//   loads unrolled) and folds that row's maximum into the output rows
//   whose windows hold it. A window's rows arrive in order and each row is
//   scanned left to right, so this is the row-major scan. Loads an output:
//   3 (R + 2) / R at stride 1, 3 (2 R + 1) / R at stride 2, against 9 one
//   window a thread; the rest of the rereads hit L1 and L2. The stride
//   fixes R when the kernel is built: 4 at stride 1, where each input row
//   serves three output rows; 1 (the window scanned alone) at stride 2,
//   where windows share one row in three and 4-row strips measured slower
//   on the H100 (PERF.md).
// - Any other window, one chunk a thread over its clipped window; a scalar
//   instantiation (one element a thread) covers C not a multiple of the
//   chunk, a misaligned base or a channel stride other than 1.
// - No padded copy, no index output, no shared memory, no allocation; it
//   launches on the caller's stream.
//
// The same file pools NDHWC clips (I3D's 3D pools, `vv_max_pool_ndhwc`):
// a KT x KH x KW window over (frame, row, column) with the pads before each
// axis given and the output's sizes fixing those after (TF's SAME), each
// window clipped to the clip and scanned frame by frame, each frame
// row-major, as F.max_pool3d scans its -inf padded copy. Bytes bound it as
// in 2D (I3D's 11 such pools at one 250-frame clip: 0.13 ms at 3.35
// TB/s). A 3x3x3 window at stride 1 (the modules' pools, 9 of the 11) goes
// by strips of 4 output frames, each input frame's nine voxels read once a
// strip; any other window one chunk a thread, or one element a thread
// where the chunks are not 16-byte vectors.
#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace vv {
namespace pool {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// One element at a time (the scalar instantiation): m takes v where v > m
// or v is NaN, aten's rule, compared in f32.
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -INFINITY; }
template <> __device__ __forceinline__ __nv_bfloat16 neg_inf<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0xff80);
}
template <> __device__ __forceinline__ __half neg_inf<__half>() {
  return __ushort_as_half(0xfc00);
}

template <typename T>
__device__ __forceinline__ void fold_one(T v, T& m) {
  const float f = as_f32(v);
  if (f > as_f32(m) || isnan(f)) m = v;
}

// A 16-byte chunk as four 32-bit lanes, each one f32 or two bf16 or f16
// values, held as raw bits from load to store. `fold` applies aten's rule
// to a lane: f32 by compare and select; a pair by a packed compare whose
// mask (0xffff per half where v > m or v is NaN) selects v's halves.
template <typename T> struct Lanes;
template <> struct Lanes<float> {
  static constexpr int V = 4;
  static constexpr unsigned kNegInf = 0xff800000u;
  __device__ static void fold(unsigned v, unsigned& m) {
    const float f = __uint_as_float(v);
    if (f > __uint_as_float(m) || isnan(f)) m = v;
  }
};
template <typename P, unsigned NEG_INF>
struct PairLanes {
  static constexpr int V = 8;
  static constexpr unsigned kNegInf = NEG_INF;
  __device__ static void fold(unsigned v, unsigned& m) {
    P a, b;
    memcpy(&a, &v, 4);
    memcpy(&b, &m, 4);
    const unsigned take = __hgt2_mask(a, b) | __hneu2_mask(a, a);
    m = (v & take) | (m & ~take);
  }
};
template <> struct Lanes<__nv_bfloat16> : PairLanes<__nv_bfloat162, 0xff80ff80u> {};
template <> struct Lanes<__half> : PairLanes<__half2, 0xfc00fc00u> {};

struct Geom {
  int H, W, C, OH, OW, KH, KW, SH, SW, PH, PW;
  long long sxn, sxh, sxw, sxc;  // x's element strides
};

// A chunk's running maxima: four lanes.
struct Max4 {
  unsigned w[4];
};

template <typename T>
__device__ __forceinline__ void reset(Max4& m) {
#pragma unroll
  for (int k = 0; k < 4; ++k) m.w[k] = Lanes<T>::kNegInf;
}

template <typename T>
__device__ __forceinline__ void fold(const Max4& v, Max4& m) {
#pragma unroll
  for (int k = 0; k < 4; ++k) Lanes<T>::fold(v.w[k], m.w[k]);
}

// Folds the 16-byte chunk at p into m.
template <typename T>
__device__ __forceinline__ void fold_chunk(const T* __restrict__ p, Max4& m) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  fold<T>(Max4{{q.x, q.y, q.z, q.w}}, m);
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ p, const Max4& m) {
  *reinterpret_cast<uint4*>(p) = make_uint4(m.w[0], m.w[1], m.w[2], m.w[3]);
}

// Every launch is one thread an item, items numbered row by row: a row of
// work is (image n, output row oh) or (n, strip of output rows), its items
// the (ow, chunk) pairs, chunks fastest. Three 32-bit divisions place a
// thread.
struct Place {
  int n, row, ow, c0;
};

__device__ __forceinline__ void place(unsigned i, unsigned items, int cv, int rows, int V,
                                      Place& p) {
  const unsigned r = i / items, j = i - r * items;
  p.n = static_cast<int>(r / rows);
  p.row = static_cast<int>(r - p.n * rows);
  p.ow = static_cast<int>(j / cv);
  p.c0 = static_cast<int>(j - p.ow * cv) * V;
}

// Any window: thread (n, oh, ow, chunk) writes one chunk (V = 1: one
// element) of output pixel (n, oh, ow), scanning its clipped window
// row-major.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    max_pool_nhwc(const T* __restrict__ x, T* __restrict__ out, Geom g, unsigned total) {
  const unsigned i = blockIdx.x * 256u + threadIdx.x;
  if (i >= total) return;
  const int cv = g.C / V;
  Place q;
  place(i, g.OW * cv, cv, g.OH, V, q);
  const int h0 = q.row * g.SH - g.PH, w0 = q.ow * g.SW - g.PW;
  const T* base = x + q.n * g.sxn + q.c0 * g.sxc;
  const int ys = max(h0, 0), ye = min(h0 + g.KH, g.H);
  const int xs = max(w0, 0), xe = min(w0 + g.KW, g.W);
  if constexpr (V > 1) {
    Max4 m;
    reset<T>(m);
    for (int y = ys; y < ye; ++y)
      for (int xx = xs; xx < xe; ++xx) fold_chunk(base + y * g.sxh + xx * g.sxw, m);
    store(out + static_cast<long long>(i) * V, m);
  } else {
    T m = neg_inf<T>();
    for (int y = ys; y < ye; ++y)
      for (int xx = xs; xx < xe; ++xx) fold_one(base[y * g.sxh + xx * g.sxw], m);
    out[i] = m;
  }
}

// A 3x3 window at vertical stride S, on 16-byte chunks: thread (n, strip,
// ow, chunk) writes one chunk of R output rows oh0 .. oh0 + R - 1 of
// column ow. With R = 1 it scans the window row-major. With R > 1 it reads
// each input row of the strip once, (R - 1) S + 3 rows of three pixels,
// and folds each row's maximum into the rows whose windows hold it. A
// window's rows arrive in order and each row's maximum is scanned left to
// right, so every output takes the first of its window's maxima in
// row-major order (the last NaN where there is one), as the row-major scan
// does.
template <typename T, int S, int R>
__global__ void __launch_bounds__(256)
    max_pool_nhwc_rows(const T* __restrict__ x, T* __restrict__ out, Geom g, unsigned total,
                       int strips) {
  constexpr int V = Lanes<T>::V;
  const unsigned i = blockIdx.x * 256u + threadIdx.x;
  if (i >= total) return;
  const int cv = g.C / V;
  Place q;
  place(i, g.OW * cv, cv, strips, V, q);
  const int oh0 = q.row * R;
  const int y0 = oh0 * S - g.PH, w0 = q.ow * g.SW - g.PW;
  const T* base = x + q.n * g.sxn + q.c0;
  Max4 m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) reset<T>(m[r]);
#pragma unroll
  for (int t = 0; t < (R - 1) * S + 3; ++t) {
    const int y = y0 + t;
    if (static_cast<unsigned>(y) >= static_cast<unsigned>(g.H)) continue;
    Max4 h;
    reset<T>(h);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int xx = w0 + b;
      if (static_cast<unsigned>(xx) >= static_cast<unsigned>(g.W)) continue;
      fold_chunk(base + y * g.sxh + xx * g.sxw, R == 1 ? m[0] : h);
    }
    if constexpr (R > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (t >= r * S && t < r * S + 3) fold<T>(h, m[r]);
    }
  }
  T* o = out + ((static_cast<long long>(q.n) * g.OH + oh0) * g.OW + q.ow) * g.C + q.c0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (oh0 + r < g.OH) store(o + static_cast<long long>(r) * g.OW * g.C, m[r]);
}

inline unsigned blocks_for(long long items) { return static_cast<unsigned>((items + 255) / 256); }

// Strips of R = 4 output rows at stride 1, single rows at stride 2.
template <typename T, int S>
cudaError_t launch_rows(const T* x, T* out, const Geom& g, int n, cudaStream_t st) {
  constexpr int R = S == 1 ? 4 : 1;
  const int strips = (g.OH + R - 1) / R;
  const long long total = static_cast<long long>(n) * strips * g.OW * (g.C / Lanes<T>::V);
  max_pool_nhwc_rows<T, S, R><<<blocks_for(total), 256, 0, st>>>(
      x, out, g, static_cast<unsigned>(total), strips);
  return cudaGetLastError();
}

// The 16-byte route where x's chunks are 16-byte vectors (C a multiple of
// the chunk, unit channel stride, aligned base and pixel strides): a 3x3
// window at stride 1 or 2 by strips, any other one chunk a thread; else
// one element a thread.
template <typename T>
cudaError_t launch(const void* xv, void* outv, const Geom& g, int n, cudaStream_t st) {
  constexpr int V = Lanes<T>::V;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const bool vec = g.C % V == 0 && g.sxc == 1 && g.sxn % V == 0 && g.sxh % V == 0 &&
                   g.sxw % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && g.KH == 3 && g.KW == 3 && (g.SH == 1 || g.SH == 2))
    return g.SH == 1 ? launch_rows<T, 1>(x, out, g, n, st)
                     : launch_rows<T, 2>(x, out, g, n, st);
  const long long total = static_cast<long long>(n) * g.OH * g.OW * g.C / (vec ? V : 1);
  const unsigned t = static_cast<unsigned>(total);
  if (vec)
    max_pool_nhwc<T, V><<<blocks_for(total), 256, 0, st>>>(x, out, g, t);
  else
    max_pool_nhwc<T, 1><<<blocks_for(total), 256, 0, st>>>(x, out, g, t);
  return cudaGetLastError();
}

// The 3D pools (NDHWC, I3D's): a window of KT x KH x KW over (frame, row,
// column), each clipped to the clip, scanned frame by frame, each frame
// row-major, as F.max_pool3d scans its padded copy.
struct Geom3 {
  int T, H, W, C, OT, OH, OW, KT, KH, KW, ST, SH, SW, PT, PH, PW;
  long long sxn, sxt, sxh, sxw, sxc;  // x's element strides
};

// Any window: thread (n, ot, oh, ow, chunk) writes one chunk (V = 1: one
// element) of output voxel (n, ot, oh, ow), scanning its clipped window.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    max_pool_ndhwc(const T* __restrict__ x, T* __restrict__ out, Geom3 g, unsigned total) {
  const unsigned i = blockIdx.x * 256u + threadIdx.x;
  if (i >= total) return;
  const int cv = g.C / V;
  Place q;  // q.n: the (image, output frame) pair
  place(i, g.OW * cv, cv, g.OH, V, q);
  const int ot = q.n % g.OT, n = q.n / g.OT;
  const int t0 = ot * g.ST - g.PT, h0 = q.row * g.SH - g.PH, w0 = q.ow * g.SW - g.PW;
  const T* base = x + n * g.sxn + q.c0 * g.sxc;
  const int ts = max(t0, 0), te = min(t0 + g.KT, g.T);
  const int ys = max(h0, 0), ye = min(h0 + g.KH, g.H);
  const int xs = max(w0, 0), xe = min(w0 + g.KW, g.W);
  if constexpr (V > 1) {
    Max4 m;
    reset<T>(m);
    for (int t = ts; t < te; ++t)
      for (int y = ys; y < ye; ++y)
        for (int xx = xs; xx < xe; ++xx)
          fold_chunk(base + t * g.sxt + y * g.sxh + xx * g.sxw, m);
    store(out + static_cast<long long>(i) * V, m);
  } else {
    T m = neg_inf<T>();
    for (int t = ts; t < te; ++t)
      for (int y = ys; y < ye; ++y)
        for (int xx = xs; xx < xe; ++xx)
          fold_one(base[t * g.sxt + y * g.sxh + xx * g.sxw], m);
    out[i] = m;
  }
}

// A 3x3x3 window at stride 1 (the modules' pools), on 16-byte chunks:
// thread (n, strip, oh, ow, chunk) writes one chunk of R consecutive output
// frames ot0 .. ot0 + R - 1 at (oh, ow). It reads each frame of the strip
// once, R + 2 frames of nine voxels, takes that frame's window maximum
// row-major, and folds it into the outputs whose windows hold the frame,
// in frame order: every output takes the first of its window's maxima in
// the scan's order (the last NaN where there is one), as the one-window
// scan does.
template <typename T, int R>
__global__ void __launch_bounds__(256)
    max_pool_ndhwc_frames(const T* __restrict__ x, T* __restrict__ out, Geom3 g,
                          unsigned total, int strips) {
  constexpr int V = Lanes<T>::V;
  const unsigned i = blockIdx.x * 256u + threadIdx.x;
  if (i >= total) return;
  const int cv = g.C / V;
  Place q;  // q.n: the (image, strip) pair
  place(i, g.OW * cv, cv, g.OH, V, q);
  const int strip = q.n % strips, n = q.n / strips;
  const int ot0 = strip * R;
  const int t0 = ot0 - g.PT, h0 = q.row - g.PH, w0 = q.ow - g.PW;
  const T* base = x + n * g.sxn + q.c0;
  Max4 m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) reset<T>(m[r]);
#pragma unroll
  for (int f = 0; f < R + 2; ++f) {
    const int t = t0 + f;
    if (static_cast<unsigned>(t) >= static_cast<unsigned>(g.T)) continue;
    Max4 h;
    reset<T>(h);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int y = h0 + a;
      if (static_cast<unsigned>(y) >= static_cast<unsigned>(g.H)) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int xx = w0 + b;
        if (static_cast<unsigned>(xx) >= static_cast<unsigned>(g.W)) continue;
        fold_chunk(base + t * g.sxt + y * g.sxh + xx * g.sxw, h);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (f >= r && f < r + 3) fold<T>(h, m[r]);
  }
  T* o = out + (((static_cast<long long>(n) * g.OT + ot0) * g.OH + q.row) * g.OW + q.ow) *
                   g.C + q.c0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ot0 + r < g.OT) store(o + static_cast<long long>(r) * g.OH * g.OW * g.C, m[r]);
}

// The 16-byte route where x's chunks are 16-byte vectors: a 3x3x3 window
// at stride 1 by strips of 4 frames, any other one chunk a thread; else
// one element a thread.
template <typename T>
cudaError_t launch3(const void* xv, void* outv, const Geom3& g, int n, cudaStream_t st) {
  constexpr int V = Lanes<T>::V;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const bool vec = g.C % V == 0 && g.sxc == 1 && g.sxn % V == 0 && g.sxt % V == 0 &&
                   g.sxh % V == 0 && g.sxw % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && g.KT == 3 && g.KH == 3 && g.KW == 3 && g.ST == 1 && g.SH == 1 && g.SW == 1) {
    constexpr int R = 4;
    const int strips = (g.OT + R - 1) / R;
    const long long total = static_cast<long long>(n) * strips * g.OH * g.OW * (g.C / V);
    max_pool_ndhwc_frames<T, R><<<blocks_for(total), 256, 0, st>>>(
        x, out, g, static_cast<unsigned>(total), strips);
    return cudaGetLastError();
  }
  const long long total =
      static_cast<long long>(n) * g.OT * g.OH * g.OW * g.C / (vec ? V : 1);
  const unsigned t = static_cast<unsigned>(total);
  if (vec)
    max_pool_ndhwc<T, V><<<blocks_for(total), 256, 0, st>>>(x, out, g, t);
  else
    max_pool_ndhwc<T, 1><<<blocks_for(total), 256, 0, st>>>(x, out, g, t);
  return cudaGetLastError();
}

}  // namespace pool
}  // namespace vv

// x (N, H, W, C) of `dtype` (0 f32, 1 bf16, 2 f16) with element strides
// sxn, sxh, sxw, sxc; out (N, OH, OW, C) contiguous, of the same type, OH
// and OW from the caller's ceil geometry. Returns a CUDA error code as an
// int.
extern "C" int vv_max_pool_nhwc(const void* x, void* out, int N, int H, int W, int C,
                                int OH, int OW, int KH, int KW, int SH, int SW, int PH,
                                int PW, long long sxn, long long sxh, long long sxw,
                                long long sxc, int dtype, int device, void* stream) {
  using namespace vv::pool;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || OH <= 0 || OW <= 0 || KH <= 0 ||
      KW <= 0 || SH <= 0 || SW <= 0 || PH < 0 || PW < 0 ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(N) * OH * OW * C >= 0x7fffffffLL)  // items fit an int
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom g{H, W, C, OH, OW, KH, KW, SH, SW, PH, PW, sxn, sxh, sxw, sxc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(x, out, g, N, st));
  if (dtype == kF16) return static_cast<int>(launch<__half>(x, out, g, N, st));
  return static_cast<int>(launch<float>(x, out, g, N, st));
}

// x (N, T, H, W, C) of `dtype` (0 f32, 1 bf16, 2 f16) with element strides
// sxn, sxt, sxh, sxw, sxc; out (N, OT, OH, OW, C) contiguous, of the same
// type. PT, PH, PW are the pads before each axis; the output sizes, from
// the caller's geometry, fix the pads after. Every window is clipped to
// the clip. Returns a CUDA error code as an int.
extern "C" int vv_max_pool_ndhwc(const void* x, void* out, int N, int T, int H, int W,
                                 int C, int OT, int OH, int OW, int KT, int KH, int KW,
                                 int ST, int SH, int SW, int PT, int PH, int PW,
                                 long long sxn, long long sxt, long long sxh,
                                 long long sxw, long long sxc, int dtype, int device,
                                 void* stream) {
  using namespace vv::pool;
  if (N <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || OT <= 0 || OH <= 0 || OW <= 0 ||
      KT <= 0 || KH <= 0 || KW <= 0 || ST <= 0 || SH <= 0 || SW <= 0 || PT < 0 ||
      PH < 0 || PW < 0 || PT >= KT || PH >= KH || PW >= KW ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(N) * OT * OH * OW * C >= 0x7fffffffLL)  // items fit an int
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom3 g{T, H, W, C, OT, OH, OW, KT, KH, KW, ST, SH, SW, PT, PH, PW,
                sxn, sxt, sxh, sxw, sxc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return static_cast<int>(launch3<__nv_bfloat16>(x, out, g, N, st));
  if (dtype == kF16) return static_cast<int>(launch3<__half>(x, out, g, N, st));
  return static_cast<int>(launch3<float>(x, out, g, N, st));
}
