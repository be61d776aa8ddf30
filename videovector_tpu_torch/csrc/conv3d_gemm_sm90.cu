// K2's depth axis: a one-launch implicit-GEMM 3D convolution on NDHWC
// activations and DHWIO weights, with cp.async im2col gathers, TMA weights
// and wgmma (sm_90a), for I3D's 3x3x3 convs (models/i3d.py).
//
// Replaces no TPU kernel: the JAX package has no 3D conv (its K2,
// videovector_tpu/ops/pallas/conv_gemm.py `conv2d_im2col_gemm`, is 2D). It
// is K2's sm90 kernel (conv_gemm_sm90.cuh, shared with conv_gemm_sm90.cu)
// instantiated with DEEP = true. For output voxel m = (n, ot, oy, ox) and
// output channel o:
//   out[m, o] = conv_epilogue(sum_{d,i,j,c} x[n, ot st - pt + d,
//                             oy sh - ph + i, ox sw - pw + j, c] w[d, i, j, c, o])
// with an f32 sum, padding read as zero, and K2's epilogue (round, add the
// rounded bias, round, ReLU). Only the pads before each axis enter the
// addresses: the output sizes the wrapper passes fix the pads after, so
// TF's SAME padding (one more after than before where the total is odd)
// costs nothing.
//
// What bounds it on the H100. At one 250-frame clip I3D's 19 3x3x3 convs
// are 606 GFLOP against 0.43 GB of HBM traffic: the tensor cores bound
// every one of them (0.61 ms at 989 TFLOP/s). K = 27 C, so the implicit A
// matrix is 27 times the input, whose rereads hit L2.
//
// What the design does about it: the 2D kernel's, with the depth tap in the
// gathers. The reduction runs in (d, i, j, c) order, the order of DHWIO
// weights flattened to a (KT KH KW C, O) matrix, so one TMA map serves the
// weights as it does in 2D; a producer decomposes each row into (n, ot, oy,
// ox) once and each 16-byte chunk's k into (d, i, j, c) once a stage, and
// masks frames outside the clip as it masks rows and columns outside the
// image. No patch matrix and no per-tap launches. The DEEP branches are
// `if constexpr`, so the 2D instantiation that CaffeNet and GoogLeNet run
// is the code it was.
//
// Conv1 (7x7x7, stride 2 on every axis, over 3 channels: 6 bytes a voxel,
// which a 16-byte gather cannot address) is repacked first by
// `space_to_depth_3d` below: each 2x2x2 block of the padded clip becomes
// one voxel of 24 channels, and the kernel a 4x4x4 stride-1 conv over
// them, padding read as zero inside the repack.
#include "conv_gemm_sm90.cuh"

namespace vv {
namespace conv90 {

// The 3D space-to-depth repack of a stride-s conv (the wrapper's
// `space_to_depth_3d`, whose plain version says what it computes), in one
// launch: threads [0, x_chunks) write one 16-byte chunk of xs each, the rest
// one element of ws. xs[n, bt, bi, bj, ((a s + b) s + c') C + c] = x[n, bt s
// + a - PT, bi s + b - PH, bj s + c' - PW, c] and ws[bt, bi, bj, ((a s + b) s
// + c') C + c, o] = w[bt s + a, bi s + b, bj s + c', c, o], zero past the
// clip or the kernel. A repacked voxel has E channels, s^3 C rounded up to a
// 16-byte chunk; the channels past s^3 C are zero in both. All four tensors
// contiguous, of type T.
template <typename T>
__global__ void space_to_depth_3d(const T* __restrict__ x, const T* __restrict__ w,
                                  T* __restrict__ xs, T* __restrict__ ws, int D, int H,
                                  int W, int C, int O, int k, int s, int PT, int PH,
                                  int PW, int TB, int HB, int WB, int KB, int E,
                                  long long x_chunks, long long total) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte chunk; E % V == 0
  const int EC = s * s * s * C;      // channels of a block that hold voxels
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < x_chunks) {
      const long long p = i / (E / V);  // repacked voxel (n, bt, bi, bj)
      const int e0 = static_cast<int>(i - p * (E / V)) * V;
      const int bj = static_cast<int>(p % WB);
      long long t = p / WB;
      const int bi = static_cast<int>(t % HB);
      t /= HB;
      const int bt = static_cast<int>(t % TB);
      const long long n = t / TB;
      alignas(16) T v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = e0 + u;
        const int c = e % C, abc = e / C;
        const int tt = bt * s + abc / (s * s) - PT;
        const int y = bi * s + abc / s % s - PH, xx = bj * s + abc % s - PW;
        v[u] = e < EC && static_cast<unsigned>(tt) < static_cast<unsigned>(D) &&
                       static_cast<unsigned>(y) < static_cast<unsigned>(H) &&
                       static_cast<unsigned>(xx) < static_cast<unsigned>(W)
                   ? x[(((n * D + tt) * H + y) * W + xx) * C + c]
                   : zero<T>();
      }
      *reinterpret_cast<uint4*>(xs + p * E + e0) = *reinterpret_cast<const uint4*>(v);
    } else {
      const long long j = i - x_chunks;  // ws element (bt, bi, bj, e, o)
      const int o = static_cast<int>(j % O);
      long long t = j / O;
      const int e = static_cast<int>(t % E);
      t /= E;
      const int bj = static_cast<int>(t % KB);
      t /= KB;
      const int bi = static_cast<int>(t % KB), bt = static_cast<int>(t / KB);
      const int c = e % C, abc = e / C;
      const int tt = bt * s + abc / (s * s), y = bi * s + abc / s % s, xx = bj * s + abc % s;
      ws[j] = e < EC && tt < k && y < k && xx < k
                  ? w[(((static_cast<long long>(tt) * k + y) * k + xx) * C + c) * O + o]
                  : zero<T>();
    }
  }
}

}  // namespace conv90
}  // namespace vv

// x (N, T, H, W, C) bf16 with unit channel stride and element strides sxn,
// sxt, sxh, sxw; w (KT, KH, KW, C, O) bf16, contiguous; bias f32 (O) or
// null; out (N, OT, OH, OW, O) contiguous, f32 or bf16; one group. PT, PH,
// PW are the pads before each axis; OT, OH, OW the output's sizes. block_m
// (64 or 128) and block_n (64, 96, 128 or 192) come from the wrapper's plan.
// Returns a CUDA error code as an int.
extern "C" int vv_conv3d_gemm_sm90(const void* x, const void* w, const void* bias,
                                   void* out, int N, int T, int H, int W, int C, int O,
                                   int KT, int KH, int KW, int ST, int SH, int SW,
                                   int PT, int PH, int PW, int OT, int OH, int OW,
                                   long long sxn, long long sxt, long long sxh,
                                   long long sxw, int block_m, int block_n,
                                   int dtype_out, int relu, int device, void* stream) {
  using namespace vv::conv90;
  const long long m = static_cast<long long>(N) * OT * OH * OW;
  const long long k = static_cast<long long>(KT) * KH * KW * C;
  Geom g{};
  g.M = static_cast<int>(m);
  g.K = static_cast<int>(k);
  g.Cg = C;
  g.Og = O;
  g.O = O;
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
  g.T = T;
  g.OT = OT;
  g.ST = ST;
  g.PT = PT;
  g.KHW = KH * KW;
  g.sxt = sxt;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 8 == 0 && sxn % 8 == 0 &&
                       sxt % 8 == 0 && sxh % 8 == 0 && sxw % 8 == 0;
  const bool bn_ok = block_n == 64 || block_n == 96 || block_n == 128 || block_n == 192;
  if (N <= 0 || T <= 0 || OT <= 0 || OH <= 0 || OW <= 0 || KT <= 0 || KH <= 0 ||
      KW <= 0 || ST <= 0 || SH <= 0 || SW <= 0 || PT < 0 || PH < 0 || PW < 0 ||
      m > INT_MAX || k > INT_MAX || C % 8 != 0 || O % 8 != 0 || !aligned || !bn_ok ||
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
             ? run<vv::bf16, true>(tw, xb, b, out, g, 1, block_m, block_n, relu, s)
             : run<float, true>(tw, xb, b, out, g, 1, block_m, block_n, relu, s);
}

// x (N, T, H, W, C) and w (k, k, k, C, O) contiguous, both bf16 (dtype 1) or
// both f32 (dtype 0), for a stride-s conv with the pads PT, PH, PW before
// each axis -> xs (N, TB, HB, WB, E) and ws (KB, KB, KB, E, O) of the same
// type, KB = ceil(k / s), TB = the conv's output frames + KB - 1 (HB, WB
// likewise), E = s^3 C rounded up to a 16-byte chunk (8 bf16, 4 f32).
// Returns a CUDA error code as an int.
extern "C" int vv_space_to_depth_3d(const void* x, const void* w, void* xs, void* ws,
                                    int N, int T, int H, int W, int C, int O, int k,
                                    int s, int PT, int PH, int PW, int TB, int HB,
                                    int WB, int dtype, int device, void* stream) {
  const int vec = dtype == vv::kBF16 ? 8 : 4;
  const int kb = (k + s - 1) / s;
  if (N <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || k <= 0 || s <= 0 ||
      PT < 0 || PH < 0 || PW < 0 || TB < kb || HB < kb || WB < kb ||
      (dtype != vv::kBF16 && dtype != vv::kF32) ||
      reinterpret_cast<uintptr_t>(xs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int e = (s * s * s * C + vec - 1) / vec * vec;
  const long long x_chunks = static_cast<long long>(N) * TB * HB * WB * (e / vec);
  const long long total = x_chunks + static_cast<long long>(kb) * kb * kb * e * O;
  const int blocks = static_cast<int>(std::min((total + 255) / 256, 16LL * sms));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vv::kBF16)
    vv::conv90::space_to_depth_3d<vv::bf16><<<blocks, 256, 0, st>>>(
        static_cast<const vv::bf16*>(x), static_cast<const vv::bf16*>(w),
        static_cast<vv::bf16*>(xs), static_cast<vv::bf16*>(ws), T, H, W, C, O, k, s, PT,
        PH, PW, TB, HB, WB, kb, e, x_chunks, total);
  else
    vv::conv90::space_to_depth_3d<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(xs), static_cast<float*>(ws), T, H, W, C, O, k, s, PT, PH,
        PW, TB, HB, WB, kb, e, x_chunks, total);
  return static_cast<int>(cudaGetLastError());
}
