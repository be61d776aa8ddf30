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
// kEpiConv: round, add the rounded bias, round, ReLU). f32 operands with an
// f32 output take conv_gemm_f32_sm90.cu, every other K2 call (odd strides,
// f32 in with bf16 out) the core (conv_gemm.cu); the wrapper
// ops/hopper/conv_gemm.py picks the route from the operands, and repacks a
// strided conv over 3 channels (6 bytes a pixel, which neither a 16-byte copy
// nor TMA can address) by space-to-depth: CaffeNet's conv1 into a 3x3 conv
// over 48 channels, GoogLeNet's (7x7/2, pad 3) into a 4x4 conv over 16.
//
// What bounds it on the H100. At batch 50 CaffeNet's convs are 66.6 GFLOP
// over about 110 MB of HBM traffic (inputs, weights and outputs each once):
// conv2..conv5 are bound by the tensor cores (7.6 to 22.6 us each at 989
// TFLOP/s bf16), conv1 by memory (13.3 us at 3.35 TB/s). The implicit A
// matrix is K/C times the image (9 to 25 taps), so the gathers read every
// pixel several times; those reads hit L2 (the largest image, conv1's
// repacked input, is 15.6 MB against 50 MB of L2).
//
// What the design does about it (the kernel, conv_wgmma, is in
// conv_gemm_sm90.cuh, which conv3d_gemm_sm90.cu shares for 3D convs):
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
//   below) that writes x and w in the repacked layouts, 16 bytes a thread,
//   reading the conv's padding and the chunk's spare channels as zero.
// PERF.md (section 6) has the measured times against these bounds and what
// holds the kernel back from them.
#include "conv_gemm_sm90.cuh"

namespace vv {
namespace conv90 {

// The space-to-depth repack of a stride-s conv padded by P (the wrapper's
// `space_to_depth`, whose plain version says what it computes), in one
// launch: threads [0, x_chunks) write one 16-byte chunk of xs each, the rest
// one element of ws. xs[n, bi, bj, (a s + b) C + c] = x[n, bi s + a - P,
// bj s + b - P, c] and ws[bi, bj, (a s + b) C + c, o] = w[bi s + a, bj s + b,
// c, o], zero past the image or the kernel: the padding is read as zero
// here, so no padded copy of x is made. A repacked pixel has E channels, s s
// C rounded up to a 16-byte chunk; the channels past s s C are zero in both.
// All four tensors contiguous, of type T: bf16 for this route, f32 for
// conv_gemm_f32_sm90.cu's.
template <typename T>
__global__ void space_to_depth(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ xs, T* __restrict__ ws, int H, int W,
                               int C, int O, int k, int s, int P, int HB, int WB,
                               int KB, int E, long long x_chunks, long long total) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte chunk; E % V == 0
  const int EC = s * s * C;          // channels of a block that hold pixels
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < x_chunks) {
      const long long p = i / (E / V);  // repacked pixel (n, bi, bj)
      const int e0 = static_cast<int>(i - p * (E / V)) * V;
      const int bj = static_cast<int>(p % WB);
      const long long t = p / WB;
      const int bi = static_cast<int>(t % HB);
      const long long n = t / HB;
      alignas(16) T v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = e0 + u;
        const int c = e % C, ab = e / C;
        const int y = bi * s + ab / s - P, xx = bj * s + ab % s - P;
        v[u] = e < EC && static_cast<unsigned>(y) < static_cast<unsigned>(H) &&
                       static_cast<unsigned>(xx) < static_cast<unsigned>(W)
                   ? x[((n * H + y) * W + xx) * C + c]
                   : zero<T>();
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
      ws[j] = e < EC && y < k && xx < k ? w[((y * k + xx) * C + c) * O + o] : zero<T>();
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
  Geom g{};
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
             ? run<vv::bf16, false>(tw, xb, b, out, g, groups, block_m, block_n, relu, s)
             : run<float, false>(tw, xb, b, out, g, groups, block_m, block_n, relu, s);
}

// x (N, H, W, C) and w (k, k, C, O) contiguous, both bf16 (dtype 1) or both
// f32 (dtype 0), for a stride-s conv padded by pad on every side -> xs (N,
// HB, WB, E) and ws (KB, KB, E, O) of the same type, KB = ceil(k / s), HB =
// (H + 2 pad - k) / s + KB (WB likewise), E = s s C rounded up to a 16-byte
// chunk (8 bf16, 4 f32). Returns a CUDA error code as an int.
extern "C" int vv_space_to_depth(const void* x, const void* w, void* xs, void* ws,
                                 int N, int H, int W, int C, int O, int k, int s,
                                 int pad, int dtype, int device, void* stream) {
  const int vec = dtype == vv::kBF16 ? 8 : 4;
  if (N <= 0 || C <= 0 || O <= 0 || k <= 0 || s <= 0 || pad < 0 ||
      H + 2 * pad < k || W + 2 * pad < k ||
      (dtype != vv::kBF16 && dtype != vv::kF32) ||
      reinterpret_cast<uintptr_t>(xs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int kb = (k + s - 1) / s;
  const int hb = (H + 2 * pad - k) / s + kb, wb = (W + 2 * pad - k) / s + kb;
  const int e = (s * s * C + vec - 1) / vec * vec;
  const long long x_chunks = static_cast<long long>(N) * hb * wb * (e / vec);
  const long long total = x_chunks + static_cast<long long>(kb) * kb * e * O;
  const int blocks = static_cast<int>(std::min((total + 255) / 256, 16LL * sms));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vv::kBF16)
    vv::conv90::space_to_depth<vv::bf16><<<blocks, 256, 0, st>>>(
        static_cast<const vv::bf16*>(x), static_cast<const vv::bf16*>(w),
        static_cast<vv::bf16*>(xs), static_cast<vv::bf16*>(ws), H, W, C, O, k, s, pad,
        hb, wb, kb, e, x_chunks, total);
  else
    vv::conv90::space_to_depth<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(xs), static_cast<float*>(ws), H, W, C, O, k, s, pad, hb,
        wb, kb, e, x_chunks, total);
  return static_cast<int>(cudaGetLastError());
}
