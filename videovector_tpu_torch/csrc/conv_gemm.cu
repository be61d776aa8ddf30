// K2: convolution as an implicit GEMM, for Hopper (sm_90a).
//
// Replaces videovector_tpu/ops/pallas/conv_gemm.py `conv2d_im2col_gemm`,
// which writes the im2col patch matrix (ops/conv.py `im2col`) to memory and
// then runs the Pallas GEMM over it.
//
// What bounds it on the H100: the patch matrix. CaffeNet's conv1 (11x11,
// stride 4) expands each pixel about 7.6 times; at batch 50 the patches of
// conv1 alone are 151,250 x 363 values, and writing then re-reading them
// would cost more HBM traffic than the convolution's own input and output.
// Design: no patch matrix exists. Each block gathers its A tile directly
// from the image by index arithmetic (gemm_core.cuh ConvGeom), with zero
// fill for the padding, and shares the GEMM core and epilogue with K1. The
// reduction runs with the channel innermost so that NHWC images are read
// along contiguous memory. All tensors are addressed through strides, so
// the caller passes NHWC/HWIO tensors, or one group's channel slice of
// them, without transposes; a grouped conv is one launch per group.
#include "gemm_core.cuh"

extern "C" int vv_conv_gemm(const void* x, const void* w, const void* bias,
                            void* out, int N, int C, int H, int W, int O,
                            int KH, int KW, int SH, int SW, int PH, int PW,
                            int OH, int OW, long long sxn, long long sxc,
                            long long sxh, long long sxw, long long swo,
                            long long swc, long long swh, long long sww,
                            long long son, long long soc, long long soh,
                            long long sow, int dtype_in, int dtype_out,
                            int relu, int device, void* stream) {
  vv::ConvGeom g;
  g.M = N * OH * OW;
  g.N = O;
  g.K = C * KH * KW;
  g.C = C;
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
  g.sxc = sxc;
  g.sxh = sxh;
  g.sxw = sxw;
  g.swc = swc;
  g.swh = swh;
  g.sww = sww;
  g.sbn = swo;
  g.son_batch = son;
  g.son = soc;
  g.soh = soh;
  g.sow = sow;
  return vv::launch<vv::kEpiConv>(x, w, static_cast<const float*>(bias), out, g,
                                  dtype_in, dtype_out, relu, device, stream);
}
