// K1: tiled GEMM with a fused bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces videovector_tpu/ops/pallas/matmul.py `matmul` (kernel body
// `_matmul_kernel`) and `matmul_padded`: out = act(x.w + b), an f32 sum over
// K with bias and ReLU applied once, on the finished sum.
//
// What bounds it on the H100: on this slice's main path (fc6 50x9216x4096,
// fc7 and the tower 50x4096x4096 at batch 50) M is small, so each weight is
// used by only 50 rows: the GEMM is bound by reading w from HBM (75 MB of
// bf16 for fc6), not by the tensor cores. Design: the Pallas kernel's
// sequential K grid axis becomes the loop inside each block, blocks tile
// (M, N) and run in any order; for small M the host picks 64x32 tiles so
// that N alone yields enough blocks to spread the weight stream over the
// SMs. The epilogue runs on the accumulator in registers before the single
// store, as the Pallas kernel's last-K step does, so the activation makes no
// extra trip through HBM. Ragged M/N/K are masked in the tile loads instead
// of zero-padding copies (the port's matmul_padded is this kernel).
#include "gemm_core.cuh"

extern "C" int vv_matmul(const void* x, const void* w, const void* bias,
                         void* out, int M, int N, int K, long long sxm,
                         long long sxk, long long swk, long long swn,
                         long long som, long long son, int dtype_in,
                         int dtype_out, int relu, int device, void* stream) {
  vv::MatGeom g{M, N, K, sxm, sxk, swk, swn, som, son};
  return vv::launch<vv::kEpiK1>(x, w, static_cast<const float*>(bias), out, g,
                                dtype_in, dtype_out, relu, device, stream);
}
