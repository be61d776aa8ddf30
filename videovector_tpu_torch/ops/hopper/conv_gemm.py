"""K2: convolution as an implicit GEMM (CUDA C++ for sm_90a).

Counterpart of videovector_tpu/ops/pallas/conv_gemm.py. The kernel is
csrc/conv_gemm.cu on the GEMM core K1 uses (csrc/gemm_core.cuh); its source
note says what bounds it on the H100. Unlike the Pallas path, no patch
matrix is written: the kernel gathers patches while it loads its tiles.

Two entry points share the kernel and its launch count,
`conv2d_im2col_gemm.launches`:
- `conv2d_im2col_gemm`: the JAX signature (NCHW/OIHW, f32 out, no groups);
- `conv2d_gemm_nhwc`: MedNet's conv (NHWC/HWIO, groups as one launch per
  group on channel-slice views, bias + ReLU epilogue, chosen out dtype).
The epilogue is MedNet's (`conv_epilogue_plain`), not K1's: a bf16 output
rounds the sum, adds the rounded bias, rounds again, then applies ReLU.
Each runs its plain version (`*_plain`: im2col + matmul) for CPU tensors and
launches the kernel for CUDA tensors; on any other device it raises.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch import _build
from videovector_tpu_torch.ops.conv import im2col
from videovector_tpu_torch.ops.hopper.matmul import (
    DTYPE_CODES, INT_MAX, bias_f32, check_cuda_operands, dtype_code,
)


def conv_epilogue_plain(acc: torch.Tensor, b: torch.Tensor | None,
                        fuse_relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """K2's epilogue on an f32 sum, as models/mednet.py's bf16 conv: round
    to out_dtype, add the bias rounded to out_dtype, ReLU (the f32 case is
    act(acc + b), as K1's)."""
    y = acc.to(out_dtype)
    if b is not None:
        y = y + b.to(out_dtype)
    return torch.relu(y) if fuse_relu else y


def _out_hw(h, w, kh, kw, stride, pad):
    oh = (h + 2 * pad[0] - kh) // stride[0] + 1
    ow = (w + 2 * pad[1] - kw) // stride[1] + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv output would be empty: ({h},{w}) k=({kh},{kw})")
    return oh, ow


def _check(x, w, groups, out_dtype):
    """x: (N, C, H, W) and w: (O, C/groups, kh, kw), as logical views."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv wants 4-D x and w, got {tuple(x.shape)}, {tuple(w.shape)}")
    c, o = x.shape[1], w.shape[0]
    if c % groups or o % groups or w.shape[1] != c // groups:
        raise ValueError(f"channels {c} -> {o} with groups={groups} do not "
                         f"fit weight {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"x and w dtypes differ: {x.dtype} vs {w.dtype}")
    dtype_code(x.dtype, "x")
    dtype_code(out_dtype, "out_dtype")


def _conv_plain(x, w, b, stride, pad, groups, fuse_relu, out_dtype):
    """Plain K2 on logical NCHW/OIHW views: im2col + f32 matmul per group."""
    _check(x, w, groups, out_dtype)
    n, _, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh, ow = _out_hw(h, wd, kh, kw, stride, pad)
    cols = im2col(x.float(), kernel=(kh, kw), stride=stride, pad=pad)
    ck, og = cg * kh * kw, o // groups
    outs = []
    for g in range(groups):
        lhs = cols[:, g * ck:(g + 1) * ck].permute(0, 2, 3, 1).reshape(-1, ck)
        rhs = w[g * og:(g + 1) * og].float().reshape(og, ck).T
        bg = None if b is None else b[g * og:(g + 1) * og]
        outs.append(conv_epilogue_plain(lhs @ rhs, bg, fuse_relu,
                                        out_dtype).reshape(n, oh, ow, og))
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2)


def _conv_kernel(x, w, b, out, stride, pad, groups, fuse_relu):
    """Launches K2 once per group on logical NCHW/OIHW/NCHW views (any
    strides), writing each group's channel slice of `out`."""
    check_cuda_operands(x, w, b, out)
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh, ow = out.shape[2], out.shape[3]
    if max(n * oh * ow, cg * kh * kw, o) > INT_MAX:
        raise ValueError("conv GEMM dims beyond int32")
    if out.numel() == 0:
        return out
    og = o // groups
    bias = bias_f32(b, o)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg]
        wg = w[g * og:(g + 1) * og]
        outg = out[:, g * og:(g + 1) * og]
        bg = None if bias is None else bias[g * og:(g + 1) * og]
        rc = lib.vv_conv_gemm(
            xg.data_ptr(), wg.data_ptr(), bg.data_ptr() if bg is not None else None,
            outg.data_ptr(), n, cg, h, wd, og, kh, kw, stride[0], stride[1],
            pad[0], pad[1], oh, ow, *xg.stride(), *wg.stride(), *outg.stride(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[out.dtype], int(fuse_relu),
            x.device.index or 0, stream)
        _build.check(rc, "K2 conv_gemm")
        conv2d_im2col_gemm.launches += 1
    return out


def _device_kind(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CUDA or (plain) CPU tensors, not {x.device}")
    return x.device.type


def conv2d_im2col_gemm_plain(x, w, b=None, *, stride=(1, 1), pad=(0, 0)):
    if x.shape[1] != w.shape[1]:
        raise ValueError("conv_gemm path does not support groups")
    return _conv_plain(x, w, b, stride, pad, 1, False, torch.float32)


def conv2d_im2col_gemm(x, w, b=None, *, stride=(1, 1), pad=(0, 0)):
    """x: (N, C, H, W); w: (O, C, kh, kw); b: (O,) -> (N, O, oh, ow) f32.
    Groups unsupported on this entry point (as in the JAX module)."""
    if _device_kind(x) == "cpu":
        return conv2d_im2col_gemm_plain(x, w, b, stride=stride, pad=pad)
    if x.dim() == 4 and w.dim() == 4 and x.shape[1] != w.shape[1]:
        raise ValueError("conv_gemm path does not support groups")
    _check(x, w, 1, torch.float32)
    oh, ow = _out_hw(x.shape[2], x.shape[3], w.shape[2], w.shape[3], stride, pad)
    out = torch.empty((x.shape[0], w.shape[0], oh, ow), dtype=torch.float32,
                      device=x.device)
    return _conv_kernel(x, w, b, out, stride, pad, 1, False)


conv2d_im2col_gemm.launches = 0


def conv2d_gemm_nhwc_plain(x, w, b=None, *, stride=(1, 1), pad=(0, 0),
                           groups: int = 1, fuse_relu: bool = False,
                           out_dtype=torch.float32):
    y = _conv_plain(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride,
                    pad, groups, fuse_relu, out_dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_gemm_nhwc(x, w, b=None, *, stride=(1, 1), pad=(0, 0),
                     groups: int = 1, fuse_relu: bool = False,
                     out_dtype=torch.float32):
    """x: (N, H, W, C); w: (kh, kw, C/groups, O) HWIO; b: (O,) ->
    act(conv + b): (N, oh, ow, O) in out_dtype, contiguous NHWC."""
    if _device_kind(x) == "cpu":
        return conv2d_gemm_nhwc_plain(x, w, b, stride=stride, pad=pad,
                                      groups=groups, fuse_relu=fuse_relu,
                                      out_dtype=out_dtype)
    xv, wv = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    _check(xv, wv, groups, out_dtype)
    oh, ow = _out_hw(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, pad)
    out = torch.empty((x.shape[0], oh, ow, w.shape[3]), dtype=out_dtype,
                      device=x.device)
    _conv_kernel(xv, wv, b, out.permute(0, 3, 1, 2), stride, pad, groups,
                 fuse_relu)
    return out
