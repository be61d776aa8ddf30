"""Convolution ops (NCHW, Caffe weight layout OIHW); counterpart of
videovector_tpu/ops/conv.py.

Every function here is plain PyTorch. `im2col` feeds K2's plain version
(ops/hopper/conv_gemm.py), `conv2d` is the library convolution the JAX
module wraps, and `col2im` is im2col's adjoint (the IM2COL layer's
backward in the reference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, w, b=None, *, stride=(1, 1), pad=(0, 0), groups: int = 1):
    """x: (N, C, H, W); w: (O, C/groups, kh, kw); b: (O,). Sums in f32 and
    returns x's dtype (Caffe ConvolutionParameter semantics)."""
    out = F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                   stride=tuple(stride), padding=tuple(pad), groups=groups)
    return out.to(x.dtype)


def im2col(x, *, kernel=(1, 1), stride=(1, 1), pad=(0, 0)):
    """(N, C, H, W) -> (N, C*kh*kw, out_h, out_w), channel-major patch order
    c*kh*kw + i*kw + j as in Caffe's im2col."""
    kh, kw = kernel
    n, _, h, w = x.shape
    out_h = (h + 2 * pad[0] - kh) // stride[0] + 1
    out_w = (w + 2 * pad[1] - kw) // stride[1] + 1
    cols = F.unfold(x, (kh, kw), padding=tuple(pad), stride=tuple(stride))
    return cols.reshape(n, -1, out_h, out_w)


def col2im(cols, *, input_hw, kernel=(1, 1), stride=(1, 1), pad=(0, 0)):
    """Adjoint of `im2col` (a scatter-add of the patches, Caffe's
    col2im_cpu): (N, C*kh*kw, out_h, out_w) -> (N, C, H, W). F.fold is
    F.unfold's adjoint, as jax.linear_transpose of im2col is in JAX."""
    n = cols.shape[0]
    return F.fold(cols.reshape(n, cols.shape[1], -1), tuple(input_hw),
                  tuple(kernel), padding=tuple(pad), stride=tuple(stride))
