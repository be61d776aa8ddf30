"""Convolution ops (NCHW, Caffe weight layout OIHW); counterpart of
videovector_tpu/ops/conv.py.

Every function here is plain PyTorch. `im2col` feeds K2's plain version
(ops/hopper/conv_gemm.py), `conv2d` is the library convolution the JAX
module wraps, and `col2im` is im2col's adjoint (the IM2COL layer's
backward in the reference). `im2col_ndhwc` feeds the plain version of
K2's depth route, and `same_pads` is TF's SAME padding, which I3D's convs
and pools use (models/i3d.py).
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


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF's SAME padding of an axis of n for a window of k at stride s: the
    output is ceil(n / s), and the pads (before, after) that give it split
    their total, max((out - 1) s + k - n, 0), with the odd one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def im2col_ndhwc(x, kernel, stride, pad):
    """(N, T, H, W, C) -> (N, OT, OH, OW, kt kh kw C), zero-padded by
    pad = ((before, after),) * 3 along (T, H, W): each output voxel's
    window in (d, i, j, c) order, the order of DHWIO weights flattened."""
    (pt, pt1), (ph, ph1), (pw, pw1) = pad
    xp = F.pad(x, (0, 0, pw, pw1, ph, ph1, pt, pt1))
    for axis, (k, s) in enumerate(zip(kernel, stride), start=1):
        xp = xp.unfold(axis, k, s)           # appends the window's axis
    # (N, OT, OH, OW, C, kt, kh, kw) -> (..., kt, kh, kw, C)
    cols = xp.permute(0, 1, 2, 3, 5, 6, 7, 4)
    return cols.reshape(*cols.shape[:4], -1)
