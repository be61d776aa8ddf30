"""Max pooling with Caffe's ceil-mode geometry; counterpart of
videovector_tpu/ops/pooling.py (MAX only, what the serving slice runs).

Caffe computes the output size with CEIL division and clips the last window
to start strictly inside the image when padded; the end is padded with -inf
so the ceil-mode windows exist. At a 227 crop this gives CaffeNet's
55 -> 27 -> 13 -> 6 chain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _pooled_size(size, k, s, p):
    out = int(math.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    return out


def _pool_geometry(h, w, kernel, stride, pad):
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    oh = _pooled_size(h, kh, sh, ph)
    ow = _pooled_size(w, kw, sw, pw)
    # pad enough on the bottom/right for the ceil-mode windows
    pad_h_end = max((oh - 1) * sh + kh - h - ph, 0)
    pad_w_end = max((ow - 1) * sw + kw - w - pw, 0)
    return oh, ow, (ph, pad_h_end), (pw, pad_w_end)


def max_pool(x, *, kernel, stride, pad=(0, 0), layout: str = "NCHW"):
    """x: (N, C, H, W), or (N, H, W, C) with layout="NHWC"."""
    nchw = x if layout == "NCHW" else x.permute(0, 3, 1, 2)
    h, w = nchw.shape[2], nchw.shape[3]
    _, _, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    padded = F.pad(nchw, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]),
                   value=-math.inf)
    out = F.max_pool2d(padded, kernel_size=tuple(kernel), stride=tuple(stride))
    return out if layout == "NCHW" else out.permute(0, 2, 3, 1)
