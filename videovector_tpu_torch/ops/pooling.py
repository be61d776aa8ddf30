"""Pooling (MAX / AVE / STOCHASTIC) with Caffe's geometry; counterpart of
videovector_tpu/ops/pooling.py.

Caffe computes the output size with CEIL division and clips the last window
to start strictly inside the image when padded; the end is padded (with
-inf for MAX, 0 for the sums) so the ceil-mode windows exist. At a 227 crop
this gives CaffeNet's 55 -> 27 -> 13 -> 6 chain. AVE divides by the window
area clipped to the PADDED bounds, not to the image (pooling_layer.cpp
:169-196): F.avg_pool2d's count_include_pad / ceil_mode give other divisors
at the edges, so the divisor is built here as the JAX module builds it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from videovector_tpu_torch.ops import collectives


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


def _padded(x, pad_h, pad_w, value):
    return F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]), value=value)


def max_pool(x, *, kernel, stride, pad=(0, 0), layout: str = "NCHW"):
    """x: (N, C, H, W), or (N, H, W, C) with layout="NHWC"."""
    nchw = x if layout == "NCHW" else x.permute(0, 3, 1, 2)
    h, w = nchw.shape[2], nchw.shape[3]
    _, _, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    out = F.max_pool2d(_padded(nchw, pad_h, pad_w, -math.inf),
                       kernel_size=tuple(kernel), stride=tuple(stride))
    return out if layout == "NCHW" else out.permute(0, 2, 3, 1)


def _window_sum(x, kernel, stride, pad_h, pad_w):
    """Sum over each ceil-mode window of x zero-padded by pad_h/pad_w."""
    return F.avg_pool2d(_padded(x, pad_h, pad_w, 0.0), tuple(kernel),
                        tuple(stride), divisor_override=1)


def avg_pool(x, *, kernel, stride, pad=(0, 0)):
    """Caffe AVE on (N, C, H, W): divide by the window area within the
    PADDED bounds."""
    _, _, h, w = x.shape
    oh, ow, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    summed = _window_sum(x, kernel, stride, pad_h, pad_w)
    # the divisor: window sums of ones over the image and its pad, with
    # zeros for the ceil-mode extension beyond the pad
    ones = torch.ones((1, 1, h + 2 * pad[0], w + 2 * pad[1]),
                      dtype=torch.float32, device=x.device)
    div = _window_sum(ones, kernel, stride, (0, max(pad_h[1] - pad[0], 0)),
                      (0, max(pad_w[1] - pad[1], 0)))[:, :, :oh, :ow]
    # the divisor in x's dtype, as JAX keeps a bf16 chain bf16
    return summed / div.to(x.dtype)


def stochastic_uniforms(shape, generator: torch.Generator, device):
    """Uniforms in [1e-6, 1) of `shape` for STOCHASTIC pooling's TRAIN race,
    from `generator`. The one place the pooling draws random numbers: its
    bits differ from jax.random.uniform's, so parity tests replace this
    function with one that returns JAX's uniforms. On a batch shard, the
    whole batch's uniforms cut to the rank's rows (batch axis 0), as
    dropout's masks are (ops/collectives.py)."""
    u = collectives.data_draw(
        shape, 0, lambda s: torch.rand(s, generator=generator, device=device))
    return 1e-6 + u * (1.0 - 1e-6)


def _patches(arr, oh, ow, kernel, stride, pads, fill):
    """(N, C, H, W) -> (N, C, OH, OW, KH*KW): each output position's window
    elements along the last axis (one strided slice per kernel offset)."""
    a = _padded(arr, pads[0], pads[1], fill)
    ps = [a[:, :, i:i + (oh - 1) * stride[0] + 1:stride[0],
            j:j + (ow - 1) * stride[1] + 1:stride[1]]
          for i in range(kernel[0]) for j in range(kernel[1])]
    return torch.stack(ps, dim=-1)


def stochastic_pool(x, *, kernel, stride, pad=(0, 0),
                    generator: torch.Generator | None = None,
                    deterministic: bool = True):
    """Stochastic pooling (Caffe pooling_layer.cu STOCHASTIC). TEST (or no
    generator): the value-weighted average sum(x^2)/sum(x) over the window,
    0/0 read as 0/1. TRAIN: each window samples one element with
    probability proportional to its value, as an exponential race (score
    x / -log(u) for x > 0, else 0; the window's largest score wins, the
    first on ties). The race runs over each window's own patch, so that
    overlapping windows (stride < kernel) never share a winner: JAX's
    comment records the reduce-window formulation that did."""
    _, _, h, w = x.shape
    oh, ow, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    if deterministic or generator is None:
        num = _window_sum(x * x, kernel, stride, pad_h, pad_w)
        den = _window_sum(x, kernel, stride, pad_h, pad_w)
        return num / torch.where(den == 0, torch.ones_like(den), den)
    u = stochastic_uniforms(x.shape, generator, x.device)
    score = torch.where(x > 0, x / -torch.log(u), 0.0)
    sc = _patches(score, oh, ow, kernel, stride, (pad_h, pad_w), -math.inf)
    xs = _patches(x, oh, ow, kernel, stride, (pad_h, pad_w), 0.0)
    idx = torch.argmax(sc, dim=-1, keepdim=True)
    return torch.gather(xs, -1, idx)[..., 0]
