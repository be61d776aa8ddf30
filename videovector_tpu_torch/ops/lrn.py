"""Local Response Normalization; counterpart of videovector_tpu/ops/lrn.py.

Caffe lrn_layer.cpp: across channels, scale = 1 + (alpha/size) * the sum
of x^2 over the channels [c - size/2, c + size/2] (clipped), y = x *
scale^-beta (:105-160). Within a channel, the mean of x^2 over a size x
size window, as AVE pooling with pad size/2 (the reference composes pool
and power layers, :40-70)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from videovector_tpu_torch.ops.pooling import avg_pool


def channel_window_sum(sq, axis: int, local_size: int):
    """Clipped sliding-window sum over `axis`, as shifted adds in the JAX
    module's order (the window is [c - size//2, c + size - 1 - size//2])."""
    axis = axis % sq.dim()
    half = local_size // 2
    c = sq.shape[axis]
    pads = [0] * (2 * sq.dim())
    # F.pad lists (before, after) pairs from the last dim backwards
    pos = 2 * (sq.dim() - 1 - axis)
    pads[pos], pads[pos + 1] = half, local_size - 1 - half
    sqp = F.pad(sq, pads)
    summed = None
    for o in range(local_size):
        part = sqp.narrow(axis, o, c)
        summed = part if summed is None else summed + part
    return summed


def _check_odd(local_size: int) -> None:
    # ref lrn_layer.cpp LayerSetUp: CHECK_EQ(size_ % 2, 1); an even size
    # would silently use a window shifted one channel against Caffe's
    if local_size % 2 != 1:
        raise ValueError(f"LRN local_size must be odd (got {local_size}); "
                         f"the reference CHECKs this at setup")


def lrn_cross_channel(x, *, local_size: int = 5, alpha: float = 1.0,
                      beta: float = 0.75, axis: int = 1):
    """x: (N, C, H, W), or channels on another `axis`."""
    _check_odd(local_size)
    summed = channel_window_sum(x * x, axis, local_size)
    scale = 1.0 + (alpha / local_size) * summed
    return x * torch.pow(scale, -beta)


# CaffeNet's and GoogLeNet's LRN (size 5, alpha 1e-4, beta 0.75) on NHWC x
lrn_nhwc = functools.partial(lrn_cross_channel, alpha=1e-4, axis=3)


def lrn_within_channel(x, *, local_size: int = 5, alpha: float = 1.0,
                       beta: float = 0.75):
    """x: (N, C, H, W)."""
    _check_odd(local_size)
    half = local_size // 2
    mean_sq = avg_pool(x * x, kernel=(local_size, local_size), stride=(1, 1),
                       pad=(half, half))
    scale = 1.0 + alpha * mean_sq
    return x * torch.pow(scale, -beta)
