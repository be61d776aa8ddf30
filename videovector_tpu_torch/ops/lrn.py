"""Local Response Normalization helpers; counterpart of
videovector_tpu/ops/lrn.py (the cross-channel window sum MedNet uses)."""

from __future__ import annotations

import torch.nn.functional as F


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
