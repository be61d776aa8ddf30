"""Normalization ops; counterpart of videovector_tpu/ops/normalization.py."""

from __future__ import annotations

import torch

L2_NORM_EPS = 1e-10


def l2_normalize_rows(x, eps: float = L2_NORM_EPS):
    """Row-wise L2 normalize: y = x / (||x||_2 + eps), rows = leading axis,
    features = everything else; eps is added to the norm. A zero row gives 0,
    not NaN (the JAX function's where-guard, kept exactly)."""
    feat_dims = tuple(range(1, x.dim()))
    sq = torch.sum(x * x, dim=feat_dims, keepdim=True)
    nonzero = sq > 0
    safe_norm = torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq)))
    return torch.where(nonzero, x / (safe_norm + eps), torch.zeros_like(x))


def mvn(x, *, normalize_variance: bool = True, across_channels: bool = False,
        eps: float = 1e-10):
    """Mean-variance normalization (Caffe mvn_layer.cpp). x: (N, C, H, W);
    across_channels=False normalizes each (H, W) plane of each channel,
    True normalizes over C.H.W per sample; eps is added to the std."""
    if x.dim() != 4:
        raise ValueError("mvn expects NCHW")
    dims = (1, 2, 3) if across_channels else (2, 3)
    out = x - torch.mean(x, dim=dims, keepdim=True)
    if normalize_variance:
        var = torch.mean(out * out, dim=dims, keepdim=True)
        out = out / (torch.sqrt(var) + eps)
    return out
