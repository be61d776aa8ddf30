"""Social pooling, a differentiable neighbourhood pooling over agent
positions; counterpart of videovector_tpu/ops/social.py.

ref:src/caffe/layers/social_pooling_layer.cpp:39-186 (+ .cu). Given agent
features whose first two dims are (x, y) positions, a B x B relation matrix
R, and an optional per-agent mean position to re-add:

  d_x[i,j] = x_i - x_j ;  d_y[i,j] = y_i - y_j
  e[i,j,:] = sigmoid(d_x[i,j].w_x + d_y[i,j].w_y + b)      (learned 2 -> F map)
  out[i,:] = sum_j R[i,j] . e[i,j,:]                        (masked neighbour sum)

Learnable blobs: w (2, F), b (F,). Autograd replaces the manual backward
(ref :188-286). The neighbour sum is an elementwise product and a sum over
j, not a batched GEMM, so that no TF32 setting can reach it.
"""

from __future__ import annotations

import torch


def social_pooling(feats, relations, w, b, mean_pos=None):
    """feats: (B, D) with x = feats[:, 0], y = feats[:, 1];
    relations: (B, B); w: (2, F); b: (F,); mean_pos: an optional (B, 2)
    added to the (x, y) columns first (ref :99-104).
    Returns (B, F)."""
    xy = feats[:, :2] if mean_pos is None else feats[:, :2] + mean_pos
    x, y = xy[:, 0], xy[:, 1]
    dx = x[:, None] - x[None, :]          # (B, B)
    dy = y[:, None] - y[None, :]
    e = torch.sigmoid(dx[..., None] * w[0] + dy[..., None] * w[1] + b)
    return (relations[..., None] * e).sum(dim=1)
