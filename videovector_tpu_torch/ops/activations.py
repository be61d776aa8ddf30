"""Elementwise ("neuron") ops; counterpart of videovector_tpu/ops/activations.py
(only what the serving slice runs)."""

from __future__ import annotations

import torch


def relu(x, negative_slope: float = 0.0):
    """ReLU with optional leak (Caffe relu_layer)."""
    if negative_slope == 0.0:
        return torch.clamp_min(x, 0)
    return torch.clamp_min(x, 0) + negative_slope * torch.clamp_max(x, 0)
