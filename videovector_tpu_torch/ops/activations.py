"""Elementwise ("neuron") ops; counterpart of videovector_tpu/ops/activations.py
(what the serving and training slices run: relu and dropout)."""

from __future__ import annotations

import torch


def relu(x, negative_slope: float = 0.0):
    """ReLU with optional leak (Caffe relu_layer).

    Written as the JAX op is, max(x, 0) (+ slope * min(x, 0)), so that the
    gradient at exactly 0 is the same: torch.maximum splits a tie evenly,
    giving 0.5 (0.5 + 0.5 * slope with the leak), where torch.relu gives 0
    and clamp_min 1."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if negative_slope == 0.0:
        return torch.maximum(x, zero)
    return torch.maximum(x, zero) + negative_slope * torch.minimum(x, zero)


def dropout_mask(shape, keep: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Bernoulli(keep) keep-mask of `shape` (bool) from `generator`. The one
    place dropout draws random numbers: its bits differ from
    jax.random.bernoulli's, so parity tests replace this function with one
    that returns JAX's mask."""
    return torch.rand(shape, generator=generator, device=device) < keep


def apply_dropout(x, mask: torch.Tensor, keep: float):
    """where(mask, x / keep, 0). Divides by keep as the JAX op does (a
    multiply by 1/keep rounds differently); keep goes in as a 0-d tensor of
    x's dtype, since CUDA turns a division by a host scalar into a multiply
    by its reciprocal."""
    keep_t = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / keep_t, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def dropout(x, *, rate: float, generator: torch.Generator | None,
            deterministic: bool = False):
    """Inverted dropout: keep with prob (1 - rate) and scale kept units by
    1/(1 - rate) at train time; identity at test time or at rate 0 (Caffe
    dropout_layer, scale_ = 1/(1 - threshold))."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        # keep = 0 would send 0/0 through the backward of x / keep
        raise ValueError(f"dropout rate must be < 1 (got {rate})")
    if generator is None:
        raise ValueError("dropout at rate > 0 needs a torch.Generator")
    keep = 1.0 - rate
    return apply_dropout(x, dropout_mask(x.shape, keep, generator, x.device),
                         keep)
