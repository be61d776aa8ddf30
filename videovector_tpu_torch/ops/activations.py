"""Elementwise ("neuron") ops; counterpart of videovector_tpu/ops/activations.py,
plus the channel softmax of the JAX package's SOFTMAX layer.

Each op's gradient is JAX's at ties and zeros: relu's at 0 is 0.5, absval's
at 0 is +1 (JAX's abs rule), bnll's at 0 is 0.5, power's at a zero base
with a fractional exponent is inf as in lax.pow."""

from __future__ import annotations

import torch

from videovector_tpu_torch.ops import collectives


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


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def bnll(x):
    """Binomial normal log likelihood log(1 + exp(x)), overflow-safe: JAX's
    softplus, logaddexp(x, 0) (Caffe's bnll_layer.cpp branches at 0 for
    the same function)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def power(x, power: float = 1.0, scale: float = 1.0, shift: float = 0.0):
    """(shift + scale * x) ** power (Caffe power_layer.cpp)."""
    base = shift + scale * x
    if power == 1.0:
        return base
    return torch.pow(base, power)


class _AbsVal(torch.autograd.Function):
    """|x| with JAX's gradient: +1 where x >= 0 (0 included), else -1
    (torch.abs's is 0 at 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absval(x):
    return _AbsVal.apply(x)


def threshold(x, threshold: float = 0.0):
    """1 where x > t, else 0, in x's dtype (Caffe threshold_layer.cpp); no
    gradient, as a cast from bool has none in JAX."""
    return (x > threshold).to(x.dtype)


def softmax(x):
    """The SOFTMAX layer's: over channels (axis 1) per position, over axis
    0 for a 1-D x (Caffe softmax_layer.cpp:24-60)."""
    return torch.softmax(x, dim=1 if x.dim() > 1 else 0)


def dropout_mask(shape, keep: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Bernoulli(keep) keep-mask of `shape` (bool) from `generator`. The one
    place dropout draws random numbers: its bits differ from
    jax.random.bernoulli's, so parity tests replace this function with one
    that returns JAX's mask."""
    return torch.rand(shape, generator=generator, device=device) < keep


def batch_dropout_mask(shape, keep: float, generator: torch.Generator,
                       device, layout=None) -> torch.Tensor:
    """dropout_mask of `shape`. On a batch shard (the "data" axis of
    ops/collectives.py), with `layout` = (the shape to draw in, its batch
    axis), the whole batch's mask is drawn in that layout and the rank
    keeps its rows: the one-device mask's slice, as GSPMD's step draws it,
    reshaped to `shape`."""
    if layout is None or collectives.axis("data") is None:
        return dropout_mask(shape, keep, generator, device)
    lshape, axis = layout
    return collectives.data_draw(
        lshape, axis, lambda s: dropout_mask(s, keep, generator, device)
    ).reshape(shape)


def apply_dropout(x, mask: torch.Tensor, keep: float):
    """where(mask, x / keep, 0). Divides by keep as the JAX op does (a
    multiply by 1/keep rounds differently); keep goes in as a 0-d tensor of
    x's dtype, since CUDA turns a division by a host scalar into a multiply
    by its reciprocal."""
    keep_t = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / keep_t, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def dropout(x, *, rate: float, generator: torch.Generator | None,
            deterministic: bool = False, layout=None):
    """Inverted dropout: keep with prob (1 - rate) and scale kept units by
    1/(1 - rate) at train time; identity at test time or at rate 0 (Caffe
    dropout_layer, scale_ = 1/(1 - threshold)). `layout` = (shape,
    batch_axis): the shape the mask is drawn in (x's elements, in order)
    and its batch axis, for a batch shard (dropout_mask); default x's shape
    with the batch on axis 0 (batch_dropout_mask)."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        # keep = 0 would send 0/0 through the backward of x / keep
        raise ValueError(f"dropout rate must be < 1 (got {rate})")
    if generator is None:
        raise ValueError("dropout at rate > 0 needs a torch.Generator")
    keep = 1.0 - rate
    mask = batch_dropout_mask(x.shape, keep, generator, x.device, layout)
    return apply_dropout(x, mask, keep)
