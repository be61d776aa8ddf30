"""Reduction and elementwise-combination ops (the SUM and ELTWISE layers);
counterpart of videovector_tpu/ops/reductions.py. Gradients come from
autograd, but for the division form of ELTWISE PROD's backward."""

from __future__ import annotations

import torch


def sum_reduce(x, num_output: int = 1):
    """Sum over all non-leading axes per sample; broadcast the scalar to
    `num_output` channels (ref:src/caffe/layers/sum_layer.cpp:32-54). Used as
    the dot-product score reducer after an Eltwise PROD: the broadcast lets
    one target score line up against `num_negatives` negative scores."""
    s = torch.sum(x.reshape(x.shape[0], -1), dim=1, keepdim=True)
    if num_output == 1:
        return s
    return torch.broadcast_to(s, (x.shape[0], num_output))


class _ProdDivGrad(torch.autograd.Function):
    """The product of the inputs, with the reference's division backward
    grad_i = (out / x_i) * g (ref eltwise_layer.cpp:132-134): NaN where an
    input is 0 (0/0), by design."""

    @staticmethod
    def forward(ctx, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        ctx.save_for_backward(out, *xs)
        return out

    @staticmethod
    def backward(ctx, g):
        out, *xs = ctx.saved_tensors
        return tuple((out / x) * g for x in xs)


def eltwise_prod(*xs, stable_grad: bool = True):
    """Eltwise PROD (ref:src/caffe/layers/eltwise_layer.cpp).

    `stable_grad` = EltwiseParameter.stable_prod_grad (default true): the
    stable backward computes each input's grad as the product of the OTHER
    inputs (ref eltwise_layer.cpp:121-131), which is what autograd of the
    chained multiply gives. stable_prod_grad=false reproduces the reference's
    division formulation (`_ProdDivGrad`), different only where an input is
    0 ("may be numerically unstable", caffe.proto:728-731)."""
    if stable_grad or len(xs) == 1:
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out
    return _ProdDivGrad.apply(*xs)


def eltwise_sum(*xs, coeffs=None):
    """Eltwise SUM with optional per-input coefficients."""
    if coeffs is None:
        coeffs = [1.0] * len(xs)
    if len(coeffs) != len(xs):
        raise ValueError("coeff count must match input count")
    out = coeffs[0] * xs[0]
    for c, x in zip(coeffs[1:], xs[1:]):
        out = out + c * x
    return out


def eltwise_max(*xs):
    """Elementwise max; a tie splits the gradient evenly, as jnp.maximum's
    does."""
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out
