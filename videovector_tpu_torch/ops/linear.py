"""Fully-connected ops; counterpart of videovector_tpu/ops/linear.py, plus
the embedding tower's differentiable GEMM on K1.

`inner_product` keeps the JAX op's layout, w as (fan_in, num_output), and
its quirk: a positive `inner_product_param.regularization` r scales the
weight gradient by (1 + r/2) in backward (Caffe inner_product_layer.cpp);
a negative r is inert.

`tower_matmul` is the training tower's x.w + b. Its forward is K1
(ops/hopper/matmul.py) with the bias epilogue and no fused ReLU; the ReLU
runs after it (ops.activations.relu), because from relu(h) alone a tie
h == 0, whose gradient is 0.5, cannot be told from h < 0, whose gradient is
0. Its backward is plain torch.matmul, as the JAX package leaves the
backward of `jnp.dot` to XLA (K1 has no backward there). It copies the
JAX step's rounding: the operands are cast to the compute dtype before the
product, so the weight gradient, the cotangent of that cast, is rounded to
the compute dtype and back to f32: dW = f32(cdt(x_cdt^T . dY)), with the
product in f32 with TF32 off (`no_tf32`), whatever the process sets.
"""

from __future__ import annotations

import contextlib

import torch

from videovector_tpu_torch.ops.hopper.matmul import matmul, matmul_plain


@contextlib.contextmanager
def no_tf32():
    """f32 products on the card in full f32 (TF32 off) inside the block,
    whatever the process's setting, which is restored after it: the JAX
    package's f32 dots are full f32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _matmul(x, w):
    """x @ w with an f32 sum and f32 result (JAX's preferred_element_type)."""
    return torch.matmul(x.float(), w.float())


class _InnerProductReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, regularization):
        ctx.save_for_backward(x, w)
        ctx.regularization = regularization
        return _matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _matmul(g, w.T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (_matmul(x.T, g) * (1.0 + ctx.regularization / 2.0)).to(w.dtype)
        return dx, dw, None


def inner_product(x, w, b=None, *, regularization: float = 0.0):
    """y = x @ w (+ b). x: (M, K) [dims beyond 2 are flattened, as Caffe
    flattens C.H.W], w: (K, N), b: (N,). The sum and y are f32."""
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if regularization > 0.0:
        y = _InnerProductReg.apply(x, w, regularization)
    else:
        y = _matmul(x, w)
    if b is not None:
        y = y + b
    return y


class _TowerMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, cdt, plain):
        xc, wc = x.to(cdt), w.to(cdt)
        mm = matmul_plain if plain else matmul
        h = mm(xc, wc, b, out_dtype=torch.float32)
        ctx.save_for_backward(xc, wc)
        ctx.x_dtype = x.dtype
        return h

    @staticmethod
    def backward(ctx, dy):
        xc, wc = ctx.saved_tensors
        dx = dw = db = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                dx = (dy @ wc.float().T).to(xc.dtype).to(ctx.x_dtype)
            if ctx.needs_input_grad[1]:
                dw = (xc.float().T @ dy).to(wc.dtype).float()
        if ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db, None, None


def tower_matmul(x, w, b, *, compute_dtype: torch.dtype = torch.bfloat16,
                 plain: bool = False):
    """x: (M, D), w: (D, E) and b: (E,) f32 -> x.w + b: (M, E) f32, with x
    and w cast to `compute_dtype` for the product; differentiable in all
    three. The forward is one K1 launch for CUDA tensors (its plain
    version for CPU tensors, or when `plain`)."""
    return _TowerMatmul.apply(x, w, b, compute_dtype, plain)
