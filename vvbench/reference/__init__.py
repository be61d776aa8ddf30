"""Plain references of the benchmark's configurations.

Plain PyTorch with TF32 off unless a caller asks for the control's
precision. Nothing here imports the program, `jax` or the JAX package: a
reference is given the benchmark's own inputs (weights, frames, batches,
gallery) and works out again whatever the program derives from them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for every f32 product and convolution in the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at e4m3's 448), back in f32: an fp8 operand."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def l2_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Rows over (||row|| + eps); a zero row stays zero."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return torch.where(norm > 0, x / (norm + eps), torch.zeros_like(x))
