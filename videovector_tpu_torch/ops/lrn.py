"""Local Response Normalization; counterpart of videovector_tpu/ops/lrn.py.

Caffe lrn_layer.cpp: across channels, scale = 1 + (alpha/size) * the sum
of x^2 over the channels [c - size/2, c + size/2] (clipped), y = x *
scale^-beta (:105-160). Within a channel, the mean of x^2 over a size x
size window, as AVE pooling with pad size/2 (the reference composes pool
and power layers, :40-70).

`lrn_nhwc`, the across-channels LRN of (N, H, W, C) activations (CaffeNet's
and GoogLeNet's), launches csrc/lrn_nhwc.cu where `device.runs_kernel` says
so: one read of x, the window's squares, sum and scale in f32, one rounding
to x's dtype. Else it runs its plain version `lrn_nhwc_plain`
(`lrn_cross_channel` on the last axis, in x's dtype): on a CPU tensor
inside the custom op `vvtpu::lrn_nhwc`, as the launch is, so that
`torch.export` records one node either way. The kernel is forward only: a
call that autograd records raises on a card, as K1's and K2's entry points
do, and takes the plain version on the CPU. The counter `vvtpu.lrn.calls`
adds each call, `vvtpu.lrn.launches` each launch (utils/timer.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videovector_tpu_torch import _build
from videovector_tpu_torch.device import runs_kernel
from videovector_tpu_torch.ops.hopper.matmul import forward_only
from videovector_tpu_torch.ops.pooling import POOL_DTYPE_CODES, avg_pool
from videovector_tpu_torch.utils.timer import count


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


def lrn_nhwc_plain(x, local_size: int = 5, alpha: float = 1e-4,
                   beta: float = 0.75):
    """`lrn_cross_channel` over the channels of (N, H, W, C) x."""
    return lrn_cross_channel(x, local_size=local_size, alpha=alpha,
                             beta=beta, axis=3)


def lrn_nhwc(x, *, local_size: int = 5, alpha: float = 1e-4,
             beta: float = 0.75):
    """The across-channels LRN of (N, H, W, C) x (CaffeNet's and GoogLeNet's
    by default): where `runs_kernel(x)`, one launch of csrc/lrn_nhwc.cu
    (f32, bf16 or f16) through `vvtpu::lrn_nhwc`, contiguous in x's dtype;
    else the plain version (module docstring)."""
    count("vvtpu.lrn.calls", 1)
    if runs_kernel(x):
        forward_only(x)
    elif x.device.type != "cpu" or (torch.is_grad_enabled()
                                    and x.requires_grad):
        return lrn_nhwc_plain(x, local_size, alpha, beta)
    return torch.ops.vvtpu.lrn_nhwc(x, local_size, alpha, beta)


def _check(x, local_size):
    _check_odd(local_size)
    if x.dim() != 4:
        raise ValueError(f"lrn_nhwc wants (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in POOL_DTYPE_CODES:
        raise TypeError(f"lrn_nhwc takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")


@torch.library.custom_op(
    "vvtpu::lrn_nhwc", mutates_args=(),
    schema="(Tensor x, int local_size, float alpha, float beta) -> Tensor")
def _lrn_nhwc_op(x: torch.Tensor, local_size: int, alpha: float,
                 beta: float) -> torch.Tensor:
    """`lrn_nhwc` as a custom op: the kernel's launch on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check(x, local_size)
    if x.device.type == "cpu":
        return lrn_nhwc_plain(x, local_size, alpha, beta).contiguous()
    return _lrn_nhwc_kernel(x, local_size, alpha, beta)


@_lrn_nhwc_op.register_fake
def _lrn_nhwc_fake(x, local_size, alpha, beta):
    _check(x, local_size)
    return x.new_empty(x.shape)


def _lrn_nhwc_kernel(x, local_size, alpha, beta):
    """One launch of csrc/lrn_nhwc.cu, counted."""
    if x.device.type != "cuda":
        raise ValueError(f"lrn_nhwc runs on CUDA or (plain) CPU tensors, not "
                         f"{x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    rc = lib.vv_lrn_nhwc(
        x.data_ptr(), out.data_ptr(), *x.shape, *x.stride(), local_size,
        alpha / local_size, beta, POOL_DTYPE_CODES[x.dtype],
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lrn_nhwc")
    count("vvtpu.lrn.launches", 1)
    return out


def lrn_within_channel(x, *, local_size: int = 5, alpha: float = 1.0,
                       beta: float = 0.75):
    """x: (N, C, H, W)."""
    _check_odd(local_size)
    half = local_size // 2
    mean_sq = avg_pool(x * x, kernel=(local_size, local_size), stride=(1, 1),
                       pad=(half, half))
    scale = 1.0 + alpha * mean_sq
    return x * torch.pow(scale, -beta)
