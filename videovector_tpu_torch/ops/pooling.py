"""Pooling (MAX / AVE / STOCHASTIC) with Caffe's geometry; counterpart of
videovector_tpu/ops/pooling.py.

Caffe computes the output size with CEIL division and clips the last window
to start strictly inside the image when padded; the end is padded (with
-inf for MAX, 0 for the sums) so the ceil-mode windows exist. At a 227 crop
this gives CaffeNet's 55 -> 27 -> 13 -> 6 chain. AVE divides by the window
area clipped to the PADDED bounds, not to the image (pooling_layer.cpp
:169-196): F.avg_pool2d's count_include_pad / ceil_mode give other divisors
at the edges, so the divisor is built here as the JAX module builds it.

MAX on NHWC (`max_pool(layout="NHWC")`, MedNet's and GoogLeNet's pools)
launches csrc/max_pool_nhwc.cu where `device.runs_kernel` says so, which
clips each window to the image (no padded copy, no index written); else
its plain version `max_pool_nhwc_plain` (a -inf F.pad, then F.max_pool2d),
equal bit for bit: on a CPU tensor inside the custom op
`vvtpu::max_pool_nhwc`, as the launch is, so that `torch.export` records
one node either way. The counter `vvtpu.max_pool.calls` adds each NHWC
call, `vvtpu.max_pool.launches` each launch (utils/timer.py). NCHW (the
graph engine's POOLING) pools as the plain version does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from videovector_tpu_torch import _build
from videovector_tpu_torch.device import runs_kernel
from videovector_tpu_torch.ops import collectives
from videovector_tpu_torch.utils.timer import count


def _pooled_size(size, k, s, p):
    out = int(math.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    return out


def _pool_geometry(h, w, kernel, stride, pad):
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    oh = _pooled_size(h, kh, sh, ph)
    ow = _pooled_size(w, kw, sw, pw)
    # pad enough on the bottom/right for the ceil-mode windows
    pad_h_end = max((oh - 1) * sh + kh - h - ph, 0)
    pad_w_end = max((ow - 1) * sw + kw - w - pw, 0)
    return oh, ow, (ph, pad_h_end), (pw, pad_w_end)


def _padded(x, pad_h, pad_w, value):
    return F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]), value=value)


def _max_pool_nchw(x, kernel, stride, pad):
    """Caffe's MAX of (N, C, H, W) x: a -inf pad of the ceil-mode windows'
    extent, then F.max_pool2d."""
    h, w = x.shape[2], x.shape[3]
    _, _, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    return F.max_pool2d(_padded(x, pad_h, pad_w, -math.inf),
                        kernel_size=tuple(kernel), stride=tuple(stride))


def max_pool(x, *, kernel, stride, pad=(0, 0), layout: str = "NCHW"):
    """x: (N, C, H, W), or (N, H, W, C) with layout="NHWC" (through
    `max_pool_nhwc`, counted in `vvtpu.max_pool.calls`)."""
    if layout == "NCHW":
        return _max_pool_nchw(x, kernel, stride, pad)
    count("vvtpu.max_pool.calls", 1)
    return max_pool_nhwc(x, kernel, stride, pad)


def max_pool_nhwc_plain(x, kernel, stride, pad=(0, 0)):
    """Caffe's MAX of (N, H, W, C) x, in plain PyTorch: the NCHW pool on
    the permuted view."""
    return _max_pool_nchw(x.permute(0, 3, 1, 2), kernel, stride,
                          pad).permute(0, 2, 3, 1)


def max_pool_nhwc(x, kernel, stride, pad=(0, 0)):
    """Caffe's MAX of (N, H, W, C) x -> contiguous (N, OH, OW, C) in x's
    dtype: where `runs_kernel(x)`, one launch of csrc/max_pool_nhwc.cu
    (f32, bf16 or f16) through `vvtpu::max_pool_nhwc`; else the plain
    version (module docstring)."""
    if runs_kernel(x) or x.device.type == "cpu":
        return torch.ops.vvtpu.max_pool_nhwc(x, list(kernel), list(stride),
                                             list(pad))
    return max_pool_nhwc_plain(x, kernel, stride, pad).contiguous()


POOL_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _pooled_shape(x, kernel, stride, pad):
    if x.dim() != 4:
        raise ValueError(f"max_pool_nhwc wants (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    oh, ow, _, _ = _pool_geometry(x.shape[1], x.shape[2], kernel, stride, pad)
    if oh < 1 or ow < 1:
        raise ValueError(f"pool output would be empty: {tuple(x.shape)} "
                         f"kernel {kernel} stride {stride} pad {pad}")
    return x.shape[0], oh, ow, x.shape[3]


@torch.library.custom_op(
    "vvtpu::max_pool_nhwc", mutates_args=(),
    schema="(Tensor x, int[] kernel, int[] stride, int[] pad) -> Tensor")
def _max_pool_nhwc_op(x: torch.Tensor, kernel: list[int], stride: list[int],
                      pad: list[int]) -> torch.Tensor:
    """`max_pool_nhwc` as a custom op: the kernel's launch on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return max_pool_nhwc_plain(x, kernel, stride, pad).contiguous()
    return _max_pool_nhwc_kernel(x, tuple(kernel), tuple(stride), tuple(pad))


@_max_pool_nhwc_op.register_fake
def _max_pool_nhwc_fake(x, kernel, stride, pad):
    return x.new_empty(_pooled_shape(x, kernel, stride, pad))


def _max_pool_nhwc_kernel(x, kernel, stride, pad):
    """One launch of csrc/max_pool_nhwc.cu, counted."""
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_nhwc runs on CUDA or (plain) CPU "
                         f"tensors, not {x.device}")
    if x.dtype not in POOL_DTYPE_CODES:
        raise TypeError(f"max_pool_nhwc takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    n, oh, ow, c = _pooled_shape(x, kernel, stride, pad)
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    rc = lib.vv_max_pool_nhwc(
        x.data_ptr(), out.data_ptr(), n, x.shape[1], x.shape[2], c, oh, ow,
        *kernel, *stride, *pad, *x.stride(), POOL_DTYPE_CODES[x.dtype],
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "max_pool_nhwc")
    count("vvtpu.max_pool.launches", 1)
    return out


def _window_sum(x, kernel, stride, pad_h, pad_w):
    """Sum over each ceil-mode window of x zero-padded by pad_h/pad_w."""
    return F.avg_pool2d(_padded(x, pad_h, pad_w, 0.0), tuple(kernel),
                        tuple(stride), divisor_override=1)


def avg_pool(x, *, kernel, stride, pad=(0, 0)):
    """Caffe AVE on (N, C, H, W): divide by the window area within the
    PADDED bounds."""
    _, _, h, w = x.shape
    oh, ow, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    summed = _window_sum(x, kernel, stride, pad_h, pad_w)
    # the divisor: window sums of ones over the image and its pad, with
    # zeros for the ceil-mode extension beyond the pad
    ones = torch.ones((1, 1, h + 2 * pad[0], w + 2 * pad[1]),
                      dtype=torch.float32, device=x.device)
    div = _window_sum(ones, kernel, stride, (0, max(pad_h[1] - pad[0], 0)),
                      (0, max(pad_w[1] - pad[1], 0)))[:, :, :oh, :ow]
    # the divisor in x's dtype, as JAX keeps a bf16 chain bf16
    return summed / div.to(x.dtype)


def stochastic_uniforms(shape, generator: torch.Generator, device):
    """Uniforms in [1e-6, 1) of `shape` for STOCHASTIC pooling's TRAIN race,
    from `generator`. The one place the pooling draws random numbers: its
    bits differ from jax.random.uniform's, so parity tests replace this
    function with one that returns JAX's uniforms. On a batch shard, the
    whole batch's uniforms cut to the rank's rows (batch axis 0), as
    dropout's masks are (ops/collectives.py)."""
    u = collectives.data_draw(
        shape, 0, lambda s: torch.rand(s, generator=generator, device=device))
    return 1e-6 + u * (1.0 - 1e-6)


def _patches(arr, oh, ow, kernel, stride, pads, fill):
    """(N, C, H, W) -> (N, C, OH, OW, KH*KW): each output position's window
    elements along the last axis (one strided slice per kernel offset)."""
    a = _padded(arr, pads[0], pads[1], fill)
    ps = [a[:, :, i:i + (oh - 1) * stride[0] + 1:stride[0],
            j:j + (ow - 1) * stride[1] + 1:stride[1]]
          for i in range(kernel[0]) for j in range(kernel[1])]
    return torch.stack(ps, dim=-1)


def stochastic_pool(x, *, kernel, stride, pad=(0, 0),
                    generator: torch.Generator | None = None,
                    deterministic: bool = True):
    """Stochastic pooling (Caffe pooling_layer.cu STOCHASTIC). TEST (or no
    generator): the value-weighted average sum(x^2)/sum(x) over the window,
    0/0 read as 0/1. TRAIN: each window samples one element with
    probability proportional to its value, as an exponential race (score
    x / -log(u) for x > 0, else 0; the window's largest score wins, the
    first on ties). The race runs over each window's own patch, so that
    overlapping windows (stride < kernel) never share a winner: JAX's
    comment records the reduce-window formulation that did."""
    _, _, h, w = x.shape
    oh, ow, pad_h, pad_w = _pool_geometry(h, w, kernel, stride, pad)
    if deterministic or generator is None:
        num = _window_sum(x * x, kernel, stride, pad_h, pad_w)
        den = _window_sum(x, kernel, stride, pad_h, pad_w)
        return num / torch.where(den == 0, torch.ones_like(den), den)
    u = stochastic_uniforms(x.shape, generator, x.device)
    score = torch.where(x > 0, x / -torch.log(u), 0.0)
    sc = _patches(score, oh, ow, kernel, stride, (pad_h, pad_w), -math.inf)
    xs = _patches(x, oh, ow, kernel, stride, (pad_h, pad_w), 0.0)
    idx = torch.argmax(sc, dim=-1, keepdim=True)
    return torch.gather(xs, -1, idx)[..., 0]
