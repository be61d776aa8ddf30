"""The k largest scores of each row on the card: csrc/top_k_rows.cu.

`top_k_rows(scores, k)` gives the (..., min(k, G)) values and int64
indices of the k largest of each row of G f32 scores, in the order of
`top_k_stable_plain` (models/retrieval_pipeline.py), a stable descending
sort, bit for bit: values descending, equal values by the lower index
first, -0.0 equal to +0.0, NaN above +inf (lax.top_k's order but at
signed zeros, which XLA ranks +0.0 first). It
launches the kernel pair through the custom op `vvtpu::top_k_rows`, whose
fake gives the outputs' shapes, so that a captured graph or
`torch.export` sees one node. It reads each score once and keeps k
candidates a thread (the source's note); the number of slices a row is
split into comes from the shape alone (`slices`). Forward only: a call
that autograd records raises. The counter `vvtpu.topk.launches` adds each
launch of the pair (utils/timer.py); `top_k_stable` counts the calls.
"""

from __future__ import annotations

import functools

import torch

from videovector_tpu_torch import _build
from videovector_tpu_torch.ops.hopper.matmul import forward_only
from videovector_tpu_torch.utils.timer import count

MAX_K = 32
THREADS = 256          # csrc/top_k_rows.cu's kThreads
# no slice holds fewer scores than two 16-byte loads a thread: below that a
# slice's time is its merge's, and more slices only add merges (on an H100,
# 50 x 1,000,000 scores take the same time from 6 to 32 slices a row, one
# row of 20,000 from 10 slices on)
MIN_SLICE = 2 * 4 * THREADS
# stage 1 asks for about this many CTAs on each SM
CTAS_PER_SM = 6


def slices(rows: int, cols: int, sms: int) -> int:
    """How many slices each of `rows` rows of `cols` scores is cut into: as
    many as put about CTAS_PER_SM CTAs on each of the card's `sms` SMs,
    and none shorter than MIN_SLICE."""
    most = max(1, cols // MIN_SLICE)
    want = -(-CTAS_PER_SM * sms // rows)
    return max(1, min(most, want))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def top_k_rows(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row of CUDA f32 `scores`
    (the last axis), through the kernel pair (module docstring)."""
    forward_only(scores)
    return torch.ops.vvtpu.top_k_rows(scores, k)


def _check(scores, k):
    if scores.dtype != torch.float32 or scores.dim() < 1:
        raise TypeError(f"top_k_rows takes f32 scores with a last axis, got "
                        f"{scores.dtype} of shape {tuple(scores.shape)}")
    if not 0 <= k <= MAX_K:
        raise ValueError(f"top_k_rows keeps 0 to {MAX_K} scores a row, not "
                         f"{k}")


def _out_shape(scores, k):
    return (*scores.shape[:-1], min(k, scores.shape[-1]))


@torch.library.custom_op(
    "vvtpu::top_k_rows", mutates_args=(),
    schema="(Tensor scores, int k) -> (Tensor, Tensor)")
def _top_k_rows_op(scores: torch.Tensor, k: int):
    """`top_k_rows` as a custom op: the kernel pair's launch."""
    _check(scores, k)
    return _top_k_rows_kernel(scores, k)


@_top_k_rows_op.register_fake
def _top_k_rows_fake(scores, k):
    _check(scores, k)
    shape = _out_shape(scores, k)
    return (scores.new_empty(shape),
            scores.new_empty(shape, dtype=torch.int64))


def _top_k_rows_kernel(scores, k):
    """One launch of csrc/top_k_rows.cu's two stages, counted."""
    if scores.device.type != "cuda":
        raise ValueError(f"top_k_rows runs on CUDA tensors, not "
                         f"{scores.device}")
    shape = _out_shape(scores, k)
    values = torch.empty(shape, dtype=torch.float32, device=scores.device)
    indices = torch.empty(shape, dtype=torch.int64, device=scores.device)
    if values.numel() == 0:
        return values, indices
    cols = scores.shape[-1]
    x = scores.reshape(-1, cols)
    if x.stride(1) != 1:
        x = x.contiguous()
    rows, kept = x.shape[0], shape[-1]
    index = scores.device.index or 0
    lib = _build.load_library()
    s = slices(rows, cols, _sms(index))
    scratch = torch.empty(rows * s * MAX_K, dtype=torch.int64,
                          device=scores.device)
    rc = lib.vv_top_k_rows(
        x.data_ptr(), x.stride(0), rows, cols, kept, s,
        scratch.data_ptr(), values.data_ptr(), indices.data_ptr(), index,
        torch.cuda.current_stream(scores.device).cuda_stream)
    _build.check(rc, "top_k_rows")
    count("vvtpu.topk.launches", 1)
    return values, indices
