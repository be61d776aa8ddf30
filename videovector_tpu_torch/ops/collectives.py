"""Collectives over the axes of a device mesh, and the context that tells the
ops which axes they run under.

The JAX package runs one program over many devices: GSPMD inserts the
collectives of a sharded step, and `shard_map` bodies name them
(`lax.psum`, `lax.all_gather`, `lax.ppermute`). The port runs one process a
device (parallel/mesh.py): every tensor is the rank's own shard, and the
collectives are these functions, each a `torch.distributed` call on the
process group of one mesh axis ("data" or "model").

An op that reduces over the batch (a loss's mean, a count, a retrieval
eval over the whole batch) asks `axis("data")` whether the batch it sees is
a shard, and if so returns the global value, the same on every rank, as
GSPMD's step does. The gradient convention that makes this exact: each
rank's gradient is d times its share of the true gradient (d = the data
axis's size), and the train step averages the gradients over "data" once.
A local mean over equal shards already has that gradient; so `data_mean`
passes its gradient through unchanged, and `data_gather` hands each rank d
times its slice. On the "model" axis the loss is computed whole on every
rank, so `model_gather`'s backward is the rank's slice, `model_sum`'s is
the identity, and `model_copy` (the identity forward) sums the gradient of
a replicated input over the ranks that used it in column shards
(Megatron's f and g pair).

gloo has no all_gather for CUDA tensors. There the gathers are an
all_reduce of a zero tensor with the rank's slot filled, which is exact
(every element is one rank's value plus zeros).
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis as seen from this rank: its process group, its size
    and this rank's index along it."""
    group: Any
    size: int
    index: int


# the active axes by name ("data", "model"), and the data shard's layout
# (`batch`: the rank's rows of the batch axis; `time_major`: blobs carry the
# batch on axis 1). A module global, not a thread-local: autograd's backward
# threads read what each Function saved at forward, never this.
_ACTIVE: dict[str, Axis] = {}
_LAYOUT: dict[str, Any] = {}


@contextlib.contextmanager
def active_axes(*, data: Axis | None = None, model: Axis | None = None,
                batch: int | None = None, time_major: bool = False):
    """Run the block with the given mesh axes active (None: not sharded on
    that axis). `batch` is the rank's batch rows, which the dropout layer
    needs to find a blob's batch axis."""
    saved = dict(_ACTIVE), dict(_LAYOUT)
    _ACTIVE.clear()
    _ACTIVE.update({k: v for k, v in (("data", data), ("model", model))
                    if v is not None})
    _LAYOUT.clear()
    _LAYOUT.update(batch=batch, time_major=time_major)
    try:
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(saved[0])
        _LAYOUT.clear()
        _LAYOUT.update(saved[1])


def axis(name: str) -> Axis | None:
    """The active axis `name` when it spans more than one rank, else None
    (a one-rank axis's collectives are the identity and are skipped)."""
    a = _ACTIVE.get(name)
    return a if a is not None and a.size > 1 else None


def layout() -> dict:
    return dict(_LAYOUT)


# -- raw collectives (no autograd) ------------------------------------------

def _gathers_by_reduce(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, ax: Axis, *, mean: bool = False):
    """The sum (or mean) of x over the axis: a new tensor."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ax.group)
    return y / ax.size if mean else y


def all_gather(x: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """The axis's shards of x concatenated along `dim`, in axis order."""
    x = x.detach().contiguous()
    dim = dim % max(x.dim(), 1)
    if _gathers_by_reduce(x, ax.group):
        dt = x.dtype
        wide = torch.int32 if dt == torch.bool else dt
        slots = torch.zeros((ax.size,) + tuple(x.shape), dtype=wide,
                            device=x.device)
        slots[ax.index] = x.to(wide)
        dist.all_reduce(slots, op=dist.ReduceOp.SUM, group=ax.group)
        parts = list(slots.to(dt).unbind(0))
    else:
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, ax: Axis, src_index: int = 0) -> torch.Tensor:
    """x of the rank at `src_index` along the axis, on every rank."""
    y = x.detach().clone().contiguous()
    src = dist.get_global_rank(ax.group, src_index)
    dist.broadcast(y, src=src, group=ax.group)
    return y


def my_slice(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


# -- differentiable collectives -------------------------------------------

class _Reduce(torch.autograd.Function):
    """all_reduce sum (or mean) forward; the gradient times `scale`."""

    @staticmethod
    def forward(ctx, x, ax, mean, scale):
        ctx.scale = scale
        return all_reduce(x, ax, mean=mean)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1 else g * ctx.scale), None, None, None


class _Gather(torch.autograd.Function):
    """all_gather along `dim` forward; the gradient is this rank's slice
    times `scale`."""

    @staticmethod
    def forward(ctx, x, ax, dim, scale):
        ctx.ax, ctx.dim, ctx.scale = ax, dim % x.dim(), scale
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        s = my_slice(g, ctx.ax, ctx.dim)
        return (s if ctx.scale == 1 else s * ctx.scale), None, None, None


class _Copy(torch.autograd.Function):
    """The identity forward; the gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis of a per-shard mean (equal shards): the
    global mean. Gradient unchanged (see the module docstring)."""
    ax = axis("data")
    return x if ax is None else _Reduce.apply(x, ax, True, 1)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data axis (counts)."""
    ax = axis("data")
    return x if ax is None else _Reduce.apply(x, ax, False, ax.size)


def data_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole batch of a batch-sharded x (its batch axis `dim`)."""
    ax = axis("data")
    return x if ax is None else _Gather.apply(x, ax, dim, ax.size)


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated input entering a column-parallel product."""
    ax = axis("model")
    return x if ax is None else _Copy.apply(x, ax)


def model_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The column shards of x put back together along `dim`."""
    ax = axis("model")
    return x if ax is None else _Gather.apply(x, ax, dim, 1)


def model_sum(x: torch.Tensor, ax: Axis | None = None) -> torch.Tensor:
    """The sum of per-shard partial sums over the model axis (psum):
    gradient unchanged, the loss after it being whole on every rank."""
    ax = ax if ax is not None else axis("model")
    return x if ax is None or ax.size == 1 else _Reduce.apply(x, ax, False, 1)


def data_draw(shape, axis_: int, draw):
    """`draw(global_shape)` of the whole batch, cut to this rank's rows: a
    random tensor that is the one-device draw's slice. `shape` is the
    rank's, with its batch on `axis_`. Off the data axis, draw(shape)."""
    ax = axis("data")
    if ax is None:
        return draw(tuple(shape))
    shape = list(shape)
    shape[axis_] *= ax.size
    return my_slice(draw(tuple(shape)), ax, axis_)
