"""Multi-process input pipeline for the data-parallel axis; counterpart of
videovector_tpu/parallel/multihost.py.

One process a device: every rank loads its own slice of the global batch
and never sees the rest. The JAX package assembles per-host slices into
global jax.Arrays; here the rank's slice is the whole story, a local tensor
on the rank's device, which the sharded steps (parallel/train.py) take as
is.

- `host_shard_range(n, mesh)`: this rank's [start, stop) of a global batch
  axis of n, from its index on "data" (ranks on one "model" row share it).
- `global_batch_from_local(batch, mesh, axes)`: the rank's rows (already
  cut) on its device.
- `global_batch_from_device_shards(batch, mesh)`: the rank's rows cut from
  a host-global batch on axis 0.
- `replicate_global(tree, mesh)`: the same values on every rank.
- `HostShardedSource`: a batch source whose rank emits only its rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from videovector_tpu_torch.convert import map_params
from videovector_tpu_torch.ops.collectives import Axis, all_reduce, broadcast
from videovector_tpu_torch.ops.sharding import (
    batch_rows, mesh_axis, mesh_device, rank_rows,
)


def host_shard_range(global_batch: int, mesh) -> tuple[int, int]:
    """[start, stop) of the global batch this rank must produce: its block
    of the "data" axis (mesh order)."""
    ax = mesh_axis(mesh, "data")
    if global_batch % ax.size:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"data axis {ax.size}")
    per = global_batch // ax.size
    return ax.index * per, (ax.index + 1) * per


def _place(leaf, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(leaf) if not isinstance(
        leaf, torch.Tensor) else leaf, device=dev)


def global_batch_from_local(batch: dict, mesh,
                            axes: dict | None = None) -> dict:
    """The rank's batch rows (host_shard_range sized, along each key's batch
    axis: `axes`, default 0) as tensors on its device: what shard_batch
    gives for the global batch. `axes` is the JAX signature's; the rows are
    already cut, so it only documents the layout here."""
    dev = mesh_device(mesh)
    return {k: _place(v, dev) for k, v in batch.items()}


def global_batch_from_device_shards(batch: dict, mesh) -> dict:
    """The rank's rows of a host-global batch, cut on axis 0 over "data", on
    its device."""
    ax = mesh_axis(mesh, "data")
    dev = mesh_device(mesh)

    def place(leaf):
        leaf = np.asarray(leaf)
        if leaf.shape[0] % ax.size:
            raise ValueError(
                f"leading dim {leaf.shape[0]} not divisible by data axis "
                f"{ax.size}")
        return _place(rank_rows(leaf, ax), dev)
    return {k: place(v) for k, v in batch.items()}


def replicate_global(tree, mesh):
    """A host tree (the same values on every rank: a deterministic init
    from a shared seed) as tensors on each rank's device. Under __debug__
    each leaf is broadcast from rank 0 and compared: a rank whose values
    differ raises on every rank (the flag is all-reduced, so no rank is left
    waiting in a collective)."""
    dev = mesh_device(mesh)
    out = map_params(lambda l: _place(l, dev), tree)
    if __debug__ and dist.get_world_size() > 1:
        world = Axis(dist.group.WORLD, dist.get_world_size(),
                     dist.get_rank())
        bad = torch.zeros((), dtype=torch.int32, device=dev)
        for t in _leaves(out):
            if not torch.equal(broadcast(t, world), t):
                bad += 1
        if int(all_reduce(bad, world)):
            raise ValueError("replicate_global: ranks hold different values "
                             "(seed every rank alike)")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class HostShardedSource:
    """A batch source whose rank emits only its slice of the global batch,
    on its device.

    With `simulate=True`, source.next_batch() yields the GLOBAL batch on
    every rank (the same deterministic stream) and the wrapper cuts the
    rank's rows (host_shard_range); a deployment points each rank's source
    at its own data range and passes simulate=False. The source's
    `batch_axes()` ride through: time-major tracking batches are (T, B, ...)
    and split on axis 1, not on time."""

    def __init__(self, source, mesh, *, simulate: bool = False):
        self.source = source
        self.mesh = mesh
        self.simulate = simulate
        self.axes = (dict(source.batch_axes())
                     if hasattr(source, "batch_axes") else {})

    def batch_axes(self) -> dict:
        return dict(self.axes)

    def next_batch(self) -> dict:
        batch = self.source.next_batch()
        if self.simulate:
            batch = batch_rows({k: np.asarray(v) for k, v in batch.items()},
                               mesh_axis(self.mesh, "data"), self.axes)
        return global_batch_from_local(batch, self.mesh, self.axes)

    def __iter__(self):
        while True:
            yield self.next_batch()
