"""A rank's view of a device mesh: its axes and device, its rows of a batch,
its shard of the params, which rank writes, and what a run does differently
on a mesh (`MeshRun`).

parallel/mesh.py builds the mesh (a DeviceMesh of axes "data" and "model",
one process a device). The layers that take a mesh (the graph's sinks, the
metrics, the solver's train loop, the tools) read it through this module,
so that none of them imports parallel/; the collectives are
ops/collectives.py's.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch
import torch.distributed as dist

from videovector_tpu_torch.convert import map_params
from videovector_tpu_torch.ops.collectives import Axis, active_axes, all_gather


def mesh_axis(mesh, name: str) -> Axis:
    """This rank's view of the mesh axis `name`: its group, size and index
    (looked up once a mesh: a step asks for it every call)."""
    axes = mesh.__dict__.setdefault("_vvtpu_axes", {})
    if name not in axes:
        axes[name] = Axis(mesh.get_group(name),
                          mesh.size(mesh.mesh_dim_names.index(name)),
                          mesh.get_local_rank(name))
    return axes[name]


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_writer(mesh) -> bool:
    """True on the one rank that writes files and logs (rank 0), and
    without a mesh."""
    return mesh is None or dist.get_rank() == 0


@contextlib.contextmanager
def writer_logs(mesh):
    """The block's INFO log lines come from the writer rank alone
    (is_writer): logging below WARNING is off on the other ranks while it
    runs."""
    quiet = not is_writer(mesh)
    prev = logging.root.manager.disable
    if quiet:
        logging.disable(logging.INFO)
    try:
        yield
    finally:
        if quiet:
            logging.disable(prev)


def axes_of(mesh, *, data: bool = True, model: bool = True,
            batch: int | None = None, time_major: bool = False):
    """A context (ops/collectives.active_axes) in which the ops see the
    mesh's axes: "data" when the batch is sharded (`batch`: the rank's rows),
    "model" when the 2-D params are."""
    return active_axes(data=mesh_axis(mesh, "data") if data else None,
                       model=mesh_axis(mesh, "model") if model else None,
                       batch=batch, time_major=time_major)


def rank_rows(x, ax: Axis, dim: int = 0, what: str = "batch"):
    """The rank's block of x along `dim`, the ax.index-th of ax.size equal
    blocks: a contiguous copy of a host array or a tensor (so that only the
    rank's rows go on to its device). Raises when the axis does not
    divide."""
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"{what}: axis {dim} of length {n} not divisible "
                         f"by the mesh axis's {ax.size} ranks")
    per = n // ax.size
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(ax.index * per, (ax.index + 1) * per)
    part = x[tuple(idx)]
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


def batch_rows(batch: dict, ax: Axis, axes: dict | None = None) -> dict:
    """rank_rows of every key along its batch axis (`axes`, default 0)."""
    axes = axes or {}
    return {k: rank_rows(v, ax, axes.get(k, 0), f"batch key {k!r}")
            for k, v in batch.items()}


def local_rows(batch, axes: dict | None = None) -> int | None:
    """The batch rows of the first key (its batch axis from `axes`)."""
    if not isinstance(batch, dict):
        return int(batch.shape[0])
    axes = axes or {}
    for k, v in batch.items():
        a = axes.get(k, 0)
        if getattr(v, "dim", lambda: 0)() > a:
            return int(v.shape[a])
    return None


def shard_params(params, mesh, *, model_axis: bool = False):
    """The rank's params on its device: replicated over "data", and with
    `model_axis` every 2-D param cut to the rank's columns (the JAX
    package's default layout, `_param_pspec`)."""
    ax = mesh_axis(mesh, "model")
    dev = mesh_device(mesh)

    def place(leaf):
        t = torch.as_tensor(leaf, device=dev)
        if model_axis and t.dim() == 2:
            t = rank_rows(t, ax, 1, f"param of shape {tuple(t.shape)}")
        return t
    return map_params(place, params)


def unshard_params(params, mesh, *, model_axis: bool = False):
    """The whole params from the ranks' shards (shard_params' inverse): the
    2-D params gathered over "model" on every rank."""
    ax = mesh_axis(mesh, "model")
    if not model_axis or ax.size == 1:
        return params
    return map_params(
        lambda t: all_gather(t, ax, 1) if t.dim() == 2 else t, params)


def all_reduce_grads(grads, mesh, *, wire_dtype=None):
    """Each gradient averaged over "data": one all_reduce per leaf, in
    `wire_dtype` on the wire (default: the gradient's, f32), back to the
    gradient's dtype. The gradients are reduced in place (with no wire
    dtype). Runs at one rank too (there it is the identity)."""
    ax = mesh_axis(mesh, "data")

    def reduce(g):
        w = g.to(wire_dtype) if wire_dtype is not None else g
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=ax.group)
        if ax.size > 1:
            w = w.div_(ax.size)
        return w.to(g.dtype)
    return map_params(reduce, grads)


class MeshRun:
    """What a run (training, a test pass, an extraction) does differently
    on a mesh, and nothing without one (mesh=None): cut the rank's rows of
    a host batch (each key on its batch axis, `batch_axes`), run functions
    under the mesh's axes, shard the params (2-D columns over "model" when
    that axis spans more than one rank) and put them back whole, average
    gradients over "data", gather blobs back whole, and write and log on
    the writer rank alone. `time_major`: the blobs carry the batch on axis
    1 (tracking sources), for DROPOUT's masks."""

    def __init__(self, mesh, batch_axes: dict | None = None,
                 time_major: bool = False):
        self.mesh = mesh
        self.batch_axes = dict(batch_axes or {})
        self.time_major = time_major
        self.writer = is_writer(mesh)
        if mesh is not None:
            self.data = mesh_axis(mesh, "data")
            self.model_axis = mesh.size(1) > 1

    def rows(self, batch: dict) -> dict:
        return batch if self.mesh is None else batch_rows(
            batch, self.data, self.batch_axes)

    def shard(self, tree):
        return tree if self.mesh is None else shard_params(
            tree, self.mesh, model_axis=self.model_axis)

    def whole(self, tree):
        return tree if self.mesh is None else unshard_params(
            tree, self.mesh, model_axis=self.model_axis)

    def reduce(self, grads):
        return grads if self.mesh is None else all_reduce_grads(grads,
                                                                self.mesh)

    def gather(self, blobs: dict) -> dict:
        """The whole batch of each blob of the rank's rows (batch axis 0)."""
        return blobs if self.mesh is None else {
            k: all_gather(v, self.data, 0) for k, v in blobs.items()}

    def axes(self, *, data: bool = True, rows=None):
        if self.mesh is None:
            return contextlib.nullcontext()
        return axes_of(self.mesh, data=data, batch=rows,
                       time_major=self.time_major)

    def under_axes(self, fn, *, data: bool = True):
        """fn(params, batch, ...) run under the mesh's axes; `data`: the
        batch is the rank's rows."""
        if self.mesh is None:
            return fn

        def run(p, batch, *args, **kw):
            rows = local_rows(batch, self.batch_axes) if data else None
            with self.axes(data=data, rows=rows):
                return fn(p, batch, *args, **kw)
        return run
