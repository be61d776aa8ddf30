"""Device-mesh helpers; counterpart of videovector_tpu/parallel/mesh.py.

The JAX package runs one process over many devices and names them with a
`jax.sharding.Mesh` of axes ("data", "model"). PyTorch runs one process a
device, so a port mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the default process group with the same two axes:

  "data"  - batch (DP): each rank holds its rows, gradients are averaged
            over the axis once a step
  "model" - embedding columns (TP): the 2-D params column-sharded

Rank r is device (r // model, r % model), the row-major order of the JAX
package's `np.array(devices).reshape(data, model)`. Shards and collectives
are explicit (ops/collectives.py), as in the JAX package's shard_map
modules: params and batches are plain local tensors, the rank's shard.

The backend is NCCL on cards and gloo on the CPU. A caller may start the
group itself (multihost_worker.launch_workers does); otherwise `make_mesh`
starts it, from torchrun's environment (`python -m torch.distributed.run`
sets MASTER_ADDR, WORLD_SIZE, RANK and LOCAL_RANK; rank r takes card
LOCAL_RANK) or, for a one-rank mesh, from an in-memory store. A larger mesh
with neither raises and says how to launch ranks.

A rank's view of the mesh (its axes, device and shards) is
ops/sharding.py's, which the layers below parallel/ read.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from videovector_tpu_torch.device import DEFAULT, resolve


def _device_type(devices) -> str:
    if devices is None:
        return DEFAULT
    if isinstance(devices, (list, tuple)):
        devices = devices[0]
    return torch.device(devices).type


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> DeviceMesh:
    """Build a (data, model) mesh over the default process group. Defaults:
    every rank on the data axis. `devices`: the device type of the ranks
    ("cuda", the default, or "cpu"), or a list of devices whose type is
    taken.

    "model" maps to adjacent ranks (the per-step tensor-parallel
    collectives stay within a node), "data" spans the rest (the gradient
    all-reduce runs once a step)."""
    dev_type = _device_type(devices)
    if dev_type == "cuda":
        resolve("cuda")
        if "LOCAL_RANK" in os.environ:
            # a launcher's rank: the card torchrun gives this process
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if not dist.is_initialized():
        backend = "nccl" if dev_type == "cuda" else "gloo"
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            # started by torch.distributed.run: its rendezvous
            dist.init_process_group(backend, init_method="env://")
        else:
            want = (data if data is not None else 1) * model
            if want != 1:
                raise RuntimeError(
                    f"a {data}x{model} mesh needs {want} ranks, and no "
                    "process group is initialised: start one process a "
                    "device (python -m torch.distributed.run "
                    f"--nproc_per_node {want} ..., or "
                    "parallel.multihost_worker.launch_workers)")
            # a one-rank group needs no rendezvous: an in-memory store
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n}")
    if dev_type == "cuda" and "LOCAL_RANK" not in os.environ \
            and not torch.cuda.is_initialized():
        # no launcher picked the card: rank r takes card r % count, the
        # placement torchrun's LOCAL_RANK gives on one host
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    grid = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(dev_type, grid, mesh_dim_names=("data", "model"))
