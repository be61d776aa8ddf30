"""Sharded train/eval steps; counterpart of videovector_tpu/parallel/train.py.

Each rank runs the step on its shard: forward and backward of its batch
rows, one all_reduce of each gradient over "data" (the mean, in f32), and
the Caffe update. Layout, as the JAX package's GSPMD annotations:

- batch: each key split on its batch axis over "data" (`shard_batch`);
- params: replicated over "data"; with the model axis on, every 2-D param
  column-sharded over "model" (the tower weight (D, E) -> (D, E/m)), the
  rest replicated (`shard_params`);
- solver history: sharded like its param (it is built from the shards).

The ops see the axes through ops/collectives.py: a loss over the batch is
the whole batch's on every rank (so the metrics come out replicated, as
GSPMD's do), dropout masks are the whole batch's mask cut to the rank's
rows, and the fc GEMM runs on the rank's column shard on K1 with an
all_gather over "model" after it (ops/linear.py::tower_matmul).
"""

from __future__ import annotations

from typing import Callable

import torch

from videovector_tpu_torch.convert import map_params
from videovector_tpu_torch.ops.sharding import (
    all_reduce_grads, axes_of, batch_rows, local_rows, mesh_axis,
    mesh_device, rank_rows,
)
# JAX's name for the params' layout, here as in the JAX package
from videovector_tpu_torch.ops.sharding import shard_params  # noqa: F401
from videovector_tpu_torch.solver.solvers import SolverConfig, solver_update
from videovector_tpu_torch.solver.train import (
    accumulate_microbatches, value_and_grad,
)


def shard_batch(batch, mesh, axes: dict | None = None):
    """The rank's rows of every leaf, split along its batch axis (default:
    leading) over "data", on the rank's device. `axes` maps top-level dict
    keys to the axis to split: time-major sources (tracking layers emit
    (T, B, ...)) declare axis 1 via their `batch_axes()`."""
    ax = mesh_axis(mesh, "data")
    dev = mesh_device(mesh)
    if isinstance(batch, dict):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in batch_rows(batch, ax, axes).items()}
    return torch.as_tensor(rank_rows(batch, ax), device=dev)


def make_train_step(loss_fn: Callable, solver_cfg: SolverConfig, mesh, *,
                    lr_mults=None, decay_mults=None, donate: bool = True,
                    opt_barrier="auto", grad_microbatch: int = 0,
                    batch_axes=None):
    """Build `step(params, state, batch, generator) -> (params, state,
    metrics)` over the rank's shards (shard_params, shard_batch).

    loss_fn(params, batch, generator) -> (loss, aux_dict), written with the
    port's ops (which see the mesh axes): its loss and aux are then the
    whole batch's, the same on every rank. The gradient is averaged over
    "data" once, in f32, after the microbatch accumulation.

    grad_microbatch > 1 splits the rank's rows into that many microbatches,
    sums their gradients and applies ONE update (the reference's iter_size
    accumulation). batch_axes maps batch dict keys to their batch axis for
    the split, and is required for dict batches then: a silent default of
    axis 0 would split a role-major (R, B, ...) batch on the role axis.
    Each rank splits its own rows, so with dropout on and more than one
    data rank the microbatches pair masks and rows otherwise than one
    device does (the gradient is the same with dropout off).

    `donate` and `opt_barrier` are the JAX signature's: buffers are not
    donated in eager PyTorch, and the barrier is not ported
    (solver/train.py has none)."""
    def step(params, state, batch, generator):
        n_micro = grad_microbatch
        micro = bool(n_micro and n_micro > 1)
        if micro and isinstance(batch, dict) and batch_axes is None:
            raise ValueError(
                "grad_microbatch requires batch_axes (e.g. {'data': 0} "
                "for batch-leading or {'data': 1} for role-major "
                "layouts): the split axis must be declared, not guessed")
        axes = (batch_axes or {}) if isinstance(batch, dict) else {}
        rows = local_rows(batch, axes)
        vg = value_and_grad(loss_fn)
        with axes_of(mesh, batch=(rows // n_micro if micro and rows
                                  else rows)):
            if micro:
                grads, loss_sum, aux_all = accumulate_microbatches(
                    vg, params, batch, axes, n_micro, generator)
                grads = map_params(lambda g: g / n_micro, grads)
                # the displayed loss is the microbatch mean; other outputs
                # are the last microbatch's (counts must not average)
                loss = loss_sum / n_micro
                aux = aux_all[-1]
            else:
                (loss, aux), grads = vg(params, batch, generator)
        grads = all_reduce_grads(grads, mesh)
        params2, state2 = solver_update(solver_cfg, params, grads, state,
                                        lr_mults=lr_mults,
                                        decay_mults=decay_mults)
        return params2, state2, {"loss": loss, **aux}

    return step


def make_eval_step(eval_fn: Callable, mesh):
    """eval_fn(params, batch) over the rank's shards, without gradients; its
    outputs (the port's ops, which see the mesh) are replicated."""
    def step(params, batch):
        with torch.no_grad(), axes_of(mesh, batch=local_rows(batch)):
            return eval_fn(params, batch)
    return step
