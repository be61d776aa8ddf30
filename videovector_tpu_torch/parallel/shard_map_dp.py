"""Explicit-collective data parallelism with a controllable gradient wire
format; counterpart of videovector_tpu/parallel/shard_map_dp.py.

parallel/train.py averages the gradients in f32. At the flagship's shape
that is 67.1 MB a step of all_reduce. Here the loss runs per shard, as in
the JAX package's shard_map body (its mean over the rank's rows, its
dropout masks the rank's own), and the gradients can cross the wire in
bfloat16 (33.6 MB): cast to `psum_dtype`, all_reduce mean over "data",
back to f32 before the update. Momentum and master weights stay f32, so
the only change is the rounding of each step's gradient.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch.convert import map_params
from videovector_tpu_torch.core.seeds import derived_seed
from videovector_tpu_torch.ops.collectives import all_reduce
from videovector_tpu_torch.ops.sharding import (
    all_reduce_grads, mesh_axis, mesh_device,
)
from videovector_tpu_torch.parallel.train import shard_batch
from videovector_tpu_torch.solver.solvers import SolverConfig, solver_update
from videovector_tpu_torch.solver.train import value_and_grad

# the stream tag of a data shard's own dropout masks
DP_SHARD_STREAM = 0x44505348


def make_dp_train_step(loss_fn, solver_cfg: SolverConfig, mesh, *,
                       psum_dtype=None, lr_mults=None, decay_mults=None,
                       distinct_dropout_per_shard: bool = True):
    """Build step(params, state, batch, generator) -> (params, state,
    metrics) where the gradient all-reduce is an explicit mean over "data",
    in `psum_dtype` (e.g. torch.bfloat16) on the wire when given.

    params/state replicated; batch["data"] the rank's rows (place_dp).
    loss_fn(params, batch, generator) -> (loss, aux_dict of scalars), the
    rank's rows alone; the loss and each aux are averaged over "data" (f32).

    distinct_dropout_per_shard: each data rank after the first draws its
    masks from a generator of its own, seeded from the step generator's
    seed and its index (the JAX package folds the axis index into the key);
    rank 0 keeps the step generator, so one rank draws what the unsharded
    step draws. False: every rank draws from the step generator, the same
    masks."""
    ax = mesh_axis(mesh, "data")
    wire = psum_dtype
    shard_gen = torch.Generator(device=mesh_device(mesh))
    vg = value_and_grad(loss_fn)

    def step(params, state, batch, generator):
        gen = generator
        if distinct_dropout_per_shard and ax.index > 0:
            shard_gen.manual_seed(derived_seed(generator.initial_seed(),
                                               DP_SHARD_STREAM + ax.index))
            gen = shard_gen
        (loss, aux), g = vg(params, {"data": batch["data"]}, gen)
        g = all_reduce_grads(g, mesh, wire_dtype=wire)
        p2, s2 = solver_update(solver_cfg, params, g, state,
                               lr_mults=lr_mults, decay_mults=decay_mults)
        loss = all_reduce(loss, ax, mean=True)
        aux = {k: all_reduce(torch.as_tensor(v, dtype=torch.float32),
                             ax, mean=True) for k, v in aux.items()}
        return p2, s2, {"loss": loss, **aux}

    return step


def place_dp(params, state, batch, mesh):
    """Placement helper: params/state replicated on the rank's device, the
    batch's rows cut on axis 0 over "data"."""
    dev = mesh_device(mesh)
    place = (lambda t: torch.as_tensor(t, device=dev))
    state = {"iter": state["iter"],
             "history": map_params(place, state["history"])}
    return (map_params(place, params), state,
            shard_batch(batch, mesh) if batch else {})
