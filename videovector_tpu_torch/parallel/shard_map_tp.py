"""Explicit-collective tensor parallelism for the flagship tower; counterpart
of videovector_tpu/parallel/shard_map_tp.py.

The tower weight (D, E) is column-sharded over "model": each rank computes
its E/m embedding columns on K1 (bf16 operands, f32 sum), with no
communication in the GEMM. The scores need full-row sums, so each of the
five partial sums (|ctx|², |tgt|², |neg|², ctx·tgt, ctx·neg) takes one
all_reduce over "model" (8 bytes a row, or 4·N for ctx·neg). Its backward
is the identity: the loss after it is whole on every model rank, and each
rank's columns are its own.

Data parallelism composes on "data": the loss is averaged and the
violation count summed over it (ops/losses.py::max_margin_loss under the
data axis), and a train step averages the gradients over it.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch.core.seeds import derived_seed
from videovector_tpu_torch.ops import activations
from videovector_tpu_torch.ops.collectives import (
    active_axes, model_sum,
)
from videovector_tpu_torch.ops.linear import no_tf32, shard_matmul
from videovector_tpu_torch.ops.losses import max_margin_loss
from videovector_tpu_torch.ops.sharding import (
    mesh_axis, mesh_device, rank_rows,
)

# the stream tag of a model shard's own dropout masks
TP_SHARD_STREAM = 0x54505348


def make_tp_loss_fn(cfg, mesh):
    """Build loss(params, batch, generator) over the rank's shards.
    params["tower"]["w"]: (D, E/m), b: (E/m,) (place_tp_params);
    batch["data"]: the rank's (B/d, R, D) rows. Returns (loss, aux), the
    same on every rank.

    Dropout: each model rank's columns take their own masks, as the JAX
    package folds the model index into the key (independent masks on
    disjoint columns are elementwise dropout of the whole matrix). Model
    rank 0 draws from `generator`, the others from generators seeded from
    its seed and their index; data ranks draw alike."""
    n_ctx = cfg.num_context
    dax, max_ = mesh_axis(mesh, "data"), mesh_axis(mesh, "model")
    shard_gen = torch.Generator(device=mesh_device(mesh))

    def loss_fn(params, batch, generator=None):
        w, b = params["tower"]["w"], params["tower"]["b"]
        data = batch["data"]
        bsz, roles, dim = data.shape
        h = activations.relu(shard_matmul(
            data.reshape(bsz * roles, dim), w, b,
            compute_dtype=torch.bfloat16))
        if cfg.dropout_rate > 0 and generator is not None:
            keep = 1.0 - cfg.dropout_rate
            gen = generator
            if max_.index > 0:
                gen = shard_gen.manual_seed(derived_seed(
                    generator.initial_seed(), TP_SHARD_STREAM + max_.index))
            mask = activations.dropout_mask(h.shape, keep, gen, h.device)
            h = activations.apply_dropout(h, mask, keep)
        h = h.reshape(bsz, roles, -1)
        tgt = h[:, 0]
        ctx = torch.mean(h[:, 1:1 + n_ctx], dim=1)
        negs = h[:, 1 + n_ctx:]

        # the explicit collectives: full-row norms and dots over "model"
        ctx_sq = model_sum(torch.sum(ctx * ctx, -1), max_)
        tgt_sq = model_sum(torch.sum(tgt * tgt, -1), max_)
        neg_sq = model_sum(torch.sum(negs * negs, -1), max_)
        ctx_tgt = model_sum(torch.sum(ctx * tgt, -1), max_)
        with no_tf32():
            ctx_neg = model_sum(torch.einsum("bnd,bd->bn", negs, ctx), max_)

        eps = 1e-10
        one = torch.ones((), device=h.device)
        zero = torch.zeros((), device=h.device)
        denom_t = (torch.sqrt(torch.where(ctx_sq > 0, ctx_sq, one))
                   * torch.sqrt(torch.where(tgt_sq > 0, tgt_sq, one)))
        s_true = torch.where((ctx_sq > 0) & (tgt_sq > 0),
                             ctx_tgt / (denom_t + eps), zero)
        denom_n = (torch.sqrt(torch.where(ctx_sq > 0, ctx_sq, one))[:, None]
                   * torch.sqrt(torch.where(neg_sq > 0, neg_sq, one)))
        s_neg = torch.where((ctx_sq[:, None] > 0) & (neg_sq > 0),
                            ctx_neg / (denom_n + eps), zero)
        # the loss averaged, the violations summed, over "data"
        with active_axes(data=dax):
            loss, violations = max_margin_loss(
                torch.broadcast_to(s_true[:, None], s_neg.shape), s_neg,
                margin=cfg.margin, norm=cfg.norm)
        return loss, {"violations": violations}

    return loss_fn


def place_tp_params(params, mesh):
    """The tower's (D, E) weight and (E,) bias cut to the rank's columns,
    on its device."""
    ax = mesh_axis(mesh, "model")
    dev = mesh_device(mesh)
    w = torch.as_tensor(params["tower"]["w"], device=dev)
    b = torch.as_tensor(params["tower"]["b"], device=dev)
    return {"tower": {"w": rank_rows(w, ax, 1, "tower weight"),
                      "b": rank_rows(b, ax, 0, "tower bias")}}
