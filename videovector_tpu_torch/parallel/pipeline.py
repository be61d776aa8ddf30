"""Pipeline parallelism for the seq2seq (LstmEncDec) workload; counterpart
of videovector_tpu/parallel/pipeline.py.

The reference's trajectory nets are encoder -> decoder chains
(ref:src/caffe/layers/lstm_enc_dec_layer.cpp:21-207): a 2-stage pipeline.
Stage 0 (the encoder) and stage 1 (decoder + readout + loss) are the two
ranks of the mesh's "model" axis. The batch splits into M microbatches;
while stage 1 decodes microbatch i, stage 0 encodes microbatch i+1 (the
GPipe schedule: M + 1 ticks, one bubble tick at each end, which does no
work here). The encoder's final cell, the only inter-stage tensor, crosses
with a broadcast from stage 0 in the 2-rank stage group (the JAX package's
ppermute [(0, 1)]); its backward is a broadcast of the cell's gradient
from stage 1. A broadcast is all gloo offers for CUDA tensors, so one code
path serves NCCL and gloo.

The params enter through one copy whose backward sums their gradients
over the two stages in one all_reduce (JAX's transpose of the cast to
varying), so both stages end with the whole gradient. A zero "token"
leaves that copy, passes through every transfer and enters the loss: each
rank's autograd then runs the transfers' backwards in one order (the
reverse of the ticks), with both stages in each, and the gradient sum
after them all.

Composes with data parallelism: the batch shards over "data" (batch axis
1: time-major), the loss is averaged over it.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch.convert import leaves_with_paths, tree_from_paths
from videovector_tpu_torch.ops import collectives
from videovector_tpu_torch.ops.collectives import (
    Axis, active_axes, all_reduce, broadcast,
)
from videovector_tpu_torch.ops.linear import dot
from videovector_tpu_torch.ops.recurrent import LstmState, lstm, lstm_enc_dec
from videovector_tpu_torch.ops.sharding import mesh_axis

STAGE_AXIS = "model"   # pipeline stages ride the model axis of the 2D mesh
DATA_AXIS = "data"


def _split_microbatches(x, num_mb: int, batch_axis: int = 1):
    """(T, B, ...) -> (M, T, B/M, ...): microbatch-major. `batch_axis` is
    honoured by the split: the (num_mb, chunk) factor expands in place at
    that axis, then moves to the front."""
    b = x.shape[batch_axis]
    if b % num_mb:
        raise ValueError(f"batch {b} not divisible by {num_mb} microbatches")
    parts = x.reshape(*x.shape[:batch_axis], num_mb, b // num_mb,
                      *x.shape[batch_axis + 1:])
    return torch.movedim(parts, batch_axis, 0), x.shape[0]


class _Transfer(torch.autograd.Function):
    """Stage 0's payload on both stages (a broadcast from stage 0); the
    backward broadcasts the payload's gradient from stage 1. `token` is a
    zero scalar passed through, which orders the backwards."""

    @staticmethod
    def forward(ctx, payload, token, ax):
        ctx.ax = ax
        return broadcast(payload, ax, 0), token.view_as(token)

    @staticmethod
    def backward(ctx, g, g_token):
        return broadcast(g.contiguous(), ctx.ax, 1), g_token, None


class _StageSum(torch.autograd.Function):
    """The params as they are, and the first token; the backward sums every
    param's gradient over the stages in one all_reduce. Its backward needs
    the token's gradient, so it runs after every transfer's, on both
    stages."""

    @staticmethod
    def forward(ctx, ax, token, *leaves):
        ctx.ax = ax
        ctx.shapes = [l.shape for l in leaves]
        return (token.view_as(token),) + tuple(l.view_as(l) for l in leaves)

    @staticmethod
    def backward(ctx, g_token, *grads):
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), ctx.ax)
        out, at = [], 0
        for s in ctx.shapes:
            n = s.numel()
            out.append(flat[at:at + n].reshape(s))
            at += n
        return (None, g_token, *out)


def pp_encdec_loss(params, batch, *, num_microbatches: int,
                   clip_threshold: float = 0.0, stage_axis: Axis = None):
    """The rank's share of the pipeline loss; run on both ranks of the
    2-rank `stage_axis` (default: the active "model" axis).
    params = {"enc": lstm, "dec": lstm, "readout": {w, b}}, the same on both
    stages. batch = {observed, cont_obs, predicted, cont_pred, gt}, time-major
    (T, B, ...).

    Returns the Euclidean displacement loss (sum sq / (2 rows), the
    reference EuclideanLoss normalization after FLATTEN_BATCH), the same on
    both stages."""
    ax = stage_axis if stage_axis is not None else collectives.axis(
        STAGE_AXIS)
    if ax is None or ax.size != 2:
        raise ValueError("pp_encdec_loss runs on a 2-rank stage axis")
    stage = ax.index
    m = num_microbatches
    paths, leaves = zip(*leaves_with_paths(params))
    dev = leaves[0].device
    token, *leaves = _StageSum.apply(ax, torch.zeros((), device=dev),
                                     *leaves)
    params = tree_from_paths(zip(paths, leaves))
    enc_x, _ = _split_microbatches(batch["observed"], m)
    enc_c, _ = _split_microbatches(batch["cont_obs"], m)
    dec_x, _ = _split_microbatches(batch["predicted"], m)
    dec_c, _ = _split_microbatches(batch["cont_pred"], m)
    gt, t_pred = _split_microbatches(batch["gt"], m)

    bm = enc_x.shape[2]
    hidden = params["dec"]["w_h"].shape[0]
    zero_cell = torch.zeros((bm, hidden), dtype=enc_x.dtype, device=dev)
    received = zero_cell
    sq_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(m + 1):     # GPipe: m + 1 ticks, the bubbles do nothing
        payload = zero_cell
        if stage == 0 and t < m:
            _, st = lstm(params["enc"], enc_x[t], enc_c[t],
                         state=LstmState(zero_cell, zero_cell),
                         clip_threshold=clip_threshold)
            payload = st.c
        elif stage == 1 and t >= 1:
            td = t - 1
            h, _ = lstm(params["dec"], dec_x[td], dec_c[td],
                        state=LstmState(received, zero_cell),
                        clip_threshold=clip_threshold)
            tt = h.shape[0]
            pred = (dot(h.reshape(tt * bm, hidden), params["readout"]["w"])
                    + params["readout"]["b"]).reshape(tt, bm, -1)
            sq_sum = sq_sum + torch.sum((pred - gt[td]) ** 2)
        if t < m:
            received, token = _Transfer.apply(payload.contiguous(), token,
                                              ax)
    # the loss lives on stage 1 (stage 0 holds zeros): share it; the token
    # (zero) ties every transfer into both stages' graphs
    sq_sum = collectives.model_sum(sq_sum + 0.0 * token, ax)
    rows = t_pred * bm * m   # FLATTEN_BATCH row count of this data shard
    return sq_sum / (2.0 * rows)


def make_pp_loss_fn(mesh, *, num_microbatches: int,
                    clip_threshold: float = 0.0):
    """loss(params, batch) over a (data, model=2) mesh: the rank's batch
    rows (shard_batch with batch axis 1 for every key), the encoder/decoder
    pipeline over "model", the loss averaged over "data". Differentiable:
    backward, then average the gradients over "data"
    (parallel.train.all_reduce_grads), for a PP(+DP) train step."""
    n = mesh.size(mesh.mesh_dim_names.index(STAGE_AXIS))
    if n != 2:
        raise ValueError(f"pipeline has 2 stages; mesh {STAGE_AXIS}={n}")
    stage_ax = mesh_axis(mesh, STAGE_AXIS)
    data_ax = mesh_axis(mesh, DATA_AXIS)

    def loss_fn(params, batch):
        loss = pp_encdec_loss(params, batch,
                              num_microbatches=num_microbatches,
                              clip_threshold=clip_threshold,
                              stage_axis=stage_ax)
        with active_axes(data=data_ax):
            return collectives.data_mean(loss)

    return loss_fn


def reference_encdec_loss(params, batch, *, clip_threshold: float = 0.0):
    """Single-device oracle for the pipeline: plain lstm_enc_dec + readout +
    Euclidean loss."""
    _, dec_h = lstm_enc_dec(params["enc"], params["dec"],
                            batch["observed"], batch["cont_obs"],
                            batch["predicted"], batch["cont_pred"],
                            clip_threshold=clip_threshold)
    t, b, hidden = dec_h.shape
    pred = (dot(dec_h.reshape(t * b, hidden), params["readout"]["w"])
            + params["readout"]["b"]).reshape(t, b, -1)
    rows = pred.shape[0] * pred.shape[1]
    return torch.sum((pred - batch["gt"]) ** 2) / (2.0 * rows)

