"""Plain reference of the `videovec-embed-4096` configuration: the paper's
ranking-embedding step and its test eval (arXiv:1505.00315; the reference
Caffe fork's projects/videovec_embedding/mednet_embedding_train.prototxt).

TRAIN, for a (B, R, D) batch with R = 1 target + C context + N negatives:
the R role blobs stacked role-major into (R.B, D), the shared fc7 tower
x.W + b, ReLU, dropout (keep 1 - ratio, kept units divided by keep), the
context mean (ELTWISE SUM with coefficient 1/C, folded left to right), L2
normalization of the context mean, the target and each negative
(x / (||x|| + 1e-10), zero rows stay zero), cosine scores, and the L2
max-margin loss mean(max(0, margin - (s_true - s_neg))^2) over the B x N
pairs. Caffe SGD: h = momentum.h + lr.lr_mult.(g + decay.decay_mult.w),
w = w - h, with the `inv` rate lr = base_lr (1 + gamma.it)^-power.

TEST: the mean of the C context shots, the tower without dropout, L2
normalization, and the retrieval statistics of the reference's
RETRIEVAL_STATS layer with class = video id: per query every other row
ranked by -2 x.y ascending (ties by row index), AP over the matches,
hit@1 a match in first place, hit@5 the matches among the first 5 over 5.

Dropout masks are drawn again from the seed, as the program's training
loop seeds them: one generator on the batch's device, seeded at each
iteration with SplitMix64(seed << 32 | it), one uniform draw of the (R.B,
E) tower blob, kept where below keep.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vvbench.reference import l2_normalize, matmul_precision

_MASK64 = (1 << 64) - 1


def iteration_seed(seed: int, it: int) -> int:
    """SplitMix64 of (seed << 32 | it), both as 32-bit words."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def learning_rate(solver: dict, it: int) -> float:
    """Caffe's `inv` policy in f32."""
    f32 = np.float32
    base = f32(1.0) + f32(solver["gamma"]) * f32(it)
    return float(f32(solver["base_lr"]) * f32(np.power(base, f32(-solver["power"]),
                                                        dtype=np.float32)))


def dropout_mask(rows: int, width: int, keep: float, seed: int, it: int,
                 device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(iteration_seed(seed, it))
    return torch.rand((rows, width), generator=gen, device=device) < keep


def loss(w, b, data, mask, keep: float, cfg: dict):
    """The TRAIN loss of one (B, R, D) batch; `mask` the (R.B, E) keep
    mask, or None for no dropout."""
    bsz, roles, dim = data.shape
    n_ctx = cfg["context_size"] - 1
    x = data.transpose(0, 1).reshape(roles * bsz, dim)
    h = F.relu(x @ w + b)
    if mask is not None:
        h = torch.where(mask, h / torch.tensor(keep, dtype=h.dtype,
                                               device=h.device),
                        torch.zeros((), dtype=h.dtype, device=h.device))
    e = h.view(roles, bsz, -1)
    coeff = 1.0 / n_ctx
    ctx = coeff * e[1]
    for c in range(2, 1 + n_ctx):
        ctx = ctx + coeff * e[c]
    ctxn = l2_normalize(ctx)
    tgt = l2_normalize(e[0])
    negs = e[1 + n_ctx:]
    negn = l2_normalize(negs.reshape(-1, negs.shape[-1])).view(negs.shape)
    s_true = torch.sum(ctxn * tgt, dim=1)
    s_neg = torch.sum(ctxn[None] * negn, dim=2).T
    hinge = torch.clamp(cfg["margin"] - (s_true[:, None] - s_neg), min=0.0)
    return torch.mean(hinge * hinge)


def train_steps(params: dict, batches: list, cfg: dict, solver: dict,
                mults: dict, seed: int, *, start_iter: int = 0,
                history: dict | None = None, tf32: bool = False,
                half_batch: bool = False) -> dict:
    """len(batches) SGD steps from `params` ({"w", "b"}) at iterations
    start_iter, start_iter + 1, ..., from the momentum `history` (zero if
    None), each batch's dropout drawn for its iteration. Returns the losses,
    the params after each step, and the tower's live units: those whose
    bias gradient is not zero in some step (a unit with no active row in a
    step has none). `tf32` computes in TF32 (the control); `half_batch`
    takes each loss over the first half of the batch only (a fault)."""
    keep = 1.0 - cfg["dropout"]
    w, b = params["w"].clone(), params["b"].clone()
    hist = ({"w": torch.zeros_like(w), "b": torch.zeros_like(b)}
            if history is None else {k: v.clone() for k, v in history.items()})
    losses, after = [], []
    live = torch.zeros(w.shape[1], dtype=torch.bool, device=w.device)
    for it, data in enumerate(batches, start=start_iter):
        bsz, roles, _ = data.shape
        mask = dropout_mask(roles * bsz, w.shape[1], keep, seed, it,
                            data.device)
        if half_batch:
            mask = mask.view(roles, bsz, -1)[:, :bsz // 2].reshape(
                -1, w.shape[1])
            data = data[:bsz // 2]
        wv, bv = w.requires_grad_(True), b.requires_grad_(True)
        with torch.enable_grad(), matmul_precision(tf32):
            value = loss(wv, bv, data, mask, keep, cfg)
            gw, gb = torch.autograd.grad(value, (wv, bv))
        w, b = w.detach(), b.detach()
        live |= gb != 0
        rate = learning_rate(solver, it)
        new = {}
        for name, p, g in (("w", w, gw), ("b", b, gb)):
            d = g + solver["weight_decay"] * mults["decay"][name] * p
            hist[name] = (solver["momentum"] * hist[name]
                          + rate * mults["lr"][name] * d)
            new[name] = p - hist[name]
        w, b = new["w"], new["b"]
        losses.append(float(value.detach()))
        after.append({"w": w.clone(), "b": b.clone()})
    return {"losses": losses, "params": after, "live": live}


def retrieval_stats(feats: torch.Tensor, classes: torch.Tensor,
                    tf32: bool = False) -> dict:
    """mAP, hit@1, hit@5 of every row against the others (unit rows)."""
    n = feats.shape[0]
    with matmul_precision(tf32):
        dist = -2.0 * (feats @ feats.T)
    dist[torch.arange(n), torch.arange(n)] = -1e15
    order = torch.argsort(dist, dim=1, stable=True)
    valid = (torch.arange(n, device=feats.device) >= 1)[None, :].expand(n, n)
    match = valid & (classes[order] == classes[:, None])
    vf, mf = valid.to(torch.float64), match.to(torch.float64)
    val, ret = torch.cumsum(vf, 1), torch.cumsum(mf, 1)
    total = ret[:, -1]
    ap = torch.sum(mf * ret / torch.clamp(val, min=1.0), 1)
    ap = torch.where(total > 0, ap / torch.clamp(total, min=1.0), 0.0)
    hit1 = torch.sum(mf * (val <= 1.0), 1)
    hit5 = torch.sum(mf * (val <= 5.0), 1) / 5.0
    include = (classes >= 0).to(torch.float64)
    denom = torch.clamp(include.sum(), min=1.0)
    return {"test_map": float((ap * include).sum() / denom),
            "test_hit1": float((hit1 * include).sum() / denom),
            "test_hit5": float((hit5 * include).sum() / denom)}


def test_eval(params: dict, data: torch.Tensor, video_ids: torch.Tensor,
              cfg: dict, tf32: bool = False) -> dict:
    """The TEST net's statistics on a (N, C, D) batch of context shots."""
    n_ctx = data.shape[1]
    coeff = 1.0 / n_ctx
    with matmul_precision(tf32):
        avg = coeff * data[:, 0]
        for c in range(1, n_ctx):
            avg = avg + coeff * data[:, c]
        emb = l2_normalize(F.relu(avg @ params["w"] + params["b"]))
    return retrieval_stats(emb, video_ids.to(torch.int64), tf32)
