"""Loss functions; counterpart of videovector_tpu/ops/losses.py.

Each loss returns a scalar normalized exactly as Caffe's layer does (the
constants differ between losses). Every normalizer is the rank's own row
count, equal on every rank of a batch shard, so there each loss is the
mean of the ranks' losses (ops/collectives.py's data_mean): the whole
batch's loss, on every rank. Gradients come from autograd, as the JAX
package's come from JAX's: every hinge is torch.maximum against a zero
tensor, whose gradient at a tie is 0.5 as jnp.maximum's is (torch.clamp
would give 1), and |x| is ops.activations.absval, whose gradient at 0 is
+1 as jnp.abs's is (torch.abs's is 0).
"""

from __future__ import annotations

import math

import torch

from videovector_tpu_torch.ops import collectives
from videovector_tpu_torch.ops.activations import absval

LOG_THRESHOLD = 1e-20  # Caffe's kLOG_THRESHOLD (multinomial_logistic_loss_layer.cpp)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _labels(labels, device) -> torch.Tensor:
    """Caffe's float label blob as int64 row indices (truncated, as JAX's
    astype(int32) truncates)."""
    return torch.as_tensor(labels, device=device).reshape(-1) \
        .to(torch.int32).long()


def max_margin_loss(true_scores, bogus_scores, *, margin: float = 1.0,
                    norm: str = "L2", weights=None):
    """Ranking hinge over (true, bogus) score pairs (Caffe
    max_margin_loss_layer.cpp). With h = max(0, margin - (s_true - s_bogus))
    and a per-element weight w (1 if absent):

      L1: loss = sum(w * h) / count
      L2: loss = sum(w * h^2) / count

    count = h.numel(). Returns (loss, num_violations), the latter the number
    of elements with s_true < s_bogus, as f32. On a batch shard both are the
    whole batch's (ops/collectives.py: equal shards, so the mean of the
    shards' means; the count summed)."""
    diff = true_scores - bogus_scores
    h = torch.maximum(torch.zeros((), dtype=diff.dtype, device=diff.device),
                      margin - diff)
    w = (torch.ones_like(h) if weights is None
         else torch.broadcast_to(torch.as_tensor(weights, device=h.device),
                                 h.shape))
    count = h.numel()
    if norm == "L1":
        loss = torch.sum(w * h) / count
    elif norm == "L2":
        loss = torch.sum(w * h * h) / count
    else:
        raise ValueError(f"Unknown norm {norm!r}")
    num_violations = torch.sum((diff < 0).to(torch.float32))
    return collectives.data_mean(loss), collectives.data_sum(num_violations)


def euclidean_loss(pred, target, *, l1: bool = False):
    """L2: sum((a - b)^2) / (2 num); l1: sum(|a - b|) / num
    (Caffe euclidean_loss_layer.cpp)."""
    diff = pred - target
    num = pred.shape[0]
    if l1:
        return collectives.data_mean(torch.sum(absval(diff)) / num)
    return collectives.data_mean(torch.sum(diff * diff) / num / 2.0)


def hinge_loss(scores, labels, *, norm: str = "L1"):
    """Multiclass hinge (Caffe hinge_loss_layer.cpp): the true class's score
    changes sign, h = max(0, 1 + s); L1: sum(h) / num, L2: sum(h^2) / num."""
    num = scores.shape[0]
    lab = _labels(labels, scores.device)
    sign = torch.ones_like(scores)
    sign[torch.arange(num, device=scores.device), lab] = -1.0
    h = torch.maximum(_zero(scores), 1.0 + scores * sign)
    if norm == "L1":
        return collectives.data_mean(torch.sum(h) / num)
    if norm == "L2":
        return collectives.data_mean(torch.sum(h * h) / num)
    raise ValueError(f"Unknown norm {norm!r}")


def softmax_loss(logits, labels):
    """Softmax and the negative log likelihood at the label, averaged over
    num (Caffe softmax_loss_layer.cpp); the log prob is floored at
    log(LOG_THRESHOLD)."""
    num = logits.shape[0]
    lab = _labels(labels, logits.device)
    logp = torch.log_softmax(logits.reshape(num, -1), dim=-1)
    picked = logp.gather(1, lab[:, None])[:, 0]
    floor = torch.full((), math.log(LOG_THRESHOLD), dtype=picked.dtype,
                       device=picked.device)
    return collectives.data_mean(-torch.sum(torch.maximum(picked, floor))
                                 / num)


def multinomial_logistic_loss(probs, labels):
    """Negative log likelihood of already normalized probabilities, each
    floored at LOG_THRESHOLD (Caffe multinomial_logistic_loss_layer.cpp)."""
    num = probs.shape[0]
    lab = _labels(labels, probs.device)
    p = probs.reshape(num, -1).gather(1, lab[:, None])[:, 0]
    return collectives.data_mean(-torch.sum(torch.log(torch.maximum(
        p, torch.full((), LOG_THRESHOLD, dtype=p.dtype, device=p.device))))
        / num)


def sigmoid_cross_entropy_loss(logits, targets):
    """sum of the per-element logistic cross-entropy / num, in the
    overflow-safe form log(1 + exp(-|x|)) + max(x, 0) - x t
    (Caffe sigmoid_cross_entropy_loss_layer.cpp)."""
    num = logits.shape[0]
    targets = torch.as_tensor(targets, device=logits.device)
    loss = torch.sum(torch.nn.functional.softplus(-absval(logits))
                     + torch.maximum(logits, _zero(logits))
                     - logits * targets)
    return collectives.data_mean(loss / num)


def infogain_loss(probs, labels, infogain):
    """-sum_j H[label, j] log(max(p_j, LOG_THRESHOLD)) / num
    (Caffe infogain_loss_layer.cpp)."""
    num = probs.shape[0]
    lab = _labels(labels, probs.device)
    p = probs.reshape(num, -1)
    p = torch.maximum(p, torch.full((), LOG_THRESHOLD, dtype=p.dtype,
                                    device=p.device))
    h = torch.as_tensor(infogain, device=probs.device)[lab]
    return collectives.data_mean(-torch.sum(h * torch.log(p)) / num)


def contrastive_loss(a, b, similar, *, margin: float = 1.0):
    """Legacy Caffe's contrastive loss on squared distances
    (contrastive_loss_layer.cpp): the mean over pairs of
    [y d^2 + (1 - y) max(margin - d^2, 0)] / 2."""
    d2 = torch.sum((a - b) ** 2, dim=tuple(range(1, a.dim())))
    y = torch.as_tensor(similar, device=a.device).reshape(-1).to(a.dtype)
    per_pair = y * d2 + (1.0 - y) * torch.maximum(margin - d2, _zero(d2))
    return collectives.data_mean(torch.sum(per_pair) / a.shape[0] / 2.0)


def accuracy(scores, labels, *, top_k: int = 1):
    """Top-k accuracy (Caffe accuracy_layer.cpp), f32. The top k are those
    of jax.lax.top_k: on equal scores the lower index ranks first (a
    stable descending sort; torch.topk promises no order at ties)."""
    num = scores.shape[0]
    lab = _labels(labels, scores.device)
    flat = scores.reshape(num, -1)
    top_idx = torch.argsort(flat, dim=1, descending=True, stable=True)[:, :top_k]
    hit = torch.any(top_idx == lab[:, None], dim=1)
    return collectives.data_mean(torch.mean(hit.to(torch.float32)))
