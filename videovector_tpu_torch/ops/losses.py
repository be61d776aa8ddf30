"""Loss functions; counterpart of videovector_tpu/ops/losses.py (the
flagship's max-margin ranking loss; the other losses come with the
product-path slice). Gradients come from autograd."""

from __future__ import annotations

import torch


def max_margin_loss(true_scores, bogus_scores, *, margin: float = 1.0,
                    norm: str = "L2", weights=None):
    """Ranking hinge over (true, bogus) score pairs (Caffe
    max_margin_loss_layer.cpp). With h = max(0, margin - (s_true - s_bogus))
    and a per-element weight w (1 if absent):

      L1: loss = sum(w * h) / count
      L2: loss = sum(w * h^2) / count

    count = h.numel(). Returns (loss, num_violations), the latter the number
    of elements with s_true < s_bogus, as f32."""
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
    return loss, num_violations
