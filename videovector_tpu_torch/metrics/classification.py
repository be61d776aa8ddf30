"""Per-class classification statistics; counterpart of
videovector_tpu/metrics/classification.py.

ref:src/caffe/layers/classification_stats_layer.cpp:35-95. Outputs per-class
accuracy, per-class AP, and overall accuracy.

Deliberate deviation, as in the JAX package: the reference initializes its
per-class score list with `num` dummy (0, false) entries that then take part
in the AP sort (classification_stats_layer.cpp:43-44); AP here is over the
real items only, which matches the reference whenever all real scores are
positive and ranked above 0.
"""

from __future__ import annotations

import torch


def classification_stats(scores, labels, *, num_classes: int):
    """scores: (N, C) tensor; labels: (N,) int. Computes on the device of
    `scores`.

    Returns dict(per_class_accuracy (C,), per_class_ap (C,), accuracy
    scalar). Classes with no samples report 0 (as the reference does); a
    label outside [0, C), such as -1, belongs to no class (jax.nn.one_hot's
    zero row) and counts as a wrong prediction.
    """
    n = scores.shape[0]
    dev = scores.device
    labels = torch.as_tensor(labels, device=dev).reshape(-1).to(torch.int32)
    pred = torch.argmax(scores, dim=1)            # first maximum on ties
    correct = (pred == labels).to(torch.float32)

    classes = torch.arange(num_classes, dtype=torch.int32, device=dev)
    onehot = (labels[:, None] == classes[None, :]).to(torch.float32)  # (N, C)
    class_count = torch.sum(onehot, dim=0)                            # (C,)
    per_class_correct = torch.sum(onehot * correct[:, None], dim=0)
    per_class_acc = torch.where(
        class_count > 0,
        per_class_correct / torch.clamp(class_count, min=1.0), 0.0)

    # AP per class: rank all N items by class score descending; relevant =
    # items whose true label is that class; AP = mean of ret/val at relevant
    # positions, normalized by class count (ref :74-83).
    order = torch.argsort(-scores, dim=0, stable=True)                # (N, C)
    rel = torch.gather(onehot, 0, order)                              # (N, C)
    val = torch.arange(n, dtype=torch.float32, device=dev)[:, None] + 1.0
    ret = torch.cumsum(rel, dim=0)
    ap = torch.sum(rel * ret / val, dim=0)
    per_class_ap = torch.where(
        class_count > 0, ap / torch.clamp(class_count, min=1.0), 0.0)

    return {
        "per_class_accuracy": per_class_acc,
        "per_class_ap": per_class_ap,
        "accuracy": torch.mean(correct),
    }
