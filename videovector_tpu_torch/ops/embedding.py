"""Embedding-table lookup (the ID_TO_WEIGHT_MAPPING layer); counterpart of
videovector_tpu/ops/embedding.py.

Caffe's id_to_weight_mapping_layer.cpp gathers rows of a (num_ids, dim)
table by integer id in forward and scatter-adds the output gradient into
those rows in backward (no gradient to the ids); autograd of the gather
gives exactly that.
"""

from __future__ import annotations

import torch


def id_to_weight_lookup(ids, table):
    """ids: (M,) or (M, 1), any dtype (truncated to int32, as JAX's astype);
    table: (num_ids, dim) -> (M, dim).

    The JAX function's jnp.take(mode="fill", fill_value=nan): an id in
    [-num_ids, 0) counts from the end, as a numpy index does, and any other
    id outside [0, num_ids) gives a row of NaN and no gradient, so that a
    corrupt id stream shows as a NaN loss."""
    n = table.shape[0]
    flat = torch.as_tensor(ids, device=table.device).reshape(-1) \
        .to(torch.int32).long()
    valid = (flat >= -n) & (flat < n)
    rows = table[torch.where(valid, torch.remainder(flat, n),
                             torch.zeros_like(flat))]
    return torch.where(valid[:, None], rows, torch.full(
        (), float("nan"), dtype=table.dtype, device=table.device))
