"""Parameters carried across from the JAX package.

The port keeps the JAX models' layouts (HWIO conv weights, (in, out) fc
weights with fc6's rows in H, W, C order), so a JAX parameter tree converts
by casting and placing each leaf: no transposes.
"""

from __future__ import annotations

import numpy as np
import torch


def map_params(fn, tree):
    """Apply `fn` to every leaf of a nested dict of parameters."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree, *, device="cpu"):
    """A tree of numpy arrays (e.g. `jax.tree.map(np.asarray, params)` of
    RetrievalPipeline's {"mednet": ..., "tower": ...} or
    VideoEmbeddingModel's {"tower": ...}) -> the same tree of f32 tensors."""
    return map_params(
        lambda a: torch.as_tensor(np.array(a, np.float32), device=device),
        tree)
