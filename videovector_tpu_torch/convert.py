"""Parameters and solver state carried across from and to the JAX package.

The port keeps the JAX models' layouts (HWIO conv weights, (in, out) fc
weights with fc6's rows in H, W, C order), so a JAX parameter tree converts
by casting and placing each leaf: no transposes.
"""

from __future__ import annotations

import numpy as np
import torch

from videovector_tpu_torch.ops.recurrent import LstmState


def map_params(fn, tree):
    """Apply `fn` to every leaf of a nested dict of parameters."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves_with_paths(tree, prefix=()):
    """(key path, leaf) for every leaf of a nested dict, in dict order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_from_paths(pairs) -> dict:
    """The nested dict holding each (key path, leaf) of `pairs`."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def params_from_jax(tree, *, device="cpu"):
    """A tree of numpy arrays (e.g. `jax.tree.map(np.asarray, params)` of
    RetrievalPipeline's {"mednet": ..., "tower": ...} or
    VideoEmbeddingModel's {"tower": ...}) -> the same tree of f32 tensors."""
    return map_params(
        lambda a: torch.as_tensor(np.array(a, np.float32), device=device),
        tree)


def params_to_numpy(tree):
    """A tree of tensors (any device) or arrays -> the same tree of numpy
    arrays, e.g. to hand back to the JAX package."""
    return map_params(
        lambda t: (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t)), tree)


def state_from_jax(state, *, device="cpu"):
    """A JAX solver state ({"iter": int32 scalar, "history": tree}, e.g.
    through `jax.device_get`) -> the port's ({"iter": int, "history": tree
    of f32 tensors})."""
    return {"iter": int(np.asarray(state["iter"])),
            "history": params_from_jax(state["history"], device=device)}


def state_to_numpy(state):
    """The port's solver state -> {"iter": np.int32, "history": numpy
    tree}, the JAX package's layout (jnp.asarray of each leaf gives its
    state)."""
    return {"iter": np.int32(state["iter"]),
            "history": params_to_numpy(state["history"])}


def lstm_state_from_jax(carry, *, device="cpu"):
    """A JAX LSTM carry ({layer name: LstmState(c, h)}, e.g. through
    `jax.device_get`, or one LstmState) -> the port's, f32 tensors."""
    if isinstance(carry, dict):
        return {k: lstm_state_from_jax(v, device=device)
                for k, v in carry.items()}
    c, h = carry
    return LstmState(*(torch.as_tensor(np.array(a, np.float32), device=device)
                       for a in (c, h)))


def lstm_state_to_numpy(carry):
    """The port's LSTM carry ({layer name: LstmState}, or one LstmState) ->
    the same structure of (c, h) numpy pairs; the JAX package's LstmState
    takes them (`LstmState(*pair)`)."""
    if isinstance(carry, dict):
        return {k: lstm_state_to_numpy(v) for k, v in carry.items()}
    return tuple(t.detach().cpu().numpy() for t in carry)
