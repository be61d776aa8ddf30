"""Optimizers with Caffe-exact semantics; counterpart of
videovector_tpu/solver/solvers.py (SGD, Nesterov, AdaGrad; the fixed, step,
exp and inv lr policies).

Update rules (per leaf; d = grad + local_decay * reg(w), local_rate = rate *
lr_mult, local_decay = weight_decay * decay_mult; reg = identity for L2,
sign for L1):

  SGD:       h <- momentum * h + local_rate * d ;  w <- w - h
  Nesterov:  h0 = h ; h <- momentum * h + local_rate * d
             w <- w - ((1 + momentum) * h - momentum * h0)
  AdaGrad:   h <- h + d^2 ;  w <- w - local_rate * d / (sqrt(h) + delta)

Momentum multiplies the lr-scaled gradient (Caffe's convention). The
operations run in the JAX function's order, each in f32, and the learning
rate is an f32 value computed as JAX computes it, so both packages follow
the same trajectory. `SolverConfig.from_message` reads a solver prototxt
parsed by `videovector_tpu_torch.config.parse`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from videovector_tpu_torch.convert import (
    leaves_with_paths, map_params, tree_from_paths,
)


@dataclass
class SolverConfig:
    """Mirror of Caffe's SolverParameter, defaults as in the proto."""
    solver_type: str = "SGD"            # SGD | NESTEROV | ADAGRAD
    base_lr: float = 0.01
    lr_policy: str = "fixed"            # fixed | step | exp | inv
    gamma: float = 0.0001
    power: float = 0.75
    stepsize: int = 100000
    momentum: float = 0.0
    weight_decay: float = 0.0
    regularization_type: str = "L2"     # L2 | L1
    delta: float = 1e-8                 # AdaGrad
    max_iter: int = 0
    iter_size: int = 1
    # extension: microbatch split of each step's batch (the fused
    # large-batch schedule). -1 = auto (solver.train.auto_grad_microbatch),
    # 0/1 = off, N = explicit
    grad_microbatch: int = -1
    display: int = 0
    test_interval: int = 0
    test_iter: tuple = ()
    snapshot: int = 0
    snapshot_prefix: str = ""
    snapshot_after_train: bool = True
    snapshot_diff: bool = False         # store gradients in snapshots
    test_initialization: bool = True    # test at iter 0
    test_compute_loss: bool = False     # include the test net's loss
    random_seed: int = -1
    # extension: "vv" (the npz pair) or "caffe" (also the reference's
    # .caffemodel/.solverstate pair), for the prototxt-level solver
    snapshot_format: str = "vv"
    # the JAX package's choice of PRNG for the dropout keys; checked here as
    # there, so that one config serves both packages. The port draws its
    # masks from a torch.Generator (Philox) either way.
    dropout_prng: str = "threefry"
    # net, train_net, test_net, solver_mode, device_id as the prototxt has
    # them (for the prototxt-level solver)
    extras: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.solver_type == "ADAGRAD" and self.momentum:
            # the update rule has no momentum term: a nonzero value would be
            # ignored without a word (Caffe's AdaGrad sanity check)
            raise ValueError("Momentum cannot be used with AdaGrad.")
        if self.dropout_prng not in ("threefry", "rbg"):
            raise ValueError(
                f"dropout_prng must be 'threefry' or 'rbg', "
                f"got {self.dropout_prng!r}")

    @classmethod
    def from_message(cls, msg) -> "SolverConfig":
        """Build from a parsed solver prototxt Message (the JAX package's
        field mapping: solver_type by name or enum number, test_iter as a
        tuple, the net and device fields into `extras`)."""
        type_map = {0: "SGD", 1: "NESTEROV", 2: "ADAGRAD",
                    "SGD": "SGD", "NESTEROV": "NESTEROV", "ADAGRAD": "ADAGRAD"}
        kw: dict[str, Any] = {}
        for fname in ("base_lr", "lr_policy", "gamma", "power", "stepsize",
                      "momentum", "weight_decay", "regularization_type",
                      "delta", "max_iter", "iter_size", "grad_microbatch",
                      "display", "test_interval", "snapshot",
                      "snapshot_prefix", "snapshot_after_train",
                      "snapshot_diff", "test_initialization",
                      "test_compute_loss", "random_seed", "snapshot_format",
                      "dropout_prng"):
            if msg.has(fname):
                kw[fname] = msg.get(fname)
        if msg.has("solver_type"):
            kw["solver_type"] = type_map[msg.get("solver_type")]
        if msg.has("test_iter"):
            kw["test_iter"] = tuple(int(v) for v in msg.get_list("test_iter"))
        cfg = cls(**kw)
        cfg.extras = {k: msg.get(k) for k in ("net", "train_net", "test_net",
                                              "solver_mode", "device_id")
                      if msg.has(k)}
        return cfg


def _f32_pow(base, exponent) -> np.float32:
    """base ** exponent for f32 operands, rounded once to f32 (XLA's f32
    power agrees with this at the lr schedule's points; PyTorch's
    vectorized f32 pow does not always)."""
    return np.float32(np.float64(np.float32(base))
                      ** np.float64(np.float32(exponent)))


def learning_rate(cfg: SolverConfig, it) -> np.float32:
    """Caffe's GetLearningRate, as an f32 value computed in f32 as the JAX
    package computes it (a Python-float lr drifts the trajectory by ~1e-8).
    """
    f32 = np.float32
    itf = f32(int(it))
    if cfg.lr_policy == "fixed":
        return f32(cfg.base_lr)
    if cfg.lr_policy == "step":
        current_step = np.floor(itf / f32(cfg.stepsize))
        return f32(f32(cfg.base_lr) * _f32_pow(cfg.gamma, current_step))
    if cfg.lr_policy == "exp":
        return f32(f32(cfg.base_lr) * _f32_pow(cfg.gamma, itf))
    if cfg.lr_policy == "inv":
        base = f32(f32(1.0) + f32(cfg.gamma) * itf)
        return f32(f32(cfg.base_lr) * _f32_pow(base, -cfg.power))
    raise ValueError(f"Unknown lr policy {cfg.lr_policy!r}")


def init_solver_state(cfg: SolverConfig, params):
    """{"iter": 0, "history": zeros like params} (Caffe's PreSolve): the
    momentum, or AdaGrad's sum of squared gradients."""
    return {"iter": 0, "history": map_params(torch.zeros_like, params)}


def _decayed_grad(w, g, local_decay, reg_type):
    if reg_type == "L2":
        return g + local_decay * w
    if reg_type == "L1":
        return g + local_decay * torch.sign(w)
    raise ValueError(f"Unknown regularization type {reg_type!r}")


def _lookup(tree, path, default=None):
    if tree is None:
        return default
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def solver_update(cfg: SolverConfig, params, grads, state, *,
                  lr_mults=None, decay_mults=None):
    """One optimizer step. lr_mults / decay_mults: optional trees shaped
    like params, of Python floats (default 1.0 each; Caffe's per-blob
    multipliers). Returns (new_params, new_state); the inputs are not
    modified."""
    it = state["iter"]
    rate = learning_rate(cfg, it)
    momentum = cfg.momentum
    wd = cfg.weight_decay
    reg = cfg.regularization_type

    def leaf_update(w, g, h, lrm, dm):
        local_rate = float(np.float32(rate * np.float32(lrm)))
        local_decay = wd * dm
        d = _decayed_grad(w, g, local_decay, reg)
        if cfg.solver_type == "SGD":
            h_new = momentum * h + local_rate * d
            return w - h_new, h_new
        if cfg.solver_type == "NESTEROV":
            h_new = momentum * h + local_rate * d
            step = (1.0 + momentum) * h_new - momentum * h
            return w - step, h_new
        if cfg.solver_type == "ADAGRAD":
            h_new = h + d * d
            step = local_rate * d / (torch.sqrt(h_new) + cfg.delta)
            return w - step, h_new
        raise ValueError(f"Unknown solver type {cfg.solver_type!r}")

    new_w, new_h = [], []
    for path, w in leaves_with_paths(params):
        wn, hn = leaf_update(w, _lookup(grads, path),
                             _lookup(state["history"], path),
                             _lookup(lr_mults, path, 1.0),
                             _lookup(decay_mults, path, 1.0))
        new_w.append((path, wn))
        new_h.append((path, hn))
    return tree_from_paths(new_w), {"iter": it + 1,
                                    "history": tree_from_paths(new_h)}
