"""The training loop (Caffe's Solver::Solve); counterpart of
videovector_tpu/solver/train.py.

Each iteration takes the loss's gradient with autograd, accumulates it over
iter_size x grad_microbatch microbatches (`build_fused_step`) and applies
one solver update. Every `display` iterations it logs the reference's glog
lines, so tools that scrape them (plot_training_stats.py) read the port's
log; every `test_interval` iterations it averages an eval function over
`test_iter` batches; every `snapshot` iterations it writes the .vvmodel /
.vvstate pair, which either package resumes from.

`train` is an entry point: it runs on the card unless the caller passes
device="cpu", and raises without a card. Cross-batch carry (LSTM state),
the host sinks and the reference's .solverstate resume come with later
slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from videovector_tpu_torch.convert import (
    leaves_with_paths, map_params, params_to_numpy, tree_from_paths,
)
from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.solver.checkpoint import AsyncSnapshotter, restore
from videovector_tpu_torch.solver.solvers import (
    SolverConfig, init_solver_state, learning_rate, solver_update,
)
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class TrainResult:
    params: Any
    state: Any
    metrics_history: list = field(default_factory=list)
    test_history: list = field(default_factory=list)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _add(a, b):
    return {k: _add(a[k], b[k]) for k in a} if isinstance(a, dict) else a + b


def value_and_grad(loss_fn: Callable):
    """loss_fn(params, batch, generator) -> (loss, aux) becomes
    vg(params, batch, generator) -> ((loss, aux), grads), with the grads a
    tree shaped like params (zeros for a param the loss does not use), all
    detached."""
    def vg(params, batch, generator):
        p = map_params(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = loss_fn(p, batch, generator)
        paths, leaves = zip(*leaves_with_paths(p))
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_from_paths(
            (path, torch.zeros_like(leaf) if g is None else g)
            for path, leaf, g in zip(paths, leaves, gs))
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        return (loss.detach(), aux), grads
    return vg


def accumulate_microbatches(vg_fn, params, batch: dict, axes: dict,
                            n_micro: int, generator):
    """Run vg_fn(params, mb, generator) -> ((loss, aux), grads) over
    `n_micro` equal microbatches of the dict `batch`, each key cut along its
    batch axis (`axes`, default 0; role-major data has its batch axis at 1)
    as views, and sum grads and losses (the reference's iter_size
    accumulation). Raises on a batch axis that n_micro does not divide.
    Returns (grads_sum, loss_sum, [aux of each microbatch]); divide by
    n_micro for means."""
    sizes = {}
    for k, v in batch.items():
        b = v.shape[axes.get(k, 0)]
        if b % n_micro:
            raise ValueError(f"microbatch count {n_micro} does not divide "
                             f"batch axis {b} of {k!r}")
        sizes[k] = b // n_micro
    grads = loss_sum = None
    aux_all = []
    for i in range(n_micro):
        mb = {k: v.narrow(axes.get(k, 0), i * sizes[k], sizes[k])
              for k, v in batch.items()}
        (loss, aux), g = vg_fn(params, mb, generator)
        # the first microbatch's sums start from its own values: 0 + x == x
        grads = g if grads is None else _add(grads, g)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        aux_all.append(aux)
    return grads, loss_sum, aux_all


def build_fused_step(grad_fn, cfg: SolverConfig, n_accum: int, gm: int, *,
                     batch_axes: dict | None = None):
    """One step over n_accum step batches, each cut into gm microbatches:
    the n_accum x gm gradients are averaged, then one solver update (the
    reference's iter_size semantics; equal to the big-batch update up to f32
    summation order). Returns
    fstep(params, state, batches_tuple, generator) -> (params, state,
    metrics), with batches_tuple holding n_accum batch dicts."""
    n_total = n_accum * gm
    if gm > 1 and batch_axes is None:
        # a silent axis-0 split inside a batch would scramble a role-major
        # layout whose role count gm happens to divide (iter_size alone is
        # exempt: concatenating and splitting on one axis is the identity)
        raise ValueError(
            "grad_microbatch requires batch_axes (e.g. {'data': 0} "
            "for batch-leading or {'data': 1} for role-major layouts): "
            "the split axis must be declared, not guessed")
    axes = batch_axes or {}

    def fstep(p, s, batches, generator):
        # the step batches concatenate along each key's batch axis, then
        # split into n_total microbatches: [step0 micro0..gm-1, step1 ...]
        full = {k: (torch.cat([b[k] for b in batches], dim=axes.get(k, 0))
                    if n_accum > 1 else batches[0][k])
                for k in batches[0]}
        grads, loss_sum, aux_all = accumulate_microbatches(
            grad_fn, p, full, axes, n_total, generator)
        grads = map_params(lambda g: g / n_total, grads)
        p2, s2 = solver_update(cfg, p, grads, s)
        # the displayed loss is the microbatch mean (the big-batch mean for
        # equal microbatches); other outputs are the last microbatch's
        # (counts such as `violations` must not average)
        metrics = {"loss": loss_sum / n_total, **aux_all[-1]}
        if cfg.snapshot_diff:
            metrics["__diff__"] = grads
        return p2, s2, metrics

    return fstep


_MASK64 = (1 << 64) - 1


def iteration_seed(seed: int, it: int) -> int:
    """The dropout generator's seed for iteration `it`: SplitMix64 of
    seed << 32 | it (both as 32-bit words). Each iteration's masks then
    depend on (seed, it) alone, as JAX's fold_in(PRNGKey(seed), it) does,
    so a run resumed at iteration N draws iteration N's masks."""
    z = (((seed & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def auto_grad_microbatch(batch, batch_axes: dict | None = None) -> int:
    """The JAX package's large-batch rule, as it stands: cut so that each
    microbatch carries ~128 batch rows, a power of two that divides every
    key's batch length; 1 (off) below 256 rows and when batch_axes is None
    (the split axis must be declared). The rule was measured on a TPU v5e;
    the H100's own points are in PERF.md, and an explicit grad_microbatch
    overrides it."""
    if batch_axes is None:
        return 1
    axes = batch_axes or {}
    lens = {int(v.shape[axes.get(k, 0)])
            for k, v in batch.items()
            if getattr(v, "ndim", 0) > axes.get(k, 0)}
    if not lens or min(lens) < 256:
        return 1
    gm = 1
    while (all(n % (gm * 2) == 0 for n in lens)
           and min(lens) // (gm * 2) >= 128):
        gm *= 2
    return gm


def train(loss_fn: Callable, params, data: Iterator[dict], cfg: SolverConfig,
          *, device=DEFAULT, eval_fn: Callable | None = None,
          test_data: Iterator[dict] | None = None,
          resume_state_path: str | None = None,
          hooks: list | None = None,
          batch_axes: dict | None = None,
          fused_accum: bool = True) -> TrainResult:
    """loss_fn(params, batch, generator) -> (loss, aux dict): the loss of
    one batch, with dropout masks drawn from `generator`, one
    torch.Generator on the device. At the top of each iteration it is
    reseeded from (cfg.random_seed, iteration) (`iteration_seed`; a seed of
    -1 means 0, as before), and every draw of that iteration runs on from
    there: each microbatch of the fused step, each iter_size sub-batch, and
    the display-gated forward after the loop. A resumed run therefore draws
    the masks of the iteration it resumes at.
    eval_fn(params, batch) -> dict of scalars: averaged over cfg.test_iter
    batches of test_data every cfg.test_interval iterations.
    device: where the params, the batches and the work go; the card unless
    "cpu" is asked for.
    resume_state_path: a .vvstate (from either package) to resume from.
    hooks: [(interval, fn(params, it))], called every `interval` iterations.
    batch_axes: {batch key: batch axis} for the grad_microbatch split; None
    means undeclared, which keeps the auto schedule off and makes an
    explicit grad_microbatch > 1 raise.
    fused_accum: iter_size accumulation through build_fused_step (True), or
    a host loop of separate gradient calls."""
    dev = resolve(device)
    params = map_params(lambda t: torch.as_tensor(t, device=dev), params)
    state = init_solver_state(cfg, params)
    start_iter = 0
    if resume_state_path:
        if resume_state_path.endswith(".solverstate") or \
                resume_state_path.rstrip("/").endswith(".orbax"):
            raise NotImplementedError(
                f"resuming from {resume_state_path!r}: the port resumes "
                "from .vvstate snapshots (the reference's .solverstate "
                "comes with the product-path slice; orbax is not ported)")
        params, state = restore(resume_state_path)
        params = map_params(lambda t: t.to(dev), params)
        state["history"] = map_params(lambda t: t.to(dev), state["history"])
        start_iter = state["iter"]
        log.info("Restoring previous solver status from %s (iter %d)",
                 resume_state_path, start_iter)
    seed = cfg.random_seed if cfg.random_seed >= 0 else 0
    # one generator, reseeded on the host at each iteration (no new tensor
    # per step)
    generator = torch.Generator(device=dev)

    def on_device(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    grad_fn = value_and_grad(loss_fn)

    def step(p, s, batch):
        (loss, aux), grads = grad_fn(p, batch, generator)
        p2, s2 = solver_update(cfg, p, grads, s)
        metrics = {"loss": loss, **aux}
        if cfg.snapshot_diff:
            metrics["__diff__"] = grads
        return p2, s2, metrics

    def accum(p, grads_acc, batch):
        # iter_size accumulation on the host: grads averaged over sub-batches
        (loss, aux), grads = grad_fn(p, batch, generator)
        scaled = map_params(lambda g: g / cfg.iter_size, grads)
        grads_acc = scaled if grads_acc is None else _add(grads_acc, scaled)
        return grads_acc, {"loss": loss, **aux}

    result = TrainResult(params, state)

    @torch.no_grad()
    def run_test(p, it):
        if eval_fn is None or test_data is None:
            return
        n = cfg.test_iter[0] if cfg.test_iter else 1
        sums: dict[str, np.ndarray] = {}
        for _ in range(n):
            for k, v in eval_fn(p, on_device(next(test_data))).items():
                # every element of every output accumulates (the
                # reference's test_score loop)
                arr = _host(v).astype(np.float64).reshape(-1)
                sums[k] = sums[k] + arr if k in sums else arr
        avg = {k: v / n for k, v in sums.items()}
        log.info("Iteration %d, Testing net (#%d)", it, 0)
        merged: dict[str, float] = {}
        # test_compute_loss prints its own line, not an output row
        tl = avg.pop("loss", None)
        if tl is not None:
            log.info("Test loss: %g", tl[0])
            merged["loss"] = float(tl[0])
        i = 0
        for k in sorted(avg):
            for j, x in enumerate(avg[k]):
                log.info("    Test net output #%d: %s = %g", i, k, x)
                merged[k if avg[k].size == 1 else f"{k}[{j}]"] = float(x)
                i += 1
        result.test_history.append((it, merged))

    it = start_iter
    last_grads = None   # the newest gradients (kept when snapshot_diff)
    fused_plan = None   # (iter_size, grad_microbatch) once shapes are known
    fused_step = None
    # the reference's Solve() banner, also the elapsed-time anchor of the
    # log tools
    log.info("Solving")
    snapshotter = AsyncSnapshotter()

    def _snap(at_iter):
        # host copies now: the writer thread reads them later
        snapshotter.submit(
            cfg.snapshot_prefix or "snapshot", at_iter,
            params_to_numpy(params),
            {"iter": state["iter"],
             "history": params_to_numpy(state["history"])},
            diffs=params_to_numpy(last_grads) if last_grads is not None
            else None)

    try:
        while it < cfg.max_iter:
            if cfg.snapshot and it > start_iter and it % cfg.snapshot == 0:
                _snap(it)
            if cfg.test_interval and it % cfg.test_interval == 0 and (
                    it > start_iter or cfg.test_initialization):
                run_test(params, it)
            for interval, hook in (hooks or ()):
                if interval and it % interval == 0:
                    hook(params, it)

            generator.manual_seed(iteration_seed(seed, it))
            if cfg.iter_size > 1 and not fused_accum:
                grads_acc = None
                for _ in range(cfg.iter_size):
                    grads_acc, metrics = accum(params, grads_acc,
                                               on_device(next(data)))
                if cfg.snapshot_diff:
                    last_grads = grads_acc
                params, state = solver_update(cfg, params, grads_acc, state)
            else:
                batch = on_device(next(data))
                if fused_accum and fused_plan is None:
                    n_accum = max(1, cfg.iter_size)
                    gm = (auto_grad_microbatch(batch, batch_axes)
                          if cfg.grad_microbatch < 0
                          else max(1, cfg.grad_microbatch))
                    fused_plan = (n_accum, gm)
                    if n_accum * gm > 1:
                        log.info(
                            "Fused accumulation schedule: iter_size=%d x "
                            "grad_microbatch=%d (one update per step)",
                            n_accum, gm)
                        fused_step = build_fused_step(
                            grad_fn, cfg, n_accum, gm, batch_axes=batch_axes)
                if fused_step is not None:
                    batches = (batch,) + tuple(
                        on_device(next(data)) for _ in range(fused_plan[0] - 1))
                    params, state, metrics = fused_step(params, state, batches,
                                                        generator)
                else:
                    params, state, metrics = step(params, state, batch)
                last_grads = metrics.pop("__diff__", last_grads)

            if cfg.display and it % cfg.display == 0:
                loss = float(_host(metrics["loss"]).reshape(-1)[0])
                log.info("Iteration %d, loss = %g", it, loss)
                entry: dict[str, float] = {"loss": loss}
                i = 1
                for k in sorted(metrics):
                    if k == "loss":
                        continue
                    # one line per element of each output (the reference's
                    # score_index loop)
                    vec = _host(metrics[k]).astype(np.float64).reshape(-1)
                    for j, x in enumerate(vec):
                        log.info("    Train net output #%d: %s = %g", i, k, x)
                        entry[k if vec.size == 1 else f"{k}[{j}]"] = float(x)
                        i += 1
                # the reference prints the lr after the outputs (from
                # ComputeUpdateValue, which runs after Solve's display)
                log.info("Iteration %d, lr = %g",
                         it, float(learning_rate(cfg, it)))
                result.metrics_history.append((it, entry))
            it += 1
    except KeyboardInterrupt:
        # an emergency snapshot (the reference loses what followed its last
        # scheduled one)
        if cfg.snapshot_prefix:
            log.info("Interrupted at iteration %d — writing snapshot", it)
            _snap(it)
        snapshotter.wait()
        raise

    if cfg.snapshot_after_train and cfg.snapshot_prefix:
        _snap(it)
    # the reference's post-loop passes: a display-gated extra forward of the
    # train net (to print the final loss; it consumes one batch, as the
    # reference's Net::Forward does) and a final test gated on
    # max_iter % test_interval
    if cfg.display and it % cfg.display == 0:
        try:
            batch = next(data)
        except StopIteration:
            batch = None  # a finite iterator: the reference's never ends
        if batch is not None:
            generator.manual_seed(iteration_seed(seed, it))
            with torch.no_grad():
                final_loss = loss_fn(params, on_device(batch), generator)[0]
            log.info("Iteration %d, loss = %g", it,
                     float(_host(final_loss).reshape(-1)[0]))
    if cfg.test_interval and it % cfg.test_interval == 0:
        run_test(params, it)
    snapshotter.wait()  # every write is on disk before train returns
    result.params = params
    result.state = state
    return result
