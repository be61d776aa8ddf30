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
device="cpu", and raises without a card. It evaluates one or several test
nets and feeds the host sinks of the TRAIN and TEST nets
(solver/driver.py builds both from a prototxt), and threads a
cross-batch carry (the LSTM state of a stateful Net) through a reserved
"__carry__" key: the loss function returns it in its aux dict, and the
loop hands it, detached, to the next step's batch (truncated BPTT, as the
reference's backward never crosses a batch), to each iter_size sub-batch,
to the display forward, and from test batch to test batch. It resumes
from a .vvstate or from the reference's .solverstate.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from videovector_tpu_torch.convert import (
    leaves_with_paths, map_params, params_to_numpy, tree_from_paths,
)
from videovector_tpu_torch.core.seeds import iteration_seed
from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.ops.sharding import MeshRun, writer_logs
from videovector_tpu_torch.solver.checkpoint import (
    AsyncSnapshotter, restore, restore_solverstate,
)
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
    # the cross-batch carry (LSTM state) after the last step: hand it back
    # through train(initial_carry=...) to continue
    final_carry: Any = None


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _add(a, b):
    return {k: _add(a[k], b[k]) for k in a} if isinstance(a, dict) else a + b


def _detached(v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, dict):   # the "__sinks__" blobs, the "__carry__" dict
        return {k: _detached(x) for k, x in v.items()}
    if isinstance(v, tuple):  # an LstmState of the carry
        return type(v)(*(_detached(x) for x in v))
    return v


def value_and_grad(loss_fn: Callable):
    """loss_fn(params, batch, generator) -> (loss, aux) becomes
    vg(params, batch, generator) -> ((loss, aux), grads), with the grads a
    tree shaped like params (zeros for a param the loss does not use), all
    detached, aux too (so a "__carry__" enters the next step as a constant
    and its graph is freed)."""
    def vg(params, batch, generator):
        p = map_params(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = loss_fn(p, batch, generator)
        paths, leaves = zip(*leaves_with_paths(p))
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_from_paths(
            (path, torch.zeros_like(leaf) if g is None else g)
            for path, leaf, g in zip(paths, leaves, gs))
        aux = {k: _detached(v) for k, v in aux.items()}
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
                     lr_mults=None, decay_mults=None,
                     batch_axes: dict | None = None, grad_reduce=None):
    """One step over n_accum step batches, each cut into gm microbatches:
    the n_accum x gm gradients are averaged, then one solver update (the
    reference's iter_size semantics; equal to the big-batch update up to f32
    summation order) with the per-blob `lr_mults` / `decay_mults` trees
    (solver_update's). `grad_reduce` (the mesh's all_reduce over "data")
    runs once on the averaged gradients, before the update. Returns
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

    def vg_checked(p, mb, generator):
        (loss, aux), g = grad_fn(p, mb, generator)
        if "__carry__" in aux:
            raise ValueError(
                "fused accumulation cannot thread cross-batch LSTM "
                "state — pass fused_accum=False for stateful nets")
        return (loss, aux), g

    def fstep(p, s, batches, generator):
        # the step batches concatenate along each key's batch axis, then
        # split into n_total microbatches: [step0 micro0..gm-1, step1 ...]
        full = {k: (torch.cat([b[k] for b in batches], dim=axes.get(k, 0))
                    if n_accum > 1 else batches[0][k])
                for k in batches[0]}
        grads, loss_sum, aux_all = accumulate_microbatches(
            vg_checked, p, full, axes, n_total, generator)
        grads = map_params(lambda g: g / n_total, grads)
        if grad_reduce is not None:
            grads = grad_reduce(grads)
        p2, s2 = solver_update(cfg, p, grads, s, lr_mults=lr_mults,
                               decay_mults=decay_mults)
        # the displayed loss is the microbatch mean (the big-batch mean for
        # equal microbatches); other outputs are the last microbatch's
        # (counts such as `violations` must not average; the sinks' files
        # hold the last forward's rows, as the reference's
        # truncate-per-Forward writes leave them)
        metrics = {"loss": loss_sum / n_total, **aux_all[-1]}
        if cfg.snapshot_diff:
            metrics["__diff__"] = grads
        return p2, s2, metrics

    return fstep


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


def _writer_logs(fn):
    """train's log lines on a mesh's writer rank alone (writer_logs)."""
    @functools.wraps(fn)
    def wrapped(*args, mesh=None, **kw):
        with writer_logs(mesh):
            return fn(*args, mesh=mesh, **kw)
    return wrapped


def _as_list(x) -> list:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] if x is not None else []


@_writer_logs
def train(loss_fn: Callable, params, data: Iterator[dict], cfg: SolverConfig,
          *, lr_mults=None, decay_mults=None, device=DEFAULT,
          eval_fn: Callable | list | None = None,
          test_data: Iterator[dict] | list | None = None,
          sink_fn: Callable | list | None = None,
          train_sink_fn: Callable | None = None,
          resume_state_path: str | None = None,
          hooks: list | None = None,
          param_layer_order: list | None = None,
          caffe_export: Callable | None = None,
          batch_axes: dict | None = None,
          fused_accum: bool = True,
          train_output_weights: dict | None = None,
          test_output_weights: list | None = None,
          initial_carry=None, mesh=None,
          time_major: bool = False) -> TrainResult:
    """loss_fn(params, batch, generator) -> (loss, aux dict): the loss of
    one batch, with dropout masks drawn from `generator`, one
    torch.Generator on the device. At the top of each iteration it is
    reseeded from (cfg.random_seed, iteration) (`iteration_seed`; a seed of
    -1 means 0, as before), and every draw of that iteration runs on from
    there: each microbatch of the fused step, each iter_size sub-batch, and
    the display-gated forward after the loop. A resumed run therefore draws
    the masks of the iteration it resumes at.
    lr_mults / decay_mults: trees shaped like params of per-blob learning
    rate and weight decay multipliers (Caffe's blobs_lr / weight_decay;
    Net.param_multipliers builds them from a prototxt), 1.0 where absent.
    eval_fn(params, batch) -> dict of tensors, or a list of them, one per
    test net, with test_data an iterator or a list of them: every
    cfg.test_interval iterations each net's outputs are averaged, element
    by element, over cfg.test_iter[i] batches; with several nets the
    history keys are "net{i}/name".
    sink_fn (or a list, one per test net): called with the "__sinks__"
    entry an eval_fn returns (the host sinks' bottom blobs) after every
    test batch. train_sink_fn: the same for the "__sinks__" aux entry of
    loss_fn, after every step (the reference writes sink files on every
    Forward, training ones included).
    device: where the params, the batches and the work go; the card unless
    "cpu" is asked for.
    resume_state_path: a .vvstate (from either package) or a .solverstate
    (the reference's, or either package's snapshot_format: "caffe") to
    resume from.
    hooks: [(interval, fn(params, it))], called every `interval` iterations.
    param_layer_order: the param layers in net order, which a .solverstate
    resume needs (its history blobs are nameless, in net_->params() order).
    caffe_export: fn(it, params_np, state_np), run after each snapshot's
    files are written, in the writer thread.
    batch_axes: {batch key: batch axis} for the grad_microbatch split; None
    means undeclared, which keeps the auto schedule off and makes an
    explicit grad_microbatch > 1 raise.
    fused_accum: iter_size accumulation through build_fused_step (True), or
    a host loop of separate gradient calls. False for a stateful net: the
    carry threads from sub-batch to sub-batch, which the fused step
    refuses (the driver passes it).
    train_output_weights / test_output_weights: {output blob: loss weight}
    (Net.output_loss_weights), one map per test net: loss-weighted output
    lines carry the reference's " (* w = x loss)" suffix
    (ref:src/caffe/solver.cpp:204-214, :306-314).
    initial_carry: the "__carry__" the first step's batch gets (e.g. a
    TrainResult.final_carry); None starts from the layers' zero state.
    mesh: a parallel.make_mesh mesh. Every rank calls train with its rows
    of each batch (the batch axis of each key from batch_axes, default 0),
    whole test batches and whole params; the params (and the solver
    history) are sharded here, 2-D columns over "model" when that axis
    spans more than one rank (parallel.train.shard_params). The loss runs
    under the mesh's axes (ops/collectives.py: its outputs are the whole
    batch's), the gradients are averaged over "data" once a step, the test
    nets and hooks run under the model axis, and snapshots gather the
    params whole; rank 0 alone writes them and logs. The result's params
    and state are whole on every rank. `time_major`: the batch's blobs
    carry the batch on axis 1 (tracking sources), for DROPOUT's masks."""
    dev = resolve(device)
    params = map_params(lambda t: torch.as_tensor(t, device=dev), params)
    ms = MeshRun(mesh, batch_axes, time_major)
    params = ms.shard(params)
    state = init_solver_state(cfg, params)
    start_iter = 0
    if resume_state_path:
        if resume_state_path.rstrip("/").endswith(".orbax"):
            raise NotImplementedError(
                f"resuming from {resume_state_path!r}: orbax snapshots stay "
                "with the JAX package (ROADMAP, do not port); resume from a "
                ".vvstate or a .solverstate")
        if resume_state_path.endswith(".solverstate"):
            # the reference's snapshot, momentum intact
            # (ref:src/caffe/solver.cpp:419-429)
            if param_layer_order is None:
                raise ValueError(
                    "resuming from a .solverstate needs param_layer_order "
                    "(history blobs are nameless; train through SolverDriver "
                    "or pass the net's param-layer order)")
            params, state = restore_solverstate(resume_state_path, params,
                                                param_layer_order)
        else:
            params, state = restore(resume_state_path)
        params = ms.shard(map_params(lambda t: t.to(dev), params))
        state["history"] = ms.shard(
            map_params(lambda t: t.to(dev), state["history"]))
        start_iter = state["iter"]
        log.info("Restoring previous solver status from %s (iter %d)",
                 resume_state_path, start_iter)
    seed = cfg.random_seed if cfg.random_seed >= 0 else 0
    # one generator, reseeded on the host at each iteration (no new tensor
    # per step)
    generator = torch.Generator(device=dev)

    def on_device(batch, carry=None):
        out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if carry is not None:
            out["__carry__"] = carry
        return out

    grad_fn = ms.under_axes(value_and_grad(loss_fn))
    mults = {"lr_mults": lr_mults, "decay_mults": decay_mults}

    def step(p, s, batch):
        (loss, aux), grads = grad_fn(p, batch, generator)
        grads = ms.reduce(grads)
        p2, s2 = solver_update(cfg, p, grads, s, **mults)
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
    # parallel lists, one entry per test net (ref repeated test_net and
    # per-net test_iter, caffe.proto:86-112)
    eval_fns, test_datas = _as_list(eval_fn), _as_list(test_data)
    sink_fns = (list(sink_fn) if isinstance(sink_fn, (list, tuple))
                else [sink_fn] * len(eval_fns))
    weight_maps = list(test_output_weights or [])

    def suffix(w, x) -> str:
        return f" (* {w:g} = {w * x:g} loss)" if w else ""

    @torch.no_grad()
    def run_test(p, it):
        if not eval_fns or not test_datas:
            return
        merged: dict[str, float] = {}
        for net_id, (efn, tdata) in enumerate(zip(eval_fns, test_datas)):
            n = cfg.test_iter[net_id] if net_id < len(cfg.test_iter) else 1
            sums: dict[str, np.ndarray] = {}
            t_carry = None  # the recurrent state carries across test batches
            efn = ms.under_axes(efn, data=False)
            for _ in range(n):
                out = dict(efn(p, on_device(next(tdata), t_carry)))
                t_carry = out.pop("__carry__", None)
                sblobs = out.pop("__sinks__", None)
                if sblobs is not None and sink_fns[net_id] is not None:
                    sink_fns[net_id](sblobs)
                for k, v in out.items():
                    # every element of every output accumulates (the
                    # reference's test_score loop, solver.cpp:280-293)
                    arr = _host(v).astype(np.float64).reshape(-1)
                    sums[k] = sums[k] + arr if k in sums else arr
            avg = {k: v / n for k, v in sums.items()}
            log.info("Iteration %d, Testing net (#%d)", it, net_id)
            prefix = "" if len(eval_fns) == 1 else f"net{net_id}/"
            # test_compute_loss prints its own line, not an output row
            tl = avg.pop("loss", None)
            if tl is not None:
                log.info("Test loss: %g", tl[0])
                merged[prefix + "loss"] = float(tl[0])
            wmap = (weight_maps[net_id] if net_id < len(weight_maps)
                    else None) or {}
            i = 0
            for k in sorted(avg):
                w = wmap.get(k, 0.0)
                for j, x in enumerate(avg[k]):
                    log.info("    Test net output #%d: %s = %g%s", i, k, x,
                             suffix(w, x))
                    key = k if avg[k].size == 1 else f"{k}[{j}]"
                    merged[prefix + key] = float(x)
                    i += 1
        result.test_history.append((it, merged))

    it = start_iter
    # the cross-batch state the loss function threads through "__carry__"
    carry = initial_carry
    last_grads = None   # the newest gradients (kept when snapshot_diff)
    fused_plan = None   # (iter_size, grad_microbatch) once shapes are known
    fused_step = None
    # the reference's Solve() banner, also the elapsed-time anchor of the
    # log tools
    log.info("Solving")
    snapshotter = AsyncSnapshotter()

    def _snap(at_iter):
        # host copies now: the writer thread reads them later (whole: every
        # rank gathers, rank 0 writes)
        p_np = params_to_numpy(ms.whole(params))
        s_np = {"iter": state["iter"],
                "history": params_to_numpy(ms.whole(state["history"]))}
        diffs = (params_to_numpy(ms.whole(last_grads))
                 if last_grads is not None else None)
        if not ms.writer:
            return
        snapshotter.submit(
            cfg.snapshot_prefix or "snapshot", at_iter, p_np, s_np,
            diffs=diffs,
            extra=((lambda: caffe_export(at_iter, p_np, s_np))
                   if caffe_export is not None else None))

    def sink(metrics):
        sblobs = metrics.pop("__sinks__", None)
        if sblobs is not None and train_sink_fn is not None:
            train_sink_fn(sblobs)

    try:
        while it < cfg.max_iter:
            if cfg.snapshot and it > start_iter and it % cfg.snapshot == 0:
                _snap(it)
            if cfg.test_interval and it % cfg.test_interval == 0 and (
                    it > start_iter or cfg.test_initialization):
                run_test(params, it)
            for interval, hook in (hooks or ()):
                if interval and it % interval == 0:
                    with ms.axes(data=False):
                        hook(params, it)

            generator.manual_seed(iteration_seed(seed, it))
            if cfg.iter_size > 1 and not fused_accum:
                grads_acc = None
                for _ in range(cfg.iter_size):
                    grads_acc, metrics = accum(params, grads_acc,
                                               on_device(next(data), carry))
                    carry = metrics.pop("__carry__", None)
                    sink(metrics)   # every sub-batch's Forward
                grads_acc = ms.reduce(grads_acc)
                if cfg.snapshot_diff:
                    last_grads = grads_acc
                params, state = solver_update(cfg, params, grads_acc, state,
                                              **mults)
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
                            grad_fn, cfg, n_accum, gm, **mults,
                            batch_axes=batch_axes,
                            grad_reduce=ms.reduce if ms.mesh else None)
                if fused_step is not None:
                    batches = (batch,) + tuple(
                        on_device(next(data)) for _ in range(fused_plan[0] - 1))
                    params, state, metrics = fused_step(params, state, batches,
                                                        generator)
                else:
                    if carry is not None:
                        batch["__carry__"] = carry
                    params, state, metrics = step(params, state, batch)
                # the recurrent cross-batch state (ref lstm_layer.cpp:171-173)
                # comes back through aux, detached
                carry = metrics.pop("__carry__", None)
                last_grads = metrics.pop("__diff__", last_grads)
                sink(metrics)

            if cfg.display and it % cfg.display == 0:
                loss = float(_host(metrics["loss"]).reshape(-1)[0])
                log.info("Iteration %d, loss = %g", it, loss)
                entry: dict[str, float] = {"loss": loss}
                i = 1
                for k in sorted(metrics):
                    if k == "loss":
                        continue
                    # one line per element of each output (the reference's
                    # score_index loop, solver.cpp:195-217)
                    w = (train_output_weights or {}).get(k, 0.0)
                    vec = _host(metrics[k]).astype(np.float64).reshape(-1)
                    for j, x in enumerate(vec):
                        log.info("    Train net output #%d: %s = %g%s", i, k,
                                 x, suffix(w, x))
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
                final_loss = ms.under_axes(loss_fn)(
                    params, on_device(batch, carry), generator)[0]
            log.info("Iteration %d, loss = %g", it,
                     float(_host(final_loss).reshape(-1)[0]))
    if cfg.test_interval and it % cfg.test_interval == 0:
        run_test(params, it)
    snapshotter.wait()  # every write is on disk before train returns
    result.params = ms.whole(params)
    result.state = {"iter": state["iter"],
                    "history": ms.whole(state["history"])}
    result.final_carry = carry
    return result
