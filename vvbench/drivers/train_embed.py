"""Training the flagship ranking-embedding net for a window of time:
`solver.train.train` with the Net's loss as SolverDriver builds it, fed
from a pool of `pool_batches` TRAIN batches and the test batch, drawn from
the seed and held on the device.

Shots are make_synthetic_data.py's: per video a center c ~ N(0, 1), a shot
|c + shot_noise.n|; a test window holds test_context shots of video
i % test_videos at test_noise. The weights are the benchmark's (fc7's
gaussian of the prototxt's std, bias 0), handed to the program in place of
its own init.

The window opens at a hook of the training loop after `warmup_steps`
steps (the tests of iterations 0 and warmup_steps included) and closes at
the first iteration's hook past --seconds; it holds the tests that fall in
it. A traced run then profiles `traced_steps` more steps.

The check holds two stretches of `check_steps` steps against the plain
reference (vvbench/reference/embed.py): the run's first steps, from the
benchmark's weights, with the test eval of iteration 0; and steps inside
the window, with the test eval at their first iteration. The window's
stretch starts at the first multiple of test_interval past a point of the
window drawn from the seed (a quarter to three quarters of --seconds in);
the reference takes it up from the program's params and momentum history
there (read as the program's update is handed them), and the window
closes no earlier than the stretch's end.
"""

from __future__ import annotations

import contextlib
import itertools
import string
import time
from pathlib import Path

import numpy as np
import torch

from vvbench.harness import Outcome
from vvbench.reference import embed as ref
from vvbench.trace import TracedWindow


class _WindowClosed(Exception):
    """Raised from the training loop's hook to end a run's training."""


def net_text(root: Path, cfg: dict, train_source: str,
             test_source: str) -> str:
    tpl = string.Template((root / cfg["net"]).read_text())
    return tpl.substitute({**{k: v for k, v in cfg.items()
                              if isinstance(v, (int, float, str))},
                           "train_source": train_source,
                           "test_source": test_source})


def solver_text(cfg: dict, net_path: str, random_seed: int) -> str:
    fields = {**cfg["solver"], "max_iter": cfg["max_iter"],
              "snapshot": cfg["snapshot"], "random_seed": random_seed}
    lines = [f'net: "{net_path}"']
    for k, v in fields.items():
        lines.append(f'{k}: "{v}"' if isinstance(v, str) else f"{k}: {v}")
    return "\n".join(lines) + "\n"


def shots(gen: torch.Generator, centers: torch.Tensor, videos: torch.Tensor,
          count: int, noise: float) -> torch.Tensor:
    """(len(videos), count, D) shots |c_v + noise.n|."""
    n = torch.randn((videos.shape[0], count, centers.shape[1]),
                    generator=gen, device=centers.device)
    return torch.abs(centers[videos][:, None] + noise * n)


def test_windows(gen, centers, cfg: dict, mix: dict):
    """(test_batch, test_context, D) windows and their (test_batch,) f32
    video ids (1-based, as the program's shot stores number videos)."""
    vids = torch.arange(cfg["test_batch"], device=centers.device) \
        % mix["test_videos"]
    data = shots(gen, centers, vids, cfg["test_context"], mix["test_noise"])
    return data, (vids + 1).to(torch.float32)


def resident_pool(gen, centers, cfg: dict, mix: dict) -> list:
    """`pool_batches` TRAIN batches {"data": (B, R, D)}: the window's target
    and context shots from one video, the negatives from videos drawn
    uniformly."""
    b, n_win = cfg["batch_size"], cfg["context_size"]
    n_vid, dev = centers.shape[0], centers.device
    out = []
    for _ in range(mix["pool_batches"]):
        own = torch.randint(0, n_vid, (b,), generator=gen, device=dev)
        win = shots(gen, centers, own, n_win, mix["shot_noise"])
        other = torch.randint(0, n_vid, (b * cfg["num_negatives"],),
                              generator=gen, device=dev)
        neg = shots(gen, centers, other, 1, mix["shot_noise"]).view(
            b, cfg["num_negatives"], -1)
        out.append({"data": torch.cat([win, neg], dim=1).contiguous()})
    return out


class Window:
    """The training loop's hook: the params and steps the check needs, the
    window's open and close, and the traced window after it."""

    def __init__(self, r, cap: "Capture"):
        self.r, self.cap = r, cap
        n = r.mix["check_steps"]
        self.n = n
        self.keep = {1, n}
        self.params_at: dict = {}
        # where in the window its checked stretch starts, as a share of
        # --seconds
        self.at = 0.25 + 0.5 * (r.seed_for("check") % 10_000) / 10_000
        self.s = None
        self.it0 = self.it1 = None
        self.t0 = self.t1 = None
        self.peak = 0
        self.traced = None
        self.trace = None

    def _stretch(self, it: int) -> None:
        """The window's checked stretch: steps s .. s + n - 1, s the first
        multiple of test_interval past it, and the test eval at s."""
        iv = self.r.config["solver"]["test_interval"]
        s = (it + iv) // iv * iv
        self.s = s
        self.keep |= {s, s + 1, s + self.n}
        self.cap.want(range(s, s + self.n), s)

    def hook(self, params, it):
        r, mix = self.r, self.r.mix
        self.cap.it = it
        if it in self.keep:
            self.params_at[it] = {k: v.detach().clone()
                                  for k, v in params["fc7"].items()}
        if it == mix["warmup_steps"]:
            r.sync()
            r.window_starts()
            self.it0, self.t0 = it, time.perf_counter()
        elif self.t0 is not None and self.t1 is None:
            elapsed = time.perf_counter() - self.t0
            if self.s is None and elapsed >= self.at * r.seconds:
                self._stretch(it)
            if elapsed < r.seconds or it < self.s + self.n:
                return
            r.sync()
            self.it1, self.t1 = it, time.perf_counter()
            if r.device.type == "cuda":
                self.peak = torch.cuda.max_memory_allocated(r.device)
            if not r.trace:
                raise _WindowClosed
            self.traced = TracedWindow(r.device)
            self.traced.start()
        elif self.traced is not None and it == self.it1 + mix["traced_steps"]:
            steps = mix["traced_steps"]
            self.trace = self.traced.stop(
                {"steps": steps, "evals": _evals(self.r, self.it1, it)})
            raise _WindowClosed


def _evals(r, start: int, stop: int) -> int:
    """Test evals in the iterations (start, stop]: the loop tests at the top
    of each multiple of test_interval."""
    iv = r.config["solver"]["test_interval"]
    return stop // iv - start // iv


class Capture:
    """The loss, eval and update functions as the loop calls them,
    recording the batches and losses of the iterations asked for (the first
    `n` from the start), the batch and outputs of the test evals asked for
    (that of iteration 0 from the start), and the momentum history that the
    update of iteration `history_at` is handed. `it` is the iteration whose
    hook ran last: its step follows, and a test eval before the next hook
    is the next iteration's."""

    def __init__(self, n: int):
        self.it = None
        self.steps, self.evals = set(range(n)), {0}
        self.batches, self.losses, self.tests = {}, {}, {}
        self.history_at, self.history = None, None

    def want(self, steps, eval_at: int) -> None:
        self.steps |= set(steps)
        self.evals.add(eval_at)
        self.history_at = eval_at

    def update(self, fn):
        def wrapped(cfg, params, grads, state, **kw):
            if state["iter"] == self.history_at and self.history is None:
                self.history = {k: v.detach().clone()
                                for k, v in state["history"]["fc7"].items()}
            return fn(cfg, params, grads, state, **kw)
        return wrapped

    def loss(self, fn):
        def wrapped(p, batch, generator):
            loss, aux = fn(p, batch, generator)
            if self.it in self.steps and self.it not in self.batches:
                self.batches[self.it] = batch["data"].detach().clone()
                self.losses[self.it] = float(loss.detach())
            return loss, aux
        return wrapped

    def eval(self, fn):
        def wrapped(p, batch):
            out = fn(p, batch)
            it = 0 if self.it is None else self.it + 1
            if it in self.evals and it not in self.tests:
                self.tests[it] = (
                    {k: v.detach().clone() for k, v in batch.items()},
                    {k: float(v.reshape(-1)[0]) for k, v in out.items()
                     if k.startswith("test_")})
            return out
        return wrapped


@contextlib.contextmanager
def _reading_updates(cap: Capture):
    """The loop's optimizer update, wrapped for the run so that the check
    reads the history the window's checked stretch starts from."""
    from videovector_tpu_torch.solver import train as loop
    orig = loop.solver_update
    loop.solver_update = cap.update(orig)
    try:
        yield
    finally:
        loop.solver_update = orig


def _net_loss(net):
    """The Net's loss as SolverDriver builds it for a stateless net."""
    def loss_fn(p, batch, generator):
        loss, outputs = net.apply(p, batch, generator=generator)
        return loss, {k: v.reshape(-1) for k, v in outputs.items()}
    return loss_fn


def _net_eval(net):
    def eval_fn(p, batch):
        _, outputs = net.apply(p, batch)
        return {k: v.reshape(-1) for k, v in outputs.items()}
    return eval_fn


def _leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _worst_gap(prog: dict, refn: dict, leaves=None) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    leaves = list(refn) if leaves is None else leaves
    med = float(np.median([refn[k] for k in leaves]))
    return max(abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)
               for k in leaves)


def _unit_gap(prog: dict, refs: dict, live: torch.Tensor) -> float:
    """The median over the tower's live output units (the reference's) of
    the gap between the two sides' norms of a unit's (w column, b entry),
    each against the reference's norm of that unit or of the median live
    unit, whichever is larger. A unit whose pre-activation sits at ReLU's
    kink within f32 rounding takes the other branch on one side alone (a
    few units a step); the median does not see them, the dense rounding of
    a lower precision it does. A unit with no active row moves by decay
    and momentum alone, alike on both sides: once training has run, most
    units are such, and the median over all would read nought."""
    def norms(t):
        return torch.sqrt(torch.sum(t["w"] ** 2, dim=0) + t["b"] ** 2)[live]
    n_p, n_r = norms(prog), norms(refs)
    scale = torch.clamp(n_r, min=float(torch.median(n_r)))
    return float(torch.median((n_p - n_r).abs() / scale))


def step_numbers(w0: dict, losses: list, w1: dict, w3: dict,
                 ref_run: dict, solver: dict, mults: dict, it0: int = 0,
                 h0: dict | None = None) -> dict:
    """The numbers of a side (the program, or a control or fault in its
    place) against the reference's run of the steps it0, it0 + 1, ...: each
    step's loss (`loss_gap`, the worst), the first gradient's norm and the
    steps' change by the worst leaf (`grad_gap`, `update_gap`) and by the
    median live unit (`grad_unit_gap`, `update_unit_gap`).

    The first gradient is worked out, on each side, from the params after
    one step and the momentum history h0 that both sides start from (zero
    if None): g = (w0 - w1 - momentum h0) / (lr_it0 lr_mult)
    - decay decay_mult w0. Leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding) are left out of
    the change."""
    lr0 = ref.learning_rate(solver, it0)
    m = solver["momentum"]

    def grad(w_after):
        return {k: (w0[k].double() - w_after[k].double()
                    - (0.0 if h0 is None else m * h0[k].double()))
                / (lr0 * mults["lr"][k])
                - solver["weight_decay"] * mults["decay"][k] * w0[k].double()
                for k in w0}

    def change(w_after):
        return {k: w_after[k].double() - w0[k].double() for k in w0}
    g_ref, g_prog = grad(ref_run["params"][0]), grad(w1)
    d_ref, d_prog = change(ref_run["params"][-1]), change(w3)
    gn_ref = _leaf_norms(g_ref)
    med = float(np.median(list(gn_ref.values())))
    moved = [k for k in gn_ref if gn_ref[k] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(p - q) / max(abs(q), 1e-30)
                        for p, q in zip(losses, ref_run["losses"])),
        "grad_gap": _worst_gap(_leaf_norms(g_prog), gn_ref),
        "update_gap": _worst_gap(_leaf_norms(d_prog), _leaf_norms(d_ref),
                                 moved),
        "grad_unit_gap": _unit_gap(g_prog, g_ref, ref_run["live"]),
        "update_unit_gap": _unit_gap(d_prog, d_ref, ref_run["live"]),
    }


def map_gap(prog: dict, refs: dict) -> float:
    """A test eval's mAP against the reference's: read by the control runs,
    not compared (PERF.md gives the readings). hit@1 and hit@5 move in
    steps of a query (1/test_batch) when a near tie turns over, on sound
    runs too."""
    return abs(prog["test_map"] - refs["test_map"])


def run(r) -> Outcome:
    from videovector_tpu_torch.config.textformat import parse
    cfg, mix, dev = r.config, r.mix, r.device
    r.phase("imports")
    n_check = mix["check_steps"]
    gen = r.generator("data")
    centers = torch.randn((mix["videos"], cfg["feature_dim"]), generator=gen,
                          device=dev)
    test = test_windows(gen, centers, cfg, mix)
    weights = {"w": torch.randn((cfg["feature_dim"], cfg["embed_dim"]),
                                generator=r.generator("weights"), device=dev)
               * cfg["weight_std"],
               "b": torch.zeros(cfg["embed_dim"], device=dev)}
    random_seed = r.seed_for("solver")
    cap = Capture(n_check)
    window = Window(r, cap)
    pool = resident_pool(gen, centers, cfg, mix)
    r.phase("inputs made")
    _train_resident(r, parse(solver_text(cfg, "unused.prototxt", random_seed)),
                    parse(net_text(r.cell.root, cfg, "unused.vvr",
                                   "unused.vvr")),
                    weights, pool, test, window, cap)
    if window.t1 is None:
        raise RuntimeError("the training window never closed")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program's state is gone
    checks = _check(r, weights, window, cap, pool, test, random_seed)
    steps = window.it1 - window.it0
    wall = window.t1 - window.t0
    triplets = steps * cfg["batch_size"] * cfg["num_negatives"]
    return Outcome(
        end_to_end={"train_triplets_per_s": triplets / wall},
        attempted=steps, failed=0, memory_peak_bytes=window.peak,
        checks={k: (v, r.limits[k]) for k, v in checks.items()},
        trace=window.trace,
        window={"steps": steps, "evals": _evals(r, window.it0, window.it1),
                "wall_s": wall})


def _train_resident(r, solver_msg, net_msg, weights, pool, test, window,
                    cap) -> None:
    from videovector_tpu_torch.graph.net import Net
    from videovector_tpu_torch.solver.solvers import SolverConfig
    from videovector_tpu_torch.solver.train import train
    dev = r.device
    train_net, test_net = Net(net_msg, phase="TRAIN"), Net(net_msg,
                                                           phase="TEST")
    meta = torch.Generator(device=dev).manual_seed(0)
    train_net.init(meta, {"data": torch.empty(pool[0]["data"].shape,
                                              device="meta")})
    test_batch = {"data": test[0], "video_ids": test[1]}
    test_net.init(meta, {k: torch.empty(v.shape, device="meta")
                         for k, v in test_batch.items()})
    lr, decay = train_net.param_multipliers()
    r.phase("nets built")
    with _reading_updates(cap), contextlib.suppress(_WindowClosed):
        train(cap.loss(_net_loss(train_net)),
              {"fc7": {k: v.clone() for k, v in weights.items()}},
              itertools.cycle(pool), SolverConfig.from_message(solver_msg),
              lr_mults=lr, decay_mults=decay, device=dev,
              eval_fn=[cap.eval(_net_eval(test_net))],
              test_data=[itertools.repeat(test_batch)],
              hooks=[(1, window.hook)], batch_axes={"data": 0},
              train_output_weights=train_net.output_loss_weights(),
              test_output_weights=[test_net.output_loss_weights()])


def _stretches(window: Window, cap: Capture, weights: dict) -> list:
    """The two checked stretches: (prefix, first iteration, params there,
    momentum history there or None, batches, losses, params after one
    step, params after all)."""
    n, s = window.n, window.s
    return [
        ("", 0, weights, None, [cap.batches[i] for i in range(n)],
         [cap.losses[i] for i in range(n)], window.params_at[1],
         window.params_at[n]),
        ("win_", s, window.params_at[s], cap.history,
         [cap.batches[i] for i in range(s, s + n)],
         [cap.losses[i] for i in range(s, s + n)], window.params_at[s + 1],
         window.params_at[s + n])]


# Read by the control runs, not compared (PERF.md gives the readings): the
# window's worst-leaf gaps, whose tail is a unit at ReLU's kink taking the
# other branch on one side (the start's look); the window's live-unit
# medians are compared in their place.
READ_ONLY = ("win_grad_gap", "win_update_gap")


def _check(r, weights, window, cap, pool, test, random_seed) -> dict:
    cfg, mix = r.config, r.mix
    n_check = mix["check_steps"]
    s = window.s
    want = set(range(n_check)) | set(range(s or 0, (s or 0) + n_check))
    if s is None or set(cap.batches) != want or set(cap.tests) != {0, s} \
            or cap.history is None or not {1, n_check, s, s + 1, s + n_check
                                           } <= set(window.params_at):
        raise RuntimeError("the run did not reach the steps the check needs")
    feed_off = sum(int((cap.batches[i] != pool[i % len(pool)]["data"])
                       .any(dim=(1, 2)).sum()) for i in cap.batches)
    test_off = sum(int((b["data"] != test[0]).any(dim=(1, 2)).sum()
                       + (b["video_ids"].reshape(-1) != test[1]).sum())
                   for b, _ in cap.tests.values())
    nums, runs = {}, []
    for pre, it0, w0, h0, batches, losses, w1, wn in _stretches(
            window, cap, weights):
        ref_run = ref.train_steps(w0, batches, cfg, cfg["solver"],
                                  cfg["mults"], random_seed, start_iter=it0,
                                  history=h0)
        runs.append(ref_run)
        nums.update({pre + k: v for k, v in step_numbers(
            w0, losses, w1, wn, ref_run, cfg["solver"], cfg["mults"], it0,
            h0).items()})
    nums["feed_rows_off"] = float(feed_off)
    nums["test_rows_off"] = float(test_off)
    read_only = {k: nums.pop(k) for k in READ_ONLY}
    if r.control:
        r.readings = _control_readings(r, window, cap, weights, test, runs,
                                       random_seed)
        r.readings["program"].update(read_only)
    return nums


def _control_readings(r, window, cap, weights, test, runs,
                      random_seed) -> dict:
    """The numbers of the program's test evals, and of the control (the
    reference in TF32, in the program's place) and of the half-batch fault,
    against the reference, on both stretches."""
    cfg = r.config
    out = {"program": {}, "tf32": {}, "half_batch": {}}
    for (pre, it0, w0, h0, batches, *_), ref_run in zip(
            _stretches(window, cap, weights), runs):
        refs = ref.test_eval(w0, test[0], test[1], cfg)
        out["program"][pre + "map_gap"] = map_gap(cap.tests[it0][1], refs)
        for name, kw in (("tf32", {"tf32": True}),
                         ("half_batch", {"half_batch": True})):
            side = ref.train_steps(w0, batches, cfg, cfg["solver"],
                                   cfg["mults"], random_seed, start_iter=it0,
                                   history=h0, **kw)
            nums = step_numbers(w0, side["losses"], side["params"][0],
                                side["params"][-1], ref_run, cfg["solver"],
                                cfg["mults"], it0, h0)
            nums["map_gap"] = map_gap(ref.test_eval(
                w0, test[0], test[1], cfg, tf32=kw.get("tf32", False)), refs)
            out[name].update({pre + k: v for k, v in nums.items()})
    return out
