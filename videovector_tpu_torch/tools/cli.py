"""vvtpu-torch: the multi-command CLI (the `caffe.bin` equivalent);
counterpart of videovector_tpu/tools/cli.py.

ref:tools/caffe.cpp: commands train / test / device_query / time, with
--solver/--model/--weights/--snapshot/--iterations flags, and the same log
lines as the JAX package's `vvtpu`. Every command runs on the card unless
asked for the CPU (`--cpu`, `--gpu=-1`, or the solver's `solver_mode:
CPU`), and raises without a card. `time` times with CUDA events on the
card (the host clock on the CPU): per layer as the marginal time of the
forward prefix through that layer (segmented, the default), or each layer
alone (isolated), then the whole forward and backward.

Usage:
  python -m videovector_tpu_torch.tools.cli train --solver=solver.prototxt
  python -m videovector_tpu_torch.tools.cli test --model=net.prototxt \\
      --weights=model.vvmodel --iterations=50
  python -m videovector_tpu_torch.tools.cli time --model=net.prototxt
  python -m videovector_tpu_torch.tools.cli device_query

`train --mesh DxM` and `test --mesh DxM` run over a (data, model) mesh of
D x M ranks, one process a device (parallel/mesh.py): launch them with
`python -m torch.distributed.run --nproc_per_node N -m
videovector_tpu_torch.tools.cli train --mesh N ...` (NCCL on cards);
`--mesh 1` needs no launcher. Rank 0 logs and writes the files.
`--shard_gallery` shards the RETRIEVAL_STATS report's gallery rows.
"""

from __future__ import annotations

import argparse
import functools
import glob
import re
import sys
import time as _time

import numpy as np
import torch

from videovector_tpu_torch.config.textformat import parse_file
from videovector_tpu_torch.data.weights import NetWeights, load_into_params
from videovector_tpu_torch.device import resolve
from videovector_tpu_torch.graph.data_factory import MergedSource, make_data_source
from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES, LAYERS
from videovector_tpu_torch.graph.net import Net
from videovector_tpu_torch.ops.sharding import MeshRun, writer_logs
from videovector_tpu_torch.parallel import make_mesh
from videovector_tpu_torch.solver.checkpoint import load_model
from videovector_tpu_torch.solver.driver import SolverDriver, _spec_from_batch
from videovector_tpu_torch.utils.logging import get_logger
from videovector_tpu_torch.utils.timer import Timer

log = get_logger(__name__)


def _wants_cpu(args, solver_msg=None) -> bool:
    """The reference's device selection: SolverParameter.solver_mode CPU/GPU
    and the caffe.bin --gpu flag (ref:tools/caffe.cpp:97-104). `--cpu`,
    `--gpu=-1` or `solver_mode: CPU` pick the CPU; anything else the card."""
    cpu = getattr(args, "cpu", False)
    gpu = getattr(args, "gpu", None)
    if gpu is not None and int(gpu) < 0:
        cpu = True  # --gpu=-1 is CPU mode (the later Caffe's convention)
    if not cpu and solver_msg is not None:
        cpu = str(solver_msg.get("solver_mode", "GPU")).upper() == "CPU"
    return cpu


def _device(args, solver_msg=None) -> torch.device:
    """_wants_cpu's device, logged; the card must be there."""
    gpu = getattr(args, "gpu", None)
    if _wants_cpu(args, solver_msg):
        log.info("Running in CPU-only mode (solver_mode: CPU / --cpu)")
        return resolve("cpu")
    if gpu is not None:
        # accepted for the reference's driver scripts
        # (train_mednet_embedding.sh passes --gpu=3); the port runs on the
        # process's current card
        log.info("--gpu=%s accepted (the port runs on the current card)", gpu)
    return resolve("cuda")


def _parse_mesh(spec: str, devices):
    """"DxM" -> parallel.make_mesh(data=D, model=M) on `devices` (make_mesh
    starts the group for torchrun's ranks and for a one-rank mesh); "" ->
    None."""
    if not spec:
        return None
    data_sz, _, model_sz = spec.partition("x")
    return make_mesh(data=int(data_sz), model=int(model_sz or 1),
                     devices=devices)


def _mesh_of(args, solver_msg=None):
    """The command's `--mesh`, on _wants_cpu's device type."""
    return _parse_mesh(getattr(args, "mesh", ""),
                       "cpu" if _wants_cpu(args, solver_msg) else "cuda")


def mesh_command(fn):
    """fn(args, mesh): the mesh of `--mesh` (or None) is made first, then
    fn runs with its log lines on the writer rank alone (rank 0 logs and
    writes)."""
    @functools.wraps(fn)
    def run(args):
        solver = getattr(args, "solver", None)
        mesh = _mesh_of(args, parse_file(solver) if solver else None)
        with writer_logs(mesh):
            return fn(args, mesh)
    return run


def mesh_run(mesh, source) -> MeshRun:
    """A test or extraction pass over `mesh`: every rank draws the same
    stream from `source` and forwards its rows of each batch (each key's
    batch axis from the source) under the mesh's axes."""
    axes = dict(source.batch_axes()) if hasattr(source, "batch_axes") else {}
    return MeshRun(mesh, axes, any(a == 1 for a in axes.values()))


@mesh_command
def cmd_train(args, mesh) -> int:
    if args.snapshot and args.weights:
        # ref CHECK(!FLAGS_snapshot.size() || !FLAGS_weights.size()),
        # tools/caffe.cpp:82-84: a snapshot already carries the weights
        raise SystemExit("Give a snapshot to resume training or weights "
                         "to finetune but not both.")
    dev = _device(args, parse_file(args.solver))
    driver = SolverDriver.from_prototxt(args.solver, device=dev).build()
    snapshot = args.snapshot or None
    if getattr(args, "auto_resume", False) and not snapshot:
        snapshot = _latest_snapshot(driver.cfg.snapshot_prefix)
        if snapshot:
            log.info("Auto-resuming from %s", snapshot)
    if mesh is not None:
        log.info("Training over mesh data=%d model=%d", mesh.size(0),
                 mesh.size(1))
    _train_with_restarts(driver, snapshot=snapshot,
                         weights=args.weights or None, mesh=mesh,
                         shard_gallery=bool(getattr(args, "shard_gallery",
                                                    False)),
                         max_restarts=getattr(args, "max_restarts", 0))
    log.info("Optimization Done.")
    return 0


def _train_with_restarts(driver, *, snapshot, weights, mesh=None,
                         shard_gallery: bool = False,
                         max_restarts: int = 0):
    """Failure recovery: on a runtime fault (anything but Ctrl-C), reload
    the newest snapshot and continue, up to `max_restarts` times. The
    reference's recovery is a human re-running `caffe train --snapshot=...`
    (ref:src/caffe/solver.cpp:419-429 Restore); this automates it
    in-process. Each restart rebuilds the data sources, so the sampling
    streams restart from their seed, as a manual restart's do."""
    restarts = 0
    while True:
        try:
            return driver.train(resume_state_path=snapshot,
                                weights_path=weights, mesh=mesh,
                                shard_gallery=shard_gallery)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 - deliberate catch-all
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = _latest_snapshot(driver.cfg.snapshot_prefix)
            log.error("Training failed (%s: %s); restart %d/%d from %s",
                      type(e).__name__, e, restarts, max_restarts,
                      latest or ("finetune weights" if weights else
                                 "scratch"))
            if latest is not None:
                # a snapshot carries the full state; --weights only seeds
                # the first attempt
                snapshot = latest
                weights = None
            # else no snapshot landed yet: keep the original snapshot or
            # weights, so that a finetune restarts from them
            driver = driver.rebuild()


def _latest_snapshot(prefix: str):
    """The newest <prefix>_iter_N.vvstate, or None."""
    if not prefix:
        return None
    best, best_iter = None, -1
    for path in glob.glob(f"{glob.escape(prefix)}_iter_*.vvstate"):
        m = re.search(r"_iter_(\d+)\.vvstate$", path)
        if m and int(m.group(1)) > best_iter:
            best, best_iter = path, int(m.group(1))
    return best


def _load_weights(path: str, params, dev):
    """A .vvmodel's layers copied into params; any other file is read as the
    reference's .caffemodel (data/weights.py, name-matched, shape-checked,
    INNER_PRODUCT blobs transposed)."""
    if not path.endswith(".vvmodel"):
        return load_into_params(NetWeights.load(path), params)
    for lname, lp in load_model(path).items():
        if lname in params:
            params[lname].update({k: v.to(dev) for k, v in lp.items()})
    return params


@mesh_command
def cmd_test(args, mesh) -> int:
    """Average net outputs over N forward iterations (ref caffe.cpp:127-190).
    """
    if not args.weights and not getattr(args, "allow_random_weights", False):
        # ref CHECK_GT(FLAGS_weights.size(), 0) "Need model weights to
        # score." (tools/caffe.cpp:129); the explicit opt-out is for smoke
        # runs
        raise SystemExit("Need model weights to score "
                         "(or pass --allow_random_weights).")
    dev = _device(args)
    net = Net(parse_file(args.model), phase="TEST")
    source = MergedSource([make_data_source(l, phase="TEST")
                           for l in net.layers
                           if l.get("type") in DATA_LAYER_TYPES])
    batch0_raw = source.next_batch()
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0),
                         _spec_from_batch(batch0_raw))
    if args.weights:
        params = _load_weights(args.weights, params, dev)

    sinks = bool(net.host_sinks)
    stateful = bool(net.stateful_layer_names)
    validators = net.batch_validators()
    shard = mesh_run(mesh, source)
    apply = shard.under_axes(net.apply)
    sums: dict[str, np.ndarray] = {}
    loss_sum = 0.0
    # the LSTM cross-batch state carries across the test forwards, as in
    # the reference (`caffe test` reuses one net, so prev_cell_ persists
    # between batches, ref lstm_layer.cpp:171-173,261-264)
    carry = None
    for i in range(args.iterations):
        raw = batch0_raw if i == 0 else source.next_batch()
        for v in validators:  # on the host batch, before it is used
            v(raw)
        batch = {k: torch.as_tensor(x, device=dev)
                 for k, x in shard.rows(raw).items()}
        with torch.no_grad():
            loss, outputs, *rest = apply(
                params, batch, state=carry, return_state=stateful,
                return_sink_blobs=sinks)
        if stateful:
            carry = rest.pop(0)
        if sinks:
            # the reference's sink layers truncate and rewrite their files
            # on every TEST forward (retrieval_stats_layer.cpp:150)
            net.process_host_sinks(
                shard.gather(rest[0]), mesh=mesh,
                shard_gallery=bool(getattr(args, "shard_gallery", False)))
        loss_sum += float(loss)
        for k, v in sorted(outputs.items()):  # JAX's jitted dict order
            arr = v.detach().cpu().numpy().reshape(-1)
            sums[k] = (sums[k] + arr) if k in sums else arr.copy()
            # per-batch per-element lines (ref:tools/caffe.cpp:156-169)
            for x in arr:
                log.info("Batch %d, %s = %g", i, k, x)
    log.info("Loss: %g", loss_sum / args.iterations)
    # every ELEMENT of every output blob gets its mean, loss-weighted
    # outputs with the reference's '(* w = x loss)' suffix
    # (ref:tools/caffe.cpp:173-185)
    out_w = net.output_loss_weights()
    for k, v in sorted(sums.items()):
        w = out_w.get(k, 0.0)
        for x in v / args.iterations:
            suffix = f" (* {w:g} = {w * x:g} loss)" if w else ""
            log.info("%s = %g%s", k, x, suffix)
    return 0


def _memory_stats(index: int) -> dict:
    """The caching allocator's numbers for card `index`, under the JAX
    runtime's memory_stats names."""
    stats = torch.cuda.memory_stats(index)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(index).total_memory,
            "num_allocs": stats.get("allocation.all.allocated", 0)}


def cmd_device_query(args) -> int:
    if getattr(args, "cpu", False):
        log.info("Device: cpu")
        log.info("  platform: cpu")
        log.info("  threads: %d", torch.get_num_threads())
        return 0
    resolve("cuda")
    if getattr(args, "watch", False):
        return _device_watch(interval=args.interval, count=args.count)
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        stats = _memory_stats(i)
        log.info("Device: cuda:%d", i)
        log.info("  platform: cuda")
        log.info("  device_kind: %s", props.name)
        log.info("  compute capability: %d.%d", props.major, props.minor)
        log.info("  multiprocessors: %d", props.multi_processor_count)
        log.info("  bytes_limit: %s", stats["bytes_limit"])
        log.info("  bytes_in_use: %s", stats["bytes_in_use"])
        log.info("  peak_bytes_in_use: %s", stats["peak_bytes_in_use"])
    return 0


def _device_watch(interval: float = 2.0, count: int = 0, out=None,
                  devices=None) -> int:
    """Live device telemetry table, the reference's gpustat.py watcher
    (ref:caffe_utils/gpustat.py:1-40): one row per card per tick with the
    caching allocator's bytes in use, peak and the card's memory, and the
    allocation count. Ctrl-C (or `count` ticks) stops."""
    write = (out.write if out is not None
             else lambda s: print(s, end="", flush=True))

    def mb(v):
        return f"{v / (1 << 20):8.1f}" if isinstance(v, (int, float)) \
            else "     n/a"

    if devices is None:
        devices = list(range(torch.cuda.device_count()))
    write(f"{'time':>8s}  {'dev':<22s} {'used MB':>8s} {'peak MB':>8s} "
          f"{'limit MB':>8s} {'use%':>5s} {'allocs':>7s}\n")
    tick = 0
    try:
        while True:
            ts = _time.strftime("%H:%M:%S")
            for d in devices:
                stats = _memory_stats(d) or {}
                used = stats.get("bytes_in_use")
                peak = stats.get("peak_bytes_in_use")
                limit = stats.get("bytes_limit")
                pct = (f"{100.0 * used / limit:5.1f}"
                       if isinstance(used, (int, float))
                       and isinstance(limit, (int, float)) and limit
                       else "  n/a")
                allocs = stats.get("num_allocs", "n/a")
                write(f"{ts:>8s}  {f'cuda:{d}':<22.22s} {mb(used)} "
                      f"{mb(peak)} {mb(limit)} {pct} {allocs!s:>7s}\n")
            tick += 1
            if count and tick >= count:
                break
            _time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return 0


def _time_ms(fn, iters: int, device, repeats: int = 1) -> float:
    """Mean ms of fn() over `iters` calls after one warm-up, the least of
    `repeats` such runs: CUDA events on a card, the host clock on the CPU.
    """
    fn()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timer = Timer(device=device)
        timer.start()
        for _ in range(iters):
            fn()
        best = min(best, timer.stop() / iters)
    return best


def _grad_leaves(params):
    """Detached copies of every param that require grad: (tree, leaves)."""
    tree = {ln: {pn: t.detach().requires_grad_() for pn, t in lp.items()}
            for ln, lp in params.items()}
    return tree, [t for lp in tree.values() for t in lp.values()]


def _backward(scalar, leaves) -> None:
    if scalar.requires_grad:
        torch.autograd.grad(scalar, leaves, allow_unused=True)


def _float_sum(tensors):
    tot = None
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            s = t.float().sum()
            tot = s if tot is None else tot + s
    return tot if tot is not None else torch.zeros(())


def cmd_time(args) -> int:
    """Per-layer forward timing and whole-step forward and backward timing
    (ref caffe.cpp:194-266)."""
    dev = _device(args)
    net_msg = parse_file(args.model)
    net = Net(net_msg, phase="TRAIN")
    # the batch from the net's data layers, or, for deploy-style prototxts
    # (the reference `caffe time` staple), from its input/input_dim
    # declarations (ref:tools/caffe.cpp:199-201)
    rng = np.random.RandomState(0)
    batch = {}
    input_names = list(net_msg.get_list("input"))
    input_dims = [int(d) for d in net_msg.get_list("input_dim")]
    for idx, name in enumerate(input_names):
        dims = input_dims[idx * 4:(idx + 1) * 4]
        if not dims:
            raise ValueError(f"input {name!r} has no input_dim")
        batch[str(name)] = rng.randn(*dims).astype(np.float32)
    for layer in net.layers:
        if layer.get("type") in DATA_LAYER_TYPES:
            batch.update(make_data_source(layer, phase="TRAIN").next_batch())
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0),
                         _spec_from_batch(batch))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    iters = args.iterations
    log.info("*** Benchmark begins ***")
    mode = getattr(args, "per_layer", "segmented")
    if getattr(args, "fused_only", False):
        mode = "off"
    memory = getattr(args, "memory", False)
    backward = getattr(args, "backward", False)
    if mode == "segmented":
        _time_segmented(net, params, batch, iters, backward=backward)
    elif mode == "isolated":
        _time_isolated(net, params, batch, iters, backward=backward)
    return _time_fused(net, params, batch, iters, memory=memory)


def _time_segmented(net, params, batch, iters, backward=False) -> None:
    """Per-layer cost as the marginal time of adding the layer to the
    forward prefix (`Net.apply(max_layers=k)`, the per-layer graph): prefix
    L is the whole forward, so the column sums to what a step pays. With
    `backward`, each prefix runs forward and backward of the sum of its
    blobs with respect to the params (the reference prints both,
    caffe.cpp:232-249). Each prefix's time is the least of 3 runs: eager
    prefixes are paced by the host, whose hiccups would otherwise make
    marginals negative."""
    dev = next(iter(batch.values())).device
    names = [str(l.get("name")) for l in net.layers
             if l.get("type") not in DATA_LAYER_TYPES]
    gen = torch.Generator(device=dev).manual_seed(0)

    def prefix(k):
        if not backward:
            with torch.no_grad():
                net.apply(params, batch, generator=gen, return_blobs=True,
                          max_layers=k)
            return
        tree, leaves = _grad_leaves(params)
        with torch.enable_grad():
            _, blobs = net.apply(tree, batch, generator=gen,
                                 return_blobs=True, max_layers=k)
            _backward(_float_sum(blobs.values()), leaves)

    prefix_ms = [_time_ms(lambda: prefix(k), iters, dev, repeats=3)
                 for k in range(len(names) + 1)]
    what = "forward-backward" if backward else "forward"
    total = 0.0
    for i, name in enumerate(names):
        dt = prefix_ms[i + 1] - prefix_ms[i]
        total += dt
        log.info("%-24s %s (marginal): %.3f ms", name, what, dt)
    log.info("Total %s (prefix sum): %.3f ms", what, total)


def _time_isolated(net, params, batch, iters, backward=False) -> None:
    """Each layer alone on the blobs of one full forward (the reference's
    per-layer Forward and Backward loops, caffe.cpp:209-249)."""
    dev = next(iter(batch.values())).device
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        _, blobs = net.apply(params, batch, generator=gen, return_blobs=True)
    ctx = net._context(gen)
    total = 0.0
    for layer in net.layers:
        ltype, lname = layer.get("type"), layer.get("name")
        if ltype in DATA_LAYER_TYPES:
            continue
        ldef = LAYERS[ltype]
        bottoms = [blobs[str(b)] for b in layer.get_list("bottom")]
        lparams = net._resolve_params(params, net.param_meta, lname)

        def fwd(ldef=ldef, lparams=lparams, bottoms=bottoms, layer=layer):
            with torch.no_grad():
                ldef.apply(lparams, bottoms, layer, ctx)
        dt = _time_ms(fwd, iters, dev)
        total += dt
        log.info("%-24s forward: %.3f ms", lname, dt)
        if not backward:
            continue
        # the per-layer Backward: gradients of the sum of its outputs with
        # respect to its params and float bottoms
        xs = [b.detach().requires_grad_() if b.is_floating_point() else b
              for b in bottoms]
        ps = {k: v.detach().requires_grad_() for k, v in lparams.items()}
        leaves = [x for x in xs if x.requires_grad] + list(ps.values())
        if not leaves:
            continue  # nothing to differentiate

        def bwd(ldef=ldef, ps=ps, xs=xs, layer=layer, leaves=leaves):
            with torch.enable_grad():
                _backward(_float_sum(ldef.apply(ps, xs, layer, ctx)), leaves)
        log.info("%-24s backward: %.3f ms", lname, _time_ms(bwd, iters, dev))
    log.info("Total per-layer forward: %.3f ms", total)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB"):
        if n < 1024:
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.2f} GiB"


def _time_fused(net, params, batch, iters, memory=False) -> int:
    dev = next(iter(batch.values())).device
    gen = torch.Generator(device=dev).manual_seed(0)
    has_loss = any(w != 0.0 for ws in net.loss_weights.values() for w in ws)
    if not has_loss:
        # a loss-less (deploy) net: reduce every net output to a scalar
        # (ones cotangents), the isolated per-layer backward's convention
        # and the reference's Backward-on-whatever-diffs
        # (ref:tools/caffe.cpp:241-249)
        log.info("net has no loss layer: timing forward+backward of "
                 "sum(outputs)")

    def scalar(p):
        if has_loss:
            return net.loss_fn(p, batch, gen)
        _, outputs = net.apply(p, batch, generator=gen)
        return _float_sum(outputs.values())

    def step():
        tree, leaves = _grad_leaves(params)
        with torch.enable_grad():
            _backward(scalar(tree), leaves)

    def forward():
        with torch.no_grad():
            scalar(params)

    if memory:
        for tag, fn in (("fused forward-backward", step),
                        ("forward only", forward)):
            _log_memory(tag, fn, dev)
    ms = _time_ms(step, iters, dev)
    log.info("Fused forward-backward: %.3f ms (%.1f steps/s)", ms, 1e3 / ms)
    log.info("*** Benchmark ends ***")
    return 0


def _log_memory(tag: str, fn, dev) -> None:
    """The caching allocator's peak bytes around one call of fn, the port's
    counterpart of the JAX package's XLA buffer report: the peak, the bytes
    in use before it (params and batch: the arguments) and the difference
    (temporaries). Not reported on the CPU."""
    if dev.type != "cuda":
        log.info("Memory (%s): not reported by this backend", tag)
        return
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    log.info("Memory (%s): peak %s (arguments %s, temporaries %s)", tag,
             _fmt_bytes(peak), _fmt_bytes(before), _fmt_bytes(peak - before))


def _device_flags(p, what: str) -> None:
    p.add_argument("--cpu", action="store_true",
                   help=f"run {what} on the CPU (the default is the card)")
    p.add_argument("--gpu", type=int, default=None,
                   help="reference-script compatibility: accepted; -1 means "
                        "CPU mode, otherwise the current card")


def _mesh_flags(p) -> None:
    p.add_argument("--mesh", default="",
                   help="a mesh as DATAxMODEL (e.g. 4x2, or 4 for 4x1) of "
                        "ranks, one process a device (launch N > 1 ranks "
                        "with python -m torch.distributed.run): batch over "
                        "data, 2-D params over model")
    p.add_argument("--shard_gallery", action="store_true",
                   help="with --mesh: shard the RETRIEVAL_STATS report's "
                        "gallery rows over the data axis")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a model from a solver prototxt")
    p.add_argument("--solver", required=True)
    p.add_argument("--snapshot", default="",
                   help="resume from a .vvstate snapshot, or a reference "
                        ".solverstate (momentum history restored; "
                        "ref solver.cpp:419-429)")
    p.add_argument("--weights", default="",
                   help="finetune from .vvmodel weights")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="failure recovery: on a runtime fault, reload the "
                        "newest snapshot and continue, up to N times "
                        "(0 = fail fast, the reference behavior)")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest snapshot matching the "
                        "solver's snapshot_prefix, if any")
    _device_flags(p, "training (also from the solver's solver_mode: CPU)")
    _mesh_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("test", help="score a model")
    p.add_argument("--model", required=True)
    p.add_argument("--weights", default="")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="score with random init (the reference CHECK-fails "
                        "without --weights; this is the explicit opt-out)")
    p.add_argument("--iterations", type=int, default=50)
    _device_flags(p, "scoring")
    _mesh_flags(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("device_query", help="show device info")
    p.add_argument("--watch", action="store_true",
                   help="live telemetry table (gpustat-style): memory "
                        "used/peak/limit per card, sampled periodically")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch sampling period in seconds")
    p.add_argument("--count", type=int, default=0,
                   help="--watch tick count (0 = until Ctrl-C)")
    p.add_argument("--cpu", action="store_true",
                   help="describe the CPU instead of the cards")
    p.set_defaults(fn=cmd_device_query)

    p = sub.add_parser("time", help="per-layer timing benchmark")
    p.add_argument("--model", required=True)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--per_layer", default="segmented",
                   choices=["segmented", "isolated", "off"],
                   help="segmented (default): per-layer cost as the marginal "
                        "time of the forward prefix; isolated: each layer "
                        "alone (reference caffe.cpp semantics); off: the "
                        "whole forward-backward only")
    p.add_argument("--fused_only", action="store_true",
                   help="[deprecated] alias for --per_layer=off")
    _device_flags(p, "the benchmark")
    p.add_argument("--memory", action="store_true",
                   help="report the caching allocator's peak bytes around "
                        "the forward and the forward-backward")
    p.add_argument("--backward", action="store_true",
                   help="also time backward per layer (reference "
                        "caffe time prints both)")
    p.set_defaults(fn=cmd_time)

    # deprecated shims (ref:tools/train_net.cpp:3-6 etc.: thin aliases)
    p = sub.add_parser("train_net", help="[deprecated] use train")
    p.add_argument("solver")
    p.add_argument("snapshot", nargs="?", default="")
    _device_flags(p, "training")
    p.set_defaults(fn=lambda a: cmd_train(argparse.Namespace(
        solver=a.solver, snapshot=a.snapshot, weights="", cpu=a.cpu,
        gpu=a.gpu)))
    p = sub.add_parser("finetune_net", help="[deprecated] use train --weights")
    p.add_argument("solver")
    p.add_argument("weights")
    _device_flags(p, "training")
    p.set_defaults(fn=lambda a: cmd_train(argparse.Namespace(
        solver=a.solver, snapshot="", weights=a.weights, cpu=a.cpu,
        gpu=a.gpu)))
    p = sub.add_parser("test_net", help="[deprecated] use test")
    p.add_argument("model")
    p.add_argument("weights")
    p.add_argument("iterations", nargs="?", type=int, default=50)
    _device_flags(p, "scoring")
    p.set_defaults(fn=cmd_test)
    p = sub.add_parser("net_speed_benchmark", help="[deprecated] use time")
    p.add_argument("model")
    p.add_argument("iterations", nargs="?", type=int, default=50)
    _device_flags(p, "the benchmark")
    p.set_defaults(fn=cmd_time)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
