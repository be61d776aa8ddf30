"""The port's side of tests/test_torch_parallel_*.py: each function runs on
every gloo rank (tests/torch_parallel_cases.py) and returns numpy results.
No JAX here; inputs are numpy, made from seeds by the test files."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from videovector_tpu_torch.convert import map_params, params_to_numpy
from videovector_tpu_torch.models.embedding import (
    VideoEmbeddingConfig, VideoEmbeddingModel,
)
from videovector_tpu_torch.ops.sharding import (
    all_reduce_grads, mesh_axis, unshard_params,
)
from videovector_tpu_torch.parallel import make_mesh, make_train_step
from videovector_tpu_torch.parallel.train import shard_batch, shard_params
from videovector_tpu_torch.solver.solvers import SolverConfig, init_solver_state


def _t(tree):
    return map_params(lambda a: torch.as_tensor(np.asarray(a)), tree)


def mesh_errors():
    out = []
    for kw in (dict(model=3), dict(data=4, model=4), dict(data=3, model=2)):
        try:
            make_mesh(devices="cpu", **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    mesh = make_mesh(devices="cpu", model=2)
    return out, mesh.size(0), mesh.size(1), \
        mesh.get_local_rank("data"), mesh.get_local_rank("model")


def layout(params, batch, data, model, axes):
    mesh = make_mesh(data, model, devices="cpu")
    p = shard_params(_t(params), mesh, model_axis=model > 1)
    b = shard_batch(_t(batch), mesh, axes)
    full = unshard_params(p, mesh, model_axis=model > 1)
    return params_to_numpy(p), params_to_numpy(b), params_to_numpy(full)


def embedding_steps(params, batches, data, model, cfg, scfg, gm=0,
                    role_major=False, seed=3):
    """make_train_step on the flagship model: (losses, aux per step, final
    whole params)."""
    mesh = make_mesh(data, model, devices="cpu")
    mcfg = VideoEmbeddingConfig(**cfg)
    m = VideoEmbeddingModel(mcfg)
    s = SolverConfig(**scfg)
    p = shard_params(_t(params), mesh, model_axis=model > 1)
    state = init_solver_state(s, p)
    axes = {"data": 1 if role_major else 0}
    step = make_train_step(
        lambda pp, b, g: m.loss(pp, b, generator=g, train=True,
                                role_major=role_major),
        s, mesh, grad_microbatch=gm, batch_axes=axes if gm else None)
    gen = torch.Generator()
    losses, auxes = [], []
    for i, b in enumerate(batches):
        gen.manual_seed(seed + i)
        p, state, met = step(p, state, shard_batch(_t(b), mesh, axes), gen)
        losses.append(float(met["loss"]))
        auxes.append({k: float(v) for k, v in met.items() if k != "loss"})
    full = unshard_params(p, mesh, model_axis=model > 1)
    return losses, auxes, params_to_numpy(full), dist.get_rank(), \
        mesh_axis(mesh, "data").index


def dp_steps(params, data, cfg, scfg, wire, steps=4, seed=5):
    """make_dp_train_step (f32 or bf16 wire): (losses, final params)."""
    from videovector_tpu_torch.parallel.shard_map_dp import (
        make_dp_train_step, place_dp,
    )
    mesh = make_mesh(4, 1, devices="cpu")
    m = VideoEmbeddingModel(VideoEmbeddingConfig(**cfg))
    s = SolverConfig(**scfg)
    step = make_dp_train_step(
        lambda pp, b, g: m.loss(pp, b, generator=g, train=False), s, mesh,
        psum_dtype=torch.bfloat16 if wire == "bf16" else None)
    p, st, batch = place_dp(_t(params), init_solver_state(s, _t(params)),
                            {"data": data}, mesh)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for _ in range(steps):
        p, st, met = step(p, st, batch, gen)
        losses.append(float(met["loss"]))
    return losses, params_to_numpy(p)


def tp_loss(params, data, cfg, data_n, model_n):
    """make_tp_loss_fn: (loss, violations, the whole w and b gradients
    averaged over "data")."""
    from videovector_tpu_torch.parallel.shard_map_tp import (
        make_tp_loss_fn, place_tp_params,
    )
    from videovector_tpu_torch.solver.train import value_and_grad
    from videovector_tpu_torch.ops.collectives import all_gather
    mesh = make_mesh(data_n, model_n, devices="cpu")
    fn = make_tp_loss_fn(VideoEmbeddingConfig(**cfg), mesh)
    p = place_tp_params(params, mesh)
    b = shard_batch({"data": data}, mesh)
    (loss, aux), g = value_and_grad(fn)(p, b, None)
    g = all_reduce_grads(g, mesh)
    ax = mesh_axis(mesh, "model")
    return (float(loss), float(aux["violations"]),
            all_gather(g["tower"]["w"], ax, 1).numpy(),
            all_gather(g["tower"]["b"], ax, 0).numpy())


def host_source():
    from videovector_tpu_torch.parallel.multihost import (
        HostShardedSource, global_batch_from_device_shards, host_shard_range,
    )

    class TimeMajor:
        def batch_axes(self):
            return {"obs": 1, "ids": 0}

        def next_batch(self):
            obs = np.broadcast_to(np.arange(8, dtype=np.float32)[None, :, None],
                                  (3, 8, 2)).copy()
            return {"obs": obs, "ids": np.arange(8, dtype=np.float32)}

    mesh = make_mesh(4, 1, devices="cpu")
    src = HostShardedSource(TimeMajor(), mesh, simulate=True)
    b = src.next_batch()
    err = None
    try:
        global_batch_from_device_shards(
            {"data": np.zeros((7, 15, 32), np.float32)}, mesh)
    except ValueError as e:
        err = str(e)
    shards = global_batch_from_device_shards(
        {"data": np.arange(8, dtype=np.float32)}, mesh)
    return (src.batch_axes(), params_to_numpy(b), err,
            host_shard_range(8, mesh), shards["data"].numpy())


def replicate_check():
    """replicate_global: equal trees pass; a rank with other values makes
    every rank raise."""
    from videovector_tpu_torch.parallel.multihost import replicate_global
    mesh = make_mesh(4, 1, devices="cpu")
    ok = replicate_global({"a": {"w": np.ones((2, 3), np.float32)}}, mesh)
    try:
        replicate_global({"w": np.full(3, float(dist.get_rank() == 2),
                                       np.float32)}, mesh)
        raised = False
    except ValueError:
        raised = True
    return params_to_numpy(ok), raised


def eval_step(params, data, cfg, data_n, model_n):
    from videovector_tpu_torch.parallel import make_eval_step
    mesh = make_mesh(data_n, model_n, devices="cpu")
    m = VideoEmbeddingModel(VideoEmbeddingConfig(**cfg))
    p = shard_params(_t(params), mesh, model_axis=model_n > 1)

    def eval_fn(pp, b):
        loss, aux = m.loss(pp, b, train=False)
        return {"loss": loss, "violations": aux["violations"]}
    out = make_eval_step(eval_fn, mesh)(p, shard_batch({"data": data}, mesh))
    return {k: float(v) for k, v in out.items()}


def pipeline(params, batch, data_n, microbatches, clip=0.0):
    """make_pp_loss_fn on a (data_n, 2) mesh: per M, (loss, gradients
    averaged over "data"); then the divisibility error."""
    from videovector_tpu_torch.parallel.pipeline import make_pp_loss_fn
    from videovector_tpu_torch.solver.train import value_and_grad
    mesh = make_mesh(data_n, 2, devices="cpu")
    axes = {k: 1 for k in batch}
    b = shard_batch(_t(batch), mesh, axes)
    out = []
    for m in microbatches:
        fn = make_pp_loss_fn(mesh, num_microbatches=m, clip_threshold=clip)
        (loss, _), g = value_and_grad(
            lambda p, bb, _g: (fn(p, bb), {}))(_t(params), b, None)
        out.append((float(loss),
                    params_to_numpy(all_reduce_grads(g, mesh))))
    err = None
    try:
        make_pp_loss_fn(mesh, num_microbatches=3)(_t(params), b)
    except ValueError as e:
        err = str(e)
    try:
        make_pp_loss_fn(make_mesh(devices="cpu"), num_microbatches=1)
    except ValueError as e:
        err = (err, str(e))
    return out, err


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def driver_train(solver_path, data_n, model_n, params=None,
                 shard_gallery=False):
    """SolverDriver.train over a (data_n, model_n) mesh: (metrics history,
    test history, whole final params, the final carry as numpy)."""
    from videovector_tpu_torch.solver.driver import SolverDriver
    mesh = make_mesh(data_n, model_n, devices="cpu")
    d = SolverDriver.from_prototxt(solver_path, device="cpu").build()
    if params is not None:
        d.params = _t(params)
    res = d.train(mesh=mesh, shard_gallery=shard_gallery)
    carry = res.final_carry
    if isinstance(carry, dict):
        carry = {k: tuple(_np(t) for t in v) for k, v in carry.items()}
    return (res.metrics_history, res.test_history,
            params_to_numpy(res.params), _np(carry))


def worker_steps(solver_path, params, iters=3):
    """multihost_worker's steps (worker_losses) over this launch's ranks,
    from `params` (whole, numpy): the loss list."""
    from videovector_tpu_torch.parallel.multihost_worker import worker_losses
    from videovector_tpu_torch.solver.driver import SolverDriver
    d = SolverDriver.from_prototxt(solver_path, device="cpu").build()
    return worker_losses(d, _t(params), iters)


def net_steps(net_text, batches, data_n, model_n, steps_seed=11):
    """make_train_step on a Net with a batch-coupled head (SOFTMAX_LOSS,
    ACCURACY, CLASSIFICATION_STATS): (per-step outputs, whole params)."""
    from videovector_tpu_torch.config.textformat import parse
    from videovector_tpu_torch.graph.net import Net
    from videovector_tpu_torch.solver.driver import _spec_from_batch
    mesh = make_mesh(data_n, model_n, devices="cpu")
    net = Net(parse(net_text), phase="TRAIN")
    params, _ = net.init(torch.Generator().manual_seed(0),
                         _spec_from_batch(batches[0]))
    s = SolverConfig(base_lr=0.1, momentum=0.9)
    p = shard_params(params, mesh, model_axis=model_n > 1)
    st = init_solver_state(s, p)

    def loss_fn(pp, b, g):
        loss, outs = net.apply(pp, b, generator=g)
        return loss, {k: v.reshape(-1) for k, v in outs.items()}
    step = make_train_step(loss_fn, s, mesh)
    gen = torch.Generator()
    hist = []
    for i, b in enumerate(batches):
        gen.manual_seed(steps_seed + i)
        p, st, met = step(p, st, shard_batch(_t(b), mesh), gen)
        hist.append({k: _np(v) for k, v in met.items()})
    return hist, params_to_numpy(unshard_params(p, mesh,
                                                model_axis=model_n > 1))


class _Lines:
    """The port logger's messages (rank 0's; the others log nothing)."""

    def __init__(self):
        import logging
        self.lines = []
        outer = self

        class H(logging.Handler):
            def emit(self, record):
                outer.lines.append(record.getMessage())
        self.h = H()
        self.logger = logging.getLogger("videovector_tpu_torch")

    def __enter__(self):
        self.logger.addHandler(self.h)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.h)


def cli_runs(solver, model, weights, out_prefix, blobs):
    """`train --mesh 2`, `test --mesh 2` and `extract_features --mesh 2` in
    this rank: the log lines each command logged here."""
    from videovector_tpu_torch.tools import cli
    from videovector_tpu_torch.tools import extract_features
    out = {}
    with _Lines() as lt:
        assert cli.main(["train", "--solver", solver, "--mesh", "2",
                         "--cpu"]) == 0
    out["train"] = lt.lines
    with _Lines() as ls:
        assert cli.main(["test", "--model", model, "--weights", weights,
                         "--iterations", "2", "--mesh", "2", "--cpu"]) == 0
    out["test"] = ls.lines
    with _Lines() as le:
        assert extract_features.main([
            "--model", model, "--weights", weights, "--blobs", blobs,
            "--out", out_prefix, "--num_batches", "2", "--mesh", "2",
            "--cpu"]) == 0
    out["extract"] = le.lines
    return out


def serving_case(artifact, batch):
    """shard_serving of a one-device artifact over 2 ranks, and its
    refusals."""
    from videovector_tpu_torch.tools import serving
    mesh = make_mesh(devices="cpu")
    call, meta = serving.load_serving(artifact)
    out = serving.shard_serving(call, meta, mesh)(batch)
    errs = []
    bad = dict(meta, nr_devices=2)
    for m, b in ((bad, batch), (meta, {k: v[:3] for k, v in batch.items()}),
                 (dict(meta, batch_axes={k: None for k in batch}), batch)):
        try:
            serving.shard_serving(call, m, mesh)(b)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    with _Lines() as lr:
        assert serving.main(["run", artifact, "--mesh", "2"]) == 0
    return {k: _np(v) for k, v in out.items()}, errs, lr.lines


def retrieval(feats, vids, cls, out_dir, data_n, model_n):
    """The mesh engines (query chunks over "data"; gallery rows with
    shard_gallery) and their csv reports (rank 0 writes `<mesh>_*.csv`)."""
    from videovector_tpu_torch.metrics.retrieval import (
        retrieval_stats_chunked, retrieval_stats_report,
    )
    mesh = make_mesh(data_n, model_n, devices="cpu")
    tag = f"{data_n}x{model_n}"
    out = {}
    for method in ("count", "sort"):
        out[("chunks", method)] = {k: float(v) for k, v in
                                   retrieval_stats_chunked(
            feats, vids, cls, query_chunk=64, method=method,
            exclude_same_video_shots=True, mesh=mesh, device="cpu").items()}
    for excl in (False, True):
        out[("gshard", excl)] = {k: float(v) for k, v in
                                 retrieval_stats_chunked(
            feats, vids, cls, query_chunk=64, exclude_same_video_shots=excl,
            mesh=mesh, shard_gallery=True, device="cpu").items()}
    out["report"] = retrieval_stats_report(
        feats, vids, cls, f"{out_dir}/{tag}_mesh.csv", mesh=mesh,
        device="cpu")
    out["report_gshard"] = retrieval_stats_report(
        feats, vids, cls, f"{out_dir}/{tag}_gshard.csv", mesh=mesh,
        shard_gallery=True, method="count", device="cpu")
    errs = []
    for kw in (dict(shard_gallery=True, method="sort"),
               dict(chunk_driver="host")):
        try:
            retrieval_stats_chunked(feats, vids, cls, mesh=mesh,
                                    device="cpu", **kw)
        except ValueError as e:
            errs.append(str(e))
    try:
        retrieval_stats_report(feats, vids, cls, f"{out_dir}/x.csv",
                               mesh=mesh, shard_gallery=True, method="sort",
                               device="cpu")
    except ValueError as e:
        errs.append(str(e))
    out["errors"] = errs
    return out
