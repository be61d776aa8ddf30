"""videovector_tpu_torch/parallel/ (mesh, train, shard_map_dp,
shard_map_tp, multihost) against the JAX package's parallel/ on the CPU.

The port's ranks are 4 gloo processes (tests/torch_parallel_cases.py),
rank r matched to JAX's device (r // model, r % model) of conftest's
8-device CPU mesh; all of this file's cases run in one launch. Flagship
model at D=32, E=16, 1 + 4 + 6 roles, B=8 or 16, inputs from a numpy seed.
Tolerances: losses 2e-5 relative, params 1e-4 relative + 1e-6 (JAX's own
bounds in tests/test_multihost.py, test_shard_map_dp.py); TP values 1e-5,
gradients 1e-4 of their largest magnitude, and the bf16-cast tower
weight's gradient within one bf16 rounding (JAX rounds its sum over
"data" to bf16). Gradients and params (not only
losses) are compared, so a gradient scaled by the data or model size
fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from videovector_tpu.models import VideoEmbeddingConfig as JCfg
from videovector_tpu.models import VideoEmbeddingModel as JModel
from videovector_tpu.parallel import make_mesh as jmake_mesh
from videovector_tpu.parallel import make_train_step as jmake_train_step
from videovector_tpu.parallel.shard_map_dp import (
    make_dp_train_step as jmake_dp_train_step, place_dp as jplace_dp,
)
from videovector_tpu.parallel.shard_map_tp import (
    make_tp_loss_fn as jmake_tp_loss_fn, place_tp_params as jplace_tp_params,
)
from videovector_tpu.parallel.train import (
    shard_batch as jshard_batch, shard_params as jshard_params,
)
from videovector_tpu.solver import SolverConfig as JSolverConfig
from videovector_tpu.solver import init_solver_state as jinit_state

from videovector_tpu_torch.convert import params_to_numpy
from videovector_tpu_torch.models.embedding import (
    VideoEmbeddingConfig, VideoEmbeddingModel,
)
from videovector_tpu_torch.solver.solvers import (
    SolverConfig, init_solver_state, solver_update,
)
from videovector_tpu_torch.solver.train import value_and_grad

CFG = dict(feature_dim=32, embed_dim=16, num_context=4, num_negatives=6,
           dropout_rate=0.0, compute_dtype="float32")
SCFG = dict(base_lr=0.01, momentum=0.9, weight_decay=1e-4)
# (data, model, grad_microbatch, role_major)
TRAIN_CASES = [(4, 1, 0, False), (2, 2, 0, False), (4, 1, 2, False),
               (2, 2, 2, True)]
TP_CFG = dict(feature_dim=64, embed_dim=32, num_context=4, num_negatives=6,
              margin=1.5, dropout_rate=0.0, compute_dtype="float32")
DP_CFG = dict(feature_dim=48, embed_dim=32, num_context=4, num_negatives=6,
              dropout_rate=0.0, compute_dtype="float32")
DP_SCFG = dict(base_lr=0.05, momentum=0.9, weight_decay=1e-4,
               lr_policy="fixed")


def _jparams(cfg, seed=0):
    p = JModel(JCfg(**cfg)).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _batches(rs, n, b=16, cfg=CFG, role_major=False):
    out = []
    for _ in range(n):
        x = rs.randn(b, 1 + cfg["num_context"] + cfg["num_negatives"],
                     cfg["feature_dim"]).astype(np.float32)
        out.append({"data": np.ascontiguousarray(x.transpose(1, 0, 2))
                    if role_major else x})
    return out


def _jax_train(params, batches, data, model, gm, role_major):
    mesh = jmake_mesh(data=data, model=model,
                      devices=jax.devices()[:data * model])
    jm = JModel(JCfg(**CFG))
    scfg = JSolverConfig(**SCFG)
    p = jshard_params(jax.tree.map(jnp.asarray, params), mesh,
                      model_axis=model > 1)
    st = jinit_state(scfg, p)
    axes = {"data": 1 if role_major else 0}
    step = jmake_train_step(
        lambda pp, b, r: jm.loss(pp, b, rng=r, train=True,
                                 role_major=role_major),
        scfg, mesh, donate=False, grad_microbatch=gm,
        batch_axes=axes if gm else None)
    losses = []
    for i, b in enumerate(batches):
        p, st, met = step(p, st, jshard_batch(
            {"data": jnp.asarray(b["data"])}, mesh, axes),
            jax.random.PRNGKey(i))
        losses.append(float(met["loss"]))
    return losses, jax.tree.map(np.asarray, p)


def _dropout_reference(params, batches, cfg):
    """The port's one-device steps with dropout 0.5 (masks from one
    torch.Generator seeded 3 + i at step i): what the sharded steps must
    reproduce with their global-mask draws."""
    m = VideoEmbeddingModel(VideoEmbeddingConfig(**cfg))
    s = SolverConfig(**SCFG)
    p = {"tower": {k: torch.tensor(np.array(v)) for k, v in
                   params["tower"].items()}}
    st = init_solver_state(s, p)
    vg = value_and_grad(lambda pp, b, g: m.loss(pp, b, generator=g,
                                                train=True))
    gen = torch.Generator()
    losses, viol = [], []
    for i, b in enumerate(batches):
        gen.manual_seed(3 + i)
        (loss, aux), g = vg(p, {"data": torch.as_tensor(b["data"])}, gen)
        p, st = solver_update(s, p, g, st)
        losses.append(float(loss))
        viol.append(float(aux["violations"]))
    return losses, viol, params_to_numpy(p)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rs = np.random.RandomState(1701)
    params = _jparams(CFG)
    train = {}
    for data, model, gm, rm in TRAIN_CASES:
        train[(data, model, gm, rm)] = _batches(rs, 3, role_major=rm)
    drop_cfg = dict(CFG, dropout_rate=0.5)
    drop_batches = _batches(rs, 3, b=8)
    layout_batch = {"data": rs.randn(8, 11, 32).astype(np.float32),
                    "rm": rs.randn(11, 8, 32).astype(np.float32)}
    tp_params = _jparams(TP_CFG)
    tp_data = rs.randn(16, 11, 64).astype(np.float32)
    dp_params = _jparams(DP_CFG, seed=3)
    dp_data = rs.randn(16, 11, 48).astype(np.float32)
    run = [("mesh_errors", {}),
           ("layout", dict(params=params, batch=layout_batch, data=2,
                           model=2, axes={"rm": 1}))]
    for (data, model, gm, rm), b in train.items():
        run.append(("embedding_steps", dict(
            params=params, batches=b, data=data, model=model, cfg=CFG,
            scfg=SCFG, gm=gm, role_major=rm)))
    for data, model in ((4, 1), (2, 2)):
        run.append(("embedding_steps", dict(
            params=params, batches=drop_batches, data=data, model=model,
            cfg=drop_cfg, scfg=SCFG)))
    run += [("dp_steps", dict(params=dp_params, data=dp_data, cfg=DP_CFG,
                              scfg=DP_SCFG, wire=w)) for w in ("f32", "bf16")]
    run += [("tp_loss", dict(params=tp_params, data=tp_data, cfg=TP_CFG,
                             data_n=2, model_n=2)),
            ("host_source", {}), ("replicate_check", {}),
            ("eval_step", dict(params=params, data=drop_batches[0]["data"],
                               cfg=CFG, data_n=2, model_n=2))]
    out = cases.run(4, run, tmp_path_factory.mktemp("parallel_steps"),
                    timeout=150)
    res = {"params": params, "train": train, "drop": drop_batches,
           "layout_batch": layout_batch, "tp": (tp_params, tp_data),
           "dp": (dp_params, dp_data), "out": out}
    it = iter(range(len(run)))
    keys = (["mesh", "layout"] + [("train",) + k for k in train]
            + [("drop", 4, 1), ("drop", 2, 2), ("dp", "f32"), ("dp", "bf16"),
               "tp", "source", "replicate", "eval"])
    res["at"] = {k: next(it) for k in keys}
    return res


def _per_rank(ranks, key):
    i = ranks["at"][key]
    return [r[i] for r in ranks["out"]]


def test_make_mesh_errors_and_rank_order(ranks):
    jerr = []
    for kw in (dict(model=3), dict(data=4, model=4), dict(data=3, model=2)):
        with pytest.raises(ValueError) as e:
            jmake_mesh(devices=jax.devices()[:4], **kw)
        jerr.append(str(e.value))
    for r, (errs, d, m, di, mi) in enumerate(_per_rank(ranks, "mesh")):
        assert errs == jerr
        assert (d, m, di, mi) == (2, 2, r // 2, r % 2)


def test_shard_params_and_batch_match_jax_shards(ranks):
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    jp = jshard_params(jax.tree.map(jnp.asarray, ranks["params"]), mesh,
                       model_axis=True)
    lb = ranks["layout_batch"]
    jb = jshard_batch({k: jnp.asarray(v) for k, v in lb.items()}, mesh,
                      {"rm": 1})
    grid = mesh.devices
    for r, (p, b, full) in enumerate(_per_rank(ranks, "layout")):
        dev = grid[r // 2, r % 2]

        def shard_on(arr):
            (s,) = [s for s in arr.addressable_shards if s.device == dev]
            return np.asarray(s.data)
        for k in ("w", "b"):
            np.testing.assert_array_equal(p["tower"][k],
                                          shard_on(jp["tower"][k]))
            np.testing.assert_array_equal(full["tower"][k],
                                          ranks["params"]["tower"][k])
        for k in lb:
            np.testing.assert_array_equal(b[k], shard_on(jb[k]))


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}_gm{c[2]}"
                         + ("_rm" if c[3] else ""))
def test_make_train_step_matches_jax(ranks, case):
    data, model, gm, rm = case
    jl, jp = _jax_train(ranks["params"], ranks["train"][case], data, model,
                        gm, rm)
    for losses, _, full, _, _ in _per_rank(ranks, ("train",) + case):
        np.testing.assert_allclose(losses, jl, rtol=2e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(full["tower"][k], jp["tower"][k],
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_dropout_masks_are_the_one_device_masks(ranks, mesh):
    """Dropout 0.5: each rank draws the whole batch's mask and keeps its
    rows, so the sharded trajectory is the port's one-device trajectory
    (losses, violation counts, params)."""
    rl, rv, rp = _dropout_reference(ranks["params"], ranks["drop"],
                                    dict(CFG, dropout_rate=0.5))
    for losses, aux, full, _, _ in _per_rank(ranks, ("drop",) + mesh):
        np.testing.assert_allclose(losses, rl, rtol=2e-5)
        assert [a["violations"] for a in aux] == rv
        np.testing.assert_allclose(full["tower"]["w"], rp["tower"]["w"],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_make_dp_train_step_matches_jax(ranks, wire):
    params, data = ranks["dp"]
    jm = JModel(JCfg(**DP_CFG))
    scfg = JSolverConfig(**DP_SCFG)
    mesh = jmake_mesh(data=4, model=1, devices=jax.devices()[:4])
    step = jmake_dp_train_step(
        lambda p, b, r: jm.loss(p, b, rng=r, train=False), scfg, mesh,
        psum_dtype=jnp.bfloat16 if wire == "bf16" else None)
    p, s, _ = jplace_dp(jax.tree.map(jnp.array, params),
                        jinit_state(scfg, params), {}, mesh)
    jl = []
    for _ in range(4):
        p, s, m = step(p, s, {"data": jnp.asarray(data)},
                       jax.random.PRNGKey(5))
        jl.append(float(m["loss"]))
    jw = np.asarray(p["tower"]["w"])
    for losses, tp in _per_rank(ranks, ("dp", wire)):
        np.testing.assert_allclose(losses, jl, rtol=2e-5 if wire == "f32"
                                   else 2e-2)
        if wire == "f32":
            np.testing.assert_allclose(tp["tower"]["w"], jw, rtol=1e-4,
                                       atol=1e-6)
        else:
            # JAX's bound for the bf16 wire against its own f32 wire
            assert np.abs(tp["tower"]["w"] - jw).max() \
                < 1e-2 * max(np.abs(jw).max(), 1e-6)


def test_make_tp_loss_fn_values_and_grads_match_jax(ranks):
    params, data = ranks["tp"]
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    fn = jmake_tp_loss_fn(JCfg(**TP_CFG), mesh)
    jp = jplace_tp_params(jax.tree.map(jnp.asarray, params), mesh)
    jb = jshard_batch({"data": jnp.asarray(data)}, mesh)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: fn(p, jb, None), has_aux=True)(jp)
    gw, gb = np.asarray(jg["tower"]["w"]), np.asarray(jg["tower"]["b"])
    for loss, viol, w, b in _per_rank(ranks, "tp"):
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        assert viol == float(jaux["violations"])
        np.testing.assert_allclose(b, gb, rtol=0, atol=1e-4 * np.abs(gb).max())
        # the tower's weight gradient is the cotangent of its bf16 cast in
        # both packages; JAX sums the ranks' bf16 gradients over "data" in
        # bf16 (its psum runs on that cotangent), the port in f32: one bf16
        # rounding of the sum apart, and of the addends where they cancel
        np.testing.assert_allclose(w, gw, rtol=2.0 ** -8,
                                   atol=2.0 ** -9 * np.abs(gw).max())


def test_host_sharded_source_honours_batch_axes(ranks):
    for r, (axes, b, err, rng, shard) in enumerate(
            _per_rank(ranks, "source")):
        assert axes == {"obs": 1, "ids": 0}
        # the rank holds ONE batch row across all T, not a time slice
        assert b["obs"].shape == (3, 2, 2)
        np.testing.assert_array_equal(b["obs"][:, :, 0],
                                      np.tile([2 * r, 2 * r + 1], (3, 1)))
        np.testing.assert_array_equal(b["ids"], [2 * r, 2 * r + 1])
        assert "not divisible" in err and "7" in err
        assert rng == (2 * r, 2 * r + 2)
        np.testing.assert_array_equal(shard, [2 * r, 2 * r + 1])


def test_replicate_global_checks_the_ranks_agree(ranks):
    for ok, raised in _per_rank(ranks, "replicate"):
        np.testing.assert_array_equal(ok["a"]["w"], np.ones((2, 3)))
        assert raised


def test_make_eval_step_outputs_are_replicated(ranks):
    m = VideoEmbeddingModel(VideoEmbeddingConfig(**CFG))
    p = {"tower": {k: torch.tensor(np.array(v)) for k, v in
                   ranks["params"]["tower"].items()}}
    with torch.no_grad():
        loss, aux = m.loss(p, {"data": torch.as_tensor(
            ranks["drop"][0]["data"])}, train=False)
    for out in _per_rank(ranks, "eval"):
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
        assert out["violations"] == float(aux["violations"])
