"""The port's training slice (videovector_tpu_torch: ops.activations.dropout,
ops.linear.inner_product, ops.losses, models.embedding's scores and loss,
solver.{solvers,checkpoint,train}, utils.logging) against the JAX package on
the CPU.

Small sizes: D = E = 64, B = 4, 1 target + 2 context + 3 negatives. Inputs
are made with numpy from a seed; params and solver state are carried across
with `convert`. f32 unless stated. Tolerances: values within 1e-6 and
gradients within 1e-5 relative for the ops and the model; trajectories
within 1e-5 relative in f32 and one bf16 step (2**-8) of max|w| in bf16,
since both packages sum in their own order.
"""

import functools
import inspect
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu import ops as jops
from videovector_tpu.models import embedding as jemb
from videovector_tpu.solver import checkpoint as jckpt
from videovector_tpu.solver import solvers as jsol
from videovector_tpu.solver import train as jtrain
from videovector_tpu.utils.logging import GlogFormatter as JaxGlog
from videovector_tpu_torch import convert
from videovector_tpu_torch.models import embedding as temb
from videovector_tpu_torch.ops import activations as tact
from videovector_tpu_torch.ops import linear as tlin
from videovector_tpu_torch.ops import losses as tloss
from videovector_tpu_torch.solver import checkpoint as tckpt
from videovector_tpu_torch.solver import solvers as tsol
from videovector_tpu_torch.solver import train as ttrain
from videovector_tpu_torch.utils.logging import GlogFormatter as TorchGlog

torch.set_num_threads(1)

SMALL = dict(feature_dim=64, embed_dim=64, num_context=2, num_negatives=3,
             weight_std=0.1)
R, B, D = 6, 4, 64
# bench.py's solver
BENCH_SOLVER = dict(base_lr=0.05, momentum=0.9, weight_decay=5e-4,
                    lr_policy="inv", gamma=0.001, power=0.75)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _models(**kw):
    cfg = dict(SMALL, **kw)
    return (jemb.VideoEmbeddingModel(jemb.VideoEmbeddingConfig(**cfg)),
            temb.VideoEmbeddingModel(temb.VideoEmbeddingConfig(**cfg)))


def _params(jm, seed=0):
    jp = jm.init(jax.random.PRNGKey(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _tree_close(tport, tjax, rtol, atol=0.0):
    for path, leaf in convert.leaves_with_paths(tport):
        ref = tjax
        for k in path:
            ref = ref[k]
        _close(leaf.detach().numpy(), ref, rtol, atol)


# -- ops ------------------------------------------------------------------

def test_dropout_identity_at_rate_0_and_rate_1_raises():
    x = torch.randn(3, 5)
    assert tact.dropout(x, rate=0.0, generator=None) is x
    assert tact.dropout(x, rate=0.5, generator=None, deterministic=True) is x
    with pytest.raises(ValueError, match="< 1"):
        tact.dropout(x, rate=1.0, generator=torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        tact.dropout(x, rate=0.5, generator=None)


@pytest.mark.parametrize("rate", [0.9, 0.5])
def test_dropout_with_jax_mask_equals_jax_bit_for_bit(monkeypatch, rate):
    """JAX's jax.random.bernoulli mask, injected through dropout_mask: value
    and gradient equal to JAX's dropout bit for bit."""
    x = np.random.RandomState(0).randn(32, 48).astype(np.float32)
    key = jax.random.PRNGKey(3)
    mask = np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    monkeypatch.setattr(tact, "dropout_mask",
                        lambda shape, keep, gen, dev: torch.as_tensor(mask))
    g = np.random.RandomState(1).randn(32, 48).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jops.dropout(v, rate=rate, rng=key),
                       jnp.asarray(x))
    xt = _t(x, grad=True)
    got = tact.dropout(xt, rate=rate, generator=torch.Generator())
    got.backward(_t(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_dropout_own_generator_keeps_a_tenth_scaled_by_1_over_keep():
    x = torch.rand(1000, 1000) + 0.5           # no zeros among the inputs
    y = tact.dropout(x, rate=0.9, generator=torch.Generator().manual_seed(7))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.1) <= 0.01
    np.testing.assert_array_equal(
        y[kept].numpy(), x[kept].numpy() / np.float32(1.0 - 0.9))
    # the same seed gives the same mask, another seed another one
    again = tact.dropout(x, rate=0.9, generator=torch.Generator().manual_seed(7))
    other = tact.dropout(x, rate=0.9, generator=torch.Generator().manual_seed(8))
    assert torch.equal(again, y) and not torch.equal(other, y)


def test_l2_normalize_rows_gradient_at_zero_rows_matches_jax():
    from videovector_tpu_torch.ops.normalization import l2_normalize_rows
    rs = np.random.RandomState(2)
    x = rs.randn(6, 5).astype(np.float32)
    x[[1, 4]] = 0.0
    g = rs.randn(6, 5).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jops.l2_normalize_rows(v) * g))(
        jnp.asarray(x))
    xt = _t(x, grad=True)
    (l2_normalize_rows(xt) * _t(g)).sum().backward()
    got = xt.grad.numpy()
    assert np.isfinite(got).all() and (got[[1, 4]] == 0).all()
    _close(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("r", [0.5, -0.5, 0.0])
def test_inner_product_regularization_matches_jax_custom_vjp(r):
    """r > 0 scales dW by (1 + r/2); a negative r is inert, as in JAX."""
    rs = np.random.RandomState(3)
    x, w, b = (rs.randn(5, 2, 4).astype(np.float32),
               rs.randn(8, 6).astype(np.float32), rs.randn(6).astype(np.float32))
    g = rs.randn(5, 6).astype(np.float32)

    def jf(x_, w_, b_):
        return jnp.sum(jops.inner_product(x_, w_, b_, regularization=r) * g)
    jv = jf(*map(jnp.asarray, (x, w, b)))
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    tv = (tlin.inner_product(xt, wt, bt, regularization=r) * _t(g)).sum()
    tv.backward()
    _close(tv.item(), jv, rtol=1e-6)
    for got, ref in zip((xt.grad, wt.grad, bt.grad), jg):
        _close(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["L1", "L2"])
@pytest.mark.parametrize("weighted", [False, True])
def test_max_margin_loss_matches_jax(rng, norm, weighted):
    """On tests/test_losses.py's inputs: loss, violation count and both
    gradients, rtol 1e-6."""
    t = rng.randn(6, 10).astype(np.float32)
    b = rng.randn(6, 10).astype(np.float32)
    w = (rng.rand(6, 10).astype(np.float32) + 0.1) if weighted else None

    def jf(t_, b_):
        return jops.max_margin_loss(t_, b_, margin=2.0, norm=norm,
                                    weights=None if w is None else jnp.asarray(w))
    (jl, jv), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(t), jnp.asarray(b))
    tt, bt = _t(t, True), _t(b, True)
    tl, tv = tloss.max_margin_loss(tt, bt, margin=2.0, norm=norm,
                                   weights=None if w is None else _t(w))
    tl.backward()
    _close(tl.item(), jl, rtol=1e-6)
    assert tv.dtype == torch.float32 and tv.item() == float(jv)
    _close(tt.grad.numpy(), jg[0], rtol=1e-6, atol=1e-9)
    _close(bt.grad.numpy(), jg[1], rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="norm"):
        tloss.max_margin_loss(tt, bt, norm="L3")


# -- the model ------------------------------------------------------------

def _jax_value_and_grads(jm, jp, data, **kw):
    def f(p):
        return jm.loss(p, {"data": jnp.asarray(data)}, **kw)
    (loss, aux), g = jax.value_and_grad(f, has_aux=True)(jp)
    return float(loss), jax.tree.map(np.asarray, aux), jax.tree.map(np.asarray, g)


def _port_value_and_grads(tm, tp, data, **kw):
    p = convert.map_params(lambda t: t.clone().requires_grad_(), tp)
    loss, aux = tm.loss(p, {"data": torch.as_tensor(data)}, **kw)
    loss.backward()
    return (loss.item(), {k: v.detach().numpy() for k, v in aux.items()},
            convert.map_params(lambda t: t.grad, p))


@pytest.mark.parametrize("role_major", [True, False])
@pytest.mark.parametrize("weights", ["none", "b", "b1"])
def test_scores_and_loss_match_jax(role_major, weights):
    jm, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    jp, tp = _params(jm)
    rs = np.random.RandomState(4)
    shape = (R, B, D) if role_major else (B, R, D)
    data = rs.randn(*shape).astype(np.float32)
    w = {"none": None, "b": rs.rand(B).astype(np.float32) + 0.5,
         "b1": rs.rand(B, 1).astype(np.float32) + 0.5}[weights]
    jl, jaux, jg = _jax_value_and_grads(
        jm, jp, data, train=True, role_major=role_major,
        weights=None if w is None else jnp.asarray(w))
    tl, taux, tg = _port_value_and_grads(
        tm, tp, data, train=True, role_major=role_major,
        weights=None if w is None else torch.as_tensor(w))
    _close(tl, jl, rtol=1e-6)
    for k in ("violations", "mean_true_score", "mean_neg_score"):
        _close(taux[k], jaux[k], rtol=1e-6, atol=1e-7)
    _tree_close(tg, jg, rtol=1e-5, atol=1e-5 * np.abs(jg["tower"]["w"]).max())
    js = jm.scores(jp, jnp.asarray(data), role_major=role_major)
    ts = tm.scores(tp, torch.as_tensor(data), role_major=role_major)
    for a, b in zip(ts[:2], js[:2]):
        _close(a.numpy(), b, rtol=1e-6, atol=1e-7)
    for k in ("target", "context"):
        _close(ts[2][k].numpy(), js[2][k], rtol=1e-5, atol=1e-7)


def test_loss_rejects_bad_weights_and_roles():
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(0))
    data = torch.randn(R, B, D)
    with pytest.raises(ValueError, match="weights carry 3 entries"):
        tm.loss(tp, {"data": data}, role_major=True, weights=torch.ones(3))
    with pytest.raises(ValueError, match="weights carry 5 entries"):
        tm.loss(tp, {"data": data, "weights": torch.ones(5, 1)},
                role_major=True)
    with pytest.raises(ValueError, match="7 roles"):
        tm.loss(tp, {"data": torch.randn(7, B, D)}, role_major=True)
    with pytest.raises(ValueError, match="5 roles"):
        tm.scores(tp, torch.randn(B, 5, D))
    _, tm_drop = _models(dropout_rate=0.9, compute_dtype="float32")
    with pytest.raises(ValueError, match="generator"):
        tm_drop.loss(tp, {"data": data}, role_major=True, train=True)


def test_zero_embedding_rows_give_zero_gradient():
    """All-zero params make every embedding row zero; the gradient through
    them is exactly 0, finite (tests/test_embedding_model.py's case)."""
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = convert.map_params(torch.zeros_like,
                            tm.init(torch.Generator().manual_seed(0)))
    data = np.random.RandomState(5).randn(B, R, D).astype(np.float32)
    _, _, g = _port_value_and_grads(tm, tp, data, train=False)
    for _, leaf in convert.leaves_with_paths(g):
        assert torch.isfinite(leaf).all() and leaf.abs().sum().item() == 0.0


def test_remat_tower_gives_the_same_grads_with_dropout():
    """remat_tower recomputes the tower in backward with the same dropout
    mask (drawn outside the recomputed region): grads equal to the
    non-remat run from the same generator seed."""
    data = torch.as_tensor(np.random.RandomState(6).randn(R, B, D)
                           .astype(np.float32))
    grads = []
    for remat in (False, True):
        _, tm = _models(dropout_rate=0.9, remat_tower=remat)
        tp = tm.init(torch.Generator().manual_seed(0))
        p = convert.map_params(lambda t: t.requires_grad_(), tp)
        loss, _ = tm.loss(p, {"data": data}, role_major=True, train=True,
                          generator=torch.Generator().manual_seed(11))
        loss.backward()
        grads.append((loss.item(), p["tower"]["w"].grad, p["tower"]["b"].grad))
    assert grads[0][0] == grads[1][0]
    assert grads[0][1].abs().sum() > 0
    assert torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(grads[0][2], grads[1][2])


# -- the solver -----------------------------------------------------------

@pytest.mark.parametrize("policy", [
    dict(lr_policy="fixed", base_lr=0.01),
    dict(lr_policy="step", base_lr=0.01, gamma=0.1, stepsize=300),
    dict(lr_policy="exp", base_lr=0.01, gamma=0.99993),
    dict(lr_policy="inv", base_lr=0.001, gamma=0.001, power=0.75),
])
def test_learning_rate_equals_jax_f32(policy):
    jc, tc = jsol.SolverConfig(**policy), tsol.SolverConfig(**policy)
    for it in (0, 1, 1000, 10**5):
        ref = np.asarray(jsol.learning_rate(jc, it))
        got = tsol.learning_rate(tc, it)
        assert got.dtype == np.float32 and ref.dtype == np.float32
        assert got == ref, (policy, it, got, ref)


@pytest.mark.parametrize("solver_type", ["SGD", "NESTEROV", "ADAGRAD"])
@pytest.mark.parametrize("reg", ["L2", "L1"])
def test_solver_update_matches_jax(solver_type, reg):
    """Three updates with lr and decay multipliers, within 1e-7."""
    kw = dict(solver_type=solver_type, regularization_type=reg, base_lr=0.1,
              weight_decay=0.01, lr_policy="inv", gamma=0.01, power=0.75,
              momentum=0.0 if solver_type == "ADAGRAD" else 0.9)
    jc, tc = jsol.SolverConfig(**kw), tsol.SolverConfig(**kw)
    rs = np.random.RandomState(7)
    p0 = {"a": {"w": rs.randn(5, 3).astype(np.float32),
                "b": rs.randn(3).astype(np.float32)}}
    lr_m = {"a": {"w": 1.0, "b": 2.0}}
    dm = {"a": {"w": 1.0, "b": 0.0}}
    jp, js = jax.tree.map(jnp.asarray, p0), None
    js = jsol.init_solver_state(jc, jp)
    tp = convert.params_from_jax(p0)
    ts = tsol.init_solver_state(tc, tp)
    for _ in range(3):
        g = {"a": {"w": rs.randn(5, 3).astype(np.float32),
                   "b": rs.randn(3).astype(np.float32)}}
        jp, js = jsol.solver_update(jc, jp, jax.tree.map(jnp.asarray, g), js,
                                    lr_mults=lr_m, decay_mults=dm)
        tp, ts = tsol.solver_update(tc, tp, convert.params_from_jax(g), ts,
                                    lr_mults=lr_m, decay_mults=dm)
    assert ts["iter"] == int(js["iter"]) == 3
    _tree_close(tp, jax.tree.map(np.asarray, jp), rtol=1e-7, atol=1e-7)
    _tree_close(ts["history"], jax.tree.map(np.asarray, js["history"]),
                rtol=1e-7, atol=1e-7)


def test_solver_config_checks():
    with pytest.raises(ValueError, match="AdaGrad"):
        tsol.SolverConfig(solver_type="ADAGRAD", momentum=0.9)
    with pytest.raises(ValueError, match="dropout_prng"):
        tsol.SolverConfig(dropout_prng="rc4")
    assert tsol.SolverConfig(dropout_prng="rbg").dropout_prng == "rbg"
    assert tsol.learning_rate(tsol.SolverConfig(lr_policy="fixed"), 3) == \
        np.float32(0.01)
    with pytest.raises(ValueError, match="policy"):
        tsol.learning_rate(tsol.SolverConfig(lr_policy="poly"), 3)


# -- the train loop -------------------------------------------------------

def _batches(n, *, b=B, seed=8):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randn(R, b, D).astype(np.float32)} for _ in range(n)]


def _jax_loss(jm):
    return lambda p, batch, key: jm.loss(p, batch, rng=key, train=True,
                                         role_major=True)


def _port_loss(tm):
    return lambda p, batch, gen: tm.loss(p, batch, generator=gen, train=True,
                                         role_major=True)


def _train_both(n_steps, *, model_kw=None, solver_kw=None, jax_kw=None,
                port_kw=None, batches=None):
    jm, tm = _models(**(model_kw or {}))
    jp, tp = _params(jm)
    skw = {**BENCH_SOLVER, "max_iter": n_steps, "display": 1,
           **(solver_kw or {})}
    batches = batches or _batches(n_steps + 1)
    rj = jtrain.train(_jax_loss(jm), jp,
                      iter([jax.tree.map(jnp.asarray, b) for b in batches]),
                      jsol.SolverConfig(**skw), **(jax_kw or {}))
    rt = ttrain.train(_port_loss(tm), tp, iter(batches),
                      tsol.SolverConfig(**skw), device="cpu",
                      **(port_kw or {}))
    return rj, rt


def _losses(result):
    return [m["loss"] for _, m in result.metrics_history]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ten_step_trajectory_matches_jax(dtype):
    """10 steps of bench.py's solver from JAX's params, dropout off."""
    rj, rt = _train_both(10, model_kw=dict(dropout_rate=0.0,
                                           compute_dtype=dtype))
    jw = np.asarray(rj.params["tower"]["w"])
    if dtype == "float32":
        rtol, atol = 1e-5, 1e-5 * np.abs(jw).max()
    else:
        rtol, atol = 2.0**-8, 2.0**-8 * np.abs(jw).max()
    assert len(_losses(rt)) == 10
    _close(_losses(rt), _losses(rj), rtol=rtol)
    _tree_close(rt.params, jax.tree.map(np.asarray, rj.params), rtol, atol)
    _tree_close(rt.state["history"],
                jax.tree.map(np.asarray, rj.state["history"]), rtol,
                atol * 0.1)
    assert rt.state["iter"] == int(rj.state["iter"]) == 10
    # the trajectory moved: the weights are not where they started
    assert np.abs(jw - np.asarray(_params(_models()[0])[0]["tower"]["w"])).max() \
        > 10 * atol


def test_dropout_trajectory_with_jax_masks_matches_jax(monkeypatch):
    """3 steps at dropout 0.9 with JAX's per-iteration masks (bernoulli of
    fold_in(PRNGKey(seed), it)) injected into the port."""
    n, seed = 3, 5
    keep = np.float32(1.0) - np.float32(0.9)
    masks = [torch.as_tensor(np.array(jax.random.bernoulli(
        jax.random.fold_in(jax.random.PRNGKey(seed), it), 1.0 - 0.9,
        (R * B, D)))) for it in range(n + 1)]
    assert keep > 0
    drawn = iter(masks)

    def jax_mask(shape, keep_, gen, dev):
        assert tuple(shape) == (R * B, D)
        return next(drawn)
    monkeypatch.setattr(tact, "dropout_mask", jax_mask)
    rj, rt = _train_both(n, model_kw=dict(dropout_rate=0.9,
                                          compute_dtype="float32"),
                         solver_kw=dict(random_seed=seed))
    jw = np.asarray(rj.params["tower"]["w"])
    _close(_losses(rt), _losses(rj), rtol=1e-5)
    _tree_close(rt.params, jax.tree.map(np.asarray, rj.params), 1e-5,
                1e-5 * np.abs(jw).max())
    assert next(drawn, None) is None      # one mask per step + the extra fwd


def test_grad_microbatch_2_on_role_major_data_equals_the_big_batch():
    batches = _batches(5, b=8)
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(1))
    runs = []
    for gm in (1, 2):
        cfg = tsol.SolverConfig(**BENCH_SOLVER, max_iter=4, display=1,
                                grad_microbatch=gm)
        runs.append(ttrain.train(_port_loss(tm), tp, iter(batches), cfg,
                                 device="cpu", batch_axes={"data": 1}))
    _close(_losses(runs[1]), _losses(runs[0]), rtol=1e-5)
    _tree_close(runs[1].params, convert.params_to_numpy(runs[0].params),
                1e-5, 1e-6)


def test_fused_iter_size_equals_the_host_loop():
    """One batch over and over (as tests/test_fused_accum.py does), so that
    the host loop's displayed loss, its last sub-batch's, is the mean too."""
    batches = _batches(1) * 9
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(2))
    cfg = tsol.SolverConfig(**BENCH_SOLVER, max_iter=4, display=1,
                            iter_size=2)
    host, fused = (ttrain.train(_port_loss(tm), tp, iter(batches), cfg,
                                device="cpu", fused_accum=f)
                   for f in (False, True))
    _close(_losses(fused), _losses(host), rtol=1e-5)
    _tree_close(fused.params, convert.params_to_numpy(host.params), 1e-5, 1e-6)


def test_fused_step_matches_jax_build_fused_step():
    """One fused step, iter_size 2 x gm 2 on role-major data, against JAX's
    build_fused_step: the averaged update and the displayed loss."""
    jm, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    jp, tp = _params(jm)
    cfg = dict(BENCH_SOLVER, max_iter=1)
    bs = _batches(2, b=4)
    jf = jtrain.build_fused_step(
        jax.value_and_grad(_jax_loss(jm), has_aux=True),
        jsol.SolverConfig(**cfg), 2, 2, batch_axes={"data": 1}, jit=False)
    tf = ttrain.build_fused_step(
        ttrain.value_and_grad(_port_loss(tm)), tsol.SolverConfig(**cfg), 2, 2,
        batch_axes={"data": 1})
    jp2, _, jm2 = jf(jp, jsol.init_solver_state(jsol.SolverConfig(**cfg), jp),
                     tuple(jax.tree.map(jnp.asarray, b) for b in bs),
                     jax.random.PRNGKey(0))
    tp2, ts2, tm2 = tf(tp, tsol.init_solver_state(tsol.SolverConfig(**cfg), tp),
                       tuple(convert.params_from_jax(b) for b in bs), None)
    _close(tm2["loss"].item(), jm2["loss"], rtol=1e-6)
    _close(tm2["violations"].item(), jm2["violations"], rtol=0)
    _tree_close(tp2, jax.tree.map(np.asarray, jp2), 1e-5, 1e-7)
    assert ts2["iter"] == 1
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.build_fused_step(ttrain.value_and_grad(_port_loss(tm)),
                                tsol.SolverConfig(**cfg), 1, 3,
                                batch_axes={"data": 1})(
            tp, ts2, (convert.params_from_jax(bs[0]),), None)


def test_grad_microbatch_without_batch_axes_raises():
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(3))
    cfg = tsol.SolverConfig(**BENCH_SOLVER, max_iter=2, grad_microbatch=2)
    with pytest.raises(ValueError, match="batch_axes"):
        ttrain.train(_port_loss(tm), tp, iter(_batches(3)), cfg, device="cpu")
    ok = tsol.SolverConfig(**BENCH_SOLVER, max_iter=2, iter_size=2)
    ttrain.train(_port_loss(tm), tp, iter(_batches(5)), ok, device="cpu")


def test_auto_grad_microbatch_equals_jax():
    def mk(b):
        return {"data": np.zeros((b, 4), np.float32),
                "ids": np.zeros((b,), np.float32)}
    cases = [(mk(b), {}) for b in (128, 255, 256, 300, 512, 1024, 4096, 8192)]
    cases += [(mk(512), None),
              ({"data": np.zeros((15, 512, 8), np.float32)}, {"data": 1}),
              ({"data": np.zeros((15, 8192, 8), np.float32)}, {"data": 1}),
              ({"data": np.zeros((512, 4), np.float32),
                "gallery": np.zeros((258, 4), np.float32)}, {})]
    got = [ttrain.auto_grad_microbatch(b, a) for b, a in cases]
    assert got == [jtrain.auto_grad_microbatch(b, a) for b, a in cases]
    assert got[-3:-1] == [4, 64]


def test_resume_from_a_jax_vvstate_continues_jax_trajectory(tmp_path):
    """JAX trains 3 steps and snapshots; JAX and the port each resume from
    that .vvstate for 3 more steps on the same batches."""
    jm, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    jp, tp = _params(jm)
    batches = _batches(7)
    first = dict(BENCH_SOLVER, max_iter=3, snapshot_prefix=str(tmp_path / "j"))
    jtrain.train(_jax_loss(jm), jp, iter([jax.tree.map(jnp.asarray, b)
                                          for b in batches[:3]]),
                 jsol.SolverConfig(**first))
    state = str(tmp_path / "j_iter_3.vvstate")
    more = dict(BENCH_SOLVER, max_iter=6, display=1)
    rj = jtrain.train(_jax_loss(jm), jp,
                      iter([jax.tree.map(jnp.asarray, b) for b in batches[3:]]),
                      jsol.SolverConfig(**more), resume_state_path=state)
    rt = ttrain.train(_port_loss(tm), tp, iter(batches[3:]),
                      tsol.SolverConfig(**more), device="cpu",
                      resume_state_path=state)
    assert [i for i, _ in rt.metrics_history] == [3, 4, 5]
    assert rt.state["iter"] == 6
    _close(_losses(rt), _losses(rj), rtol=1e-5)
    jw = np.asarray(rj.params["tower"]["w"])
    _tree_close(rt.params, jax.tree.map(np.asarray, rj.params), 1e-5,
                1e-5 * np.abs(jw).max())
    with pytest.raises(NotImplementedError, match="solverstate"):
        ttrain.train(_port_loss(tm), tp, iter(batches), tsol.SolverConfig(
            max_iter=1), device="cpu", resume_state_path="x.solverstate")


def test_port_snapshot_loads_in_jax_restore(tmp_path):
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(4))
    tp["odd/name%"] = {"w": torch.ones(2)}    # escaped key parts
    cfg = tsol.SolverConfig(**BENCH_SOLVER, max_iter=3, snapshot=2,
                            snapshot_diff=True,
                            snapshot_prefix=str(tmp_path / "p"))
    rt = ttrain.train(_port_loss(tm), tp, iter(_batches(4)), cfg, device="cpu")
    jp, js = jckpt.restore(str(tmp_path / "p_iter_3.vvstate"))
    assert int(js["iter"]) == 3
    _tree_close(rt.params, jax.tree.map(np.asarray, jp), 0)
    _tree_close(rt.state["history"], jax.tree.map(np.asarray, js["history"]), 0)
    diffs = jckpt.load_diffs(str(tmp_path / "p_iter_3.vvmodel"))
    assert diffs["tower"]["w"].shape == (D, D)
    assert np.abs(np.asarray(diffs["tower"]["w"])).max() > 0
    # the mid-run snapshot, and the port's own loaders
    p2, s2 = tckpt.restore(str(tmp_path / "p_iter_2.vvstate"))
    assert s2["iter"] == 2 and p2["odd/name%"]["w"].shape == (2,)
    assert tckpt.load_diffs(str(tmp_path / "p_iter_2.vvmodel")) is not None
    assert "diff" not in tckpt.load_model(str(tmp_path / "p_iter_2.vvmodel"))


def test_convert_solver_state_both_ways():
    jc = jsol.SolverConfig(momentum=0.9)
    jp = {"tower": {"w": jnp.ones((3, 2)), "b": jnp.zeros(2)}}
    js = jsol.init_solver_state(jc, jp)
    js = {"iter": jnp.int32(7),
          "history": jax.tree.map(lambda a: a + 0.5, js["history"])}
    ts = convert.state_from_jax(jax.device_get(js))
    assert ts["iter"] == 7 and ts["history"]["tower"]["w"].dtype == torch.float32
    back = convert.state_to_numpy(ts)
    assert back["iter"].dtype == np.int32 and int(back["iter"]) == 7
    np.testing.assert_array_equal(back["history"]["tower"]["w"],
                                  np.full((3, 2), 0.5, np.float32))


class _Lines(logging.Handler):
    """Collects a logger's lines, glog prefix stripped."""
    PREFIX = re.compile(r"^[DIWEF]\d{4} \d\d:\d\d:\d\d\.\d{6} +\d+ \S+:\d+\] ")

    def __init__(self, formatter):
        super().__init__()
        self.setFormatter(formatter)
        self.lines = []

    def emit(self, record):
        line = self.format(record)
        assert self.PREFIX.match(line), line
        self.lines.append(self.PREFIX.sub("", line))


def _split_numbers(line):
    parts = re.split(r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?)", line)
    return parts[0::2], [float(p) for p in parts[1::2]]


def test_display_and_test_log_lines_equal_jax():
    """The display, lr and test lines, with their glog prefixes stripped,
    are JAX's text; their numbers agree within the trajectory's tolerance
    (printed with %g, six digits)."""
    jm, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    jlog = logging.getLogger("videovector_tpu.solver.train")
    tlog = logging.getLogger("videovector_tpu_torch.solver.train")
    jh, th = _Lines(JaxGlog()), _Lines(TorchGlog())
    jlog.addHandler(jh)
    tlog.addHandler(th)
    test_batches = _batches(8, seed=9)

    def jeval(p, b):
        loss, aux = jm.loss(p, b, train=False, role_major=True)
        return {"loss": loss, **aux}

    def teval(p, b):
        loss, aux = tm.loss(p, b, train=False, role_major=True)
        return {"loss": loss, **aux}
    try:
        _train_both(4, model_kw=dict(dropout_rate=0.0, compute_dtype="float32"),
                    solver_kw=dict(display=2, test_interval=2, test_iter=(2,)),
                    jax_kw=dict(eval_fn=jeval, test_data=iter(
                        [jax.tree.map(jnp.asarray, b) for b in test_batches])),
                    port_kw=dict(eval_fn=teval, test_data=iter(test_batches)))
    finally:
        jlog.removeHandler(jh)
        tlog.removeHandler(th)
    assert th.lines[0] == "Solving"
    assert any(l.startswith("    Train net output #1: mean_neg_score = ")
               for l in th.lines)
    assert any(l.startswith("    Test net output #") for l in th.lines)
    assert any(l.startswith("Test loss: ") for l in th.lines)
    assert len(th.lines) == len(jh.lines) > 10
    for tl, jl in zip(th.lines, jh.lines):
        ttext, tnum = _split_numbers(tl)
        jtext, jnum = _split_numbers(jl)
        assert ttext == jtext, (tl, jl)
        _close(tnum, jnum, rtol=2e-5, atol=1e-6)


def _test_windows(n, *, b=40, frames=4, videos=10, seed=12):
    """Test batches of the flagship's TEST branch at width D: (b, frames, D)
    raw context frames near their video's center, and (b,) video ids."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(videos, D).astype(np.float32)
    out = []
    for _ in range(n):
        vids = rs.randint(0, videos, size=b).astype(np.int32)
        data = centers[vids][:, None, :] + 0.8 * rs.randn(b, frames, D)
        out.append({"data": data.astype(np.float32), "video_ids": vids})
    return out


def test_flagship_test_eval_lines_equal_jax():
    """The flagship's test-interval eval (generate_net.py's TEST branch:
    context frames averaged, fc7 tower + ReLU, L2 normalize, then
    RETRIEVAL_STATS with class = video id and exclude_same_video_shots
    false) through both packages' train at test_interval 2: the Test net
    output lines (test_hit1, test_hit5, test_map) are JAX's text, their
    numbers within 2e-5."""
    from videovector_tpu.metrics import retrieval_stats as jstats
    from videovector_tpu_torch.metrics import retrieval_stats as tstats
    jm, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    jlog = logging.getLogger("videovector_tpu.solver.train")
    tlog = logging.getLogger("videovector_tpu_torch.solver.train")
    jh, th = _Lines(JaxGlog()), _Lines(TorchGlog())
    jlog.addHandler(jh)
    tlog.addHandler(th)
    windows = _test_windows(3)

    def named(out):
        return {"test_map": out["mean_ap"], "test_hit1": out["hit_at_1"],
                "test_hit5": out["hit_at_5"]}

    def jeval(p, b):
        return named(jstats(jm.extract(p, b["data"]), b["video_ids"],
                            b["video_ids"], exclude_same_video_shots=False))

    def teval(p, b):
        return named(tstats(tm.extract(p, b["data"]), b["video_ids"],
                            b["video_ids"], exclude_same_video_shots=False))
    try:
        rj, rt = _train_both(
            4, model_kw=dict(dropout_rate=0.0, compute_dtype="float32"),
            solver_kw=dict(display=2, test_interval=2, test_iter=(1,)),
            jax_kw=dict(eval_fn=jeval, test_data=iter(
                [jax.tree.map(jnp.asarray, b) for b in windows])),
            port_kw=dict(eval_fn=teval, test_data=iter(windows)))
    finally:
        jlog.removeHandler(jh)
        tlog.removeHandler(th)
    tests = [l for l in th.lines if l.startswith("    Test net output #")]
    assert [l.split(" = ")[0] for l in tests[:3]] == [
        "    Test net output #0: test_hit1", "    Test net output #1: test_hit5",
        "    Test net output #2: test_map"]
    assert len(tests) == 9 and [i for i, _ in rt.test_history] == [0, 2, 4]
    values = [v for _, m in rt.test_history for v in m.values()]
    assert all(0.0 <= v <= 1.0 for v in values) and max(values) > 0.2
    assert len(th.lines) == len(jh.lines)
    for tl, jl in zip(th.lines, jh.lines):
        ttext, tnum = _split_numbers(tl)
        jtext, jnum = _split_numbers(jl)
        assert ttext == jtext, (tl, jl)
        _close(tnum, jnum, rtol=2e-5, atol=1e-6)


# -- the dropout stream on resume ------------------------------------------

def test_iteration_seed_is_splitmix64_of_seed_and_iteration():
    assert ttrain.iteration_seed(0, 0) == 0xE220A8397B1DCDAF
    seeds = {ttrain.iteration_seed(s, it) for s in (0, 1, 5) for it in range(50)}
    assert len(seeds) == 150 and all(0 <= x < 2 ** 64 for x in seeds)
    assert ttrain.iteration_seed(5, 7) == ttrain.iteration_seed(5 + 2 ** 32, 7)


@pytest.mark.parametrize("gm", [1, 2])
def test_dropout_run_resumed_from_a_snapshot_equals_the_run_through(tmp_path,
                                                                   gm):
    """Dropout 0.9: 6 steps equal 3 steps, a snapshot, a resume from its
    .vvstate and 3 more steps, bit for bit (params, history, displayed
    losses), with grad_microbatch 1 and 2: each iteration draws its masks
    from (seed, iteration), as JAX's fold_in(key, it) does."""
    _, tm = _models(dropout_rate=0.9, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(6))
    batches = _batches(8, b=4)
    kw = dict(BENCH_SOLVER, display=1, random_seed=11, grad_microbatch=gm)
    run = functools.partial(ttrain.train, _port_loss(tm), tp, device="cpu",
                            batch_axes={"data": 1})
    whole = run(iter(batches), tsol.SolverConfig(**kw, max_iter=6))
    run(iter(batches[:3]), tsol.SolverConfig(
        **kw, max_iter=3, snapshot_prefix=str(tmp_path / "p")))
    resumed = run(iter(batches[3:]), tsol.SolverConfig(**kw, max_iter=6),
                  resume_state_path=str(tmp_path / "p_iter_3.vvstate"))
    assert [i for i, _ in resumed.metrics_history] == [3, 4, 5]
    assert _losses(resumed) == _losses(whole)[3:]
    for tree in ("params", "state"):
        a, b = getattr(resumed, tree), getattr(whole, tree)
        a, b = (a, b) if tree == "params" else (a["history"], b["history"])
        for path, leaf in convert.leaves_with_paths(a):
            ref = b
            for k in path:
                ref = ref[k]
            assert torch.equal(leaf, ref), (tree, path)
    # the masks did move the trajectory: dropout off ends elsewhere
    off = ttrain.train(_port_loss(_models(dropout_rate=0.0,
                                          compute_dtype="float32")[1]), tp,
                       iter(batches), tsol.SolverConfig(**kw, max_iter=6),
                       device="cpu", batch_axes={"data": 1})
    assert not torch.equal(off.params["tower"]["w"], whole.params["tower"]["w"])


# -- host-fed training: the port's sampler and stores feeding train --------

HOST = dict(feature_dim=32, embed_dim=16, num_context=4, num_negatives=10,
            weight_std=0.1, dropout_rate=0.0, compute_dtype="float32")


def _host_stores(tmp_path):
    """A training store of 30 videos x 10 shots and a test store of 24
    windows of 4 context shots over 6 videos, at 32 dims, as
    projects/videovec_embedding/make_synthetic_data.py makes them."""
    from videovector_tpu_torch.data import records as trec
    from videovector_tpu_torch.data import shots as tshots
    from videovector_tpu_torch.data import wire as twire
    rs = np.random.RandomState(21)
    videos = []
    for v in range(30):
        center = rs.randn(32).astype(np.float32)
        feats = np.abs(center + 0.4 * rs.randn(10, 32).astype(np.float32))
        videos.append(tshots.ShotVideo(v + 1, np.arange(10, dtype=np.int32),
                                       feats))
    train_path, test_path = str(tmp_path / "train.vvr"), str(tmp_path / "test.vvr")
    tshots.ShotDataset(videos).to_records(train_path)
    with trec.RecordWriter(test_path) as w:
        for i in range(24):
            video = videos[i % 6]
            ids = rs.choice(10, size=4, replace=False)
            w.append(str(i), twire.TestVideoShotWindows(
                video_id=int(video.video_id), context_shot_words=[
                    twire.Datum(float_data=video.features[j])
                    for j in ids]).encode())
    return train_path, test_path


def _host_sources(shots, train_path, test_path):
    cfg = shots.SampledShotsConfig(
        batch_size=8, num_negative_samples=10, max_buffer_size=100,
        negative_swap_percentage=50, max_same_video_negs=6,
        context_type="WINDOW", context_size=5, output_video_ids=False,
        seed=1234)
    train = shots.VideoSampledShotsSource(
        shots.ShotDataset.from_records(train_path), cfg)
    test = shots.VideoShotWindowTestSource(
        shots.TestWindowDataset.from_records(test_path), 12)
    return iter(train), iter(test)


def test_host_fed_training_matches_jax(tmp_path):
    """Each package's sampler, reading the same VVR stores, feeds its own
    train: 10 steps of the flagship's layout (B, 15, D) at D=32, E=16,
    dropout off, with the flagship's test eval every 5 iterations (video
    ids cast to int32, as the RETRIEVAL_STATS layer does). Trajectories
    within 1e-5 relative, test lines within 2e-5."""
    from videovector_tpu.data import shots as jshots
    from videovector_tpu.metrics import retrieval_stats as jstats
    from videovector_tpu_torch.data import shots as tshots
    from videovector_tpu_torch.metrics import retrieval_stats as tstats
    train_path, test_path = _host_stores(tmp_path)
    jm = jemb.VideoEmbeddingModel(jemb.VideoEmbeddingConfig(**HOST))
    tm = temb.VideoEmbeddingModel(temb.VideoEmbeddingConfig(**HOST))
    jp, tp = _params(jm)

    def named(out):
        return {"test_map": out["mean_ap"], "test_hit1": out["hit_at_1"],
                "test_hit5": out["hit_at_5"]}

    def jeval(p, b):
        vids = jnp.asarray(b["video_ids"]).astype(jnp.int32)
        return named(jstats(jm.extract(p, b["data"]), vids, vids,
                            exclude_same_video_shots=False))

    def teval(p, b):
        vids = b["video_ids"].to(torch.int32)
        return named(tstats(tm.extract(p, b["data"]), vids, vids,
                            exclude_same_video_shots=False))
    skw = dict(BENCH_SOLVER, max_iter=10, display=1, test_interval=5,
               test_iter=(1,))
    jlog = logging.getLogger("videovector_tpu.solver.train")
    tlog = logging.getLogger("videovector_tpu_torch.solver.train")
    jh, th = _Lines(JaxGlog()), _Lines(TorchGlog())
    jlog.addHandler(jh)
    tlog.addHandler(th)
    try:
        jdata, jtest = _host_sources(jshots, train_path, test_path)
        rj = jtrain.train(
            lambda p, b, key: jm.loss(p, b, rng=key, train=True), jp, jdata,
            jsol.SolverConfig(**skw), eval_fn=jeval, test_data=jtest)
        tdata, ttest = _host_sources(tshots, train_path, test_path)
        rt = ttrain.train(
            lambda p, b, gen: tm.loss(p, b, generator=gen, train=True), tp,
            tdata, tsol.SolverConfig(**skw), device="cpu",
            batch_axes={"data": 0}, eval_fn=teval, test_data=ttest)
    finally:
        jlog.removeHandler(jh)
        tlog.removeHandler(th)
    assert len(_losses(rt)) == 10 and rt.state["iter"] == 10
    _close(_losses(rt), _losses(rj), rtol=1e-5)
    jw = np.asarray(rj.params["tower"]["w"])
    _tree_close(rt.params, jax.tree.map(np.asarray, rj.params), 1e-5,
                1e-5 * np.abs(jw).max())
    assert [i for i, _ in rt.test_history] == [0, 5, 10]
    values = [v for _, m in rt.test_history for v in m.values()]
    assert all(0.0 <= v <= 1.0 for v in values) and max(values) > 0.2
    tests = [l for l in th.lines if l.startswith("    Test net output #")]
    assert len(tests) == 9 and len(th.lines) == len(jh.lines)
    # a reservoir negative can be the target shot itself: its score then
    # ties the true score, and rounding decides whether it counts as a
    # violation, so that count may differ by the number of such ties
    ties = iter(_target_negative_ties(tshots, train_path, test_path, 10))
    for tl, jl in zip(th.lines, jh.lines):
        ttext, tnum = _split_numbers(tl)
        jtext, jnum = _split_numbers(jl)
        assert ttext == jtext, (tl, jl)
        if "violations = " in tl:
            n_ties = next(ties)
            assert abs(tnum[-1] - jnum[-1]) <= n_ties, (tl, jl, n_ties)
            tnum, jnum = tnum[:-1], jnum[:-1]
        _close(tnum, jnum, rtol=2e-5, atol=1e-6)
    assert next(ties, None) is None


def _target_negative_ties(shots, train_path, test_path, n):
    """For each of the first n batches, how many negatives are the item's
    target shot itself."""
    data, _ = _host_sources(shots, train_path, test_path)
    out = []
    for _ in range(n):
        b = next(data)["data"]
        out.append(int((b[:, None, 0] == b[:, 5:]).all(-1).sum()))
    return out


def test_train_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    assert inspect.signature(ttrain.train).parameters["device"].default == \
        "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _models(dropout_rate=0.0, compute_dtype="float32")
    tp = tm.init(torch.Generator().manual_seed(0))
    cfg = tsol.SolverConfig(max_iter=1)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.train(_port_loss(tm), tp, iter(_batches(1)), cfg)
    r = ttrain.train(_port_loss(tm), tp, iter(_batches(1)), cfg, device="cpu")
    assert r.params["tower"]["w"].device.type == "cpu"
