"""The port's graph engine (videovector_tpu_torch.graph: layers, net) against
the JAX package's on the CPU.

Small sizes: feature 64, embed 32, B = 8 windows of 1 target + 4 context +
10 negatives, test batches of 12 windows. Nets come from
projects/videovec_embedding/generate_net.py's emit (the flagship's twelve
layer types) or from short inline prototxts, parsed by each package's own
parser. Inputs are made with numpy from a seed; weights are carried across
from JAX with `convert.params_from_jax`. Tolerances: the generated TRAIN
net's loss and every gradient within 1e-5 relative of JAX's unfused Net
(the per-layer graph the port runs) and 1e-4 of JAX's default fused one;
the TEST outputs within 1e-5; the Net against the port's hand-written
VideoEmbeddingModel.loss within 1e-4 (JAX's own bound for that check,
tests/test_embedding_model.py).
"""

import importlib.util
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu.graph.net import filter_layers as jfilter
from videovector_tpu.solver import solvers as jsol
from videovector_tpu.solver import train as jtrain
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.graph import filter_layers as tfilter
from videovector_tpu_torch.graph import layers as tlayers
from videovector_tpu_torch.models import embedding as temb
from videovector_tpu_torch.ops import activations as tact
from videovector_tpu_torch.solver import solvers as tsol
from videovector_tpu_torch.solver import train as ttrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
D, E, B, NEG, TEST_B = 64, 32, 8, 10, 12
BENCH_SOLVER = dict(base_lr=0.05, momentum=0.9, weight_decay=5e-2,
                    lr_policy="inv", gamma=0.001, power=0.75)


def _emit(**kw):
    spec = importlib.util.spec_from_file_location(
        "generate_net", ROOT / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = dict(batch=B, test_batch=TEST_B, embed=E, negatives=NEG,
                weight_std=0.1, dropout=0.0)
    args.update(kw)
    return mod.emit("train.vvr", "test.vvr", **args)


def _nets(txt, phase, *, jax_kw=None, port_kw=None):
    return (JNet(jparse(txt), phase, **{"fuse_scoring": False,
                                        **(jax_kw or {})}),
            TNet(tparse(txt), phase, **(port_kw or {})))


def _init(jn, tn, batch, seed=0):
    """JAX's params from PRNGKey(seed), carried to the port; the port's
    own init runs too (shapes, multipliers, sharing)."""
    jp, _ = jn.init(jax.random.PRNGKey(seed), {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    tn.init(torch.Generator().manual_seed(seed), batch)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _train_batch(seed=1, b=B):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(b, 1 + 4 + NEG, D).astype(np.float32)}


def _test_batch(seed=2, videos=4):
    rs = np.random.RandomState(seed)
    vids = rs.randint(1, videos + 1, size=TEST_B)
    centers = rs.randn(videos + 1, D).astype(np.float32)
    data = centers[vids][:, None, :] + 0.8 * rs.randn(TEST_B, 4, D)
    return {"data": data.astype(np.float32),
            "video_ids": vids.astype(np.float32)}


def _jax_loss_grads(jn, jp, batch, **kw):
    def f(p):
        loss, outs = jn.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                              **kw)
        return loss, outs
    (loss, outs), g = jax.value_and_grad(f, has_aux=True)(jp)
    return (float(loss), jax.tree.map(np.asarray, outs),
            jax.tree.map(np.asarray, g))


def _port_loss_grads(tn, tp, batch, **kw):
    p = convert.map_params(lambda t: t.clone().requires_grad_(), tp)
    loss, outs = tn.apply(p, {k: torch.as_tensor(v) for k, v in batch.items()},
                          **kw)
    loss.backward()
    return (loss.item(), {k: v.detach().numpy() for k, v in outs.items()},
            convert.map_params(lambda t: t.grad.numpy(), p))


def _tree_close(got, ref, rtol):
    """Every leaf within rtol of the reference's largest magnitude."""
    for path, leaf in convert.leaves_with_paths(got):
        r = ref
        for k in path:
            r = r[k]
        r = np.asarray(r)
        np.testing.assert_allclose(leaf, r, rtol=rtol,
                                   atol=rtol * np.abs(r).max(), err_msg=path)


# -- the flagship prototxt ---------------------------------------------------

def test_flagship_train_net_loss_and_grads_match_jax():
    jn, tn = _nets(_emit(), "TRAIN")
    batch = _train_batch()
    jp, tp = _init(jn, tn, batch)
    assert {k: sorted(v) for k, v in tp.items()} == {"fc7": ["b", "w"]}
    jl, jouts, jg = _jax_loss_grads(jn, jp, batch)
    tl, touts, tg = _port_loss_grads(tn, tp, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _tree_close(tg, jg, 1e-5)
    assert sorted(touts) == sorted(jouts) == ["loss_output",
                                              "train_violations"]
    for k in touts:
        np.testing.assert_allclose(touts[k], jouts[k], rtol=1e-5)
    # JAX's default Net fuses the scoring head: the same math, summed in
    # another order
    jf = JNet(jparse(_emit()), "TRAIN")
    jfl, _, jfg = _jax_loss_grads(jf, jp, batch)
    np.testing.assert_allclose(tl, jfl, rtol=1e-4)
    _tree_close(tg, jfg, 1e-4)


def test_flagship_train_net_with_jax_dropout_mask_matches_jax(monkeypatch):
    """Dropout 0.9 on drop7 with JAX's mask (bernoulli of fold_in(key,
    crc32("drop7"))) injected into the port."""
    txt = _emit(dropout=0.9)
    jn, tn = _nets(txt, "TRAIN")
    batch = _train_batch(3)
    jp, tp = _init(jn, tn, batch)
    key = jax.random.PRNGKey(7)
    mask = np.array(jax.random.bernoulli(
        jax.random.fold_in(key, zlib.crc32(b"drop7") & 0x7FFFFFFF),
        np.float32(1.0) - np.float32(0.9), (B * 15, E)))
    drawn = []

    def jax_mask(shape, keep, gen, dev):
        drawn.append(tuple(shape))
        return torch.as_tensor(mask)
    monkeypatch.setattr(tact, "dropout_mask", jax_mask)
    jl, _, jg = _jax_loss_grads(jn, jp, batch, rng=key)
    tl, _, tg = _port_loss_grads(tn, tp, batch,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn == [(B * 15, E)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _tree_close(tg, jg, 1e-5)


def test_flagship_test_net_outputs_match_jax():
    jn, tn = _nets(_emit(), "TEST")
    batch = _test_batch()
    jp, tp = _init(jn, tn, batch)
    jl, jouts, _ = _jax_loss_grads(jn, jp, batch)
    with torch.no_grad():
        tl, touts = tn.apply(tp, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert sorted(touts) == ["test_hit1", "test_hit5", "test_map"]
    assert tl.item() == jl == 0.0
    for k in touts:
        np.testing.assert_allclose(touts[k].numpy(), jouts[k], rtol=1e-5)
    assert 0.0 < touts["test_map"].item() <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_net_equals_the_hand_model(dtype):
    """The generated TRAIN net and the port's VideoEmbeddingModel.loss on
    the same params and batch (dropout 0): loss and fc7's gradients within
    1e-4, in f32 and with bf16 GEMM operands (ROADMAP item 6a's done
    criterion; JAX checks the same in tests/test_embedding_model.py)."""
    txt = _emit()
    tn = TNet(tparse(txt), "TRAIN",
              compute_dtype=None if dtype == "float32" else dtype)
    batch = {"data": torch.as_tensor(_train_batch(4)["data"])}
    params, _ = tn.init(torch.Generator().manual_seed(3), batch)
    model = temb.VideoEmbeddingModel(temb.VideoEmbeddingConfig(
        feature_dim=D, embed_dim=E, num_context=4, num_negatives=NEG,
        margin=2.0, norm="L2", dropout_rate=0.0, compute_dtype=dtype))
    p = convert.map_params(lambda t: t.clone().requires_grad_(), params)
    h = {"tower": convert.map_params(lambda t: t.clone().requires_grad_(),
                                     params["fc7"])}
    net_loss = tn.loss_fn(p, batch)
    hand_loss, _ = model.loss(h, batch, train=True)
    net_loss.backward()
    hand_loss.backward()
    np.testing.assert_allclose(net_loss.item(), hand_loss.item(), rtol=1e-4)
    for k in ("w", "b"):
        ref = h["tower"][k].grad.numpy()
        np.testing.assert_allclose(p["fc7"][k].grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_flagship_ten_steps_with_multipliers_match_jax_train():
    """10 steps of the generated TRAIN net through each package's train,
    with the Net's lr/decay multipliers (fc7: blobs_lr 1, 2 and
    weight_decay 1, 0) and dropout 0: losses, params and history within
    1e-5 relative."""
    jn, tn = _nets(_emit(), "TRAIN")
    batches = [_train_batch(10 + i) for i in range(11)]
    jp, tp = _init(jn, tn, batches[0])
    lr, decay = tn.param_multipliers()
    assert (lr, decay) == ({"fc7": {"w": 1.0, "b": 2.0}},
                           {"fc7": {"w": 1.0, "b": 0.0}})
    skw = dict(BENCH_SOLVER, max_iter=10, display=1)

    def jloss(p, b, key):
        loss, outs = jn.apply(p, b, rng=key)
        return loss, {k: jnp.ravel(v) for k, v in outs.items()}

    def tloss(p, b, gen):
        loss, outs = tn.apply(p, b, generator=gen)
        return loss, {k: v.reshape(-1) for k, v in outs.items()}
    rj = jtrain.train(jloss, jp, iter([jax.tree.map(jnp.asarray, b)
                                       for b in batches]),
                      jsol.SolverConfig(**skw), lr_mults=lr,
                      decay_mults=decay)
    rt = ttrain.train(tloss, tp, iter(batches), tsol.SolverConfig(**skw),
                      lr_mults=lr, decay_mults=decay, device="cpu",
                      batch_axes={"data": 0})
    losses = [[m["loss"] for _, m in r.metrics_history] for r in (rt, rj)]
    assert len(losses[0]) == 10
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    _tree_close(convert.params_to_numpy(rt.params),
                jax.tree.map(np.asarray, rj.params), 1e-5)
    _tree_close(convert.params_to_numpy(rt.state["history"]),
                jax.tree.map(np.asarray, rj.state["history"]), 1e-5)
    # the multipliers acted: without them the port ends elsewhere
    plain = ttrain.train(tloss, tp, iter(batches), tsol.SolverConfig(**skw),
                         device="cpu")
    assert not torch.allclose(plain.params["fc7"]["b"], rt.params["fc7"]["b"])


# -- Net semantics (tests/test_net.py, tests/test_net_semantics.py) ----------

FILTER_NET = """
layers { name: "d" type: MEMORY_DATA top: "x" }
layers { name: "a" type: RELU bottom: "x" top: "x" include: { phase: TRAIN } }
layers { name: "b" type: RELU bottom: "x" top: "x" include: { phase: TEST } }
layers { name: "c" type: RELU bottom: "x" top: "x" exclude: { phase: TEST } }
layers { name: "lvl1" type: RELU bottom: "x" top: "x"
  include: { min_level: 1 } }
layers { name: "lvl0only" type: RELU bottom: "x" top: "x"
  include: { max_level: 0 } }
layers { name: "deploy_only" type: RELU bottom: "x" top: "x"
  include: { stage: "deploy" } }
layers { name: "not_deploy" type: RELU bottom: "x" top: "x"
  exclude: { stage: "deploy" } }
layers { name: "either" type: RELU bottom: "x" top: "x"
  include: { phase: TEST } include: { stage: "deploy" } }
"""


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("stages", [(), ("deploy",)])
def test_filter_layers_matches_jax(phase, level, stages):
    names = [[l.get("name") for l in f(parse(FILTER_NET), phase, level, stages)]
             for f, parse in ((tfilter, tparse), (jfilter, jparse))]
    assert names[0] == names[1]
    net = TNet(tparse(FILTER_NET), phase, level=level, stages=stages)
    assert [l.get("name") for l in net.layers] == names[0]


SHARE_NET = """
layers {{ name: "d" type: MEMORY_DATA top: "x1" top: "x2" }}
layers {{ name: "ipA" type: INNER_PRODUCT bottom: "x1" top: "h1"
  param: "shared_w" {bias_share}
  inner_product_param {{ num_output: 4 {bias}
    weight_filler {{ type: "gaussian" std: 0.5 }}
    bias_filler {{ type: "uniform" }} }} }}
layers {{ name: "ipB" type: INNER_PRODUCT bottom: "x2" top: "h2"
  param: "shared_w" {bias_share} {mode}
  inner_product_param {{ num_output: {n_b} {bias}
    weight_filler {{ type: "gaussian" std: 0.5 }}
    bias_filler {{ type: "uniform" }} }} }}
"""


@pytest.mark.parametrize("mode", ["STRICT", "PERMISSIVE"])
def test_param_sharing_matches_jax(rng, mode):
    """STRICT: two INNER_PRODUCTs share w and b by name; PERMISSIVE: ipB's
    (8, 3) weight views ipA's (6, 4) one (equal counts, no bias). Outputs
    and the accumulated gradient of the owner equal JAX's."""
    if mode == "STRICT":
        txt = SHARE_NET.format(bias_share='param: "shared_b"', bias="",
                               mode="", n_b=4)
        batch = {"x1": rng.randn(2, 6).astype(np.float32),
                 "x2": rng.randn(2, 6).astype(np.float32)}
    else:
        txt = SHARE_NET.format(bias_share="", bias="bias_term: false",
                               mode='blob_share_mode: PERMISSIVE', n_b=3)
        batch = {"x1": rng.randn(2, 6).astype(np.float32),
                 "x2": rng.randn(2, 8).astype(np.float32)}
    jn, tn = _nets(txt, "TRAIN")
    jp, tp = _init(jn, tn, batch)
    assert sorted(tp) == ["ipA"]
    assert tn.param_meta["ipB"]["w"].shared_owner == "ipA"
    assert tn.param_meta["ipB"]["w"].shared_shape == \
        (None if mode == "STRICT" else (8, 3))

    def jf(p):
        _, b = jn.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        return_blobs=True)
        return jnp.sum(b["h1"]) + 2.0 * jnp.sum(b["h2"]), b
    (_, jb), jg = jax.value_and_grad(jf, has_aux=True)(jp)
    p = convert.map_params(lambda t: t.clone().requires_grad_(), tp)
    _, tb = tn.apply(p, {k: torch.as_tensor(v) for k, v in batch.items()},
                     return_blobs=True)
    (tb["h1"].sum() + 2.0 * tb["h2"].sum()).backward()
    for k in ("h1", "h2"):
        np.testing.assert_allclose(tb[k].detach().numpy(), jb[k], rtol=1e-6)
    _tree_close(convert.map_params(lambda t: t.grad.numpy(), p),
                jax.tree.map(np.asarray, jg), 1e-6)
    # a shape mismatch under STRICT raises in both packages
    bad = SHARE_NET.format(bias_share="", bias="bias_term: false", mode="",
                           n_b=3)
    spec = {"x1": np.zeros((2, 6), np.float32), "x2": np.zeros((2, 8),
                                                            np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        TNet(tparse(bad), "TRAIN").init(torch.Generator(), spec)


def test_auto_tops_and_loss_weight_overrides_match_jax(rng):
    """A MAX_MARGIN_LOSS without tops gets its two auto tops (weights 1, 0)
    without touching the caller's message; `loss_weight` overrides them.
    Loss, outputs and output_loss_weights equal JAX's."""
    scores = {"ts": rng.randn(5, 3).astype(np.float32),
              "ns": rng.randn(5, 3).astype(np.float32)}
    for extra in ("", "loss_weight: 0.5 loss_weight: 2.0"):
        txt = f"""
        layers {{ name: "d" type: MEMORY_DATA top: "ts" top: "ns" }}
        layers {{ name: "mm" type: MAX_MARGIN_LOSS bottom: "ts" bottom: "ns"
          {extra} max_margin_loss_param {{ margin: 1.5 }} }}
        """
        tmsg = tparse(txt)
        before = tmsg.dumps()
        jn, tn = JNet(jparse(txt), "TRAIN"), TNet(tmsg, "TRAIN")
        assert tmsg.dumps() == before
        jl, jouts = jn.apply({}, {k: jnp.asarray(v) for k, v in scores.items()})
        tl, touts = tn.apply({}, {k: torch.as_tensor(v)
                                  for k, v in scores.items()})
        assert sorted(touts) == sorted(jouts) == ["mm_auto_top_0",
                                                  "mm_auto_top_1"]
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        for k in touts:
            np.testing.assert_allclose(touts[k].numpy(), jouts[k], rtol=1e-6)
        assert tn.output_loss_weights() == jn.output_loss_weights()
    assert tn.loss_weights["mm"] == [0.5, 2.0]


@pytest.mark.parametrize("mults,err", [
    ("blobs_lr: 1", "blobs_lr has 1 entries"),
    ("weight_decay: 1 weight_decay: 0 weight_decay: 1", "weight_decay has 3"),
    ("blobs_lr: 1 blobs_lr: -2", "negative blobs_lr"),
    ("weight_decay: -1 weight_decay: 0", "negative weight_decay"),
])
def test_multiplier_checks(mults, err):
    txt = f"""
    layers {{ name: "d" type: MEMORY_DATA top: "x" }}
    layers {{ name: "ip" type: INNER_PRODUCT bottom: "x" top: "y" {mults}
      inner_product_param {{ num_output: 2 }} }}
    """
    with pytest.raises(ValueError, match=err):
        TNet(tparse(txt), "TRAIN").init(torch.Generator(),
                                        {"x": np.zeros((2, 3), np.float32)})


def test_param_multipliers_and_flat_param_list_match_jax():
    txt = """
    layers { name: "d" type: MEMORY_DATA top: "x" }
    layers { name: "ip1" type: INNER_PRODUCT bottom: "x" top: "h"
      blobs_lr: 3 blobs_lr: 0 weight_decay: 0.5 weight_decay: 0
      inner_product_param { num_output: 4 } }
    layers { name: "ip2" type: INNER_PRODUCT bottom: "h" top: "y"
      inner_product_param { num_output: 2 bias_term: false } }
    """
    batch = {"x": np.zeros((2, 3), np.float32)}
    jn, tn = _nets(txt, "TRAIN")
    jp, tp = _init(jn, tn, batch)
    assert tn.param_multipliers() == (
        {"ip1": {"w": 3.0, "b": 0.0}, "ip2": {"w": 1.0}},
        {"ip1": {"w": 0.5, "b": 0.0}, "ip2": {"w": 1.0}})
    assert tn.flat_param_list(tp) == jn.flat_param_list(jp)


def test_deploy_input_v0_upgrade_and_inplace_output_match_jax(rng):
    """A V0 net (upgraded on load) with a NetParameter-level `input`: an
    INNER_PRODUCT on a 4-d input (flattened), then an in-place ReLU, whose
    blob stays a net output; max_layers stops early."""
    txt = """
    name: "v0"
    input: "data"
    input_dim: 2 input_dim: 3 input_dim: 2 input_dim: 2
    layers { layer { name: "ip" type: "innerproduct" num_output: 5
                     weight_filler { type: "gaussian" std: 0.5 }
                     bias_filler { type: "constant" value: 0.1 } }
             bottom: "data" top: "h" }
    layers { layer { name: "r" type: "relu" } bottom: "h" top: "h" }
    """
    batch = {"data": rng.randn(2, 3, 2, 2).astype(np.float32)}
    jn, tn = _nets(txt, "TEST")
    assert tn.input_names == jn.input_names == ["data"]
    jp, tp = _init(jn, tn, batch)
    _, jouts = jn.apply(jp, {"data": jnp.asarray(batch["data"])})
    _, touts = tn.apply(tp, {"data": torch.as_tensor(batch["data"])})
    assert list(touts) == ["h"] and (touts["h"] >= 0).all()
    np.testing.assert_allclose(touts["h"].numpy(), jouts["h"], rtol=1e-6)
    _, first = tn.apply(tp, {"data": torch.as_tensor(batch["data"])},
                        max_layers=1)
    assert (first["h"] < 0).any()


def test_init_params_from_fillers_and_the_generator():
    """The port's own fills: INNER_PRODUCT fills (num_output, K) and
    transposes to a contiguous (K, num_output); the same seed gives the
    same params, and the fillers' statistics are theirs."""
    txt = """
    layers { name: "d" type: MEMORY_DATA top: "x" }
    layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "y"
      inner_product_param { num_output: 300
        weight_filler { type: "gaussian" std: 0.5 }
        bias_filler { type: "constant" value: 0.25 } } }
    """
    spec = {"x": np.zeros((2, 400), np.float32)}
    net = TNet(tparse(txt), "TRAIN")
    a, _ = net.init(torch.Generator().manual_seed(5), spec)
    b, _ = net.init(torch.Generator().manual_seed(5), spec)
    w = a["ip"]["w"]
    assert w.shape == (400, 300) and w.is_contiguous()
    assert torch.equal(w, b["ip"]["w"])
    assert abs(w.std().item() - 0.5) < 0.01
    assert torch.equal(a["ip"]["b"], torch.full((300,), 0.25))
    ref = torch.randn((300, 400), generator=torch.Generator().manual_seed(5))
    assert torch.equal(w, (ref * 0.5).T)


@pytest.mark.parametrize("cfg", [
    None, {"type": "constant", "value": -1.5},
    {"type": "uniform", "min": -0.5, "max": 2.0},
    {"type": "gaussian", "mean": 0.5, "std": 2.0},
    {"type": "gaussian", "std": 1.0, "sparse": 50},
    {"type": "positive_unitball"}, {"type": "xavier", "std": 9.0},
])
def test_fillers_match_jax_in_distribution(cfg):
    """Every filler of get_filler on a (200, 300) blob against JAX's on the
    same config: the streams differ (torch.Generator against threefry), so
    the checks are the values' range, mean, spread, zero share and row sums,
    each within sampling error of JAX's."""
    from videovector_tpu.core import fillers as jfillers
    from videovector_tpu_torch.core import fillers as tfillers
    shape = (200, 300)
    got = tfillers.get_filler(cfg)(torch.Generator().manual_seed(0),
                                   shape).numpy()
    ref = np.asarray(jfillers.get_filler(cfg)(jax.random.PRNGKey(0), shape))
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    for a, b in ((got, ref), (ref, got)):
        assert a.min() >= b.min() - 0.05 * (np.ptp(b) + 1) - 1e-6
        assert a.max() <= b.max() + 0.05 * (np.ptp(b) + 1) + 1e-6
    for stat in (np.mean, np.std, lambda x: np.mean(x == 0)):
        assert abs(stat(got) - stat(ref)) <= 0.02 * (np.std(ref) + 1e-3) + 0.01
    if cfg and cfg["type"] == "positive_unitball":
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    if cfg is None or cfg["type"] == "constant":
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="Unknown filler"):
        tfillers.get_filler({"type": "msra"})


# -- side tables and the stats layer ----------------------------------------

def _stats_net(param):
    return f"""
    layers {{ name: "d" type: MEMORY_DATA top: "feats" top: "vids" }}
    layers {{ name: "rs" type: RETRIEVAL_STATS bottom: "feats" bottom: "vids"
      top: "map" top: "hit1" top: "hit5"
      retrieval_stats_param {{ {param} }} }}
    """


def _stats_batch(rng, n=24, videos=6):
    vids = np.repeat(np.arange(1, videos + 1), n // videos).astype(np.float32)
    feats = rng.randn(n, 16).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return {"feats": feats, "vids": vids}


@pytest.mark.parametrize("param", [
    "", "exclude_same_video_shots: false", "id_to_class_file: CSV",
    "id_to_class_file: CSV exclude_same_video_shots: false",
    "video_level_retrieval: true max_num_videos: 6 id_to_class_file: CSV",
])
def test_retrieval_stats_side_tables_match_jax(rng, tmp_path, param):
    csv = tmp_path / "classes.csv"
    csv.write_text("".join(f"{v},{v % 3}\n" for v in range(1, 7)))
    txt = _stats_net(param.replace("CSV", f'"{csv}"'))
    batch = _stats_batch(rng)
    jn, tn = JNet(jparse(txt), "TEST"), TNet(tparse(txt), "TEST")
    _, jouts = jn.apply({}, {k: jnp.asarray(v) for k, v in batch.items()})
    _, touts = tn.apply({}, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("map", "hit1", "hit5"):
        np.testing.assert_allclose(touts[k].numpy(), jouts[k], rtol=1e-6)
    if "video_level" in param:
        check = tn.batch_validators()
        assert len(check) == 1
        check[0](batch)
        with pytest.raises(ValueError, match="max_num_videos"):
            check[0]({"vids": batch["vids"][:12]})


def test_video_level_retrieval_needs_max_num_videos(rng):
    tn = TNet(tparse(_stats_net("video_level_retrieval: true")), "TEST")
    with pytest.raises(ValueError, match="max_num_videos > 0"):
        tn.apply({}, {k: torch.as_tensor(v)
                      for k, v in _stats_batch(rng).items()})


@pytest.mark.parametrize("weighting", ["csv", "direct"])
def test_max_margin_weights_match_jax(rng, tmp_path, weighting):
    """MAX_MARGIN_LOSS's third bottom: ids looked up in id_to_weight_file
    (unknown ids weigh 0), or the weights themselves with
    use_direct_weight. Loss and both score gradients equal JAX's."""
    csv = tmp_path / "w.csv"
    csv.write_text("7,0.5\n3,2.0\n11,1.25\n")
    param = (f'id_to_weight_file: "{csv}"' if weighting == "csv"
             else "use_direct_weight: true")
    txt = f"""
    layers {{ name: "d" type: MEMORY_DATA top: "ts" top: "ns" top: "w" }}
    layers {{ name: "mm" type: MAX_MARGIN_LOSS bottom: "ts" bottom: "ns"
      bottom: "w" top: "l" top: "v"
      max_margin_loss_param {{ margin: 2.0 norm: L2 {param} }} }}
    """
    third = (np.array([[3], [7], [5], [11]], np.float32) if weighting == "csv"
             else rng.rand(4, 1).astype(np.float32))
    batch = {"ts": rng.randn(4, 3).astype(np.float32),
             "ns": rng.randn(4, 3).astype(np.float32), "w": third}
    jn, tn = JNet(jparse(txt), "TRAIN"), TNet(tparse(txt), "TRAIN")
    jl, jg = jax.value_and_grad(lambda s: jn.apply({}, s)[0])(
        {k: jnp.asarray(v) for k, v in batch.items()})
    ts = {k: torch.tensor(v, requires_grad=k != "w") for k, v in batch.items()}
    tl, _ = tn.apply({}, ts)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for k in ("ts", "ns"):
        np.testing.assert_allclose(ts[k].grad.numpy(), jg[k], rtol=1e-6,
                                   atol=1e-7)


def test_missing_or_bad_side_files_raise(tmp_path):
    with pytest.raises(ValueError, match="does not exist"):
        TNet(tparse(_stats_net('id_to_class_file: "/nonexistent.csv"')),
             "TEST")
    bad = tmp_path / "neg.csv"
    bad.write_text("1,-0.5\n")
    txt = f"""
    layers {{ name: "mm" type: MAX_MARGIN_LOSS bottom: "a" bottom: "b"
      max_margin_loss_param {{ id_to_weight_file: "{bad}" }} }}
    """
    with pytest.raises(ValueError, match="negative weight"):
        TNet(tparse(txt), "TRAIN")
    with pytest.raises(ValueError, match="does not exist"):
        TNet(tparse(txt.replace(str(bad), "/nonexistent.csv")), "TRAIN")
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(ValueError, match="no entries"):
        TNet(tparse(_stats_net(f'id_to_class_file: "{empty}"')), "TEST")
    # pre-seeding the side table is the opt-out
    TNet(tparse(_stats_net('id_to_class_file: "/nonexistent.csv"')), "TEST",
         side={"rs": None})


def test_stats_output_file_report_matches_jax(rng, tmp_path):
    """RETRIEVAL_STATS with stats_output_file: process_host_sinks writes the
    per-query csv; its ids equal JAX's and its numbers agree within 1e-6."""
    csv = tmp_path / "classes.csv"
    csv.write_text("".join(f"{v},{v % 3}\n" for v in range(1, 7)))
    files = []
    outs = []
    for parse, net_cls, tag in ((jparse, JNet, "j"), (tparse, TNet, "t")):
        path = tmp_path / f"{tag}.csv"
        txt = _stats_net(f'id_to_class_file: "{csv}" '
                         f'stats_output_file: "{path}"')
        net = net_cls(parse(txt), "TEST")
        assert [s["name"] for s in net.host_sinks] == ["rs"]
        batch = _stats_batch(np.random.RandomState(4))
        if tag == "j":
            _, blobs = net.apply({}, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                 return_blobs=True)
        else:
            _, _, blobs = net.apply({}, {k: torch.as_tensor(v)
                                         for k, v in batch.items()},
                                    return_sink_blobs=True)
            assert sorted(blobs) == ["feats", "vids"]
        net.process_host_sinks(blobs)
        files.append(path.read_text().splitlines())
    assert files[0][0] == files[1][0] and len(files[0]) == len(files[1]) == 25
    for a, b in zip(files[0][1:], files[1][1:]):
        a, b = a.split(","), b.split(",")
        assert a[:2] == b[:2] and a[5:] == b[5:]
        np.testing.assert_allclose([float(x) for x in a[2:5]],
                                   [float(x) for x in b[2:5]], rtol=1e-6)


# -- errors ----------------------------------------------------------------

@pytest.mark.parametrize("ltype,match", [
    ("NO_SUCH_LAYER", "not registered"),
])
def test_unported_layer_types_raise(ltype, match):
    txt = f"""
    layers {{ name: "d" type: MEMORY_DATA top: "x" }}
    layers {{ name: "l" type: {ltype} bottom: "x" top: "y" }}
    """
    with pytest.raises(NotImplementedError, match=match):
        TNet(tparse(txt), "TRAIN")


def test_every_jax_type_is_ported_or_pending():
    from videovector_tpu.graph import layers as jlayers
    assert set(jlayers.LAYERS) == set(tlayers.LAYERS) | set(tlayers.PENDING_TYPES)
    assert not set(tlayers.LAYERS) & set(tlayers.PENDING_TYPES)
    assert len(tlayers.LAYERS) == 48 and not tlayers.PENDING_TYPES
    assert tlayers.DATA_LAYER_TYPES == jlayers.DATA_LAYER_TYPES
    assert tlayers.SINK_LAYER_TYPES == jlayers.SINK_LAYER_TYPES
    assert tlayers.STATEFUL_LAYER_TYPES == jlayers.STATEFUL_LAYER_TYPES


def test_dropout_at_train_needs_a_generator(rng):
    txt = """
    layers { name: "d" type: MEMORY_DATA top: "x" }
    layers { name: "dr" type: DROPOUT bottom: "x" top: "y"
      dropout_param { dropout_ratio: 0.5 } }
    """
    x = {"x": torch.as_tensor(rng.randn(20, 40).astype(np.float32))}
    net = TNet(tparse(txt), "TRAIN")
    with pytest.raises(ValueError, match="generator"):
        net.apply({}, x)
    _, out = net.apply({}, x, generator=torch.Generator().manual_seed(1))
    kept = out["y"] != 0
    assert 0.3 < kept.float().mean().item() < 0.7
    # TEST is the identity, with or without a generator
    assert TNet(tparse(txt), "TEST").apply({}, x)[1]["y"] is x["x"]


def test_quant_and_infogain_raise_not_ported():
    """Once refused, both now work: an INNER_PRODUCT in the int8 quant side
    table gives JAX's int8 forward (an exact int32 sum, dequantized in
    f32: equal here, the scales being powers of two), and the infogain
    matrix is read."""
    txt = """
    layers { name: "d" type: MEMORY_DATA top: "x" }
    layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "y"
      inner_product_param { num_output: 2 } }
    """
    x = np.array([[1.0, -2.0, 0.5]], np.float32)
    w = np.array([[1.0, 0.5], [-1.0, 2.0], [0.25, -0.75]], np.float32)
    b = np.array([0.5, -1.0], np.float32)
    q = {"w_q": np.array([[64, 32], [-64, 127], [16, -48]], np.int8),
         "s_w": np.array([2.0 ** -6, 2.0 ** -6], np.float32),
         "s_x": np.float32(2.0 ** -6), "mode": "int8"}
    jnet = JNet(jparse(txt), "TEST")
    jnet.init(jax.random.PRNGKey(0), {"x": jax.ShapeDtypeStruct((1, 3),
                                                                jnp.float32)})
    jnet.quant = {"ip": q}
    want = np.asarray(jnet.apply({"ip": {"w": jnp.asarray(w),
                                         "b": jnp.asarray(b)}},
                                 {"x": jnp.asarray(x)})[1]["y"])
    net = TNet(tparse(txt), "TEST")
    net.init(torch.Generator(), {"x": x})
    net.quant = {"ip": {k: (torch.as_tensor(v) if k != "mode" else v)
                        for k, v in q.items()}}
    got = net.apply({"ip": {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}},
                    {"x": torch.as_tensor(x)})[1]["y"]
    np.testing.assert_array_equal(got.numpy(), want)
    # the infogain matrix is read since item 6c-ii: a missing source is the
    # reference's CHECK failure, as in JAX's Net
    with pytest.raises(ValueError, match="infogain source 'h.binaryproto'"):
        TNet(tparse("""
        layers { name: "l" type: RELU bottom: "x" top: "x"
          infogain_loss_param { source: "h.binaryproto" } }
        """), "TRAIN")
