"""The port's scoring-head fusion (videovector_tpu_torch/graph/fuse.py) on
the CPU: the cases of the JAX package's tests/test_fuse.py.

The fused Net (the default) against the unfused one (fuse_scoring=False) on
the same params, batch and dropout generator: the loss and the outputs bit
for bit, every gradient within 1e-6 of its largest magnitude (see
_assert_grads_equal), on generate_net.py's nets and on a reference-style
net (the reference's CONCAT -> one NORMALIZATION -> SLICE stack variant);
and the
port's fused Net against JAX's fused Net (dropout 0, JAX's params carried
across with `convert.params_from_jax`): loss and gradients within 1e-6
relative of the largest magnitude. Small sizes: feature 48, embed 48,
B = 16 windows of 1 + 4 + 5 roles.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config.textformat import parse as jparse
from videovector_tpu.graph.net import Net as JNet
from videovector_tpu_torch import convert
from videovector_tpu_torch.config.textformat import parse
from videovector_tpu_torch.graph.fuse import ScoringFusion, _l2n_feat
from videovector_tpu_torch.graph.net import Net
from videovector_tpu_torch.metrics.retrieval import IdToClassMap
from videovector_tpu_torch.ops.normalization import l2_normalize_rows

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _emit(**kw):
    spec = importlib.util.spec_from_file_location(
        "generate_net", ROOT / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = dict(batch=16, test_batch=8, negatives=5, embed=48,
                buffer_size=480, weight_std=0.01, dropout=0.9)
    args.update(kw)
    return mod.emit("train.vvr", "test.vvr", **args)


def _batch(seed=0, b=16, roles=10, d=48):
    rs = np.random.RandomState(seed)
    return {"data": torch.as_tensor(rs.randn(b, roles, d, 1)
                                    .astype(np.float32))}


def _pair(txt, phase, batch, side=None):
    """(unfused, fused) Nets and the unfused one's params."""
    n0 = Net(parse(txt), phase, fuse_scoring=False,
             side=dict(side) if side else None)
    n1 = Net(parse(txt), phase, side=dict(side) if side else None)
    p, meta = n0.init(torch.Generator().manual_seed(0), batch)
    n1.param_meta = meta
    return n0, n1, p


def _loss_grads(net, params, batch, seed=7):
    p = convert.map_params(lambda t: t.clone().requires_grad_(), params)
    gen = torch.Generator().manual_seed(seed)
    loss, outs = net.apply(p, batch, generator=gen)
    loss.backward()
    return loss.item(), outs, convert.map_params(lambda t: t.grad, p)


def _assert_grads_equal(g0, g1):
    """Within 1e-6 of each gradient's largest magnitude: the gradient into
    the context vector that all the scores share is summed over the
    negatives by one reduction over the role axis in the fused graph, and
    by autograd's accumulation, in another order, in the unfused one, so the
    last bit may differ (JAX's tests/test_fuse.py allows 1e-7 absolute)."""
    for (path, a), (_, b) in zip(convert.leaves_with_paths(g0),
                                 convert.leaves_with_paths(g1)):
        _close_to_max(b.numpy(), a.numpy(), 1e-6)


def test_generated_net_fused_matches_unfused():
    batch = _batch()
    n0, n1, p = _pair(_emit(), "TRAIN", batch)
    l0, o0, g0 = _loss_grads(n0, p, batch)
    l1, o1, g1 = _loss_grads(n1, p, batch)
    assert l0 == l1                              # bit-equal loss
    _assert_grads_equal(g0, g1)
    assert sorted(o0) == sorted(o1)
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    # the motif ran symbolically: the score SLICE, the context sum, 7
    # normalizations, 6 products, 6 sums and the score CONCAT
    assert n1._last_absorbed == 22
    assert n0._last_absorbed == 0


def test_generated_net_flagship_roles_fused_matches_unfused():
    """The flagship's 15 roles (10 negatives), dropout 0.9."""
    batch = _batch(seed=3, b=8, roles=15, d=32)
    n0, n1, p = _pair(_emit(negatives=10, embed=32, batch=8), "TRAIN", batch)
    l0, _, g0 = _loss_grads(n0, p, batch)
    l1, _, g1 = _loss_grads(n1, p, batch)
    assert l0 == l1
    _assert_grads_equal(g0, g1)
    assert n1._last_absorbed == 37


def test_return_blobs_materializes_all_intermediates():
    """Full-blob requests (debug dumps, `time`-style) still see every motif
    blob, equal to the unfused values."""
    batch = _batch(seed=1, b=8, roles=8)
    n0, n1, p = _pair(_emit(negatives=3), "TRAIN", batch)
    gen = torch.Generator().manual_seed(0)
    _, b0 = n0.apply(p, batch, generator=gen.manual_seed(0),
                     return_blobs=True)
    _, b1 = n1.apply(p, batch, generator=gen.manual_seed(0),
                     return_blobs=True)
    assert set(b0) == set(b1)
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


def _jax_fused(txt, phase, batch, params, **kw):
    jn = JNet(jparse(txt), phase, **kw)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jn.init(jax.random.PRNGKey(0), jb)

    def f(p):
        return jn.apply(p, jb, rng=jax.random.PRNGKey(0))
    (loss, outs), g = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, convert.params_to_numpy(params)))
    return float(loss), jax.tree.map(np.asarray, outs), \
        jax.tree.map(np.asarray, g), jn


def _close_to_max(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("negatives", [5, 10])
def test_fused_net_matches_jax_fused_net(negatives):
    """The port's fused Net against JAX's fused Net, dropout 0, JAX's
    params: loss and gradients within 1e-6."""
    txt = _emit(dropout=0.0, negatives=negatives)
    batch = _batch(seed=4, roles=5 + negatives)
    jn = JNet(jparse(txt), "TRAIN")
    jp, _ = jn.init(jax.random.PRNGKey(0),
                    {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tn = Net(parse(txt), "TRAIN")
    tn.init(torch.Generator().manual_seed(0), batch)
    tl, touts, tg = _loss_grads(tn, params, batch)
    jl, jouts, jg, jn = _jax_fused(txt, "TRAIN", batch, params)
    assert tn._last_absorbed == jn._last_absorbed
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for (path, leaf) in convert.leaves_with_paths(tg):
        ref = jg
        for k in path:
            ref = ref[k]
        _close_to_max(leaf.numpy(), ref, 1e-6)
    for k in touts:
        _close_to_max(touts[k].detach().numpy(), jouts[k], 1e-6)


# The reference's hand-written flagship (mednet_embedding_train.prototxt)
# normalizes through a stack: CONCAT(dim0) of the context mean, the target
# and the negatives, ONE NORMALIZATION, then a SLICE back; shown here at
# 3 negatives.
REFERENCE_STYLE = """
name: "reference_style"
input: "data"
input_dim: 6 input_dim: 8 input_dim: 40 input_dim: 1
layers { name: "slice_input" type: SLICE bottom: "data"
  top: "t" top: "c1" top: "c2" top: "c3" top: "c4"
  top: "n1" top: "n2" top: "n3" slice_param { slice_dim: 1 } }
layers { name: "concat_all" type: CONCAT
  bottom: "t" bottom: "c1" bottom: "c2" bottom: "c3" bottom: "c4"
  bottom: "n1" bottom: "n2" bottom: "n3"
  top: "tower_in" concat_param { concat_dim: 0 } }
layers { name: "fc7" type: INNER_PRODUCT bottom: "tower_in" top: "emb"
  inner_product_param { num_output: 24
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu7" type: RELU bottom: "emb" top: "emb" }
layers { name: "slice_emb" type: SLICE bottom: "emb"
  top: "et" top: "ec1" top: "ec2" top: "ec3" top: "ec4"
  top: "en1" top: "en2" top: "en3" slice_param { slice_dim: 0 } }
layers { name: "ctx_avg" type: ELTWISE
  bottom: "ec1" bottom: "ec2" bottom: "ec3" bottom: "ec4" top: "ctx"
  eltwise_param { operation: SUM coeff: 0.25 coeff: 0.25 coeff: 0.25
                  coeff: 0.25 } }
layers { name: "stack" type: CONCAT bottom: "ctx" bottom: "et"
  bottom: "en1" bottom: "en2" bottom: "en3" top: "stacked"
  concat_param { concat_dim: 0 } }
layers { name: "norm_all" type: NORMALIZATION bottom: "stacked"
  top: "stacked_n" }
layers { name: "unstack" type: SLICE bottom: "stacked_n"
  top: "ctxn" top: "etn" top: "en1n" top: "en2n" top: "en3n"
  slice_param { slice_dim: 0 } }
layers { name: "true_prod" type: ELTWISE bottom: "ctxn" bottom: "etn"
  top: "tp" eltwise_param { operation: PROD } }
layers { name: "true_score" type: SUM bottom: "tp" top: "ts"
  sum_param { num_output: 3 } }
layers { name: "np1" type: ELTWISE bottom: "ctxn" bottom: "en1n" top: "np1"
  eltwise_param { operation: PROD } }
layers { name: "ns1" type: SUM bottom: "np1" top: "ns1" }
layers { name: "np2" type: ELTWISE bottom: "ctxn" bottom: "en2n" top: "np2"
  eltwise_param { operation: PROD } }
layers { name: "ns2" type: SUM bottom: "np2" top: "ns2" }
layers { name: "np3" type: ELTWISE bottom: "ctxn" bottom: "en3n" top: "np3"
  eltwise_param { operation: PROD } }
layers { name: "ns3" type: SUM bottom: "np3" top: "ns3" }
layers { name: "neg_concat" type: CONCAT bottom: "ns1" bottom: "ns2"
  bottom: "ns3" top: "negs" concat_param { concat_dim: 1 } }
layers { name: "loss" type: MAX_MARGIN_LOSS bottom: "ts" bottom: "negs"
  top: "loss" top: "violations" loss_weight: 1.0 loss_weight: 0.0
  max_margin_loss_param { margin: 1.0 norm: L2 } }
"""


def test_reference_style_prototxt_fused_matches_unfused():
    """The stack variant (NORMALIZATION distributed over a Stack, SLICE of
    a Stack back into its elements), and the role-major feed on it."""
    batch = _batch(seed=5, b=6, roles=8, d=40)
    n0, n1, p = _pair(REFERENCE_STYLE, "TRAIN", batch)
    l0, o0, g0 = _loss_grads(n0, p, batch)
    l1, o1, g1 = _loss_grads(n1, p, batch)
    assert l0 == l1
    _assert_grads_equal(g0, g1)
    # slice_emb, ctx_avg, the stack, its norm and slice, 4 prods, 4 sums,
    # neg_concat
    assert n1._last_absorbed == 14
    # the role-major feed: its SLICE(dim1) and CONCAT(dim0) absorb too
    assert n1.role_major_candidates(batch) == ["data"]
    n1.role_major_inputs = ("data",)
    rm = {"data": batch["data"].movedim(1, 0).contiguous()}
    l2, _, g2 = _loss_grads(n1, p, rm)
    assert n1._last_absorbed == 16
    assert l2 == l1
    _assert_grads_equal(g1, g2)
    # and JAX's fused Net on the same params
    jl, _, jg, jn = _jax_fused(REFERENCE_STYLE, "TRAIN", batch, p,
                               fuse_scoring=True)
    np.testing.assert_allclose(l1, jl, rtol=1e-6)
    _close_to_max(g1["fc7"]["w"].numpy(), jg["fc7"]["w"], 1e-6)


def test_generated_test_net_fused_matches_unfused():
    """The TEST phase (raw context frames averaged before the tower,
    RETRIEVAL_STATS on the normalized embedding) is untouched by the
    fusion: outputs equal."""
    rs = np.random.RandomState(6)
    tb = {"data": torch.as_tensor(rs.randn(8, 4, 48, 1).astype(np.float32)),
          "video_ids": torch.as_tensor(
              rs.randint(0, 50, (8,)).astype(np.float32))}
    side = {"retrieval_stats": IdToClassMap(np.arange(50), np.arange(50) % 5)}
    t0, t1, p = _pair(_emit(), "TEST", tb, side=side)
    _, o0 = t0.apply(p, tb)
    _, o1 = t1.apply(p, tb)
    assert sorted(o0) == sorted(o1) == ["test_hit1", "test_hit5", "test_map"]
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k


def test_partial_motif_falls_back():
    """A motif intermediate read by a layer that does not absorb: the symbol
    materializes there with the unfused values, and an unconsumed symbol
    is still a net output."""
    txt = """
name: "partial"
input: "data"
input_dim: 12 input_dim: 6
layers { name: "sl" type: SLICE bottom: "data" top: "a" top: "b"
         slice_param { slice_dim: 0 } }
layers { name: "na" type: NORMALIZATION bottom: "a" top: "an" }
layers { name: "nb" type: NORMALIZATION bottom: "b" top: "bn" }
layers { name: "pw" type: RELU bottom: "an" top: "an2" }
layers { name: "pr" type: ELTWISE bottom: "an" bottom: "bn" top: "p"
         eltwise_param { operation: PROD } }
layers { name: "sm" type: SUM bottom: "p" top: "s" }
layers { name: "el" type: SUM bottom: "an2" top: "l" loss_weight: 1.0 }
"""
    rs = np.random.RandomState(2)
    batch = {"data": torch.as_tensor(rs.randn(12, 6).astype(np.float32))}
    n0, n1, p = _pair(txt, "TRAIN", batch)
    l0, o0 = n0.apply(p, batch)
    l1, o1 = n1.apply(p, batch)
    assert l0.item() == l1.item()
    assert sorted(o0) == sorted(o1) == ["l", "s"]
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    assert n1._last_absorbed == 5


def test_inplace_rewrite_between_same_name_slices():
    """A blob sliced (dim0), rewritten IN PLACE, then sliced again under the
    same name: the second slice captures the rewritten value (versioned
    roots), the first keeps its capture; fused == unfused."""
    txt = """
name: "inplace_reslice"
input: "data"
input_dim: 12 input_dim: 6
layers { name: "s1" type: SLICE bottom: "data" top: "a" top: "b"
         slice_param { slice_dim: 0 } }
layers { name: "na" type: NORMALIZATION bottom: "a" top: "an" }
layers { name: "nb" type: NORMALIZATION bottom: "b" top: "bn" }
layers { name: "rl" type: RELU bottom: "data" top: "data" }
layers { name: "s2" type: SLICE bottom: "data" top: "c" top: "d"
         slice_param { slice_dim: 0 } }
layers { name: "nc" type: NORMALIZATION bottom: "c" top: "cn" }
layers { name: "nd" type: NORMALIZATION bottom: "d" top: "dn" }
layers { name: "p1" type: ELTWISE bottom: "an" bottom: "cn" top: "p"
         eltwise_param { operation: PROD } }
layers { name: "p2" type: ELTWISE bottom: "bn" bottom: "dn" top: "q"
         eltwise_param { operation: PROD } }
layers { name: "m1" type: SUM bottom: "p" top: "sp" }
layers { name: "m2" type: SUM bottom: "q" top: "sq" }
layers { name: "cat" type: CONCAT bottom: "sp" bottom: "sq" top: "spq"
         concat_param { concat_dim: 1 } }
layers { name: "el" type: SUM bottom: "spq" top: "l" loss_weight: 1.0 }
"""
    rs = np.random.RandomState(3)
    batch = {"data": torch.as_tensor(rs.randn(12, 6).astype(np.float32))}
    n0, n1, p = _pair(txt, "TRAIN", batch)
    l0, o0 = n0.apply(p, batch)
    l1, o1 = n1.apply(p, batch)
    assert l0.item() == l1.item()
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    # both SLICEs, the 4 norms, 2 products, 2 sums and the CONCAT
    assert n1._last_absorbed == 11


def test_role_major_feed_bit_equal():
    """Feeding the data blob role-major ((R, B, D, 1)) with
    role_major_inputs set: bit-equal to the normal feed (the SLICE(dim1) and
    CONCAT(dim0) absorb into a reshape; dropout masks drawn alike); the
    unfused Net takes the movedim view."""
    batch = _batch()
    rm = {"data": batch["data"].movedim(1, 0).contiguous()}
    n0, n1, p = _pair(_emit(), "TRAIN", batch)
    l0, _, g0 = _loss_grads(n1, p, batch)
    base = n1._last_absorbed
    n1.role_major_inputs = ("data",)
    l1, _, g1 = _loss_grads(n1, p, rm)
    assert l0 == l1
    _assert_grads_equal(g0, g1)
    assert n1._last_absorbed == base + 2
    n0.role_major_inputs = ("data",)
    l2, _, _ = _loss_grads(n0, p, rm)
    assert l2 == l0


def test_role_major_candidates():
    n = Net(parse(_emit()), "TRAIN")
    assert n.role_major_candidates(
        {"data": np.zeros((4, 10, 48, 1), np.float32)}) == ["data"]
    assert n.role_major_candidates(
        {"data": np.zeros((4, 9, 48, 1), np.float32)}) == []
    assert Net(parse(_emit()), "TRAIN", fuse_scoring=False) \
        .role_major_candidates({"data": np.zeros((4, 10, 48, 1))}) == []


def test_disable_env(monkeypatch):
    monkeypatch.setenv("VVTPU_DISABLE_FUSION", "1")
    assert not Net(parse(_emit(negatives=3)), "TRAIN").fuse_scoring
    monkeypatch.setenv("VVTPU_DISABLE_FUSION", "0")
    assert Net(parse(_emit(negatives=3)), "TRAIN").fuse_scoring


def test_prefix_runs_are_unfused():
    """max_layers (`time`'s prefix marginals) sees the per-layer graph."""
    batch = _batch()
    _, n1, p = _pair(_emit(), "TRAIN", batch)
    n1.apply(p, batch, generator=torch.Generator(), max_layers=30)
    assert n1._last_absorbed == 0


def test_unstable_prod_grad_declines_fusion():
    """ELTWISE PROD with stable_prod_grad: false keeps the reference's
    division backward (NaN at the ReLU's zeros), so those layers stay
    per-layer: the NaN pattern and every finite entry equal the unfused
    Net's, and fewer layers absorb than in the stable graph."""
    msg_txt = _emit(dropout=0.0)
    net = parse(msg_txt)
    flipped = 0
    for layer in net.get_list("layers"):
        ep = layer.get_msg("eltwise_param")
        if layer.get("type") == "ELTWISE" and ep.get("operation") == "PROD":
            ep.add("stable_prod_grad", False)
            flipped += 1
    assert flipped > 0
    batch = _batch()
    n0 = Net(net, "TRAIN", fuse_scoring=False)
    n1 = Net(net, "TRAIN")
    p, meta = n0.init(torch.Generator().manual_seed(0), batch)
    n1.param_meta = meta
    l0, _, g0 = _loss_grads(n0, p, batch)
    l1, _, g1 = _loss_grads(n1, p, batch)
    assert l0 == l1
    saw_nan = False
    for (_, a), (_, b) in zip(convert.leaves_with_paths(g0),
                              convert.leaves_with_paths(g1)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        saw_nan |= bool(torch.isnan(a).any())
        fin = ~torch.isnan(a)
        assert torch.equal(a[fin], b[fin])
    assert saw_nan
    stable = Net(parse(msg_txt), "TRAIN")
    stable.param_meta = meta
    _loss_grads(stable, p, batch)
    assert n1._last_absorbed < stable._last_absorbed


def test_l2n_feat_is_l2_normalize_rows_batched():
    """The batched normalization is the per-role one, zero rows included."""
    rs = np.random.RandomState(9)
    x = torch.as_tensor(rs.randn(5, 7, 11).astype(np.float32))
    x[2, 3] = 0.0
    got = _l2n_feat(x, rows_ndim=2)
    for k in range(5):
        assert torch.equal(got[k], l2_normalize_rows(x[k]))
    assert torch.equal(_l2n_feat(x[0]), l2_normalize_rows(x[0]))


def test_fusion_symbols_materialize_once():
    """Each symbol materializes once per apply (the cache)."""
    fz = ScoringFusion()
    x = torch.arange(12.0).reshape(4, 3)
    root = parse('layers { name: "s" type: SLICE bottom: "x" top: "a" '
                 'top: "b" slice_param { slice_dim: 0 } }')
    layer = root.get_list("layers")[0]
    assert fz.try_absorb(layer, {"x": x}, []) == ["a", "b"]
    a1, a2 = fz.materialize("a"), fz.materialize("a")
    assert a1 is a2 and torch.equal(a1, x[:2])
