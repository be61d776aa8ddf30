"""The port's remaining Caffe layer types (graph/layers.py: the loss zoo,
ACCURACY, ARGMAX, MVN, ID_TO_WEIGHT_MAPPING, CLASSIFICATION_STATS and
DUMMY_DATA) and their ops against the JAX package's on the CPU.

Each net is parsed by each package's own parser and fed the same seeded
numpy inputs; weights are carried across from JAX with
`convert.params_from_jax`. Every blob and every gradient of the loss (the
params' and the float inputs') is held within rtol 1e-5 and atol 1e-6 of
JAX's, in f32; the integer-valued tops (ARGMAX's indices, ACCURACY) are
equal. DUMMY_DATA's random fills cannot match threefry, so they are held to
their shape, their statistics and their refill rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kitchen_sink_net import NET as KITCHEN_SINK_NET

from videovector_tpu import ops as jops
from videovector_tpu.config import parse as jparse
from videovector_tpu.data.wire import BlobProto
from videovector_tpu.graph import Net as JNet
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.ops import embedding as temb
from videovector_tpu_torch.ops import normalization as tnorm

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
N, K, C = 8, 5, 6          # rows, input width, classes

ZOO = """
name: "zoo"
layers { name: "d" type: MEMORY_DATA top: "x" top: "label" top: "t" }
layers { name: "pairs" type: MEMORY_DATA top: "a" top: "b" top: "sim"
  top: "ids" top: "img" top: "img_t" }
layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "s"
  inner_product_param { num_output: 6
    weight_filler { type: "gaussian" std: 0.5 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "sm_loss" type: SOFTMAX_LOSS bottom: "s" bottom: "label"
  top: "l_sm" loss_weight: 0.5 }
layers { name: "acc" type: ACCURACY bottom: "s" bottom: "label" top: "acc"
  accuracy_param { top_k: 2 } }
layers { name: "hinge" type: HINGE_LOSS bottom: "s" bottom: "label"
  top: "l_hinge" hinge_loss_param { norm: L2 } }
layers { name: "prob" type: SOFTMAX bottom: "s" top: "prob" }
layers { name: "mll" type: MULTINOMIAL_LOGISTIC_LOSS bottom: "prob"
  bottom: "label" top: "l_mll" }
layers { name: "ig" type: INFOGAIN_LOSS bottom: "prob" bottom: "label"
  top: "l_ig" infogain_loss_param { source: "%(infogain)s" } }
layers { name: "sce" type: SIGMOID_CROSS_ENTROPY_LOSS bottom: "s" bottom: "t"
  top: "l_sce" loss_weight: 2.0 }
layers { name: "euc" type: EUCLIDEAN_LOSS bottom: "s" bottom: "t"
  top: "l_euc" }
layers { name: "con" type: CONTRASTIVE_LOSS bottom: "a" bottom: "b"
  bottom: "sim" top: "l_con" contrastive_loss_param { margin: 1.5 } }
layers { name: "am" type: ARGMAX bottom: "s" top: "am"
  argmax_param { top_k: 3 out_max_val: true } }
layers { name: "cs" type: CLASSIFICATION_STATS bottom: "s" bottom: "label"
  top: "pc_acc" top: "pc_ap" top: "c_acc"
  classification_stats_param { num_classes: 6 } }
layers { name: "emb" type: ID_TO_WEIGHT_MAPPING bottom: "ids" top: "w"
  id_to_weight_mapping_param { max_ids: 7 num_output: 4
    weight_filler { type: "gaussian" std: 1.0 } } }
layers { name: "euc_emb" type: EUCLIDEAN_LOSS bottom: "w" bottom: "a"
  top: "l_emb" euclidean_loss_param { l1: true } }
layers { name: "mvn" type: MVN bottom: "img" top: "m"
  mvn_param { across_channels: true } }
layers { name: "euc_mvn" type: EUCLIDEAN_LOSS bottom: "m" bottom: "img_t"
  top: "l_mvn" }
"""


def _zoo_batch(rs):
    return {
        "x": rs.randn(N, K).astype(np.float32),
        "label": rs.randint(0, C, N).astype(np.float32),
        "t": rs.rand(N, C).astype(np.float32),
        "a": rs.randn(N, 4).astype(np.float32),
        "b": rs.randn(N, 4).astype(np.float32),
        "sim": rs.randint(0, 2, N).astype(np.float32),
        "ids": rs.randint(0, 7, N).astype(np.float32),
        "img": rs.randn(2, 3, 4, 5).astype(np.float32),
        "img_t": rs.randn(2, 3, 4, 5).astype(np.float32),
    }


def _write_infogain(path, rs, c=C):
    with open(path, "wb") as f:
        f.write(BlobProto.from_array(
            rs.rand(1, 1, c, c).astype(np.float32)).encode())


def _run_both(txt, batch, grad_keys=(), phase="TRAIN"):
    """(JAX's loss, blobs, param grads, input grads), then the port's."""
    jn, tn = JNet(jparse(txt), phase), TNet(tparse(txt), phase)
    jp, _ = jn.init(jax.random.PRNGKey(0), {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    tn.init(torch.Generator().manual_seed(0), batch)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p, g):
        return jn.apply(p, {**jb, **g})[0]
    jl, blobs = jn.apply(jp, jb, return_blobs=True)
    jgp, jgi = jax.grad(jloss, argnums=(0, 1))(
        jp, {k: jb[k] for k in grad_keys})

    tb = {k: torch.tensor(v, requires_grad=k in grad_keys)
          for k, v in batch.items()}
    for lp in tp.values():
        for v in lp.values():
            v.requires_grad_(True)
    tl, tblobs = tn.apply(tp, tb, return_blobs=True)
    if tl.requires_grad:
        tl.backward()
    return ((jl, blobs, jgp, jgi),
            (tl, tblobs, {ln: {k: v.grad for k, v in lp.items()}
                          for ln, lp in tp.items()},
             {k: tb[k].grad for k in grad_keys}))


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def test_layer_zoo_net_matches_jax(tmp_path, rng):
    """Every loss of the zoo with its loss_weight, ACCURACY, ARGMAX,
    CLASSIFICATION_STATS, ID_TO_WEIGHT_MAPPING and MVN in one TRAIN net:
    the loss, every blob and every gradient."""
    ig = str(tmp_path / "infogain.binaryproto")
    _write_infogain(ig, rng)
    batch = _zoo_batch(rng)
    (jl, jblobs, jgp, jgi), (tl, tblobs, tgp, tgi) = _run_both(
        ZOO % {"infogain": ig}, batch, grad_keys=("x", "a", "b", "img"))
    _close(tl, jl, "loss")
    assert sorted(tblobs) == sorted(jblobs)
    for k in jblobs:
        _close(tblobs[k], jblobs[k], k)
    for k in ("acc", "am", "pc_acc", "c_acc"):
        np.testing.assert_array_equal(tblobs[k].detach().numpy(),
                                      np.asarray(jblobs[k]), err_msg=k)
    for ln, lp in jgp.items():
        for k, g in lp.items():
            _close(tgp[ln][k], g, f"d{ln}/{k}")
    for k, g in jgi.items():
        _close(tgi[k], g, f"d{k}")


def test_kitchen_sink_net_matches_jax(rng):
    """tests/test_kitchen_sink_net.py's net (the neuron and glue types with
    MVN and ARGMAX): every blob."""
    batch = {"x": rng.randn(3, 6).astype(np.float32),
             "x4": rng.randn(2, 3, 4, 5).astype(np.float32)}
    (_, jblobs, _, _), (_, tblobs, _, _) = _run_both(KITCHEN_SINK_NET, batch)
    assert sorted(tblobs) == sorted(jblobs)
    for k in jblobs:
        _close(tblobs[k], jblobs[k], k)


@pytest.mark.parametrize("normalize_variance", [True, False])
@pytest.mark.parametrize("across_channels", [False, True])
def test_mvn_matches_jax(rng, normalize_variance, across_channels):
    x = rng.randn(2, 3, 4, 5).astype(np.float32) * 3 + 1
    g = rng.randn(2, 3, 4, 5).astype(np.float32)
    kw = dict(normalize_variance=normalize_variance,
              across_channels=across_channels)
    jv, vjp = jax.vjp(lambda x: jops.mvn(x, **kw), jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = tnorm.mvn(tx, **kw)
    tv.backward(torch.as_tensor(g))
    _close(tv, jv, "mvn")
    _close(tx.grad, vjp(jnp.asarray(g))[0], "dmvn")
    with pytest.raises(ValueError, match="NCHW"):
        tnorm.mvn(torch.zeros(2, 3))


ARGMAX = """
layers { name: "d" type: MEMORY_DATA top: "x" }
layers { name: "am" type: ARGMAX bottom: "x" top: "y"
  argmax_param { top_k: %d out_max_val: %s } }
"""


@pytest.mark.parametrize("top_k", [1, 3, 6])
@pytest.mark.parametrize("out_max_val", ["false", "true"])
def test_argmax_ties_rank_the_larger_index_first(top_k, out_max_val):
    """Rows with ties: the reference's std::greater over (value, index)
    pairs ranks the larger index first, in both packages."""
    x = np.array([[1, 1, 1, 1, 1, 1], [0, 2, 2, 0, 2, 1],
                  [3, 3, 1, 1, 0, 3]], np.float32).reshape(3, 2, 3)
    txt = ARGMAX % (top_k, out_max_val)
    (_, jb, _, _), (_, tb, _, _) = _run_both(txt, {"x": x})
    np.testing.assert_array_equal(tb["y"].numpy(), np.asarray(jb["y"]))
    assert tb["y"].shape == (3, 2 if out_max_val == "true" else 1, top_k, 1)
    if top_k == 3:
        np.testing.assert_array_equal(tb["y"].numpy()[:, 0, :, 0],
                                      [[5, 4, 3], [4, 2, 1], [5, 1, 0]])


@pytest.mark.parametrize("top_k", [0, 7])
def test_argmax_top_k_outside_the_row_raises(top_k):
    x = {"x": torch.zeros(2, 6)}
    with pytest.raises(ValueError, match="top_k"):
        TNet(tparse(ARGMAX % (top_k, "false")), "TEST").apply({}, x)


def test_id_to_weight_lookup_matches_jax(rng):
    """In-range ids gather, ids in [-n, 0) count from the end, others give
    NaN rows and no gradient: values and the table's gradient."""
    table = rng.randn(5, 3).astype(np.float32)
    ids = np.array([0, 4, -1, -5, 5, -6, 2.7, 2], np.float32)
    g = rng.randn(8, 3).astype(np.float32)
    jv, vjp = jax.vjp(lambda t: jops.id_to_weight_lookup(jnp.asarray(ids), t),
                      jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    tv = temb.id_to_weight_lookup(torch.as_tensor(ids), tt)
    np.testing.assert_array_equal(np.isnan(tv.detach().numpy()),
                                  np.isnan(np.asarray(jv)))
    _close(tv, jv, "lookup")
    tv.backward(torch.as_tensor(g))
    _close(tt.grad, vjp(jnp.asarray(g))[0], "dtable")
    assert np.isnan(tv.detach().numpy()[[4, 5]]).all()


DUMMY = """
layers { name: "dummy" type: DUMMY_DATA top: "c" top: "g"
  dummy_data_param { num: 4 channels: 3 height: 2 width: 5
    num: 64 channels: 32 height: 1 width: 1
    data_filler { type: "constant" value: 0.75 }
    data_filler { type: "gaussian" mean: 1.0 std: 2.0 } } }
layers { name: "d" type: MEMORY_DATA top: "x" }
layers { name: "ip" type: INNER_PRODUCT bottom: "g" top: "y"
  inner_product_param { num_output: 2 weight_filler { type: "gaussian" } } }
layers { name: "euc" type: EUCLIDEAN_LOSS bottom: "y" bottom: "x" top: "l" }
"""


def test_dummy_data_constant_fills_equal_jax():
    x = {"x": np.zeros((64, 2), np.float32)}
    jn, tn = JNet(jparse(DUMMY), "TRAIN"), TNet(tparse(DUMMY), "TRAIN")
    jp, _ = jn.init(jax.random.PRNGKey(0), {
        "x": jax.ShapeDtypeStruct((64, 2), jnp.float32)})
    tp, _ = tn.init(torch.Generator().manual_seed(0), x)
    assert tp["ip"]["w"].shape == (32, 2)
    _, jb = jn.apply(jp, {"x": jnp.asarray(x["x"])}, return_blobs=True)
    for gen in (None, torch.Generator().manual_seed(3)):
        _, tb = tn.apply(tp, {"x": torch.as_tensor(x["x"])}, generator=gen,
                         return_blobs=True)
        np.testing.assert_array_equal(tb["c"].numpy(), np.asarray(jb["c"]))
        assert tb["g"].shape == jb["g"].shape == (64, 32, 1, 1)


def test_dummy_data_gaussian_refills_on_every_forward():
    """The gaussian top: its statistics; a new fill for each step generator
    (train reseeds it every iteration), the same fill for the same seed and
    without a generator; the layer's name salts the stream."""
    tn = TNet(tparse(DUMMY), "TRAIN")
    x = {"x": torch.zeros(64, 2)}
    tp, _ = tn.init(torch.Generator().manual_seed(0), x)

    def fill(gen, net=tn):
        return net.apply(tp, x, generator=gen, return_blobs=True)[1]["g"]

    draws = [fill(torch.Generator().manual_seed(s)) for s in (1, 2, 1)]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[0], draws[2])
    assert torch.equal(fill(None), fill(None))
    assert abs(draws[0].mean().item() - 1.0) < 0.2
    assert abs(draws[0].std().item() - 2.0) < 0.2
    renamed = TNet(tparse(DUMMY.replace('name: "dummy"', 'name: "dummy2"')),
                   "TRAIN")
    assert not torch.equal(fill(torch.Generator().manual_seed(1), renamed),
                           draws[0])


def test_infogain_matrix_is_read_from_its_blobproto(tmp_path, rng):
    path = str(tmp_path / "h.binaryproto")
    _write_infogain(path, rng, c=4)
    txt = f"""
    layers {{ name: "d" type: MEMORY_DATA top: "p" top: "y" }}
    layers {{ name: "ig" type: INFOGAIN_LOSS bottom: "p" bottom: "y"
      top: "l" infogain_loss_param {{ source: "{path}" }} }}
    """
    tn = TNet(tparse(txt), "TRAIN")
    h = BlobProto.decode(open(path, "rb").read()).to_array().reshape(4, 4)
    np.testing.assert_array_equal(tn.side["ig"].numpy(), h)
    p = rng.rand(3, 4).astype(np.float32)
    y = np.array([0, 3, 1], np.float32)
    (jl, _, _, _), (tl, _, _, _) = _run_both(txt, {"p": p, "y": y})
    _close(tl, jl, "infogain")
    two_bottoms = txt.replace(f'source: "{path}"', "")
    for net_cls, parse in ((JNet, jparse), (TNet, tparse)):
        with pytest.raises(ValueError, match="needs infogain_loss_param"):
            net_cls(parse(two_bottoms), "TRAIN")
