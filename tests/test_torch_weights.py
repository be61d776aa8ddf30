""".caffemodel IO (videovector_tpu_torch.data.weights) against the JAX
package's data/weights.py on the CPU, and the .caffemodel reaching the
port's CLI and SolverDriver.

Params are drawn with numpy from a seed at the narrowed extraction net's
shapes (tests/test_torch_vision_net.py), plus LSTM layouts. A file written
by either package loads into the other's params exactly (float32 bytes are
copied, not computed), and re-encoding gives the same bytes.
"""

import numpy as np
import pytest
import torch

from test_torch_driver import FEAT, _solver, mini  # noqa: F401 - fixture
from test_torch_vision_net import (
    _extraction_batch, _random_params, extraction_net,
)
from videovector_tpu.config import parse as jparse
from videovector_tpu.data import weights as jw
from videovector_tpu.graph import Net as JNet
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import weights as tw
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.ops.hopper import matmul as k1
from videovector_tpu_torch.solver import driver as tdriver
from videovector_tpu_torch.tools import cli as tcli


@pytest.fixture(scope="module")
def net_params():
    """(the port's Net, its init params, seeded params of those shapes)."""
    batch = _extraction_batch()
    params = _random_params(JNet(jparse(extraction_net()), "TEST"), batch)
    tn = TNet(tparse(extraction_net()), "TEST")
    tp, _ = tn.init(torch.Generator(), batch)
    return tn, tp, params


def _assert_tree_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for lname in ref:
        assert sorted(got[lname]) == sorted(ref[lname]), lname
        for pname, r in ref[lname].items():
            g = got[lname][pname]
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, np.asarray(r),
                                          err_msg=f"{lname}/{pname}")


def test_jax_caffemodel_loads_into_the_port_as_into_jax(net_params, tmp_path):
    tn, tp, params = net_params
    path = str(tmp_path / "jax.caffemodel")
    jw.params_to_weights(params, name="med").save(path)
    ref = jw.load_into_params(jw.NetWeights.load(path), params)
    got = tw.load_into_params(tw.NetWeights.load(path), tp)
    _assert_tree_equal(got, ref)
    _assert_tree_equal(got, params)
    for lname, lp in got.items():
        for pname, t in lp.items():
            assert t.dtype == torch.float32 and t.is_contiguous(), lname
    # fc weights arrive transposed from Caffe's (N, K) and contiguous, so
    # that K1 takes its f32 route on them, not the core
    assert tuple(got["fc6"]["w"].shape) == (64, 32)
    assert got["fc6"]["w"].stride() == (32, 1)
    assert k1.k1_route(torch.zeros(2, 64), got["fc6"]["w"],
                       torch.float32) == "f32"
    # what the transpose alone would give: the core route
    assert k1.k1_route(torch.zeros(2, 64), torch.as_tensor(
        np.asarray(params["fc6"]["w"]).T.copy()).T, torch.float32) == "core"


def test_port_caffemodel_loads_into_jax(net_params, tmp_path):
    _, _, params = net_params
    tparams = convert.params_from_jax(params)
    path = str(tmp_path / "port.caffemodel")
    tw.params_to_weights(tparams, name="med").save(path)
    ref = jw.load_into_params(jw.NetWeights.load(path), params)
    _assert_tree_equal(ref, params)


def test_encodings_are_byte_equal(net_params):
    _, _, params = net_params
    jbytes = jw.params_to_weights(params, name="med").encode()
    tbytes = tw.params_to_weights(convert.params_from_jax(params),
                                  name="med").encode()
    assert tbytes == jbytes
    dec = tw.NetWeights.decode(jbytes)
    assert dec.name == "med"
    assert [l.name for l in dec.layers] == sorted(params)
    assert dec.encode() == jbytes
    assert tw.NetWeights.decode(jbytes).by_name()["conv2"].blobs[0].channels \
        == params["conv2"]["w"].shape[1]


def test_loaded_blobs_land_on_the_targets_device(net_params, tmp_path):
    _, tp, params = net_params
    path = str(tmp_path / "w.caffemodel")
    jw.params_to_weights(params).save(path)
    meta = convert.map_params(lambda t: t.to("meta"), tp)
    got = tw.load_into_params(tw.NetWeights.load(path), meta)
    assert got["conv1"]["w"].device.type == "meta"


def test_load_errors_match_jax(net_params, tmp_path):
    tn, tp, params = net_params
    w = jw.params_to_weights(params)
    # an extra blob (a bias for a bias_term: false layer) is refused
    w.by_name()["fc7"].blobs.append(w.by_name()["fc7"].blobs[-1])
    with pytest.raises(ValueError, match="2 params"):
        jw.load_into_params(w, params)
    with pytest.raises(ValueError, match="2 params"):
        tw.load_into_params(tw.NetWeights.decode(w.encode()), tp)
    # a shape the net does not have
    bad = dict(params, conv1={"w": np.zeros((8, 3, 5, 5), np.float32),
                              "b": params["conv1"]["b"]})
    data = jw.params_to_weights(bad).encode()
    with pytest.raises(ValueError):
        jw.load_into_params(jw.NetWeights.decode(data), params)
    with pytest.raises(ValueError):
        tw.load_into_params(tw.NetWeights.decode(data), tp)
    # strict: a layer the file lacks
    part = jw.params_to_weights({"conv1": params["conv1"]}).encode()
    with pytest.raises(KeyError, match="conv2"):
        tw.load_into_params(tw.NetWeights.decode(part), tp, strict=True)
    # not strict: the file's layers load, the others keep their params
    got = tw.load_into_params(tw.NetWeights.decode(part), tp)
    np.testing.assert_array_equal(got["conv1"]["w"].numpy(),
                                  params["conv1"]["w"])
    assert got["conv2"]["w"] is tp["conv2"]["w"]


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_lstm_blobs_round_trip_as_in_jax(cond, bias):
    rs = np.random.RandomState(4)
    i, h, o = 5, 3, 4
    lp = {"w_i": rs.randn(i, 4 * h), "w_h": rs.randn(h, 4 * h)}
    if cond:
        lp.update(w_o2h=rs.randn(o, 4 * h), w_h2o=rs.randn(h, o))
    if bias:
        lp["b"] = rs.randn(4 * h)
        if cond:
            lp.update(b_o2h=rs.randn(4 * h), b_h2o=rs.randn(o))
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    jbytes = jw.params_to_weights({"lstm": lp}).encode()
    tbytes = tw.params_to_weights(
        {"lstm": convert.params_from_jax(lp)}).encode()
    assert tbytes == jbytes
    blobs = tw.NetWeights.decode(jbytes).layers[0].blobs
    got = tw.lstm_blobs_to_params(blobs, lp)
    ref = jw.lstm_blobs_to_params(jw.NetWeights.decode(jbytes).layers[0].blobs,
                                  lp)
    _assert_tree_equal({"l": got}, {"l": ref})
    _assert_tree_equal({"l": got}, {"l": lp})
    loaded = tw.load_into_params(tw.NetWeights.decode(jbytes),
                                 {"lstm": convert.params_from_jax(lp)})
    _assert_tree_equal(loaded, {"lstm": lp})
    with pytest.raises(ValueError, match="blobs in the weights file"):
        tw.lstm_blobs_to_params(blobs[:-1], lp)


def test_cli_load_weights_reads_caffemodel_in_order(net_params, tmp_path):
    """--weights files apply in order: a later file's layers win, and a
    .caffemodel and a .vvmodel mix."""
    from videovector_tpu_torch.solver.checkpoint import snapshot
    _, tp, params = net_params
    first = str(tmp_path / "imagenet.caffemodel")
    jw.params_to_weights(params).save(first)
    second = snapshot(str(tmp_path / "task"), 0, {
        "fc7": {"w": np.full((32, 32), 0.5, np.float32),
                "b": np.zeros(32, np.float32)}})[0]
    p = tcli._load_weights(first, dict(tp), torch.device("cpu"))
    p = tcli._load_weights(second, p, torch.device("cpu"))
    np.testing.assert_array_equal(p["conv1"]["w"].numpy(),
                                  params["conv1"]["w"])
    np.testing.assert_array_equal(p["fc7"]["w"].numpy(), 0.5)


def test_driver_finetunes_from_caffemodel_as_from_vvmodel(mini, tmp_path):  # noqa: F811
    """SolverDriver.train(weights_path=<.caffemodel>) starts from the file's
    params, as it does from the same params in a .vvmodel, and as JAX's
    driver loads them."""
    from videovector_tpu.data.weights import params_to_weights
    from videovector_tpu_torch.solver.checkpoint import snapshot
    (_, tmsg) = _solver(mini, max_iter=0, test_interval=0, test_iter=None,
                        display=0)
    td = tdriver.SolverDriver(tmsg, device="cpu").build()
    rs = np.random.RandomState(6)
    pre = {"fc7": {"w": rs.randn(FEAT, 16).astype(np.float32),
                   "b": rs.randn(16).astype(np.float32)}}
    caffemodel = str(tmp_path / "pre.caffemodel")
    params_to_weights(pre).save(caffemodel)
    vvmodel = snapshot(str(tmp_path / "pre"), 0, pre)[0]
    a = td.train(weights_path=caffemodel).params
    b = td.train(weights_path=vvmodel).params
    _assert_tree_equal(a, pre)
    _assert_tree_equal(a, convert.params_to_numpy(b))


def test_cli_test_scores_a_caffemodel_as_its_vvmodel(mini):  # noqa: F811
    """`vvtpu-torch test --weights=x.caffemodel` gives the same outputs as
    the same params in a .vvmodel."""
    from test_torch_driver import Lines
    from videovector_tpu_torch.solver.checkpoint import load_model
    assert tcli.main(["train", "--solver", mini["solver"], "--cpu"]) == 0
    snap = str(mini["tmp"] / "snap_iter_10.vvmodel")
    caffemodel = str(mini["tmp"] / "snap.caffemodel")
    tw.params_to_weights(load_model(snap)).save(caffemodel)
    outs = []
    for weights in (snap, caffemodel):
        with Lines() as lines:
            assert tcli.main(["test", "--model", mini["net"], "--weights",
                              weights, "--iterations", "2", "--cpu"]) == 0
        outs.append([r.args for r in lines.records
                     if r.msg == "Batch %d, %s = %g"])
    assert outs[0] == outs[1] and len(outs[0]) == 6
