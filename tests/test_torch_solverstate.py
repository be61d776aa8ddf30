"""The reference's .caffemodel/.solverstate pair in the port
(videovector_tpu_torch.data.netproto, solver/checkpoint.py's
export_caffe_snapshot and restore_solverstate) against the JAX package's,
on the CPU.

From the same numpy params and history both packages write the same bytes;
each package's restore_solverstate of the other's pair gives the writer's
arrays bit for bit; the hand-assembled SolverState of
tests/test_solverstate.py restores in the port; mismatches are as loud as
JAX's; and a solverstate that JAX's driver wrote resumes the port's driver
on the JAX trajectory (losses within 1e-5 relative, as the driver tests
hold the port's training).
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_driver import _losses, _solver, write_mini_project
from videovector_tpu.config import parse as jparse
from videovector_tpu.data import netproto as jnet
from videovector_tpu.solver import checkpoint as jckpt
from videovector_tpu.solver import driver as jdriver
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import netproto as tnet
from videovector_tpu_torch.data.wire import BlobProto
from videovector_tpu_torch.solver import checkpoint as tckpt
from videovector_tpu_torch.solver import driver as tdriver

torch.set_num_threads(1)

NET = """
layers { name: "data" type: MEMORY_DATA top: "x" }
layers { name: "conv" type: CONVOLUTION bottom: "x" top: "c" }
layers { name: "fc" type: INNER_PRODUCT bottom: "c" top: "f" }
layers { name: "emb" type: ID_TO_WEIGHT_MAPPING bottom: "f" top: "e" }
layers { name: "rnn" type: LSTM bottom: "e" top: "h" }
layers { name: "dec" type: LSTM_CONDITIONAL bottom: "h" top: "y" }
"""
ORDER = ["conv", "fc", "emb", "rnn", "dec"]


def _tree(rng) -> dict:
    """A param-shaped tree over every blob layout: conv OIHW, an
    INNER_PRODUCT (K, N), an embedding table, an LSTM and a conditional
    LSTM (with and without biases in turn)."""
    h, i, o = 3, 5, 2
    tree = {"conv": {"w": rng.randn(4, 2, 3, 3), "b": rng.randn(4)},
            "fc": {"w": rng.randn(6, 5), "b": rng.randn(5)},
            "emb": {"table": rng.randn(7, 5)},
            "rnn": {"w_i": rng.randn(i, 4 * h), "w_h": rng.randn(h, 4 * h),
                    "b": rng.randn(4 * h)},
            "dec": {"w_i": rng.randn(h, 4 * h), "w_h": rng.randn(h, 4 * h),
                    "w_o2h": rng.randn(o, 4 * h), "w_h2o": rng.randn(h, o)}}
    return {ln: {k: v.astype(np.float32) for k, v in lp.items()}
            for ln, lp in tree.items()}


def _bits(tree) -> dict:
    return {ln: {k: np.asarray(v, np.float32).tobytes() for k, v in lp.items()}
            for ln, lp in tree.items()}


def test_export_pair_is_byte_equal_to_jax(tmp_path, rng):
    params, history = _tree(rng), _tree(rng)
    t_model, t_state = tckpt.export_caffe_snapshot(
        str(tmp_path / "s"), 7, convert.params_from_jax(params),
        {"iter": 7, "history": convert.params_from_jax(history)},
        tparse(NET), ORDER)
    want = {p: Path(p).read_bytes() for p in (t_model, t_state)}
    j_model, j_state = jckpt.export_caffe_snapshot(
        str(tmp_path / "s"), 7, params, {"iter": np.int32(7),
                                         "history": history},
        jparse(NET), ORDER)
    assert (j_model, j_state) == (t_model, t_state)
    for p, data in want.items():
        assert Path(p).read_bytes() == data, p
    assert t_state.endswith("s_iter_7.solverstate")
    it, learned, blobs = tnet.load_solverstate(t_state)
    assert (it, learned) == (7, t_model)
    assert len(blobs) == 2 + 2 + 1 + 3 + 4


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_restores_the_others_pair(tmp_path, rng, writer):
    params, history = _tree(rng), _tree(rng)
    prefix = str(tmp_path / writer)
    if writer == "port":
        _, state = tckpt.export_caffe_snapshot(
            prefix, 12, convert.params_from_jax(params),
            {"iter": 12, "history": convert.params_from_jax(history)},
            tparse(NET), ORDER)
        template = jax.tree.map(np.zeros_like, params)
        got_p, got_s = jckpt.restore_solverstate(state, template, ORDER)
        got_p = jax.tree.map(np.asarray, got_p)
        got_h = jax.tree.map(np.asarray, got_s["history"])
    else:
        _, state = jckpt.export_caffe_snapshot(
            prefix, 12, params, {"iter": np.int32(12), "history": history},
            jparse(NET), ORDER)
        template = {ln: {k: torch.zeros(v.shape) for k, v in lp.items()}
                    for ln, lp in params.items()}
        got_p, got_s = tckpt.restore_solverstate(state, template, ORDER)
        assert all(isinstance(v, torch.Tensor) and v.is_contiguous()
                   for lp in got_p.values() for v in lp.values())
        got_h = got_s["history"]
    assert int(got_s["iter"]) == 12
    assert _bits(got_p) == _bits(params)
    assert _bits(got_h) == _bits(history)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _blob_bytes(num, channels, height, width, data: np.ndarray) -> bytes:
    """A BlobProto assembled by hand: num..width varints, packed f32 data."""
    buf = bytearray()
    for fnum, v in ((1, num), (2, channels), (3, height), (4, width)):
        buf += _varint((fnum << 3) | 0) + _varint(v)
    payload = np.asarray(data, "<f4").tobytes()
    buf += _varint((5 << 3) | 2) + _varint(len(payload)) + payload
    return bytes(buf)


def test_hand_assembled_solverstate_restores_in_the_port(tmp_path):
    """tests/test_solverstate.py's SolverState, written field by field per
    the proto2 wire format, with a learned_net named by its bare file name
    (found beside the solverstate): iter, weights and momentum, the
    INNER_PRODUCT (N, K) -> (K, N) transpose included."""
    rng = np.random.RandomState(0)
    w_caffe = rng.randn(6, 4).astype(np.float32)
    b_ref = rng.randn(6).astype(np.float32)
    hw_caffe = rng.randn(6, 4).astype(np.float32)
    hb = rng.randn(6).astype(np.float32)

    def layer_bytes(name, blobs):
        nm = name.encode()
        buf = bytearray(_varint((4 << 3) | 2) + _varint(len(nm)) + nm)
        for bb in blobs:
            buf += _varint((6 << 3) | 2) + _varint(len(bb)) + bb
        return bytes(buf)

    lb = layer_bytes("ip", [_blob_bytes(1, 1, 6, 4, w_caffe.reshape(-1)),
                            _blob_bytes(1, 1, 1, 6, b_ref)])
    (tmp_path / "foreign_iter_42.caffemodel").write_bytes(
        _varint((2 << 3) | 2) + _varint(len(lb)) + lb)
    ss = bytearray(_varint((1 << 3) | 0) + _varint(42))
    name = b"/elsewhere/foreign_iter_42.caffemodel"
    ss += _varint((2 << 3) | 2) + _varint(len(name)) + name
    for bb in (_blob_bytes(1, 1, 6, 4, hw_caffe.reshape(-1)),
               _blob_bytes(1, 1, 1, 6, hb)):
        ss += _varint((3 << 3) | 2) + _varint(len(bb)) + bb
    state_path = tmp_path / "foreign_iter_42.solverstate"
    state_path.write_bytes(bytes(ss))
    template = {"ip": {"w": torch.zeros(4, 6), "b": torch.zeros(6)}}
    params, state = tckpt.restore_solverstate(str(state_path), template,
                                              ["ip"])
    assert state["iter"] == 42
    np.testing.assert_array_equal(params["ip"]["w"].numpy(), w_caffe.T)
    np.testing.assert_array_equal(params["ip"]["b"].numpy(), b_ref)
    np.testing.assert_array_equal(state["history"]["ip"]["w"].numpy(),
                                  hw_caffe.T)
    np.testing.assert_array_equal(state["history"]["ip"]["b"].numpy(), hb)


@pytest.mark.parametrize("case,error", [
    ("too_few_blobs", "mismatch"), ("too_many_blobs", "mismatch"),
    ("absent_layer", "absent"), ("missing_model", "does not exist")])
def test_mismatches_are_loud_as_in_jax(tmp_path, case, error):
    blob = BlobProto(num=1, channels=1, height=2, width=3,
                     data=np.zeros(6, np.float32))
    template = {"ip": {"w": torch.zeros(3, 2), "b": torch.zeros(2)}}
    jtemplate = {"ip": {"w": np.zeros((3, 2), np.float32),
                        "b": np.zeros(2, np.float32)}}
    bias = BlobProto(num=1, channels=1, height=1, width=2,
                     data=np.zeros(2, np.float32))
    if case == "missing_model":
        tnet.save_solverstate(str(tmp_path / "s.solverstate"), 3,
                              {"ip": {"w": np.zeros((3, 2), np.float32),
                                      "b": np.zeros(2, np.float32)}},
                              str(tmp_path / "gone.caffemodel"), ["ip"])
        for mod, tmpl in ((tckpt, template), (jckpt, jtemplate)):
            with pytest.raises(FileNotFoundError, match=error):
                mod.restore_solverstate(str(tmp_path / "s.solverstate"),
                                        tmpl, ["ip"])
        return
    blobs = {"too_few_blobs": [blob], "too_many_blobs": [blob, bias, bias],
             "absent_layer": [blob, bias]}[case]
    order = ["ip", "nope"] if case == "absent_layer" else ["ip"]
    exc = KeyError if case == "absent_layer" else ValueError
    for fn, tmpl in ((tnet.history_from_blobs, template),
                     (jnet.history_from_blobs, jtemplate)):
        with pytest.raises(exc, match=error):
            fn(blobs, tmpl, order)
    with pytest.raises(KeyError, match="absent"):
        tnet.save_solverstate(str(tmp_path / "x"), 1, template, "m", ["nope"])


def test_a_jax_written_solverstate_resumes_the_ports_driver(tmp_path):
    """JAX's driver trains the mini project 4 iterations with
    snapshot_format: "caffe"; both drivers resume from its iteration-2
    .solverstate to 6: the port's losses within 1e-5 of JAX's."""
    mini = write_mini_project(tmp_path)
    fields = dict(max_iter=4, snapshot=2, test_interval=0, test_iter=None,
                  snapshot_format="caffe")
    jmsg, _ = _solver(mini, **fields)
    jdriver.SolverDriver(jmsg).build().train()
    state = str(mini["tmp"] / "snap_iter_2.solverstate")
    assert os.path.exists(state)
    more = dict(fields, max_iter=6, snapshot=0)
    jmsg, tmsg = _solver(mini, **more)
    tres = tdriver.SolverDriver(tmsg, device="cpu").build().train(
        resume_state_path=state)
    jres = jdriver.SolverDriver(jmsg).build().train(resume_state_path=state)
    assert [i for i, _ in tres.metrics_history] == [2, 3, 4, 5]
    np.testing.assert_allclose(_losses(tres), _losses(jres), rtol=1e-5)
    np.testing.assert_allclose(tres.params["fc7"]["w"].numpy(),
                               np.asarray(jres.params["fc7"]["w"]),
                               rtol=1e-5, atol=1e-6)
