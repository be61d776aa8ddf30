"""The port's binary proto codec (videovector_tpu_torch.config.binproto,
proto_schema) and full NetParameter IO (data/netproto.py) against the JAX
package's, on the CPU.

The schema tables are equal; the flagship net, the repo's solver and the
extraction net encode to JAX's bytes and decode back; save_net from the
same params (tensors in the port, numpy in JAX) writes JAX's .caffemodel
bytes, diffs included, and load_net of either file gives the other
package's configs and blobs; the conditional LSTM's seven blobs round-trip.
Every comparison is exact: both packages move the same f32 bits.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_extract import project  # noqa: F401 - fixture
from videovector_tpu.config import binproto as jbin
from videovector_tpu.config import parse as jparse
from videovector_tpu.config import proto_schema as jschema
from videovector_tpu.data import netproto as jnet
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import binproto as tbin
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.config import proto_schema as tschema
from videovector_tpu_torch.config.textformat import Message, parse_file
from videovector_tpu_torch.data import netproto as tnet
from videovector_tpu_torch.data import weights as tweights

ROOT = Path(__file__).resolve().parent.parent
PROJECT = ROOT / "projects" / "videovec_embedding"

NET = """
name: "rt"
force_backward: true
layers { name: "d" type: MEMORY_DATA top: "x" }
layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "h"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  inner_product_param { num_output: 4 regularization: 0.99
    weight_filler { type: "gaussian" std: 0.01 } } }
layers { name: "r" type: RELU bottom: "h" top: "h"
  relu_param { negative_slope: 0.1 } }
layers { name: "conv" type: CONVOLUTION bottom: "x" top: "c"
  convolution_param { num_output: 2 kernel_size: 3 } }
layers { name: "drop" type: DROPOUT bottom: "h" top: "h"
  dropout_param { dropout_ratio: 0.9 } include: { phase: TRAIN } }
"""


def _emit(path: Path):
    spec = importlib.util.spec_from_file_location("gen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.emit


def _texts() -> dict:
    return {
        "flagship": _emit(PROJECT / "generate_net.py")("train_db", "test_db"),
        "extraction": _emit(PROJECT / "generate_extraction_net.py")(
            "images.txt", "mean.binaryproto"),
        "solver": (PROJECT / "mednet_embedding_train_solver.prototxt")
        .read_text(),
        "small": NET,
    }


def test_schema_tables_equal_jax():
    assert tschema.MESSAGES == jschema.MESSAGES
    assert tschema.ENUMS == jschema.ENUMS


@pytest.mark.parametrize("name", ["flagship", "extraction", "solver",
                                  "small"])
def test_binproto_bytes_equal_jax_and_decode_back(name):
    text = _texts()[name]
    kind = "SolverParameter" if name == "solver" else "NetParameter"
    tmsg, jmsg = tparse(text), jparse(text)
    data = tbin.encode(tmsg, kind)
    assert data == jbin.encode(jmsg, kind)
    back = tbin.decode(data, kind)
    assert back.dumps() == jbin.decode(data, kind).dumps()
    assert tbin.encode(back, kind) == data
    assert tbin.to_text(back, kind) == jbin.to_text(jbin.decode(data, kind),
                                                    kind)


def test_binproto_files_and_errors(tmp_path):
    msg = tparse(NET)
    path = str(tmp_path / "net.binaryproto")
    tbin.write_binary(path, msg, "NetParameter")
    assert jbin.read_binary(path, "NetParameter").dumps() == \
        tbin.read_binary(path, "NetParameter").dumps()
    with pytest.raises(ValueError, match="no field"):
        tbin.encode(tparse("no_such_field: 3"), "NetParameter")
    with pytest.raises(ValueError, match="unknown field number"):
        tbin.decode(b"\xf8\x3e\x01", "NetParameter")
    m = Message()
    m.add("name", "a\nb")
    assert tbin.to_text(m, "NetParameter") == jbin.to_text(m, "NetParameter")


def _params(rng) -> dict:
    return {"ip": {"w": rng.randn(5, 4).astype(np.float32),
                   "b": rng.randn(4).astype(np.float32)},
            "conv": {"w": rng.randn(2, 1, 3, 3).astype(np.float32),
                     "b": rng.randn(2).astype(np.float32)}}


@pytest.mark.parametrize("with_diffs", [False, True])
def test_save_net_bytes_equal_jax_and_load_net_reads_both(tmp_path, rng,
                                                          with_diffs):
    params = _params(rng)
    diffs = ({ln: {k: rng.randn(*v.shape).astype(np.float32)
                   for k, v in lp.items()} for ln, lp in params.items()}
             if with_diffs else None)
    tp = convert.params_from_jax(params)            # tensors in the port
    td = convert.params_from_jax(diffs) if diffs else None
    tpath, jpath = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tnet.save_net(tpath, tparse(NET), tp, diffs=td)
    jnet.save_net(jpath, jparse(NET), params, diffs=diffs)
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    tmsg, tw = tnet.load_net(jpath)
    jmsg, jw = jnet.load_net(tpath)
    assert tmsg.dumps() == jmsg.dumps() == tparse(NET).dumps()
    assert [l.name for l in tw.layers] == [l.name for l in jw.layers]
    for tl, jl in zip(tw.layers, jw.layers):
        for a, b in zip(tl.blobs, jl.blobs):
            assert a.encode() == b.encode()
    template = {ln: {k: torch.zeros(v.shape) for k, v in lp.items()}
                for ln, lp in params.items()}
    loaded = tweights.load_into_params(tw, template)
    got_diffs = tnet.diffs_from_weights(tw, template)
    for ln, lp in params.items():
        for k, v in lp.items():
            assert loaded[ln][k].numpy().tobytes() == v.tobytes()
            if with_diffs:
                assert got_diffs[ln][k].numpy().tobytes() == \
                    diffs[ln][k].tobytes()
    assert (got_diffs is None) == (not with_diffs)


def test_the_extraction_caffemodel_of_the_card_run_loads_in_jax(project):  # noqa: F811
    """The narrowed extraction net's full NetParameter (configs and blobs,
    tests/torch_extraction_net.py) written by the port loads in JAX with
    the same configs, and JAX's loads in the port with the same bits."""
    text = Path(project["net"]).read_text()
    params = project["params"]
    tpath = str(project["tmp"] / "full_t.caffemodel")
    jpath = str(project["tmp"] / "full_j.caffemodel")
    tnet.save_net(tpath, tparse(text), convert.params_from_jax(params))
    jnet.save_net(jpath, jparse(text), params)
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    _, tw = tnet.load_net(jpath)
    template = {ln: {k: torch.zeros(np.shape(v)) for k, v in lp.items()}
                for ln, lp in params.items()}
    got = tweights.load_into_params(tw, template)
    for ln, lp in params.items():
        for k, v in lp.items():
            assert got[ln][k].numpy().tobytes() == \
                np.asarray(v, np.float32).tobytes()


def test_conditional_lstm_caffemodel_round_trip(tmp_path, rng):
    """LSTM_CONDITIONAL's seven blobs (W_i, W_h, W_o2h, W_h2o, b, b_o2h,
    b_h2o) through the port's save_net and JAX's load_net, and back."""
    h, i, o = 6, 4, 5
    lp = {"w_i": rng.randn(i, 4 * h), "w_h": rng.randn(h, 4 * h),
          "w_o2h": rng.randn(o, 4 * h), "w_h2o": rng.randn(h, o),
          "b": rng.randn(4 * h), "b_o2h": rng.randn(4 * h),
          "b_h2o": rng.randn(o)}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    msg = 'layers { name: "dec" type: LSTM_CONDITIONAL bottom: "x" top: "y" }'
    tpath, jpath = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tnet.save_net(tpath, tparse(msg), {"dec": {k: torch.as_tensor(v)
                                               for k, v in lp.items()}})
    jnet.save_net(jpath, jparse(msg), {"dec": lp})
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    _, tw = tnet.load_net(jpath)
    assert len(tw.layers[0].blobs) == 7
    out = tweights.load_into_params(
        tw, {"dec": {k: torch.zeros(v.shape) for k, v in lp.items()}})
    for k, v in lp.items():
        assert out["dec"][k].numpy().tobytes() == v.tobytes(), k


def test_repo_solver_parses_from_binary(tmp_path):
    """A binary SolverParameter written by JAX reads in the port to the
    text file's message."""
    path = str(tmp_path / "solver.binaryproto")
    solver = PROJECT / "mednet_embedding_train_solver.prototxt"
    jbin.write_binary(path, jparse(solver.read_text()), "SolverParameter")
    assert tbin.read_binary(path, "SolverParameter").dumps() == \
        parse_file(str(solver)).dumps()
