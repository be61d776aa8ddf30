"""The multi-device serving artifact (tools/serving.py: export_serving(mesh=),
mesh_serving, `export --mesh`) over gloo ranks on the CPU, against the
port's one-device artifacts and the JAX package's mesh artifacts.

The nets: JAX's 16 -> 8 deploy net (tests/test_e2e.py's
test_serving_tensor_parallel_export: INNER_PRODUCT, NORMALIZATION), a
two-conv net (its 4-D weights replicated, its fc column-sharded) and
tests/test_torch_serving.py's stateful LSTM net (time-major blobs, batch
on axis 1, state:* carries on axis 0). At 2 x 2 the deploy and conv
artifacts are within 1e-5 of JAX's 2 x 2 artifacts and of the port's
one-device ones, int8 x 2 x 2 within 1e-5 of int8 on one device, bf16 x
symbolic_batch x 2 x 2 serves 4 and 16 rows; the LSTM artifact at 1 x 2
and 2 x 2 threads its carry as the one-device artifact does. A 4-rank
group refuses a 2-device artifact, `run --mesh`, shard_serving, a batch
the data axis does not divide, the call outside mesh_serving, a group
name of no axis and a program exported on another device. A process that
made other groups first binds the artifact's group names to its own
groups. `export --mesh 1x2` and `run` launch through
torch.distributed.run.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from videovector_tpu.parallel import make_mesh as jmake_mesh
from videovector_tpu.tools import serving as jserving
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.solver.checkpoint import snapshot
from videovector_tpu_torch.tools import serving as tserving

ROOT = Path(__file__).resolve().parent.parent

DEPLOY = """
name: "deploy"
input: "data"
input_dim: 4 input_dim: 1 input_dim: 16 input_dim: 1
layers { name: "ip" type: INNER_PRODUCT bottom: "data" top: "out"
  inner_product_param { num_output: 8 weight_filler { type: "xavier" } } }
layers { name: "norm" type: NORMALIZATION bottom: "out" top: "outn" }
"""

CONV = """
name: "conv"
input: "x"
input_dim: 4 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "c1" type: CONVOLUTION bottom: "x" top: "h1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "r1" type: RELU bottom: "h1" top: "h1" }
layers { name: "c2" type: CONVOLUTION bottom: "h1" top: "h2"
  convolution_param { num_output: 6 kernel_size: 3 stride: 2 pad: 1
    weight_filler { type: "gaussian" std: 0.3 } } }
layers { name: "r2" type: RELU bottom: "h2" top: "h2" }
layers { name: "fc" type: INNER_PRODUCT bottom: "h2" top: "out"
  inner_product_param { num_output: 8 weight_filler { type: "xavier" }
    bias_filler { type: "constant" value: 0.05 } } }
"""

# the stats layers gather their bottoms' whole batch over "data" inside
# the program (graph/layers.py::_whole_batch)
STATS = """
name: "stats"
input: "data"
input_dim: 4 input_dim: 1 input_dim: 16 input_dim: 1
input: "label"
input_dim: 4 input_dim: 1 input_dim: 1 input_dim: 1
layers { name: "ip" type: INNER_PRODUCT bottom: "data" top: "out"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layers { name: "cls" type: CLASSIFICATION_STATS bottom: "out"
  bottom: "label" top: "per_class_accuracy" top: "per_class_ap"
  top: "accuracy" }
"""
STATS_TOPS = ["out", "per_class_accuracy", "per_class_ap", "accuracy"]

TOL = 1e-5


def _rows(seed, n, shape):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def _weights(tmp, name, text, feed):
    path = tmp / f"{name}.prototxt"
    path.write_text(text)
    params, _ = TNet(tparse(text), "TEST").init(
        torch.Generator().manual_seed(3), feed)
    weights, _ = snapshot(str(tmp / f"{name}_w"), 1, params)
    return str(path), weights


def _lstm_net(tmp):
    """tests/test_torch_serving.py's stateful LSTM net over a tracking
    store (batch 6, T 5 + 2): its path, weights and 3 batches."""
    from test_project_trajectory import _write_data
    from videovector_tpu_torch.graph.data_factory import (
        MergedSource, make_data_source,
    )
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    train, _ = _write_data(tmp, np.random.RandomState(0), t_obs=5, t_pred=2)
    text = f"""
    name: "lstm_serve"
    layers {{ name: "d" type: TRACKING_WINDOWS_DATA
      top: "observed" top: "cont_obs" top: "predicted" top: "cont_pred"
      top: "gt"
      tracking_windows_data_param {{ source: "{train}" batch_size: 6
        temporal_observed_size: 5 temporal_predicted_size: 2 }} }}
    layers {{ name: "enc" type: LSTM bottom: "observed" bottom: "cont_obs"
      top: "h" inner_product_param {{ num_output: 10
        weight_filler {{ type: "gaussian" std: 0.2 }} }} }}
    layers {{ name: "sil1" type: SILENCE bottom: "predicted" }}
    layers {{ name: "sil2" type: SILENCE bottom: "cont_pred" }}
    layers {{ name: "sil3" type: SILENCE bottom: "gt" }}
    """
    net = TNet(tparse(text), "TEST")
    src = MergedSource([make_data_source(l, phase="TEST") for l in net.layers
                        if l.get("type") in DATA_LAYER_TYPES])
    batches = [{k: np.asarray(v, np.float32)
                for k, v in src.next_batch().items()} for _ in range(3)]
    path, weights = _weights(tmp, "lstm", text, batches[0])
    return path, weights, batches


def _one_device(net, weights, blobs, out, batches, **kw):
    """The port's one-device artifact on each batch, its state carried
    from zeros."""
    tserving.export_serving(net, [weights], blobs, out, platforms=["cpu"],
                            **kw)
    call, meta = tserving.load_serving(out)
    outs = []
    state = {k: np.zeros(meta["inputs"][k][0], np.float32)
             for k in meta["state"]}
    for b in batches:
        got = call({**b, **state})
        state = {k: got[k] for k in meta["state"]}
        outs.append({k: v.float().numpy() for k, v in got.items()})
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_serving")
    deploy, deploy_w = _weights(tmp, "deploy", DEPLOY,
                                {"data": _rows(0, 4, (1, 16, 1))})
    conv, conv_w = _weights(tmp, "conv", CONV, {"x": _rows(0, 4, (3, 8, 8))})
    stats, stats_w = _weights(tmp, "stats", STATS,
                              {"data": _rows(0, 4, (1, 16, 1)),
                               "label": np.zeros((4, 1, 1, 1), np.float32)})
    lstm, lstm_w, lstm_batches = _lstm_net(tmp)
    calib = [{"data": _rows(i, 4, (1, 16, 1))} for i in range(3)]
    d4 = [{"data": _rows(9, 4, (1, 16, 1))}]
    sym = [{"data": _rows(2, n, (1, 16, 1))} for n in (4, 16)]
    c4 = [{"x": _rows(5, 4, (3, 8, 8))}]
    s4 = [{"data": _rows(7, 4, (1, 16, 1)), "label": np.array(
        [2, 0, 3, 1], np.float32).reshape(4, 1, 1, 1)}]
    art = {k: str(tmp / f"{k}.vvtserve") for k in (
        "f32", "int8", "bf16_sym", "conv", "stats", "lstm_1x2", "lstm_2x2")}
    specs = {
        "f32": (deploy, deploy_w, ["outn"], d4, {}),
        "int8": (deploy, deploy_w, ["outn"], d4,
                 dict(quantize="int8", calib_data=calib)),
        "bf16_sym": (deploy, deploy_w, ["outn"], sym,
                     dict(compute_dtype="bfloat16", symbolic_batch=True)),
        "conv": (conv, conv_w, ["out"], c4, {}),
        "stats": (stats, stats_w, STATS_TOPS, s4, {}),
        "lstm_2x2": (lstm, lstm_w, ["h"], lstm_batches, {}),
    }

    def case(name, spec, data_n, model_n):
        net, w, blobs, batches, kw = spec
        return ("serve_mesh", dict(net=net, weights=w, blobs=blobs,
                                   out=art[name], data_n=data_n,
                                   model_n=model_n, batches=batches, kw=kw))
    two = cases.run(2, [case("lstm_1x2", specs["lstm_2x2"], 1, 2)], tmp,
                    timeout=120)
    four = cases.run(4, [case(k, v, 2, 2) for k, v in specs.items()] + [
        ("mesh_refusals", dict(artifact=art["f32"],
                               two_device=art["lstm_1x2"], batch=d4[0]))],
        tmp, timeout=180)
    rebound = cases.run(4, [("mesh_rebound", dict(
        artifact=art["stats"], batches=s4, extra_groups=3))], tmp,
        timeout=120)
    one = {k: _one_device(net, w, blobs, str(tmp / f"one_{k}.vvtserve"),
                          batches, **kw)
           for k, (net, w, blobs, batches, kw) in specs.items()}
    jmesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    jax_out, jax_meta = {}, {}
    for k in ("f32", "conv", "stats"):
        net, w, blobs, batches, _ = specs[k]
        path = str(tmp / f"jax_{k}.vvserve")
        jax_meta[k] = jserving.export_serving(net, [w], blobs, path,
                                              platforms=["cpu"], mesh=jmesh)
        call, meta = jserving.load_serving(path)
        jax_out[k] = {n: np.asarray(v) for n, v in jserving.mesh_serving(
            call, meta)(batches[0]).items()}
    return {"two": two, "four": four, "rebound": rebound, "one": one,
            "jax": jax_out, "jax_meta": jax_meta, "specs": specs,
            "names": list(specs), "art": art, "tmp": tmp}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["f32", "conv", "stats"])
def test_2x2_artifact_matches_jaxs_mesh_artifact_and_one_device(ranks,
                                                                name):
    i = ranks["names"].index(name)
    for blob in ranks["specs"][name][2]:
        want_one = ranks["one"][name][0][blob]
        want_jax = np.asarray(ranks["jax"][name][blob], np.float32)
        for r in ranks["four"]:
            got = r[i]["outs"][0][blob]
            assert got.shape == want_one.shape
            _close(got, want_one)
            _close(got, want_jax)
    meta, jmeta = ranks["four"][0][i]["meta"], ranks["jax_meta"][name]
    assert {k: meta[k] for k in jmeta} == jmeta
    assert meta["mesh"] == {"data": 2, "model": 2}
    assert meta["nr_devices"] == 4
    assert meta["groups"] == {"mesh:data": "data", "mesh:model": "model"}
    assert meta["devices"] == ["cpu"] * 4
    # the programs gather over "data" only where the Net does (the stats
    # layer's whole batch): mesh_serving cuts the rows and gathers outputs
    for r in ranks["four"]:
        assert r[i]["stored"] == (["mesh:data", "mesh:model"]
                                  if name == "stats" else ["mesh:model"])
    assert all(r[i]["meta"] == meta for r in ranks["four"])
    assert ranks["four"][0][i]["loaded"] == meta
    assert tserving.read_meta(ranks["art"][name])["payload_bytes"] == \
        sum(meta["payloads"])


def test_int8_2x2_equals_int8_on_one_device(ranks):
    i = ranks["names"].index("int8")
    want = ranks["one"]["int8"][0]["outn"]
    for r in ranks["four"]:
        _close(r[i]["outs"][0]["outn"], want)
        assert r[i]["meta"]["quantize"] == "int8"
    # the quantized fc computes whole from the replicated table: no
    # column shards, so no program holds a collective
    assert all(r[i]["stored"] == [] for r in ranks["four"])


def test_bf16_symbolic_2x2_serves_4_and_16_rows(ranks):
    i = ranks["names"].index("bf16_sym")
    meta = ranks["four"][0][i]["meta"]
    assert meta["inputs"]["data"][0] == [-1, 1, 16, 1]
    assert meta["compute_dtype"] == "bfloat16"
    for r in ranks["four"]:
        for n, got, want in zip((4, 16), r[i]["outs"],
                                ranks["one"]["bf16_sym"]):
            assert got["outn"].shape == (n, 8)
            _close(got["outn"], want["outn"])


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_lstm_artifact_threads_its_time_major_carry(ranks, mesh):
    res = [r[0] for r in ranks["two"]] if mesh == "1x2" else \
        [r[ranks["names"].index("lstm_2x2")] for r in ranks["four"]]
    meta = res[0]["meta"]
    assert meta["batch_axes"]["h"] == 1
    assert meta["batch_axes"]["observed"] == 1
    assert meta["state"] == ["state:enc:c", "state:enc:h"]
    for r in res:
        for got, want in zip(r["outs"], ranks["one"]["lstm_2x2"]):
            for k in ("h", "state:enc:c", "state:enc:h"):
                assert got[k].shape == want[k].shape
                _close(got[k], want[k])
    assert float(np.abs(res[0]["outs"][-1]["state:enc:c"]).max()) > 0


def test_the_refusals(ranks):
    i = len(ranks["specs"])
    for r, (errs, lines) in enumerate(x[i] for x in ranks["four"]):
        assert errs[0] == ("ValueError: artifact was exported for 2 devices; "
                           "4 available (one rank a device: python -m "
                           "torch.distributed.run --nproc_per_node 2 ...)")
        assert errs[1] == ("SystemExit: --mesh: this artifact already bakes "
                           "a 4-device program; it runs on its export mesh "
                           "via mesh_serving")
        assert "artifact bakes a 4-device program" in errs[2]
        assert errs[3] == ("ValueError: input 'data' batch 3 (axis 0) not "
                           "divisible by the mesh data axis (2)")
        assert errs[4].startswith("RuntimeError: ") and \
            "run it through mesh_serving(call, meta)" in errs[4]
        assert "'mesh:model', which is none of the mesh's axes'" in errs[5]
        assert "a 1x2 export runs on 2 ranks" in errs[6]
        assert errs[7] == (f"ValueError: rank {r}'s program was exported on "
                           "cuda:1, which its buffers and constants name; "
                           "this rank serves on cpu: serve one rank a device "
                           "in the exporting ranks' order")
        # run --iterations on the baked 4-device program, logged by rank 0
        if r == 0:
            assert any(l.startswith("outn: shape=(4, 8)") for l in lines)
            assert any(l.startswith("Serving: ") for l in lines)
        else:
            assert lines == []


def test_group_names_rebind_in_a_process_that_made_other_groups(ranks):
    """The stored programs name their groups by axis; a process whose
    groups are numbered past three extra ones binds them to its own and
    gives the outputs of the exporting process."""
    i = ranks["names"].index("stats")
    for r, (exp, got) in enumerate(zip(ranks["four"], ranks["rebound"])):
        got = got[0]
        assert got["stored"] == ["mesh:data", "mesh:model"]
        assert got["names"]["data"] != exp[i]["names"]["data"]
        assert got["names"]["model"] != exp[i]["names"]["model"]
        for k in STATS_TOPS:
            np.testing.assert_array_equal(got["outs"][0][k],
                                          exp[i]["outs"][0][k])


def test_cli_export_mesh_and_run_under_torchrun(ranks, tmp_path):
    """`export --mesh 1x2 --platforms cpu` and `run` of its artifact, each
    through python -m torch.distributed.run --nproc_per_node 2."""
    net, w, _, batches, _ = ranks["specs"]["f32"]
    art = str(tmp_path / "cli.vvtserve")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2", "-m",
              "videovector_tpu_torch.tools.serving"]
    lines = {}
    for cmd in (["export", net, art, "--weights", w, "--blobs", "outn",
                 "--platforms", "cpu", "--mesh", "1x2"],
                ["run", art, "--iterations", "2"]):
        run = subprocess.run(launch + cmd, env=env, cwd=tmp_path,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        lines[cmd[0]] = (run.stdout + run.stderr).splitlines()
    meta = tserving.read_meta(art)
    assert meta["mesh"] == {"data": 1, "model": 2}
    assert meta["nr_devices"] == 2 and len(meta["payloads"]) == 2
    # rank 0 alone logs: one export line, one line a blob, one timing
    assert sum("Exported " in l for l in lines["export"]) == 1
    assert sum("outn: shape=(4, 8)" in l for l in lines["run"]) == 1
    assert sum("Serving: " in l for l in lines["run"]) == 1
