"""The port's serving export (tools/serving.py over tools/export_model.py and
torch.export) against the JAX package's on the CPU.

f32, bf16, int8, symbolic-batch and stateful LSTM artifacts are exported
from the same prototxt and .vvmodel weights by both packages, loaded, and
run on the same batches: the port's artifact against the port's Net.apply
(equal math: within 1e-5) and against JAX's load_serving (within 1e-5,
bf16 within 2e-2 of max|ref|); the metas are equal key for key; `info`
runs in a process with torch and numpy blocked; `export --mesh 1x1` gives
the one-device program, a larger mesh asks for a launch of its ranks, and
mesh_serving passes a one-device call through
(tests/test_torch_parallel_serving.py runs the larger meshes); an unknown
platform is a ValueError naming it. K1 and K2's custom ops export and
reload in a fresh process, and so does a MedNet forward with its NHWC max
pools as `vvtpu::max_pool_nhwc` nodes.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from videovector_tpu.tools import serving as jserving
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.solver.checkpoint import snapshot
from videovector_tpu_torch.tools import quantize as tquant
from videovector_tpu_torch.tools import serving as tserving

ROOT = Path(__file__).resolve().parent.parent

NET = """
name: "serve"
input: "x"
input_dim: 6 input_dim: 3 input_dim: 12 input_dim: 12
layers { name: "c1" type: CONVOLUTION bottom: "x" top: "h"
  convolution_param { num_output: 8 kernel_size: 3 stride: 1 pad: 1
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "r1" type: RELU bottom: "h" top: "h" }
layers { name: "p1" type: POOLING bottom: "h" top: "p"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "fc" type: INNER_PRODUCT bottom: "p" top: "f"
  inner_product_param { num_output: 32 weight_filler { type: "xavier" }
    bias_filler { type: "constant" value: 0.05 } } }
layers { name: "r2" type: RELU bottom: "f" top: "f" }
layers { name: "fc2" type: INNER_PRODUCT bottom: "f" top: "out"
  inner_product_param { num_output: 8 weight_filler { type: "xavier" } } }
"""


def _batch(seed, n=6):
    return {"x": np.random.RandomState(seed).randn(n, 3, 12, 12)
            .astype(np.float32)}


@pytest.fixture
def model(tmp_path):
    """The prototxt and a .vvmodel of seeded params, read by both packages."""
    net_path = tmp_path / "serve.prototxt"
    net_path.write_text(NET)
    net = TNet(tparse(NET), "TEST")
    params, _ = net.init(torch.Generator().manual_seed(3), _batch(0))
    weights, _ = snapshot(str(tmp_path / "w"), 1, params)
    return {"net": str(net_path), "weights": weights, "params": params,
            "tmp": tmp_path}


def _export_both(model, name, **kw):
    tpath = str(model["tmp"] / f"{name}.vvtserve")
    jpath = str(model["tmp"] / f"{name}.vvserve")
    tmeta = tserving.export_serving(model["net"], [model["weights"]], ["out"],
                                    tpath, platforms=["cpu"], **kw)
    jmeta = jserving.export_serving(model["net"], [model["weights"]], ["out"],
                                    jpath, platforms=["cpu"], **kw)
    return tpath, jpath, tmeta, jmeta


def _run_port_net(model, batch, compute_dtype=None, quant=None):
    net = TNet(tparse(NET), "TEST", compute_dtype=compute_dtype)
    net.quant = quant
    with torch.no_grad():
        _, blobs = net.apply(model["params"], {k: torch.as_tensor(v)
                                               for k, v in batch.items()},
                             return_blobs=True)
    return blobs["out"].float().numpy()


CALIB = [_batch(10 + i) for i in range(3)]


@pytest.mark.parametrize("case", ["f32", "bf16", "int8", "symbolic"])
def test_artifact_matches_the_net_and_jaxs_artifact(model, case):
    kw = {"bf16": dict(compute_dtype="bfloat16"),
          "int8": dict(quantize="int8", calib_data=CALIB),
          "symbolic": dict(symbolic_batch=True)}.get(case, {})
    tpath, jpath, tmeta, jmeta = _export_both(model, case, **kw)
    tcall, meta = tserving.load_serving(tpath)
    jcall, _ = jserving.load_serving(jpath)
    assert meta == tmeta
    assert tmeta == jmeta
    quant = None
    if case == "int8":
        net = TNet(tparse(NET), "TEST")
        quant = tquant.quantize_weights(
            model["params"], net, tquant.calibrate(net, model["params"], CALIB))
        assert {q["mode"] for q in quant.values()} == {"int8", "weight_only"}
    tol = 2e-2 if case == "bf16" else 1e-5
    for n in ((6, 3, 11) if case == "symbolic" else (6,)):
        batch = _batch(n, n)
        got = tcall(batch)["out"].float().numpy()
        want_net = _run_port_net(model, batch, kw.get("compute_dtype"), quant)
        want_jax = np.asarray(jcall(batch)["out"], np.float32)
        assert got.shape == (n, 8)
        np.testing.assert_allclose(got, want_net, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_net).max())
        np.testing.assert_allclose(got, want_jax, rtol=0,
                                   atol=tol * np.abs(want_jax).max())


def test_int8_artifact_is_smaller(model):
    f32, _, _, _ = _export_both(model, "f32")
    q, _, _, _ = _export_both(model, "q", quantize="int8", calib_data=CALIB)
    assert tserving.read_meta(q)["payload_bytes"] < \
        tserving.read_meta(f32)["payload_bytes"]


def test_stateful_lstm_artifact_threads_its_state(tmp_path):
    """state:<layer>:{c,h} inputs and outputs: threading the carry through
    the port's artifact over 3 batches equals the Net's own threading and
    JAX's artifact's."""
    from test_project_trajectory import _write_data
    from videovector_tpu_torch.graph.data_factory import (
        MergedSource, make_data_source,
    )
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    train, _ = _write_data(tmp_path, np.random.RandomState(0), t_obs=5,
                           t_pred=2)
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
    net_path = tmp_path / "lstm.prototxt"
    net_path.write_text(text)
    net = TNet(tparse(text), "TEST")
    src = MergedSource([make_data_source(l, phase="TEST") for l in net.layers
                        if l.get("type") in DATA_LAYER_TYPES])
    batches = [src.next_batch() for _ in range(3)]
    params, _ = net.init(torch.Generator().manual_seed(1), batches[0])
    weights, _ = snapshot(str(tmp_path / "lw"), 1, params)
    tpath, jpath = str(tmp_path / "l.vvtserve"), str(tmp_path / "l.vvserve")
    tmeta = tserving.export_serving(str(net_path), [weights], ["h"], tpath,
                                    platforms=["cpu"])
    jmeta = jserving.export_serving(str(net_path), [weights], ["h"], jpath,
                                    platforms=["cpu"])
    assert tmeta == jmeta
    assert tmeta["state"] == ["state:enc:c", "state:enc:h"]
    tcall, _ = tserving.load_serving(tpath)
    jcall, _ = jserving.load_serving(jpath)
    state, tc, jc = None, {}, {}
    for b in batches:
        with torch.no_grad():
            _, blobs, state = net.apply(
                params, {k: torch.as_tensor(v) for k, v in b.items()},
                state=state, return_blobs=True, return_state=True)
        feed = {k: np.asarray(v, np.float32) for k, v in b.items()}
        for part in ("c", "h"):
            zero = np.zeros(tuple(getattr(state["enc"], part).shape),
                            np.float32)
            feed_t = tc.get(part, zero)
            feed_j = jc.get(part, zero)
            feed[f"state:enc:{part}"] = (feed_t, feed_j)
        tout = tcall({k: (v[0] if isinstance(v, tuple) else v)
                      for k, v in feed.items()})
        jout = jcall({k: (v[1] if isinstance(v, tuple) else v)
                      for k, v in feed.items()})
        np.testing.assert_allclose(tout["h"].numpy(), blobs["h"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tout["h"].numpy(), np.asarray(jout["h"]),
                                   rtol=1e-5, atol=1e-6)
        tc = {p: tout[f"state:enc:{p}"].numpy() for p in ("c", "h")}
        jc = {p: np.asarray(jout[f"state:enc:{p}"]) for p in ("c", "h")}
    assert float(np.abs(tc["c"]).max()) > 0


def test_info_reads_the_meta_without_torch(model):
    tpath, _, tmeta, _ = _export_both(model, "f32")
    code = ("import sys; sys.modules['torch'] = None; "
            "sys.modules['numpy'] = None; "
            "from videovector_tpu_torch.tools.serving import main; "
            f"main(['info', {tpath!r}])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    meta = json.loads(out.stdout)
    assert meta.pop("payload_bytes") > 0
    assert meta == tmeta
    with open(tpath, "rb") as f:
        assert f.read(8) == tserving.MAGIC


def test_cli_export_run_and_the_refusals(model, tmp_path):
    art = str(tmp_path / "cli.vvtserve")
    assert tserving.main(["export", model["net"], art, "--weights",
                          model["weights"], "--blobs", "out",
                          "--platforms", "cpu"]) == 0
    assert tserving.main(["run", art, "--iterations", "2"]) == 0
    # a multi-device export needs its ranks launched
    # (tests/test_torch_parallel_serving.py)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tserving.main(["export", model["net"], art, "--blobs", "out",
                       "--platforms", "cpu", "--mesh", "2x1"])
    # run --mesh serves data-parallel since item 11
    # (tests/test_torch_parallel_retrieval.py); 2 ranks need a launch
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tserving.main(["run", art, "--mesh", "2"])
    call, meta = tserving.load_serving(art)
    assert tserving.mesh_serving(call, meta) is call
    # a one-rank mesh (its group started in-process) exports the
    # one-device program
    import torch.distributed as dist
    one = str(tmp_path / "one.vvtserve")
    try:
        assert tserving.main(["export", model["net"], one, "--weights",
                              model["weights"], "--blobs", "out",
                              "--platforms", "cpu", "--mesh", "1x1"]) == 0
    finally:
        dist.destroy_process_group()
    call1, meta1 = tserving.load_serving(one)
    assert (meta1["mesh"], meta1["nr_devices"]) == (
        {"data": 1, "model": 1}, 1)
    assert {k: v for k, v in meta1.items() if k != "mesh"} == \
        {k: v for k, v in meta.items() if k != "mesh"}
    batch = _batch(4)
    assert torch.equal(tserving.mesh_serving(call1, meta1)(batch)["out"],
                       call(batch)["out"])
    with pytest.raises(ValueError, match="tpu"):
        tserving.export_serving(model["net"], [], ["out"], art,
                                platforms=["tpu"])
    with pytest.raises(ValueError, match="one device"):
        tserving.export_serving(model["net"], [], ["out"], art,
                                platforms=["cuda", "cpu"])


def test_the_custom_ops_export_and_reload_in_a_fresh_process(tmp_path):
    """K1 and K2 as vvtpu:: custom ops: their fake implementations trace,
    the program saves, and a process that has imported nothing of the
    port but load_exported runs it (plain versions on the CPU)."""
    from videovector_tpu_torch.ops.hopper import conv_gemm, matmul
    from videovector_tpu_torch.tools.export_model import save_exported
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(3, 3, 4, 8, generator=g)
    w2 = torch.randn(8 * 6 * 6, 5, generator=g)

    def fn(x):
        y = torch.ops.vvtpu.k2_conv2d_nhwc(x, w1, None, [1, 1], [1, 1], 1,
                                           True, torch.float32)
        return torch.ops.vvtpu.k1_matmul(y.reshape(y.shape[0], -1), w2,
                                         None, False, torch.float32)
    x = torch.randn(2, 6, 6, 4, generator=g)
    path = str(tmp_path / "ops.pt2")
    save_exported(path, fn, x)
    want = matmul.matmul_plain(conv_gemm.conv2d_gemm_nhwc_plain(
        x, w1, pad=(1, 1), fuse_relu=True).reshape(2, -1), w2)
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from videovector_tpu_torch.tools.export_model import load_exported\n"
        f"ep = load_exported({path!r})\n"
        "names = [str(n.target) for n in ep.graph.nodes]\n"
        "assert any('vvtpu.k1_matmul' in n for n in names), names\n"
        "assert any('vvtpu.k2_conv2d_nhwc' in n for n in names), names\n"
        f"x = torch.as_tensor(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, ep.module()(x).numpy())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want.numpy())


def test_a_mednet_program_exports_its_pools_as_the_custom_op(tmp_path):
    """A narrow MedNet (CaffeNet's 3x3/2 pools after conv1, conv2 and
    conv5) exported on the CPU: the program holds three
    vvtpu.max_pool_nhwc nodes and no aten max pool, and a process that has
    imported nothing of the port but load_exported runs it, equal to the
    plain forward."""
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.models.mednet import (
        CAFFENET_CONVS, MedNet, MedNetConfig,
    )
    from videovector_tpu_torch.tools.export_model import save_exported
    convs = tuple(dataclasses.replace(c, num_output=16)
                  for c in CAFFENET_CONVS)
    cfg = MedNetConfig(convs=convs, fc6=24, fc7=12, input_hw=(67, 67),
                       compute_dtype="float32")
    params = MedNet(cfg).init(torch.Generator().manual_seed(0))
    x = torch.randn((3, 67, 67, 3), generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "mednet.pt2")
    with torch.no_grad():
        save_exported(path, lambda im: MedNet(cfg).forward(params, im), x)
        with plain_versions():
            want = MedNet(cfg).forward(params, x)
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from videovector_tpu_torch.tools.export_model import load_exported\n"
        f"ep = load_exported({path!r})\n"
        "names = [str(n.target) for n in ep.graph.nodes]\n"
        "assert sum('vvtpu.max_pool_nhwc' in n for n in names) == 3, names\n"
        "assert not any('max_pool2d' in n for n in names), names\n"
        f"x = torch.as_tensor(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "with torch.no_grad():\n"
        f"    np.save({str(tmp_path / 'y.npy')!r}, ep.module()(x).numpy())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want.numpy())
