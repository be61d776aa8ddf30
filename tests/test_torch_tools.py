"""The port's tools (ROADMAP item 10) against the JAX package's on the CPU:
dump_learned_blobs' files and the converters' stores byte-equal to JAX's;
dump_network's activations within 1e-5; parity's report, plot_training_
stats' tables and upgrade_net_proto's outputs equal to JAX's on the same
inputs; vis_snapshot's JSON structure equal with values within 1e-5;
Net.debug_info's stats within 1e-5; and MedNet.params_from_graph_engine:
the CaffeNet Net's params give RetrievalPipeline's MedNet the Net's fc7
within 1e-5.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu.tools import converters as jconv
from videovector_tpu.tools import dump as jdump
from videovector_tpu.tools import parity as jparity
from videovector_tpu.tools import plot_training_stats as jplot
from videovector_tpu.tools import upgrade_net_proto as jupgrade
from videovector_tpu.tools import vis_snapshot as jvis
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data.records import RecordWriter
from videovector_tpu_torch.data.wire import Datum
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.solver.checkpoint import snapshot
from videovector_tpu_torch.tools import converters as tconv
from videovector_tpu_torch.tools import dump as tdump
from videovector_tpu_torch.tools import parity as tparity
from videovector_tpu_torch.tools import plot_training_stats as tplot
from videovector_tpu_torch.tools import upgrade_net_proto as tupgrade
from videovector_tpu_torch.tools import vis_snapshot as tvis
from test_tools_misc import SAMPLE_LOG
from torch_extraction_net import extraction_net

NET = """
name: "tools"
input: "x"
input_dim: 3 input_dim: 2 input_dim: 9 input_dim: 9
layers { name: "c1" type: CONVOLUTION bottom: "x" top: "h"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "r1" type: RELU bottom: "h" top: "h" }
layers { name: "fc" type: INNER_PRODUCT bottom: "h" top: "out"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
"""
X = np.random.RandomState(1).randn(3, 2, 9, 9).astype(np.float32)


def _files(d) -> dict:
    d = Path(d)
    if d.is_file():
        return {"": d.read_bytes()}
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture
def nets(tmp_path):
    """Both Nets on one set of params, and the .vvmodel holding them."""
    jnet = JNet(jparse(NET), "TEST")
    jp, _ = jnet.init(jax.random.PRNGKey(2), {
        "x": jax.ShapeDtypeStruct(X.shape, jnp.float32)})
    tnet = TNet(tparse(NET), "TEST")
    tnet.init(torch.Generator(), {"x": X})
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    (tmp_path / "net.prototxt").write_text(NET)
    model, _ = snapshot(str(tmp_path / "m"), 1, tp)
    return {"jnet": jnet, "jp": jp, "tnet": tnet, "tp": tp, "tmp": tmp_path,
            "net": str(tmp_path / "net.prototxt"), "model": model}


def test_dump_learned_blobs_is_byte_equal_to_jaxs(nets):
    t, j = nets["tmp"] / "t", nets["tmp"] / "j"
    tdump.dump_learned_blobs(nets["tp"], str(t))
    jdump.dump_learned_blobs(jax.tree.map(np.asarray, nets["jp"]), str(j))
    tf, jf = _files(t), _files(j)
    assert tf.keys() == jf.keys() and "c1.w.blob" in tf
    for name in tf:
        if name.endswith(".blob"):
            assert tf[name] == jf[name], name
    with np.load(t / "weights.npz") as a, np.load(j / "weights.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_dump_network_and_parity_match_jax(nets, capsys):
    t, j = nets["tmp"] / "dt", nets["tmp"] / "dj"
    got = tdump.dump_network(nets["net"], str(t), weights=[nets["model"]],
                             batch={"x": X}, device="cpu")
    want = jdump.dump_network(nets["net"], str(j), weights=[nets["model"]],
                              batch={"x": X})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want[k]).max()))
    assert sorted(p.name for p in t.glob("*.blob")) == \
        sorted(p.name for p in j.glob("*.blob"))
    # the parity harness reads either package's dump and reports alike
    reports = []
    for main in (tparity.main, jparity.main):
        rc = main([str(t), str(j), "--atol", "1e-4"])
        reports.append((rc, capsys.readouterr().out))
    assert reports[0] == reports[1] and reports[0][0] == 0
    assert "PARITY: PASS" in reports[0][1]
    rows_t = tparity.compare(tparity.load_dump(str(t)),
                             jparity.load_dump(str(j)))
    rows_j = jparity.compare(jparity.load_dump(str(t)),
                             jparity.load_dump(str(j)))
    assert rows_t == rows_j


def test_parity_disjoint_dumps_fail_alike(tmp_path):
    a = {"x": np.zeros(3, np.float32)}
    b = {"y": np.zeros(3, np.float32)}
    assert tparity.compare(a, b) == jparity.compare(a, b)
    assert tparity.compare(a, b)[1] is False


def _images(root: Path) -> Path:
    from PIL import Image
    rng = np.random.RandomState(5)
    (root / "imgs" / "sub").mkdir(parents=True)
    lines = []
    for i, name in enumerate(["a.png", "sub/b.png", "c.png"]):
        Image.fromarray(rng.randint(0, 256, (7 + i, 9, 3), dtype=np.uint8)) \
            .save(root / "imgs" / name)
        lines.append(f"{name} {i}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return root / "list.txt"


@pytest.mark.parametrize("case", ["imageset", "imageset_shuffle",
                                  "flexible_imageset", "flexible_list",
                                  "compute_image_mean", "write_mean"])
def test_converters_write_jaxs_bytes(tmp_path, case):
    lst = _images(tmp_path)
    root = str(tmp_path / "imgs")
    outs = {}
    for tag, mod in (("t", tconv), ("j", jconv)):
        out = str(tmp_path / f"{tag}.out")
        if case.startswith("imageset"):
            mod.convert_imageset(root, str(lst), out,
                                 shuffle=case.endswith("shuffle"))
        elif case == "flexible_imageset":
            mod.convert_flexible_imageset(root, str(lst), out)
        elif case == "flexible_list":
            mod.convert_flexible_list(str(lst), out)
        elif case == "compute_image_mean":
            store = str(tmp_path / "same.vvr")
            if not os.path.exists(store):
                # images of one size (resized) for the mean
                tconv.convert_flexible_imageset(root, str(lst), store,
                                                resize_h=8, resize_w=8)
            mod.compute_image_mean(store, out)
        else:
            mod.write_mean_to_binary_proto(out, (104.0, 117.0, 123.0), 4, 5)
        outs[tag] = _files(out)
    assert outs["t"] == outs["j"]


@pytest.mark.parametrize("backend", ["lmdb", "leveldb"])
def test_database_import_export_write_jaxs_bytes(tmp_path, backend):
    src = str(tmp_path / "src.vvr")
    with RecordWriter(src) as w:
        for i in range(40):
            w.append(f"{i:08d}", Datum(channels=1, height=1, width=3,
                                       float_data=[i, 2.0 * i, -i]).encode())
    exp_t, exp_j = (getattr(m, f"export_{backend}") for m in (tconv, jconv))
    imp_t, imp_j = (getattr(m, f"import_{backend}") for m in (tconv, jconv))
    assert exp_t(src, str(tmp_path / "t.db")) == 40
    assert exp_j(src, str(tmp_path / "j.db")) == 40
    assert _files(tmp_path / "t.db") == _files(tmp_path / "j.db")
    assert imp_t(str(tmp_path / "j.db"), str(tmp_path / "t.vvr")) == 40
    assert imp_j(str(tmp_path / "t.db"), str(tmp_path / "j.vvr")) == 40
    assert _files(tmp_path / "t.vvr") == _files(tmp_path / "j.vvr") \
        == _files(src)


def test_export_net_writes_jaxs_netparameter(nets):
    t, j = str(nets["tmp"] / "t.net"), str(nets["tmp"] / "j.net")
    tconv.export_net(nets["net"], nets["model"], t)
    jconv.export_net(nets["net"], nets["model"], j)
    assert _files(t) == _files(j)


@pytest.mark.parametrize("ext", [".prototxt", ".binaryproto"])
def test_upgrade_net_proto_writes_jaxs_output(tmp_path, ext):
    src = tmp_path / "v0.prototxt"
    src.write_text("""
    input: "x"
    input_dim: 1 input_dim: 4 input_dim: 1 input_dim: 1
    layers { layer { name: "ip" type: "innerproduct" num_output: 4 }
             bottom: "x" top: "y" }
    layers { layer { name: "r" type: "relu" } bottom: "y" top: "y" }
    """)
    outs = []
    for tag, main in (("t", tupgrade.main), ("j", jupgrade.main)):
        dst = tmp_path / f"{tag}{ext}"
        assert main([str(src), str(dst)]) == 0
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1]
    if ext == ".prototxt":
        assert b"INNER_PRODUCT" in outs[0]


def test_plot_training_stats_tables_match_jax(tmp_path):
    paths = []
    for tag in ("t", "j"):
        p = tmp_path / f"{tag}.log"
        p.write_text(SAMPLE_LOG)
        paths.append(p)
    assert tplot.main([str(paths[0]), "--parse_log"]) == 0
    assert jplot.main([str(paths[1]), "--parse_log"]) == 0
    for suffix in (".train", ".test"):
        assert Path(str(paths[0]) + suffix).read_text() == \
            Path(str(paths[1]) + suffix).read_text()
    assert tplot.parse_log(str(paths[0])) == jplot.parse_log(str(paths[1]))
    assert tplot.extract_seconds(str(paths[0]), year=2026) == \
        jplot.extract_seconds(str(paths[1]), year=2026)
    csv = [tmp_path / "t.csv", tmp_path / "j.csv"]
    tplot.main([str(paths[0]), "--parse_log", "--csv", str(csv[0])])
    jplot.main([str(paths[1]), "--parse_log", "--csv", str(csv[1])])
    assert csv[0].read_text() == csv[1].read_text()


@pytest.mark.parametrize("vis_blobs", [None, ["network", "out"], ["h"]])
def test_vis_snapshot_matches_jax(nets, vis_blobs):
    _, jb = nets["jnet"].apply(nets["jp"], {"x": jnp.asarray(X)},
                               return_blobs=True)
    with torch.no_grad():
        _, tb = nets["tnet"].apply(nets["tp"], {"x": torch.as_tensor(X)},
                                   return_blobs=True)
    tpath, jpath = nets["tmp"] / "t.json", nets["tmp"] / "j.json"
    tvis.vis_snapshot(nets["tnet"], nets["tp"], tb, str(tpath),
                      vis_blobs=vis_blobs, max_elements=10)
    jvis.vis_snapshot(nets["jnet"], nets["jp"], jb, str(jpath),
                      vis_blobs=vis_blobs, max_elements=10)
    t, j = json.loads(tpath.read_text()), json.loads(jpath.read_text())
    assert t["layers"] == j["layers"]
    assert (t["name"], t["phase"]) == (j["name"], j["phase"])
    assert t["blobs"].keys() == j["blobs"].keys()
    for name, jb_ in j["blobs"].items():
        tb_ = t["blobs"][name]
        assert tb_["shape"] == jb_["shape"]
        for k in ("mean_abs", "min", "max"):
            assert abs(tb_[k] - jb_[k]) <= 1e-5 * max(1.0, abs(jb_[k]))
        np.testing.assert_allclose(tb_["values"], jb_["values"], rtol=1e-5,
                                   atol=1e-5)


def test_debug_info_stats_match_jax(nets, caplog):
    want = nets["jnet"].debug_info(nets["jp"], {"x": jnp.asarray(X)})
    with torch.no_grad():
        got = nets["tnet"].debug_info(nets["tp"], {"x": torch.as_tensor(X)})
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    assert "param:c1/w" in got


def test_params_from_graph_engine_feed_retrieval_pipeline():
    """The CaffeNet extraction Net's params, converted, give the pipeline's
    MedNet (f32, on the CPU) the Net's fc7 within 1e-5 of max|fc7|; and
    conv1_space_to_depth is accepted as the no-op it is here."""
    from videovector_tpu_torch.models.mednet import MedNet, MedNetConfig
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    text = extraction_net(crop=227, new_dim=256, widths={})
    net = TNet(tparse(text), "TEST")
    g = torch.Generator().manual_seed(4)
    params, _ = net.init(g, {"data": np.zeros((2, 3, 227, 227), np.float32),
                             "label": np.zeros(2, np.float32)})
    for lp in params.values():
        for name, t in lp.items():
            fan_in = t.shape[0] if t.dim() == 2 else t[0].numel()
            t.copy_(torch.randn(t.shape, generator=g)
                    * (fan_in ** -0.5 if name == "w" else 0.1))
    x = torch.randn(2, 3, 227, 227, generator=g) * 50
    with torch.no_grad():
        _, blobs = net.apply(params, {"data": x, "label": torch.zeros(2)},
                             return_blobs=True)
        pipe = RetrievalPipeline(RetrievalPipelineConfig(
            compute_dtype="float32"), device="cpu")
        mp = MedNet.params_from_graph_engine(params)
        got = pipe.mednet.forward(mp, x.permute(0, 2, 3, 1).contiguous())
        s2d = MedNet(MedNetConfig(compute_dtype="float32",
                                  conv1_space_to_depth=True))
        got_s2d = s2d.forward(mp, x.permute(0, 2, 3, 1).contiguous())
    want = blobs["ip2"]     # fc7 after its in-place ReLU
    assert got.shape == want.shape == (2, 4096)
    tol = 1e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got_s2d, got)
    assert mp["fc6"]["w"].shape == (9216, 4096)
    assert mp["conv1"]["w"].shape == (11, 11, 3, 96)
