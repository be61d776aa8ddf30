"""The retrieval eval's mesh engines (metrics/retrieval.py: query chunks
over "data", and with shard_gallery=True gallery rows over "data") and
shard_serving (tools/serving.py) over gloo ranks on the CPU.

JAX's cases (tests/test_driver_mesh.py): a 531 x 12 gallery (query chunks
of 64: 9 chunks, not divisible by 4 ranks or 2), exact ties at rows 3, 17
and 404, classes vids % 5 - 1 (class -1 rows excluded), both
exclude_same_video_shots settings. On a 4 x 1 and a 2 x 2 mesh (the model
axis ignored) every aggregate is bit-equal to the port's one-device
engines (which tests/test_torch_metrics.py holds to JAX's), the csv
reports byte-equal, and the argument errors are JAX's.
shard_serving over 2 ranks returns the one-device artifact's outputs,
with JAX's refusals; `run --mesh 2` serves the 2 x batch.
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from videovector_tpu.metrics import retrieval as jretrieval
from videovector_tpu.parallel import make_mesh as jmake_mesh
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.metrics.retrieval import (
    retrieval_stats_chunked, retrieval_stats_report,
)
from videovector_tpu_torch.solver.checkpoint import snapshot
from videovector_tpu_torch.tools import serving as tserving

MESHES = ((4, 1), (2, 2))

SERVE_NET = """
name: "serve"
input: "x"
input_dim: 4 input_dim: 6
layers { name: "fc" type: INNER_PRODUCT bottom: "x" top: "f"
  inner_product_param { num_output: 8 weight_filler { type: "xavier" }
    bias_filler { type: "constant" value: 0.05 } } }
layers { name: "r" type: RELU bottom: "f" top: "f" }
layers { name: "fc2" type: INNER_PRODUCT bottom: "f" top: "out"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
"""


def _gallery():
    rs = np.random.RandomState(1701)
    n, d = 531, 12
    feats = rs.randn(n, d).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    feats[17] = feats[3]
    feats[404] = feats[3]
    vids = rs.randint(0, 60, size=(n,))
    return feats, vids, (vids % 5) - 1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_retrieval")
    feats, vids, cls = _gallery()
    run = [("retrieval", dict(feats=feats, vids=vids, cls=cls,
                              out_dir=str(tmp), data_n=d, model_n=m))
           for d, m in MESHES]
    out = cases.run(4, run, tmp, timeout=120)
    return tmp, feats, vids, cls, out


@pytest.mark.parametrize("mesh", MESHES, ids=["4x1", "2x2"])
def test_mesh_engines_are_bit_equal_to_one_device(ranks, mesh):
    tmp, feats, vids, cls, out = ranks
    i = MESHES.index(mesh)
    for method in ("count", "sort"):
        one = retrieval_stats_chunked(feats, vids, cls, query_chunk=64,
                                      method=method,
                                      exclude_same_video_shots=True,
                                      device="cpu")
        for r in out:
            for k in one:
                assert r[i][("chunks", method)][k] == float(one[k]), \
                    (method, k)
    for excl in (False, True):
        one = retrieval_stats_chunked(feats, vids, cls, query_chunk=64,
                                      method="count",
                                      exclude_same_video_shots=excl,
                                      device="cpu")
        for r in out:
            for k in one:
                assert r[i][("gshard", excl)][k] == float(one[k]), (excl, k)


@pytest.mark.parametrize("mesh", MESHES, ids=["4x1", "2x2"])
def test_mesh_reports_are_byte_equal_to_one_device(ranks, mesh):
    tmp, feats, vids, cls, out = ranks
    i = MESHES.index(mesh)
    tag = f"{mesh[0]}x{mesh[1]}"
    single = tmp / f"single_{tag}.csv"
    count = tmp / f"count_{tag}.csv"
    agg = retrieval_stats_report(feats, vids, cls, str(single),
                                 device="cpu")
    agg_c = retrieval_stats_report(feats, vids, cls, str(count),
                                   method="count", device="cpu")
    for r in out:
        assert r[i]["report"] == agg
        assert r[i]["report_gshard"] == agg_c
    assert (tmp / f"{tag}_mesh.csv").read_bytes() == single.read_bytes()
    assert (tmp / f"{tag}_gshard.csv").read_bytes() == count.read_bytes()


def test_mesh_argument_errors_are_jax_s(ranks):
    import jax
    tmp, feats, vids, cls, out = ranks
    jmesh = jmake_mesh(data=4, model=1, devices=jax.devices()[:4])
    want = []
    for kw in (dict(shard_gallery=True, method="sort"),
               dict(chunk_driver="host")):
        with pytest.raises(ValueError) as e:
            jretrieval.retrieval_stats_chunked(feats, vids, cls, mesh=jmesh,
                                               **kw)
        want.append(str(e.value))
    with pytest.raises(ValueError) as e:
        jretrieval.retrieval_stats_report(feats, vids, cls,
                                          str(tmp / "j.csv"), mesh=jmesh,
                                          shard_gallery=True, method="sort")
    want.append(str(e.value))
    for r in out:
        assert r[0]["errors"] == want
    with pytest.raises(ValueError, match="requires mesh"):
        retrieval_stats_chunked(feats, vids, cls, shard_gallery=True,
                                device="cpu")


def test_shard_serving_returns_the_one_device_outputs(tmp_path):
    net_path = tmp_path / "serve.prototxt"
    net_path.write_text(SERVE_NET)
    net = TNet(tparse(SERVE_NET), "TEST")
    params, _ = net.init(torch.Generator().manual_seed(3),
                         {"x": np.zeros((4, 6), np.float32)})
    weights, _ = snapshot(str(tmp_path / "w"), 1, params)
    art = str(tmp_path / "a.vvtserve")
    tserving.export_serving(str(net_path), [weights], ["out"], art,
                            platforms=["cpu"], symbolic_batch=True)
    batch = {"x": np.random.RandomState(2).randn(8, 6).astype(np.float32)}
    call, meta = tserving.load_serving(art)
    want = call(batch)["out"].numpy()
    out = cases.run(2, [("serving_case", dict(artifact=art, batch=batch))],
                    tmp_path, timeout=120)
    for r, (got, errs, lines) in enumerate(x[0] for x in out):
        np.testing.assert_array_equal(got["out"], want)
        assert "artifact bakes a 2-device program" in errs[0]
        assert "not divisible by the mesh data axis (2)" in errs[1]
        assert "has no batch axis" in errs[2]
        if r == 0:
            # run --mesh 2: 8 rows a rank, 16 in all
            assert any(l.startswith("out: shape=(16, 3)") for l in lines)
