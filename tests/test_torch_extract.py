"""The port's feature extraction (videovector_tpu_torch.tools.extract_features)
against the JAX package's on the CPU, on the narrowed extraction net of
tests/test_torch_vision_net.py (CaffeNet's layers and geometry, narrow
widths, a 99 crop, batch 2).

Both read the same DATA store (or IMAGE_DATA list), mean file and
.caffemodel (written by JAX's params_to_weights from seeded params), and
write vvr stores and text files. Keys, row counts and Datum shapes are
equal; features within 1e-5 of max|ref| (the convolutions sum in other
orders), the text rows within one unit of their sixth decimal more than
that.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_vision_net import _random_params
from torch_extraction_net import CROP, data_layer_net, extraction_net
from videovector_tpu.config import parse as jparse
from videovector_tpu.data.weights import params_to_weights
from videovector_tpu.graph import Net as JNet
from videovector_tpu.tools import extract_features as jext
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import records as trec
from videovector_tpu_torch.data import wire as twire
from videovector_tpu_torch.graph import data_factory as tfac
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.tools import extract_features as text

torch.set_num_threads(1)
SIDE, ITEMS, BATCH = 112, 7, 2
BLOBS = ["ip2", "pool5"]


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("extract")
    rs = np.random.RandomState(41)
    store = str(tmp / "frames.vvr")
    with trec.RecordWriter(store) as w:
        for i in range(ITEMS):
            pix = rs.randint(0, 256, (3, SIDE, SIDE)).astype(np.uint8)
            w.append(f"{i:08d}", twire.Datum(
                channels=3, height=SIDE, width=SIDE, data=pix.tobytes(),
                label=i).encode())
    mean_path = str(tmp / "mean.blob")
    with open(mean_path, "wb") as f:
        f.write(twire.BlobProto.from_array(
            np.full((1, 3, SIDE, SIDE), 120.0, np.float32)).encode())
    net = tmp / "extract.prototxt"
    net.write_text(data_layer_net(store, mean_path))
    spec = {"data": np.zeros((BATCH, 3, CROP, CROP), np.float32),
            "label": np.zeros(BATCH, np.float32)}
    params = _random_params(JNet(jparse(net.read_text()), "TEST"), spec,
                            seed=8)
    weights = str(tmp / "net.caffemodel")
    params_to_weights(params).save(weights)
    return {"tmp": tmp, "net": str(net), "weights": weights,
            "store": store, "params": params}


def _read(prefix, name):
    r = trec.RecordReader(f"{prefix}_{name}.vvr")
    keys = [r.key(i).decode() for i in range(len(r))]
    datums = [twire.Datum.decode(bytes(r.value(i))) for i in range(len(r))]
    rows = Path(f"{prefix}_{name}.txt").read_text().splitlines()
    return keys, datums, rows


def test_extract_writes_what_jax_writes(project):
    tmp = project["tmp"]
    jcounts = jext.extract(project["net"], [project["weights"]], BLOBS,
                           str(tmp / "jax"), 4)
    tcounts = text.extract(project["net"], [project["weights"]], BLOBS,
                           str(tmp / "port"), 4, device="cpu")
    assert tcounts == jcounts == {"ip2": 8, "pool5": 8}
    for name, dim in (("ip2", 32), ("pool5", 16 * 2 * 2)):
        jk, jd, jr = _read(str(tmp / "jax"), name)
        tk, td, tr = _read(str(tmp / "port"), name)
        assert tk == jk == [f"{i:010d}" for i in range(8)]
        ref = np.stack([d.float_data for d in jd])
        got = np.stack([d.float_data for d in td])
        assert got.shape == ref.shape == (8, dim)
        assert all((d.channels, d.height, d.width) == (dim, 1, 1) for d in td)
        tol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        assert len(tr) == len(jr) == 8
        tvals = np.array([[float(v) for v in row.split(",")] for row in tr])
        jvals = np.array([[float(v) for v in row.split(",")] for row in jr])
        np.testing.assert_allclose(tvals, jvals, rtol=0, atol=tol + 1e-6)
        np.testing.assert_allclose(tvals, got, rtol=0, atol=5e-7)
        assert tr[0] == ",".join(f"{v:.6f}" for v in td[0].float_data)


def test_batch_zero_is_the_first_batch_of_the_store(project):
    """The batch read for shape inference is fed again as batch 0: row 0 is
    the store's first item (4 batches of 2 wrap the 7 items, so row 7 is
    item 0 again)."""
    tmp = project["tmp"]
    text.extract(project["net"], [project["weights"]], ["ip2"],
                 str(tmp / "b0"), 4, device="cpu")
    _, datums, _ = _read(str(tmp / "b0"), "ip2")
    msg = tparse(Path(project["net"]).read_text())
    net = TNet(msg, "TEST")
    layer = next(l for l in net.layers if l.get("type") == "DATA")
    batch = tfac.make_data_source(layer, phase="TEST").next_batch()
    params = {ln: {k: torch.as_tensor(v) for k, v in lp.items()}
              for ln, lp in project["params"].items()}
    _, blobs = net.apply(params, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(datums[0].float_data, blobs["ip2"][0].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(datums[7].float_data, datums[0].float_data)


def test_weight_files_apply_in_order(project, tmp_path):
    """A second file's layers replace the first's: fc7 zeroed makes ip2 0."""
    params = {"fc7": {"w": np.zeros((32, 32), np.float32),
                      "b": np.zeros(32, np.float32)}}
    task = str(tmp_path / "task.caffemodel")
    params_to_weights(params).save(task)
    text.extract(project["net"], [project["weights"], task], ["ip2"],
                 str(tmp_path / "o"), 1, device="cpu")
    _, datums, _ = _read(str(tmp_path / "o"), "ip2")
    assert all(np.all(d.float_data == 0) for d in datums)


def _outputs(tmp):
    return sorted(p.name for p in Path(tmp).iterdir()
                  if p.name.startswith("out"))


def test_unknown_blob_raises_before_any_file(project, tmp_path):
    with pytest.raises(ValueError, match=r"Unknown feature blob.*'nope'"):
        text.extract(project["net"], [], ["ip2", "nope"],
                     str(tmp_path / "out"), 1, device="cpu")
    assert _outputs(tmp_path) == []


def _read_db(path: str, backend: str):
    """(keys in store order, Datums, text rows) of a leveldb or lmdb
    extraction output."""
    r = trec.open_store(path)
    keys = [r.key(i).decode() for i in range(len(r))]
    datums = [twire.Datum.decode(bytes(r.value(i))) for i in range(len(r))]
    r.close()
    text_path = (Path(path) / "text_output.txt" if backend == "leveldb"
                 else Path(path[:-len("_lmdb")] + ".txt"))
    return keys, datums, text_path.read_text().splitlines()


@pytest.mark.parametrize("backend", ["leveldb", "lmdb"])
def test_db_backends_raise_before_any_file(project, tmp_path, backend):
    """--backend=leveldb|lmdb (once refused, now ported) writes what JAX's
    tool writes: the same store names, keys (decimal "%d" for leveldb, in
    the store's bytewise order, so "10" before "9"; "%010d" for lmdb),
    Datum shapes and text layout ("#features" and "%g," rows inside the
    LevelDB; JAX's "%.6f" csv beside the LMDB), values within 1e-5 of
    max|ref|, through extract and through main."""
    n = 12                                          # 6 batches of 2
    jext.extract(project["net"], [project["weights"]], BLOBS,
                 str(tmp_path / "jax"), n // BATCH, backend=backend)
    assert text.main([f"--model={project['net']}",
                      f"--weights={project['weights']}",
                      f"--blobs={','.join(BLOBS)}",
                      f"--out={tmp_path / 'port'}",
                      f"--num_batches={n // BATCH}", f"--backend={backend}",
                      "--cpu"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("port")) == sorted(
        p.name.replace("jax", "port", 1) for p in tmp_path.iterdir()
        if p.name.startswith("jax"))
    for name, dim in (("ip2", 32), ("pool5", 16 * 2 * 2)):
        jk, jd, jr = _read_db(str(tmp_path / f"jax_{name}_{backend}"), backend)
        tk, td, tr = _read_db(str(tmp_path / f"port_{name}_{backend}"),
                              backend)
        order = (sorted(str(i) for i in range(n)) if backend == "leveldb"
                 else [f"{i:010d}" for i in range(n)])
        assert tk == jk == order
        shape = (1, dim, 1) if backend == "leveldb" else (dim, 1, 1)
        assert all((d.channels, d.height, d.width) == shape for d in td + jd)
        ref = np.stack([d.float_data for d in jd])
        got = np.stack([d.float_data for d in td])
        tol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        assert len(tr) == len(jr) == n + (backend == "leveldb")
        if backend == "leveldb":
            assert tr[0] == jr[0] == "#features"
            assert all(r.endswith(",") for r in tr[1:])
            # the rows are in extraction order: row i is key str(i)
            row0 = td[tk.index("0")].float_data
            assert tr[1] == "".join(f"{float(v):g}," for v in row0)
            parse = lambda rows: np.array(
                [[float(v) for v in r[:-1].split(",")] for r in rows[1:]])
        else:
            assert tr[0] == ",".join(f"{v:.6f}" for v in td[0].float_data)
            parse = lambda rows: np.array(
                [[float(v) for v in r.split(",")] for r in rows])
        # %g keeps 6 significant digits: a relative error of 5e-6
        np.testing.assert_allclose(parse(tr), parse(jr), rtol=1e-5,
                                   atol=tol + 1e-6)


def test_main_picks_the_device_and_refuses_the_mesh(project, tmp_path,
                                                    monkeypatch):
    args = [f"--model={project['net']}", f"--weights={project['weights']}",
            "--blobs=ip2,pool5", f"--out={tmp_path / 'out'}",
            "--num_batches=1"]
    assert text.main(args + ["--cpu"]) == 0
    assert text.main(args + ["--gpu=-1"]) == 0
    assert len(_read(str(tmp_path / "out"), "ip2")[0]) == BATCH
    # --mesh N > 1 needs N ranks: without a process group it says how to
    # launch them (tests/test_torch_parallel_driver.py runs 2)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        text.main(args + ["--mesh=4", "--cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        text.main(args)
    with pytest.raises(RuntimeError, match="is_available"):
        text.extract(project["net"], [], ["ip2"], str(tmp_path / "x"), 1)


def test_image_data_extraction_matches_jax(tmp_path, monkeypatch):
    """The extraction prototxt as generate_extraction_net.py emits it
    (IMAGE_DATA over a list of JPEGs, resized to 112), PIL decoding in
    both packages."""
    from PIL import Image
    monkeypatch.setenv("VVTPU_NATIVE_DECODE", "0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    rs = np.random.RandomState(3)
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.jpg"
        Image.fromarray(rs.randint(0, 256, (130, 120, 3)).astype(np.uint8)) \
            .save(p)
        paths.append(f"{p} {i}")
    (tmp_path / "list.txt").write_text("\n".join(paths) + "\n")
    mean = tmp_path / "mean.blob"
    mean.write_bytes(twire.BlobProto.from_array(
        np.full((1, 3, SIDE, SIDE), 100.0, np.float32)).encode())
    net = tmp_path / "net.prototxt"
    net.write_text(extraction_net(str(tmp_path / "list.txt"), str(mean)))
    spec = {"data": np.zeros((BATCH, 3, CROP, CROP), np.float32),
            "label": np.zeros(BATCH, np.float32)}
    w = str(tmp_path / "w.caffemodel")
    params_to_weights(_random_params(JNet(jparse(net.read_text()), "TEST"),
                                     spec)).save(w)
    jext.extract(str(net), [w], ["ip2"], str(tmp_path / "j"), 2)
    text.extract(str(net), [w], ["ip2"], str(tmp_path / "t"), 2,
                 device="cpu")
    jk, jd, _ = _read(str(tmp_path / "j"), "ip2")
    tk, td, _ = _read(str(tmp_path / "t"), "ip2")
    assert tk == jk and len(tk) == 4
    ref = np.stack([d.float_data for d in jd])
    np.testing.assert_allclose(np.stack([d.float_data for d in td]), ref,
                               rtol=0, atol=1e-5 * np.abs(ref).max())
