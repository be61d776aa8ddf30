"""The port's host sinks (Net.process_host_sinks: WRITE_TO_FILE,
HDF5_OUTPUT and the rank-stats report csvs) against the JAX package's on
the CPU, and the sinks through the port's SolverDriver and `vvtpu-torch
train`/`test` (tests/test_e2e.py's sink tests on the mini project of
tests/test_torch_driver.py).

Both packages' Nets get the same blob values, so their files can be held
byte for byte: the csvs are equal bytes, and the HDF5 datasets (the
port's own writer, data/hdf5.py, read back by h5py) are equal arrays.
"""

from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_driver import Lines, _solver, write_mini_project

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import hdf5
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.solver import driver as tdriver
from videovector_tpu_torch.solver.checkpoint import snapshot
from videovector_tpu_torch.tools import cli

torch.set_num_threads(1)

SINKS = """
layers {{ name: "d" type: MEMORY_DATA top: "y" top: "x" top: "img" }}
layers {{ name: "wtf" type: WRITE_TO_FILE bottom: "y"
  write_to_file_param {{ output_file: "{d}/acts.csv" }} }}
layers {{ name: "wtf4" type: WRITE_TO_FILE bottom: "img"
  write_to_file_param {{ output_file: "{d}/img.csv" feat_size: 7 }} }}
layers {{ name: "h5" type: HDF5_OUTPUT bottom: "y" bottom: "x"
  hdf5_output_param {{ file_name: "{d}/out.h5" }} }}
"""


def _sink_blobs(rs):
    return {"y": rs.randn(4, 3).astype(np.float32) * 1e3,
            "x": rs.randint(-2, 9, 4).astype(np.float32),
            "img": rs.randn(2, 3, 4, 5).astype(np.float32)}


def _dump(tmp_path, tag, txt, blobs, **kw):
    """The sinks of `txt` (with {d} = tmp_path/tag) through the JAX Net
    ("j") or the port's ("t"); returns the directory."""
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    if tag.startswith("j"):
        net = JNet(jparse(txt.format(d=d)), "TEST")
        net.process_host_sinks({k: jnp.asarray(v) for k, v in blobs.items()},
                               **kw)
    else:
        net = TNet(tparse(txt.format(d=d)), "TEST")
        net.process_host_sinks({k: torch.as_tensor(v)
                                for k, v in blobs.items()}, **kw)
    return d


def test_write_to_file_and_hdf5_equal_jax(tmp_path, rng):
    """The csvs of a 2-D and a 4-D blob (feat_size caps the row) are JAX's
    bytes; the .h5 file holds JAX's "data" and "label" datasets."""
    blobs = _sink_blobs(rng)
    j, t = (_dump(tmp_path, tag, SINKS, blobs) for tag in ("j", "t"))
    for name in ("acts.csv", "img.csv"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    lines = (t / "acts.csv").read_text().splitlines()
    assert lines[0] == "#batch_id,channel_id,features(1..1)"
    assert len(lines) == 1 + 4 * 3
    with h5py.File(j / "out.h5", "r") as fj, h5py.File(t / "out.h5", "r") as ft:
        assert sorted(ft) == sorted(fj) == ["data", "label"]
        for k in fj:
            assert ft[k].dtype == fj[k].dtype and ft[k].shape == fj[k].shape
            np.testing.assert_array_equal(ft[k][()], fj[k][()])


def test_sinks_truncate_on_every_forward_and_append_on_request(tmp_path, rng):
    first, second = _sink_blobs(rng), _sink_blobs(rng)
    for kw in ({}, {"append": True}):
        dirs = []
        for tag in ("j", "t"):
            tag = tag + str(len(kw))
            _dump(tmp_path, tag, SINKS, first, **kw)
            dirs.append(_dump(tmp_path, tag, SINKS, second, **kw))
        j, t = dirs
        assert (t / "acts.csv").read_bytes() == (j / "acts.csv").read_bytes()
        n = len((t / "acts.csv").read_text().splitlines())
        assert n == (1 + 2 * 12 if kw else 1 + 12)
        with h5py.File(t / "out.h5", "r") as f:
            np.testing.assert_array_equal(f["data"][()], second["y"])


@pytest.mark.parametrize("bottoms,kind", [
    ('bottom: "x" bottom: "y"', "WRITE_TO_FILE"),
    ('bottom: "x"', "HDF5_OUTPUT"),
    ('bottom: "x" bottom: "y" bottom: "z"', "HDF5_OUTPUT")])
def test_sink_bottom_counts_are_checked_as_jax_checks(bottoms, kind):
    txt = f"""
    layers {{ name: "d" type: MEMORY_DATA top: "x" top: "y" top: "z" }}
    layers {{ name: "s" type: {kind} {bottoms} }}
    """
    for net_cls, parse in ((JNet, jparse), (TNet, tparse)):
        with pytest.raises(ValueError, match="expected exactly"):
            net_cls(parse(txt), "TEST")


def test_hdf5_output_batch_sizes_must_agree(tmp_path):
    txt = f"""
    layers {{ name: "d" type: MEMORY_DATA top: "x" top: "y" }}
    layers {{ name: "h" type: HDF5_OUTPUT bottom: "x" bottom: "y"
      hdf5_output_param {{ file_name: "{tmp_path}/o.h5" }} }}
    """
    net = TNet(tparse(txt), "TEST")
    with pytest.raises(ValueError, match="batch sizes differ"):
        net.process_host_sinks({"x": torch.zeros(3, 2), "y": torch.zeros(4)})


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "uint8", "int8"])
def test_hdf5_writer_round_trips_through_h5py(tmp_path, rng, dtype):
    """data/hdf5.py's files, read by libhdf5 (h5py): every dtype it takes,
    several ranks, an empty dataset and a scalar."""
    arrays = {"a": (rng.randn(3, 4, 5) * 50).astype(dtype),
              "b": np.arange(7).astype(dtype), "empty": np.zeros((0, 3), dtype),
              "scalar": np.asarray(5, dtype)}
    hdf5.write_hdf5(str(tmp_path / "x.h5"), arrays)
    with h5py.File(tmp_path / "x.h5", "r") as f:
        assert sorted(f) == sorted(arrays)
        for k, v in arrays.items():
            assert f[k].dtype == v.dtype and f[k].shape == v.shape
            np.testing.assert_array_equal(f[k][()], v)


def test_hdf5_writer_refuses_what_it_cannot_store(tmp_path):
    with pytest.raises(TypeError, match="no HDF5 datatype"):
        hdf5.write_hdf5(str(tmp_path / "x.h5"),
                        {"c": np.zeros(2, np.complex64)})
    with pytest.raises(ValueError, match="1..255 bytes"):
        hdf5.write_hdf5(str(tmp_path / "x.h5"), {"": np.zeros(2)})


def test_lookup3_known_values():
    """Bob Jenkins' published hashlittle test vectors."""
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551
    assert hdf5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


RANK = """
layers {{ name: "d" type: MEMORY_DATA top: "ctx" top: "tgt" top: "q"
  top: "qv" top: "g" top: "gv" }}
layers {{ name: "rs" type: RETRIEVAL_RANK_STATS bottom: "ctx" bottom: "tgt"
  top: "mr" top: "r1" top: "r5" top: "r10" top: "ap"
  retrieval_rank_stats_param {{ compute_ap: @AP@ positive_size: 1
    negative_size: 2 stats_output_file: "{d}/rank.csv" }} }}
layers {{ name: "fr" type: RETRIEVAL_RANK_STATS_FIXED_REF bottom: "q"
  bottom: "qv" bottom: "g" bottom: "gv"
  top: "fmr" top: "fr1" top: "fr5" top: "fr10" top: "fap"
  retrieval_rank_stats_fixed_ref_param {{ stats_output_file: "{d}/fixed.csv" }} }}
"""


@pytest.mark.parametrize("ap", ["true", "false"])
def test_rank_stats_csvs_equal_jax(tmp_path, rng, ap):
    """Both rank-stats layers with a stats_output_file are host sinks, and
    their csvs (the fixed-ref rows with the video_id column the header does
    not name) are JAX's bytes."""
    b = 6
    blobs = {"ctx": rng.randn(b, 5).astype(np.float32),
             "tgt": rng.randn(3 * b if ap == "true" else b, 5)
             .astype(np.float32),
             "q": rng.randn(b, 5).astype(np.float32),
             "qv": rng.randint(1, 4, b).astype(np.float32),
             "g": rng.randn(20, 5).astype(np.float32),
             "gv": rng.randint(-1, 4, 20).astype(np.float32)}
    txt = RANK.replace("@AP@", ap)
    assert [s["name"] for s in TNet(tparse(txt.format(d=tmp_path)),
                                    "TEST").host_sinks] == ["rs", "fr"]
    j, t = (_dump(tmp_path, tag, txt, blobs) for tag in ("j", "t"))
    for name in ("rank.csv", "fixed.csv"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    head = (t / "fixed.csv").read_text().splitlines()
    assert head[0].startswith("#item_id,rank,rec@1,rec@5,ret_id_1")
    assert len(head[1].split(",")) == 15     # i, video_id, rank, 2 + 10


WRITE_CTX = """
layers {{ name: "dump_ctx" type: WRITE_TO_FILE bottom: "ctxn"
  write_to_file_param {{ output_file: "{path}" }}
  include: {{ phase: {phase} }} }}
"""


def test_sinks_are_written_in_test_and_train_and_by_the_cli(tmp_path):
    """tests/test_e2e.py's sink tests through the port: a TEST-phase
    WRITE_TO_FILE and the stats csv at every test interval, a TRAIN-phase
    WRITE_TO_FILE truncated on every step (one forward's rows, not the
    steps' sum), an HDF5_OUTPUT of the test embeddings and ids, then
    `vvtpu-torch train` and `vvtpu-torch test` writing them again."""
    mini = write_mini_project(tmp_path)
    d = tmp_path
    net = Path(mini["net"]).read_text().replace(
        "exclude_same_video_shots: false }",
        f'exclude_same_video_shots: false stats_output_file: "{d}/stats.csv" }}')
    net += WRITE_CTX.format(path=d / "test_acts.csv", phase="TEST")
    net += WRITE_CTX.format(path=d / "train_acts.csv", phase="TRAIN")
    net += f"""
layers {{ name: "h5" type: HDF5_OUTPUT bottom: "ctxn" bottom: "video_ids"
  hdf5_output_param {{ file_name: "{d}/test.h5" }} include: {{ phase: TEST }} }}
"""
    Path(mini["net"]).write_text(net)
    files = ("stats.csv", "test_acts.csv", "train_acts.csv", "test.h5")

    def run(max_iter):
        _, tmsg = _solver(mini, max_iter=max_iter, test_interval=2)
        return tdriver.SolverDriver(tmsg, device="cpu").build().train()

    res = run(1)
    train_rows = len((d / "train_acts.csv").read_text().splitlines())
    res = run(4)
    assert res.test_history
    assert all("__sinks__" not in m for _, m in res.metrics_history)
    assert len((d / "train_acts.csv").read_text().splitlines()) == train_rows
    stats = (d / "stats.csv").read_text().splitlines()
    assert stats[0].startswith("#video_id,class_id,ap,acc@1,acc@5")
    assert len(stats) == 1 + 12
    acts = (d / "test_acts.csv").read_text().splitlines()
    assert acts[0] == "#batch_id,channel_id,features(1..1)"
    assert len(acts) == 1 + 12 * 16
    with h5py.File(d / "test.h5", "r") as f:
        assert f["data"].shape == (12, 16) and f["label"].shape == (12,)

    for name in files:
        (d / name).unlink()
    snap = snapshot(str(d / "sink_snap"), 0, res.params)[0]
    assert cli.main(["train", "--solver", mini["solver"], "--cpu"]) == 0
    assert all((d / name).exists() for name in files)
    for name in files:
        (d / name).unlink()
    with Lines() as out:
        assert cli.main(["test", "--model", mini["net"], "--weights", snap,
                         "--iterations", "2", "--cpu"]) == 0
    assert any(line.startswith("Loss: ") for line in out.lines)
    for name in ("stats.csv", "test_acts.csv", "test.h5"):
        assert (d / name).exists(), name
    assert not (d / "train_acts.csv").exists()
    assert (d / "test_acts.csv").read_text().startswith(
        "#batch_id,channel_id,")
