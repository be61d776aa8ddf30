"""The port's data-source factory (videovector_tpu_torch.graph.data_factory)
and its binding of the C++ flagship sampler (videovector_tpu_torch.data.
native) against the JAX package's, on the CPU: the factory picks the source
JAX's picks, and the same stores and seed give the same batches bit for bit,
through the Python samplers and through the native one."""

import ctypes
import importlib.util
import logging
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from videovector_tpu.config import parse as jparse
from videovector_tpu.data import native as jnative
from videovector_tpu.graph import data_factory as jfac
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import native as tnative
from videovector_tpu_torch.data import records as trec
from videovector_tpu_torch.data import shots as tshots
from videovector_tpu_torch.data import wire as twire
from videovector_tpu_torch.graph import data_factory as tfac

ROOT = Path(__file__).resolve().parent.parent


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build native/vvdata.cpp")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A training store of 40 videos x 9 shots and a test store of 30
    windows of 4 context shots over 6 videos, 24 dims, written by the
    port (byte-identical to the JAX package's writer)."""
    tmp = tmp_path_factory.mktemp("stores")
    rs = np.random.RandomState(31)
    videos = []
    for v in range(40):
        center = rs.randn(24).astype(np.float32)
        feats = np.abs(center + 0.4 * rs.randn(9, 24).astype(np.float32))
        videos.append(tshots.ShotVideo(v + 1, np.arange(9, dtype=np.int32),
                                       feats))
    train, test = str(tmp / "train.vvr"), str(tmp / "test.vvr")
    tshots.ShotDataset(videos).to_records(train)
    with trec.RecordWriter(test) as w:
        for i in range(30):
            video = videos[i % 6]
            ids = rs.choice(9, size=4, replace=False)
            w.append(str(i), twire.TestVideoShotWindows(
                video_id=int(video.video_id), context_shot_words=[
                    twire.Datum(float_data=video.features[j])
                    for j in ids]).encode())
    return train, test


def _net(train, test, **kw):
    spec = importlib.util.spec_from_file_location(
        "generate_net", ROOT / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = dict(batch=6, test_batch=8, buffer_size=100, embed=16)
    args.update(kw)
    return mod.emit(train, test, **args)


def _data_layers(txt, parse):
    return {(l.get("type"), l.get_msg("include").get("phase")): l
            for l in parse(txt).get_list("layers")
            if l.get("type").endswith("_DATA")}


def _same_batches(tsrc, jsrc, n=6):
    for _ in range(n):
        tb, jb = tsrc.next_batch(), jsrc.next_batch()
        assert sorted(tb) == sorted(jb)
        for k in jb:
            a, b = np.asarray(tb[k]), np.asarray(jb[k])
            assert a.shape == b.shape and a.dtype == b.dtype
            assert a.tobytes() == b.tobytes(), k


def test_python_samplers_match_jax_factory(stores, monkeypatch):
    """VVTPU_NATIVE_DATA=0: both factories take their Python samplers; the
    TRAIN and TEST sources give JAX's batches bit for bit."""
    monkeypatch.setenv("VVTPU_NATIVE_DATA", "0")
    txt = _net(*stores)
    tl, jl = _data_layers(txt, tparse), _data_layers(txt, jparse)
    for key, phase, seed in ((("VIDEO_SAMPLED_SHOTS_DATA", "TRAIN"), "TRAIN", 77),
                             (("VIDEO_SHOT_WINDOW_TEST_DATA", "TEST"), "TEST", 1)):
        tsrc = tfac.make_data_source(tl[key], phase=phase, seed=seed)
        jsrc = jfac.make_data_source(jl[key], phase=phase, seed=seed)
        assert type(tsrc.source).__name__ == type(jsrc.source).__name__
        assert tsrc.batch_axes() == jsrc.batch_axes()
        _same_batches(tsrc, jsrc)
    assert isinstance(tsrc.source, tshots.VideoShotWindowTestSource)


def test_native_sampler_matches_jax_native_sampler(stores):
    """The port's own build of native/vvdata.cpp against the JAX package's
    on the same store and seed: the same batches bit for bit, and each
    factory takes its native sampler for the flagship's VVR WINDOW source.
    The port's library lives in its own _build/, not in native/."""
    _needs_gxx()
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    assert tnative.available()
    lib = tnative.build_library()
    assert lib.parent == tnative.BUILD_DIR and lib.name.startswith("libvvdata_")
    kw = dict(batch_size=5, context_size=5, num_negative_samples=10,
              max_buffer_size=100, negative_swap_percentage=50,
              max_same_video_negs=6, seed=4321)
    t = tnative.NativeSampledShotsSource(stores[0], **kw)
    j = jnative.NativeSampledShotsSource(stores[0], **kw)
    assert (t.channels, t.feature_dim) == (j.channels, j.feature_dim) == (15, 24)
    _same_batches(t, j)
    t.close()
    j.close()
    with pytest.raises(RuntimeError, match="closed"):
        t.next_batch()

    txt = _net(*stores)
    key = ("VIDEO_SAMPLED_SHOTS_DATA", "TRAIN")
    tsrc = tfac.make_data_source(_data_layers(txt, tparse)[key], seed=9)
    jsrc = jfac.make_data_source(_data_layers(txt, jparse)[key], seed=9)
    assert isinstance(tsrc.source, tnative.NativeSampledShotsSource)
    assert isinstance(jsrc.source, jnative.NativeSampledShotsSource)
    _same_batches(tsrc, jsrc)
    tsrc.source.close()
    jsrc.source.close()


def test_native_sampler_rejects_what_jax_rejects(stores, tmp_path):
    _needs_gxx()
    with pytest.raises(IOError, match="reservoir"):
        tnative.NativeSampledShotsSource(stores[0], max_buffer_size=10_000)
    with pytest.raises(IOError, match="cannot open"):
        tnative.NativeSampledShotsSource(str(tmp_path / "missing.vvr"))


@pytest.mark.parametrize("change", ["pairwise", "negative_dataset", "not_vvr",
                                    "unavailable"])
def test_factory_takes_the_python_sampler_where_jax_does(stores, monkeypatch,
                                                         change):
    """Not WINDOW, a separate negative dataset, a store that is not VVR, or
    no native library: the Python sampler, as JAX's factory chooses."""
    train, test = stores
    txt = _net(train, test)
    if change == "pairwise":
        txt = txt.replace("context_type: WINDOW", "context_type: PAIRWISE")
    elif change == "negative_dataset":
        txt = txt.replace("context_type: WINDOW",
                          f'context_type: WINDOW negative_dataset: "{train}"')
    elif change == "unavailable":
        monkeypatch.setattr(tnative, "available", lambda: False)
    layer = _data_layers(txt, tparse)["VIDEO_SAMPLED_SHOTS_DATA", "TRAIN"]
    if change == "not_vvr":
        monkeypatch.setattr(tfac, "is_vvr", lambda path: False)
    src = tfac.make_data_source(layer, seed=5)
    assert isinstance(src.source, tshots.VideoSampledShotsSource)
    assert src.next_batch()["data"].shape[0] == 6


def test_factory_errors_name_their_roadmap_items(stores):
    """MEMORY_DATA has no factory, as in JAX. device_negatives (item 7, once
    refused) builds the Python sampler without negatives and the seed
    buffer, both bit for bit JAX's factory's."""
    txt = _net(*stores, device_negatives=True)
    layer = _data_layers(txt, tparse)["VIDEO_SAMPLED_SHOTS_DATA", "TRAIN"]
    src = tfac.make_data_source(layer, seed=5)
    jsrc = jfac.make_data_source(
        _data_layers(txt, jparse)["VIDEO_SAMPLED_SHOTS_DATA", "TRAIN"], seed=5)
    assert isinstance(src.source, tshots.VideoSampledShotsSource)
    np.testing.assert_array_equal(src.device_negatives["buffer"],
                                  jsrc.device_negatives["buffer"])
    np.testing.assert_array_equal(src.next_batch()["data"],
                                  jsrc.next_batch()["data"])
    layer = tparse('layers { name: "d" type: MEMORY_DATA top: "x" }'
                   ).get_list("layers")[0]
    with pytest.raises(NotImplementedError, match="no data-source factory"):
        tfac.make_data_source(layer)


@pytest.mark.parametrize("case", ["VIDEO_SHOT_WINDOW_DATA", "VIDEO_ID_TEXT",
                                  "WINDOW_DATA", "FLEXIBLE_DATA",
                                  "HDF5_DATA"])
def test_factory_builds_the_stores_and_caffe_interop_sources(tmp_path, case):
    """The four data layers the factory once refused, and VIDEO_SHOT_WINDOW
    _DATA's VIDEO_ID_TEXT backend, built from their layer messages over
    tests/test_torch_generic_sources.py's fixtures (a LevelDB window store,
    an LMDB index and frame store, h5py files, PNG windows): the tops
    named as the layer names them, the batch axes and 4 batches bit for
    bit those of JAX's factory."""
    pytest.importorskip("h5py")
    pytest.importorskip("cv2")
    from test_torch_generic_sources import _bits_equal, factory_layers
    text = factory_layers(tmp_path)[case]
    layer = tparse(text).get_list("layers")[0]
    tsrc = tfac.make_data_source(layer, phase="TRAIN", seed=21)
    jsrc = jfac.make_data_source(jparse(text).get_list("layers")[0],
                                 phase="TRAIN", seed=21)
    assert tsrc.batch_axes() == jsrc.batch_axes()
    for _ in range(4):
        batch = tsrc.next_batch()
        assert sorted(batch) == sorted(str(t) for t in layer.get_list("top"))
        _bits_equal(batch, jsrc.next_batch())


TRACKING_LAYERS = """
layers {{ name: "tracks" type: TRACKING_WINDOWS_DATA
  top: "observed" top: "cont_obs" top: "predicted" top: "cont_pred" top: "gt"
  tracking_windows_data_param {{ source: "{src}" batch_size: 6
    temporal_observed_size: 5 temporal_predicted_size: 3
    track_scale: 0.5 max_number_positions: 2 }} }}
layers {{ name: "social" type: TRACKING_WINDOWS_SOCIAL_DATA
  top: "obs" top: "mean" top: "pred" top: "rel" top: "valid" top: "labels"
  tracking_windows_data_param {{ source: "{src}" batch_size: 8
    temporal_observed_size: 5 temporal_predicted_size: 3
    encoder_bit: false }} }}
"""


def test_factory_builds_both_tracking_sources(tmp_path, rng):
    """TRACKING_WINDOWS_DATA and TRACKING_WINDOWS_SOCIAL_DATA from their
    layer messages: the tops named as the layer names them, the batch axes
    declared (time-major tops on 1), and the batches bit for bit those of
    JAX's factory on the same store, written by the port."""
    src = str(tmp_path / "tracks.vvr")
    with trec.RecordWriter(src) as w:
        for i in range(7):
            tracks = [twire.TrackPositions(
                id=10 * i + k, x=list(rng.randn(9)), y=list(rng.randn(9)))
                for k in range(1 + i % 4)]
            w.append(f"{i:08d}", twire.TrackingWindow(
                scene_id=i, track_positions=tracks).encode())
    txt = TRACKING_LAYERS.format(src=src)
    tops = {"TRACKING_WINDOWS_DATA": ["observed", "cont_obs", "predicted",
                                      "cont_pred", "gt"],
            "TRACKING_WINDOWS_SOCIAL_DATA": ["obs", "mean", "pred", "rel",
                                             "valid", "labels"]}
    for tl, jl in zip(tparse(txt).get_list("layers"),
                      jparse(txt).get_list("layers")):
        got, want = tfac.make_data_source(tl), jfac.make_data_source(jl)
        assert got.batch_axes() == want.batch_axes()
        assert got.batch_axes()[tops[tl.get("type")][0]] == 1
        for _ in range(3):
            gb, wb = got.next_batch(), want.next_batch()
            assert sorted(gb) == sorted(wb) == sorted(tops[tl.get("type")])
            for k in wb:
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.text = ""

    def emit(self, record):
        self.text += record.getMessage()


def test_failed_native_build_is_logged_not_swallowed(tmp_path, monkeypatch):
    """A source that does not compile: build_library returns None and logs
    the compiler's error as a warning; nothing is left in the build
    directory. A missing source or compiler likewise."""
    warnings = _Warnings()
    tnative.log.addHandler(warnings)
    try:
        if shutil.which("g++") is not None:
            bad = tmp_path / "vvdata.cpp"
            bad.write_text("int broken( {\n")
            monkeypatch.setattr(tnative, "SOURCE", bad)
            assert tnative.build_library(tmp_path / "b") is None
            assert "g++ failed" in warnings.text and "error" in warnings.text
            assert list((tmp_path / "b").iterdir()) == []
        monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
        assert tnative.build_library(tmp_path / "c") is None
        assert "g++ not found" in warnings.text
        monkeypatch.setattr(tnative, "SOURCE", tmp_path / "absent.cpp")
        assert tnative.build_library(tmp_path / "d") is None
        assert "absent.cpp not found" in warnings.text
    finally:
        tnative.log.removeHandler(warnings)


def test_merged_source_joins_its_sources(stores, monkeypatch):
    monkeypatch.setenv("VVTPU_NATIVE_DATA", "0")
    txt = _net(*stores)
    layers = _data_layers(txt, tparse)
    merged = tfac.MergedSource([
        tfac.make_data_source(layers["VIDEO_SAMPLED_SHOTS_DATA", "TRAIN"]),
        tfac.make_data_source(layers["VIDEO_SHOT_WINDOW_TEST_DATA", "TEST"],
                              phase="TEST")])
    batch = next(iter(merged))
    assert sorted(batch) == ["data", "video_ids"]
    assert merged.batch_axes() == {"data": 0, "video_ids": 0}


def test_library_name_says_whether_the_decoder_is_in(tmp_path):
    """Builds with and without libjpeg get different names, so that neither
    stands in for the other; the one without reports no decoder."""
    _needs_gxx()
    assert tnative.library_path(tmp_path, True) != \
        tnative.library_path(tmp_path, False)
    lib = tnative.build_library(tmp_path, jpeg=False)
    assert lib == tnative.library_path(tmp_path, False)
    assert lib.name.endswith("_nojpeg.so")
    assert not ctypes.CDLL(str(lib)).vv_jpeg_available()


def test_jpeg_build_that_does_not_load_gives_way_to_one_without(
        tmp_path, monkeypatch):
    """A cached `_jpeg` library whose dependency is missing here (built
    where libjpeg was, loaded where it is not): _library() logs why it does
    not load and builds and loads the library without the decoder, so that
    available() holds and the training path keeps its native sampler."""
    _needs_gxx()
    (tmp_path / "gone.cpp").write_text("int vv_gone() { return 1; }\n")
    (tmp_path / "user.cpp").write_text(
        "extern int vv_gone();\nint vv_user() { return vv_gone(); }\n")
    dep = tmp_path / "libvvgone.so"
    broken = tnative.library_path(tmp_path, True)
    for cmd in (["g++", "-shared", "-fPIC", "-o", str(dep),
                 str(tmp_path / "gone.cpp")],
                ["g++", "-shared", "-fPIC", "-o", str(broken),
                 str(tmp_path / "user.cpp"), f"-L{tmp_path}", "-lvvgone"]):
        subprocess.run(cmd, check=True, capture_output=True)
    dep.unlink()
    with pytest.raises(OSError, match="libvvgone"):
        ctypes.CDLL(str(broken))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_has_libjpeg", lambda cxx: True)
    warnings = _Warnings()
    tnative.log.addHandler(warnings)
    tnative._library.cache_clear()
    try:
        assert tnative.available()
        assert not tnative.jpeg_available()
        assert tnative.library_path(tmp_path, False).is_file()
        assert "does not load" in warnings.text and "libvvgone" in warnings.text
    finally:
        tnative.log.removeHandler(warnings)
        tnative._library.cache_clear()
