"""The port's host data plane (videovector_tpu_torch.data: wire, records,
shots, transformer) against the JAX package's, on the CPU: the same
messages encode to the same bytes and decode to the same values, bit for
bit; the VVR files of both writers are byte-identical and each package
reads the other's; every sampler gives the same batches bit for bit for the
same seed and dataset, and raises where the JAX one raises."""

import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from videovector_tpu.data import records as jrec
from videovector_tpu.data import shots as jshots
from videovector_tpu.data import transformer as jtr
from videovector_tpu.data import wire as jwire
from videovector_tpu_torch.data import records as trec
from videovector_tpu_torch.data import shots as tshots
from videovector_tpu_torch.data import transformer as ttr
from videovector_tpu_torch.data import wire as twire

ROOT = Path(__file__).resolve().parent.parent


def _bits_equal(a, b):
    """Arrays equal bit for bit (NaN payloads and -0.0 included)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _floats_equal(a: list, b: list):
    assert all(type(x) is float for x in a) and all(type(x) is float
                                                    for x in b)
    _bits_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))


def _same_value(t, j):
    """A decoded message of the port equals the JAX package's: field by
    field, arrays bit for bit, nested messages recursively."""
    if isinstance(j, np.ndarray):
        _bits_equal(t, j)
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j)
        if j and isinstance(j[0], float):
            _floats_equal(t, j)
        else:
            for a, b in zip(t, j):
                _same_value(a, b)
    elif hasattr(j, "__dataclass_fields__"):
        assert type(t).__name__ == type(j).__name__
        assert list(t.__dataclass_fields__) == list(j.__dataclass_fields__)
        for f in j.__dataclass_fields__:
            _same_value(getattr(t, f), getattr(j, f))
    else:
        assert type(t) is type(j) and t == j, (t, j)


def _outcome(fn, data):
    """fn(data)'s value, or its exception's type and text."""
    try:
        return "ok", fn(data)
    except Exception as e:  # noqa: BLE001 - compared between packages
        return type(e).__name__, str(e)


# -- wire -------------------------------------------------------------------

def _odd_floats(rs, n):
    """Random f32 values with a signalling NaN, a quiet NaN with payload,
    -0.0, infinities, a subnormal and the f32 extremes among them."""
    x = rs.randn(n).astype(np.float32)
    special = np.array([0x7F800001, 0xFFA00123, 0x7FC00001, 0x80000000,
                        0x7F800000, 0xFF800000, 0x00000001, 0x7F7FFFFF],
                       np.uint32).view(np.float32)
    x[:len(special)] = special[:n]
    return x


def _datum(pkg, rs, n=37, **kw):
    return pkg.Datum(channels=1, height=n, width=1, label=-int(rs.randint(9)),
                     float_data=_odd_floats(rs, n), mean=rs.randn(3),
                     min=rs.randn(2).astype(np.float32),
                     max=list(rs.randn(2)), **kw)


def _messages(pkg, seed=0):
    """One of each message type of data/wire.py, from a seed: negative
    int32s, uint8 data, unpacked floats with NaNs and -0.0, packed floats,
    names and nested messages."""
    rs = np.random.RandomState(seed)
    img = pkg.Datum(channels=3, height=4, width=5,
                    data=rs.randint(0, 256, 60).astype(np.uint8).tobytes(),
                    label=7)
    return [
        _datum(pkg, rs),
        img,
        pkg.Datum(),
        pkg.VideoShotWindow(video_id=-5, shot_id=3, video_name="vidé 1",
                            target_shot_word=_datum(pkg, rs, 5),
                            context_shot_words=[_datum(pkg, rs, 5)
                                                for _ in range(4)]),
        pkg.VideoShots(video_id=12, shot_ids=[0, -1, 2 ** 31 - 1, -2 ** 31],
                       shot_words=[_datum(pkg, rs, 8) for _ in range(4)],
                       video_name="v12"),
        pkg.TestVideoShotWindows(
            video_id=3, positive_shot_id=[4, -2], video_name="t",
            positive_shot_words=[_datum(pkg, rs, 6) for _ in range(2)],
            context_shot_words=[_datum(pkg, rs, 6) for _ in range(4)],
            negative_shot_words=[_datum(pkg, rs, 6) for _ in range(3)],
            negative_shot_id=[9, 10, -11]),
        pkg.TrackPositions(id=-4, x=list(rs.randn(5)), y=list(_odd_floats(rs, 5)),
                           cl=2, static_scene=img),
        pkg.TrackingWindow(observed_time=list(rs.randn(3)),
                           prediction_time=[0.5, -0.0],
                           scene_id=8,
                           track_positions=[pkg.TrackPositions(
                               id=i, x=[float(i)], y=[], cl=1)
                               for i in range(3)]),
        pkg.BlobProto.from_array(_odd_floats(rs, 24).reshape(2, 3, 4)),
        pkg.BlobProto(num=1, channels=1, height=1, width=3,
                      data=np.arange(3, dtype=np.float32),
                      diff=np.float32([1.5, -0.0, 2])),
    ]


@pytest.mark.parametrize("i", range(10))
def test_every_message_encodes_to_jax_bytes_and_decodes_to_jax_values(i):
    jm, tm = _messages(jwire)[i], _messages(twire)[i]
    data = jm.encode()
    assert tm.encode() == data
    _same_value(type(tm).decode(data), type(jm).decode(data))
    # and the decoded values encode as JAX's do (a signalling NaN has come
    # back quiet in both)
    assert type(tm).decode(data).encode() == type(jm).decode(data).encode()


def _packed_datum_bytes(rs):
    """A Datum as another writer may lay it out: packed float_data, an
    unpacked run, a packed mean between unpacked ones, fields out of order."""
    buf = bytearray()
    jwire.write_packed_floats(buf, 6, _odd_floats(rs, 9))
    jwire.write_repeated_floats(buf, 7, rs.randn(3))
    jwire.write_int(buf, 5, -2 ** 31)
    jwire.write_repeated_floats(buf, 6, rs.randn(70))   # run past the probe
    jwire.write_packed_floats(buf, 7, rs.randn(2))
    jwire.write_float(buf, 6, 1.25)
    jwire.write_repeated_floats(buf, 8, rs.randn(1))
    jwire.write_float(buf, 7, -0.0)
    jwire.write_bytes(buf, 4, b"\x00\x01")
    jwire.write_int(buf, 1, 2)
    jwire.write_repeated_floats(buf, 9, [])
    return bytes(buf)


def test_packed_interleaved_and_repeated_fields_decode_as_jax():
    rs = np.random.RandomState(1)
    data = _packed_datum_bytes(rs)
    _same_value(twire.Datum.decode(data), jwire.Datum.decode(data))
    assert len(twire.Datum.decode(data).float_data) == 9 + 70 + 1
    # BlobProto and TrackPositions with packed and unpacked runs
    blob = bytearray()
    jwire.write_repeated_floats(blob, 5, rs.randn(4))       # unpacked data
    jwire.write_packed_floats(blob, 6, rs.randn(4))
    jwire.write_int(blob, 1, 1)
    _same_value(twire.BlobProto.decode(bytes(blob)),
                jwire.BlobProto.decode(bytes(blob)))
    pos = bytearray()
    jwire.write_packed_floats(pos, 2, rs.randn(3))
    jwire.write_repeated_floats(pos, 2, rs.randn(2))
    jwire.write_repeated_floats(pos, 3, _odd_floats(rs, 8))
    _same_value(twire.TrackPositions.decode(bytes(pos)),
                jwire.TrackPositions.decode(bytes(pos)))
    # a message as a memoryview of a larger buffer (records give mmap slices)
    mv = memoryview(b"xx" + data)[2:]
    _same_value(twire.Datum.decode(bytes(mv)), jwire.Datum.decode(data))


@pytest.mark.parametrize("name", ["Datum", "VideoShots",
                                  "TestVideoShotWindows", "TrackingWindow",
                                  "BlobProto"])
def test_truncated_and_malformed_records_fail_as_jax(name):
    """Every prefix of an encoded message, and a few corrupt records,
    decode to the same values or fail with the same error in both."""
    rs = np.random.RandomState(2)
    msgs = {type(m).__name__: m for m in _messages(jwire, seed=3)}
    data = msgs[name].encode()
    if name == "Datum":
        data = _packed_datum_bytes(rs)
    cuts = sorted(set(range(0, min(len(data), 400)))
                  | set(range(max(0, len(data) - 60), len(data))))
    bad = [data[:k] for k in cuts]
    bad += [bytes([0x0B]) + data,                      # wire type 3
            bytes([0xFF] * 11),                        # varint too long
            bytes([0x31, 0x00]),                       # float_data as varint
            bytes([0x32, 0x03, 1, 2, 3]),              # packed, not x4 bytes
            bytes([0x0D, 1, 2, 3, 4]),                 # field 1 as I32
            bytes([0x09]) + bytes(7),                  # truncated I64
            bytes([0x35, 0, 0, 128, 63, 0x35, 1])]     # run then truncated
    jcls, tcls = getattr(jwire, name), getattr(twire, name)
    for b in bad:
        jo, to = _outcome(jcls.decode, b), _outcome(tcls.decode, b)
        assert to[0] == jo[0], (b[:20], to, jo)
        if jo[0] == "ok":
            _same_value(to[1], jo[1])
        else:
            assert to[1] == jo[1]


def test_wire_primitives_equal_jax():
    for v in (0, 1, 127, 128, 300, 2 ** 31 - 1, -1, -2 ** 31, 2 ** 63, 2 ** 64 - 1):
        jb, tb = bytearray(), bytearray()
        jwire.write_int(jb, 3, v)
        twire.write_int(tb, 3, v)
        assert jb == tb
        assert twire.read_varint(bytes(jb), 1) == jwire.read_varint(bytes(jb), 1)
    for vals in ([], [1.0], np.float32([np.nan, -0.0, 3e38]), list(range(5))):
        jb, tb = bytearray(), bytearray()
        jwire.write_repeated_floats(jb, 20, vals)      # a 2-byte key
        twire.write_repeated_floats(tb, 20, vals)
        assert jb == tb
        assert list(twire.iter_fields(bytes(jb))) == \
            list(jwire.iter_fields(bytes(jb)))


# -- records ----------------------------------------------------------------

def _items(n=6, seed=4):
    rs = np.random.RandomState(seed)
    return [(f"{i:08d}" if i % 2 else f"key{i}".encode(),
             rs.bytes(rs.randint(0, 50))) for i in range(n)]


def test_vvr_files_are_byte_identical_and_cross_read(tmp_path):
    items = _items()
    jp, tp = str(tmp_path / "j.vvr"), str(tmp_path / "t.vvr")
    jrec.write_records(jp, items)
    trec.write_records(tp, items)
    assert Path(jp).read_bytes() == Path(tp).read_bytes()
    with trec.RecordWriter(str(tmp_path / "w.vvr")) as w:
        for k, v in items:
            w.put(k, v)
    assert Path(tmp_path / "w.vvr").read_bytes() == Path(jp).read_bytes()
    for reader_mod, path in ((trec, jp), (jrec, tp), (trec, tp)):
        r = reader_mod.open_store(path)
        assert len(r) == len(items)
        for i, (k, v) in enumerate(items):
            kb = k.encode() if isinstance(k, str) else k
            assert r.key(i) == kb and bytes(r.value(i)) == v
            assert r.index_of(k) == i and bytes(r.get(k)) == v
            assert (r[i][0], bytes(r[i][1])) == (kb, v)
        assert [(k, bytes(v)) for k, v in r] == [
            (k.encode() if isinstance(k, str) else k, v) for k, v in items]
        r.close()
    assert trec.is_vvr(tp) and not trec.is_vvr(str(tmp_path / "none"))
    os.mkdir(tmp_path / "d")
    trec.write_records(str(tmp_path / "d" / "data.vvr"), items)
    assert trec.convert_dir_or_file(str(tmp_path / "d")) == \
        jrec.convert_dir_or_file(str(tmp_path / "d"))
    assert trec.is_vvr(str(tmp_path / "d"))
    assert len(trec.open_store(str(tmp_path / "d"))) == len(items)


def test_lmdb_and_leveldb_stores_raise_not_ported(tmp_path):
    """open_store and open_store_writer on LMDB and LevelDB (once refused,
    now ported): each package's writer's store opens in the port by
    content, from the directory or the data file, with the JAX reader's
    keys and values; an LMDB meta page with no database behind it and an
    unknown backend raise as JAX's do."""
    items = [(k.decode() if isinstance(k, bytes) else k, v)
             for k, v in _items(9)]
    for backend in ("lmdb", "leveldb"):
        for tag, mod in (("j", jrec), ("t", trec)):
            path = str(tmp_path / f"{backend}_{tag}")
            with mod.open_store_writer(path, backend) as w:
                for k, v in items:
                    w.put(k, v)
            paths = [path] + ([os.path.join(path, "data.mdb")]
                              if backend == "lmdb" else [])
            for where in paths:
                got, want = trec.open_store(where), jrec.open_store(where)
                assert type(got).__name__ == type(want).__name__
                assert [(k, bytes(v)) for k, v in got] == \
                    [(k, bytes(v)) for k, v in want] == \
                    sorted((k.encode(), v) for k, v in items)
                got.close()
                want.close()
    mdb = tmp_path / "lmdb_meta_only"
    mdb.mkdir()
    (mdb / "data.mdb").write_bytes(bytes(16) + struct.pack("<I", 0xBEEFC0DE)
                                   + bytes(100))
    jo = _outcome(jrec.open_store, str(mdb))
    assert _outcome(trec.open_store, str(mdb)) == jo and jo[0] != "ok"
    with pytest.raises(ValueError, match="unknown store backend"):
        trec.open_store_writer(str(tmp_path / "x"), "rocks")
    (tmp_path / "junk").write_bytes(b"not a store at all")
    (tmp_path / "empty").mkdir()
    for path in (tmp_path / "junk", tmp_path / "empty"):
        jo = _outcome(jrec.open_store, str(path))
        to = _outcome(trec.open_store, str(path))
        assert to == jo and to[0] == "ValueError"
    good = tmp_path / "g.vvr"
    trec.write_records(str(good), _items(2))
    corrupt = bytearray(good.read_bytes())
    corrupt[-1] ^= 0xFF
    (tmp_path / "c.vvr").write_bytes(bytes(corrupt))
    for mod in (jrec, trec):
        with pytest.raises(ValueError, match="corrupt footer"):
            mod.RecordReader(str(tmp_path / "c.vvr"))


# -- shot datasets and samplers -------------------------------------------

def _dataset_arrays(n, shots, d, seed, *, vary=False, min_shots=1):
    rs = np.random.RandomState(seed)
    out = []
    for v in range(n):
        s = rs.randint(min_shots, shots + 1) if vary else shots
        out.append((v + 1, (np.arange(s, dtype=np.int32) * 3 + v) % 97,
                    rs.randn(s, d).astype(np.float32), f"video{v}"))
    return out


def _datasets(arrays):
    """The same videos as a JAX and a port ShotDataset (separate copies)."""
    return tuple(pkg.ShotDataset([pkg.ShotVideo(v, s.copy(), f.copy(), name)
                                  for v, s, f, name in arrays])
                 for pkg in (jshots, tshots))


def _same_batches(jsrc, tsrc, n):
    for _ in range(n):
        jb, tb = jsrc.next_batch(), tsrc.next_batch()
        assert list(jb) == list(tb)
        for k in jb:
            _bits_equal(tb[k], jb[k])


SAMPLED = {
    "pairwise": dict(context_type="PAIRWISE"),
    "pairwise_distance": dict(context_type="PAIRWISE",
                              output_shot_distance=True, max_shot_distance=3.0),
    "window": dict(context_type="WINDOW", context_size=5),
    "window_flagship": dict(context_type="WINDOW", context_size=5,
                            num_negative_samples=10, max_buffer_size=60,
                            negative_swap_percentage=50,
                            max_same_video_negs=6),
    "window_reservoir_only": dict(context_type="WINDOW", context_size=3,
                                  num_negative_samples=4, max_buffer_size=40,
                                  negative_swap_percentage=0),
    "window_more_same_than_slots": dict(context_type="WINDOW", context_size=3,
                                        num_negative_samples=2,
                                        max_buffer_size=30,
                                        negative_swap_percentage=99,
                                        max_same_video_negs=5),
    "past": dict(context_type="PAST", context_size=3, num_negative_samples=3,
                 max_buffer_size=30, negative_swap_percentage=20,
                 max_same_video_negs=2),
    "past_continuous": dict(context_type="PAST_CONTINUOUS", context_size=3,
                            num_negative_samples=3, max_buffer_size=30,
                            negative_swap_percentage=30,
                            max_same_video_negs=2),
    "past_continuous_fixed": dict(context_type="PAST_CONTINUOUS_FIXED",
                                  context_size=3, num_negative_samples=2,
                                  max_buffer_size=30,
                                  max_same_video_negs=2),
    "rand_skip": dict(context_type="WINDOW", context_size=3, rand_skip=17,
                      num_negative_samples=2, max_buffer_size=30,
                      negative_swap_percentage=50),
    "no_video_ids": dict(context_type="PAST", context_size=2,
                         output_video_ids=False),
}


@pytest.mark.parametrize("case,separate_negatives", [
    (c, sep) for c, kw in SAMPLED.items()
    for sep in ((False, True) if kw.get("num_negative_samples") else (False,))])
def test_sampled_shots_source_gives_jax_batches(case, separate_negatives):
    kw = SAMPLED[case]
    jd, td = _datasets(_dataset_arrays(23, 9, 6, seed=5, vary=True))
    jn = tn = None
    if separate_negatives:
        jn, tn = _datasets(_dataset_arrays(10, 8, 6, seed=6))
    jcfg = jshots.SampledShotsConfig(batch_size=11, seed=42, **kw)
    tcfg = tshots.SampledShotsConfig(batch_size=11, seed=42, **kw)
    jsrc = jshots.VideoSampledShotsSource(jd, jcfg, jn)
    tsrc = tshots.VideoSampledShotsSource(td, tcfg, tn)
    _bits_equal(tsrc.reservoir.buffer if tsrc.reservoir else np.zeros(0),
                jsrc.reservoir.buffer if jsrc.reservoir else np.zeros(0))
    _same_batches(jsrc, tsrc, 5)
    if tsrc.reservoir is not None:
        assert tsrc.reservoir.keys == jsrc.reservoir.keys
    it = iter(tsrc)
    jb = next(iter(jsrc))
    _bits_equal(next(it)["data"], jb["data"])


def test_sampled_config_from_message_equals_jax():
    from videovector_tpu.config import parse as jparse
    from videovector_tpu_torch.config import parse as tparse
    text = """batch_size: 64 num_negative_samples: 10 max_buffer_size: 5000
              negative_swap_percentage: 50 max_same_video_negs: 6
              context_type: WINDOW context_size: 5 rand_skip: 3
              output_shot_distance: false max_shot_distance: 4.0
              source: "x.vvr" device_negatives: false"""
    j = jshots.SampledShotsConfig.from_message(jparse(text))
    t = tshots.SampledShotsConfig.from_message(tparse(text))
    assert vars(t) == vars(j)


@pytest.mark.parametrize("kw,n_videos,shots,err", [
    (dict(context_type="WINDOW", context_size=3, num_negative_samples=2,
          max_buffer_size=500), 10, 4, RuntimeError),     # under-fill
    (dict(context_type="PAIRWISE"), 6, 1, ValueError),    # every video < 2
    (dict(context_type="WINDOW", context_size=7), 6, 5, ValueError),
    (dict(context_type="WINDOW", context_size=4), 6, 5, ValueError),  # even
    (dict(context_type="SIDEWAYS", context_size=3), 6, 5, ValueError),
    (dict(context_type="PAIRWISE", num_negative_samples=1, max_buffer_size=4,
          negative_swap_percentage=100), 6, 5, ValueError),
    (dict(context_type="PAIRWISE", context_size=1), 6, 5, None),
    (dict(context_type="PAST", context_size=1), 6, 5, ValueError),
])
def test_sampled_source_errors_equal_jax(kw, n_videos, shots, err):
    jd, td = _datasets(_dataset_arrays(n_videos, shots, 4, seed=7))

    def run(pkg, ds):
        src = pkg.VideoSampledShotsSource(
            ds, pkg.SampledShotsConfig(batch_size=4, seed=1, **kw))
        return src.next_batch()
    jo, to = _outcome(lambda _: run(jshots, jd), None), \
        _outcome(lambda _: run(tshots, td), None)
    assert to[0] == jo[0] == (err.__name__ if err else "ok")
    if err:
        assert to[1] == jo[1]
    else:
        _bits_equal(to[1]["data"], jo[1]["data"])


EXHAUSTIVE = {
    "pairwise": dict(context_type="PAIRWISE"),
    "pairwise_negs": dict(context_type="PAIRWISE", num_negative_samples=3,
                          max_buffer_size=25, negative_swap_percentage=40,
                          max_same_video_negs=2, output_shot_distance=True),
    "window2": dict(context_type="WINDOW", context_size=2),
    "window4_negs": dict(context_type="WINDOW", context_size=4,
                         num_negative_samples=2, max_buffer_size=25,
                         negative_swap_percentage=60, max_same_video_negs=5),
    "past3": dict(context_type="PAST", context_size=3, num_negative_samples=1,
                  max_buffer_size=20, output_video_ids=False),
}


@pytest.mark.parametrize("case", list(EXHAUSTIVE))
def test_exhaustive_shots_source_gives_jax_batches(case):
    jd, td = _datasets(_dataset_arrays(9, 6, 5, seed=8, vary=True))
    kw = EXHAUSTIVE[case]
    jsrc = jshots.VideoShotsSource(
        jd, jshots.ExhaustiveShotsConfig(batch_size=7, seed=3, **kw))
    tsrc = tshots.VideoShotsSource(
        td, tshots.ExhaustiveShotsConfig(batch_size=7, seed=3, **kw))
    _same_batches(jsrc, tsrc, 12)
    assert (tsrc._video_idx, tsrc._target_ctr, tsrc._context_ctr) == \
        (jsrc._video_idx, jsrc._target_ctr, jsrc._context_ctr)


@pytest.mark.parametrize("kw", [dict(context_type="WINDOW", context_size=3),
                                dict(context_type="PAIRWISE"),
                                dict(context_type="FUTURE", context_size=2)])
def test_exhaustive_source_errors_equal_jax(kw):
    arrays = _dataset_arrays(4, 1 if kw["context_type"] == "PAIRWISE" else 4,
                             3, seed=9)
    jd, td = _datasets(arrays)
    outs = [_outcome(lambda _: pkg.VideoShotsSource(
        ds, pkg.ExhaustiveShotsConfig(batch_size=3, **kw)).next_batch(), None)
        for pkg, ds in ((jshots, jd), (tshots, td))]
    assert outs[0][0] == "ValueError" and outs[1] == outs[0]


def _test_windows(pkg, n, d, seed, *, ctx=4, pos=2, neg=3):
    rs = np.random.RandomState(seed)

    def words(k):
        return [pkg.Datum(float_data=rs.randn(d).astype(np.float32))
                for _ in range(k)]
    return [pkg.TestVideoShotWindows(
        video_id=int(rs.randint(1, 6)), positive_shot_id=[int(i), i + 1][:pos],
        context_shot_words=words(ctx), positive_shot_words=words(pos),
        negative_shot_words=words(neg), negative_shot_id=list(range(neg)))
        for i in range(n)]


@pytest.mark.parametrize("include_positives", [True, False])
@pytest.mark.parametrize("include_negatives", [True, False])
def test_window_test_source_gives_jax_batches(tmp_path, include_positives,
                                              include_negatives):
    """Stores written by either package, read by the other; batches past
    the end of the store wrap around."""
    jw = _test_windows(jwire, 9, 7, seed=10)
    jrec.write_records(str(tmp_path / "w.vvr"),
                       [(str(i), w.encode()) for i, w in enumerate(jw)])
    tw = _test_windows(twire, 9, 7, seed=10)
    trec.write_records(str(tmp_path / "t.vvr"),
                       [(str(i), w.encode()) for i, w in enumerate(tw)])
    assert (tmp_path / "w.vvr").read_bytes() == (tmp_path / "t.vvr").read_bytes()
    jds = jshots.TestWindowDataset.from_records(str(tmp_path / "t.vvr"))
    tds = tshots.TestWindowDataset.from_records(str(tmp_path / "w.vvr"))
    assert (tds.feature_dim, tds.context_size, tds.positive_size,
            tds.negative_size) == (7, 4, 2, 3)
    kw = dict(include_positives=include_positives,
              include_negatives=include_negatives,
              display_all_ids=include_positives and not include_negatives)
    jsrc = jshots.VideoShotWindowTestSource(jds, 4, **kw)
    tsrc = tshots.VideoShotWindowTestSource(tds, 4, **kw)
    assert tsrc.channels == jsrc.channels
    _same_batches(jsrc, tsrc, 4)
    with pytest.raises(ValueError, match="empty"):
        tshots.TestWindowDataset([])


def test_fixed_gallery_and_shot_dataset_records_equal_jax(tmp_path):
    jw = _test_windows(jwire, 5, 6, seed=11, pos=3, neg=2)
    jrec.write_records(str(tmp_path / "g.vvr"),
                       [(str(i), w.encode()) for i, w in enumerate(jw)])
    jg = jshots.FixedVideoShotGallery.from_records(str(tmp_path / "g.vvr"))
    tg = tshots.FixedVideoShotGallery.from_records(str(tmp_path / "g.vvr"))
    for k in ("data", "video_ids"):
        _bits_equal(tg.batch()[k], jg.batch()[k])
    assert (tg.batch()["video_ids"] == -1).sum() == 10

    arrays = _dataset_arrays(6, 5, 8, seed=12, vary=True)
    jd, td = _datasets(arrays)
    jd.to_records(str(tmp_path / "j.vvr"))
    td.to_records(str(tmp_path / "t.vvr"))
    assert (tmp_path / "j.vvr").read_bytes() == (tmp_path / "t.vvr").read_bytes()
    back = tshots.ShotDataset.from_records(str(tmp_path / "j.vvr"))
    ref = jshots.ShotDataset.from_records(str(tmp_path / "j.vvr"))
    assert len(back) == len(ref) == 6 and back.feature_dim == 8
    for a, b in zip(back.videos, ref.videos):
        assert (a.video_id, a.video_name, a.num_shots) == \
            (b.video_id, b.video_name, b.num_shots)
        _bits_equal(a.shot_ids, b.shot_ids)
        _bits_equal(a.features, b.features)
    # a VideoShots record with no shot ids numbers its shots 0..S-1
    rec = jwire.VideoShots(video_id=4, shot_words=[
        jwire.Datum(float_data=np.ones(3, np.float32))] * 2)
    jrec.write_records(str(tmp_path / "n.vvr"), [("0", rec.encode())])
    _bits_equal(tshots.ShotDataset.from_records(str(tmp_path / "n.vvr"))
                .videos[0].shot_ids, np.int32([0, 1]))
    with pytest.raises(ValueError, match="empty dataset"):
        tshots.ShotDataset([])


# -- the host image transform ----------------------------------------------

def _image_datum(pkg, rs, c=3, h=12, w=14):
    return pkg.Datum(channels=c, height=h, width=w,
                     data=rs.randint(0, 256, c * h * w).astype(np.uint8)
                     .tobytes(), mean=rs.randn(c).astype(np.float32),
                     min=rs.rand(c).astype(np.float32),
                     max=(2 + rs.rand(c)).astype(np.float32))


@pytest.mark.parametrize("cfg,kw", [
    (dict(crop_size=8, mirror=True, scale=0.5), dict(train=True, seed=1)),
    (dict(crop_size=8, mirror=True), dict(train=True, seed=2, mean=True)),
    (dict(crop_size=8), dict(train=False, mean=True)),
    (dict(crop_size=6, use_datum_scales=True, mirror=True),
     dict(train=True, seed=3)),
    (dict(crop_size=6), dict(preset=(2, 5, True), mean=True)),
    (dict(scale=0.25), dict(mean=True)),
    (dict(), dict(floats=True)),
    (dict(crop_size=4), dict(floats=True, train=True, seed=1)),   # raises
    (dict(use_datum_scales=True), dict()),                        # raises
    (dict(mirror=True), dict()),                                  # raises
])
def test_transform_datum_equals_jax(cfg, kw):
    rs = np.random.RandomState(13)
    jd = _image_datum(jwire, rs)
    td = twire.Datum.decode(jd.encode())
    if kw.get("floats"):
        f = rs.randn(3 * 12 * 14).astype(np.float32)
        jd = jwire.Datum(channels=3, height=12, width=14, float_data=f)
        td = twire.Datum(channels=3, height=12, width=14, float_data=f.copy())
    mean = rs.randn(3, 12, 14).astype(np.float32) if kw.get("mean") else None
    outs = []
    for tr, d in ((jtr, jd), (ttr, td)):
        rng = np.random.RandomState(kw["seed"]) if "seed" in kw else None
        outs.append(_outcome(lambda _: tr.transform_datum(
            d, tr.TransformConfig(**cfg), mean=mean, train=kw.get("train", False),
            rng=rng, preset=kw.get("preset")), None))
    assert outs[1][0] == outs[0][0]
    if outs[0][0] == "ok":
        _bits_equal(outs[1][1], outs[0][1])
    else:
        assert outs[1][1] == outs[0][1]


def test_transform_config_from_message_and_fused_path_rejects_datum_scales():
    from videovector_tpu.config import parse as jparse
    from videovector_tpu_torch.config import parse as tparse
    text = "crop_size: 227 mirror: true scale: 0.5 use_datum_scales: false"
    assert vars(ttr.TransformConfig.from_message(tparse(text))) == \
        vars(jtr.TransformConfig.from_message(jparse(text)))
    _bits_equal(ttr.datum_to_array(_image_datum(twire, np.random.RandomState(0))),
                jtr.datum_to_array(_image_datum(jwire, np.random.RandomState(0))))
    with pytest.raises(ValueError, match="use_datum_scales"):
        ttr.make_batch_transform(ttr.TransformConfig(use_datum_scales=True),
                                 None, (8, 8), device="cpu")


# -- the project's synthetic stores, read with JAX blocked -------------------

def test_port_reads_make_synthetic_data_stores_without_jax(tmp_path):
    """projects/videovec_embedding/make_synthetic_data.py (--dim 32) writes
    the stores; a process with jax and videovector_tpu blocked reads them
    with the port, and its values equal the JAX package's reading."""
    train, test = tmp_path / "train.vvr", tmp_path / "test.vvr"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable,
                    "projects/videovec_embedding/make_synthetic_data.py",
                    "--dim", "32", "--num_videos", "12", "--test_windows",
                    "15", "--out_train", str(train), "--out_test", str(test)],
                   cwd=ROOT, env=env, check=True, capture_output=True,
                   timeout=120)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["videovector_tpu"] = None
        import numpy as np
        from videovector_tpu_torch.data.shots import (
            SampledShotsConfig, ShotDataset, TestWindowDataset,
            VideoSampledShotsSource, VideoShotWindowTestSource)
        ds = ShotDataset.from_records({str(train)!r})
        tw = TestWindowDataset.from_records({str(test)!r})
        b = VideoSampledShotsSource(ds, SampledShotsConfig(
            batch_size=4, context_type="WINDOW", context_size=5,
            num_negative_samples=10, max_buffer_size=50,
            negative_swap_percentage=50, max_same_video_negs=6)).next_batch()
        t = VideoShotWindowTestSource(tw, 15).next_batch()
        np.savez({str(tmp_path / "port.npz")!r}, feats=np.stack(
            [v.features for v in ds.videos]), data=b["data"],
            test=t["data"], ids=t["video_ids"])
        bad = [m for m in sys.modules if m.startswith(("jax", "videovector_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    got = np.load(tmp_path / "port.npz")
    ds = jshots.ShotDataset.from_records(str(train))
    assert got["feats"].shape == (12, 12, 32)
    _bits_equal(got["feats"], np.stack([v.features for v in ds.videos]))
    jb = jshots.VideoSampledShotsSource(ds, jshots.SampledShotsConfig(
        batch_size=4, context_type="WINDOW", context_size=5,
        num_negative_samples=10, max_buffer_size=50,
        negative_swap_percentage=50, max_same_video_negs=6)).next_batch()
    _bits_equal(got["data"], jb["data"])
    jt = jshots.VideoShotWindowTestSource(
        jshots.TestWindowDataset.from_records(str(test)), 15).next_batch()
    _bits_equal(got["test"], jt["data"])
    _bits_equal(got["ids"], jt["video_ids"])
