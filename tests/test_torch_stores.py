"""The port's LMDB and LevelDB stores (videovector_tpu_torch.data.lmdbio,
leveldbio, records.open_store / open_store_writer) against the JAX
package's, on the CPU.

For the same puts both writers produce the same files, byte for byte
(data.mdb; the .ldb tables, MANIFEST-* and CURRENT, with snappy and
without, across several tables and with the stray spill); each package
reads the other's stores; both read the hand-assembled foreign fixtures of
tests/test_foreign_db.py identically, and every truncated or bit-flipped
copy of them gives the same values or raises the same exception type as
the JAX reader. The CRC32C and snappy vectors of tests/test_leveldb.py and
tests/test_foreign_db.py hold for the port, whose two primitives run in
its native library (data/native.py) whenever it is built.
"""

import io
import os
import random
import struct

import numpy as np
import pytest

from test_foreign_db import build_foreign_leveldb, build_foreign_lmdb
from videovector_tpu.data import leveldbio as jl
from videovector_tpu.data import lmdbio as jm
from videovector_tpu.data import records as jrec
from videovector_tpu_torch.data import leveldbio as tl
from videovector_tpu_torch.data import lmdbio as tm
from videovector_tpu_torch.data import native as tnative
from videovector_tpu_torch.data import records as trec


def _files(path) -> dict:
    """{name: bytes} of a store directory."""
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def _dump(reader) -> list:
    return [(bytes(k), bytes(v)) for k, v in reader]


def _outcome(fn):
    """fn()'s value, or its exception's type name."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - compared between packages
        return type(e).__name__, None


def _lmdb_items(case: str):
    rng = random.Random(7)
    if case == "small":
        return [(f"k{i}", f"value-{i}".encode()) for i in (3, 1, 2)]
    if case == "branch":
        return [(f"{i:08d}", (f"payload-{i}-" * 5).encode())
                for i in range(6000)]
    if case == "overflow":
        return [(f"ov{i}", bytes([i]) * (100_000 + i)) for i in range(5)] \
            + [("tiny", b"x")]
    if case == "mixed":
        items = {}
        for _ in range(800):
            key = bytes(rng.randrange(33, 127)
                        for _ in range(rng.randint(1, 60)))
            items[key] = bytes(rng.randrange(256) for _ in range(
                rng.choice([0, 5, 100, 1990, 2100, 5000])))
        return list(items.items())
    return []


@pytest.mark.parametrize("case", ["small", "branch", "overflow", "mixed",
                                  "empty"])
def test_lmdb_files_are_byte_equal_and_cross_read(tmp_path, case):
    items = _lmdb_items(case)
    paths = {}
    for tag, mod in (("j", jm), ("t", tm)):
        paths[tag] = str(tmp_path / tag)
        with mod.LmdbWriter(paths[tag]) as w:
            for k, v in items:
                w.put(k, v)
    assert _files(paths["t"]) == _files(paths["j"])
    want = sorted((k.encode() if isinstance(k, str) else k, v)
                  for k, v in items)
    for path in paths.values():
        got, ref = tm.LmdbReader(path), jm.LmdbReader(path)
        assert _dump(got) == _dump(ref) == want
        if want:
            k = want[len(want) // 2][0]
            assert got.index_of(k) == ref.index_of(k)
            assert bytes(got.get(k)) == bytes(ref.get(k))
        for r in (got, ref):
            with pytest.raises(KeyError):
                r.index_of(b"\x00missing")
            r.close()
    assert tm.resolve_lmdb_path(paths["t"]) == jm.resolve_lmdb_path(paths["t"])


def _leveldb_puts(case: str):
    rs = np.random.RandomState(5)
    if case == "stray_spill":
        # the reference extract_features' decimal keys: "10" < "9"
        return [(str(i), f"v{i}".encode() * 5) for i in range(400)] \
            + [("7", b"overwritten")]
    if case == "empty":
        return []
    keys = [f"{i:06d}" for i in range(300)]
    if case == "unsorted":
        rs.shuffle(keys)
    return [(k, (k.encode() + rs.bytes(rs.randint(0, 300))) * 3)
            for k in keys]


@pytest.mark.parametrize("case,kw", [
    ("sorted", {}),
    ("sorted", {"compression": "snappy"}),
    ("sorted", {"max_table_bytes": 8192}),
    ("sorted", {"max_table_bytes": 8192, "compression": "snappy",
                "block_size": 1024}),
    ("unsorted", {"max_stray_bytes": 16384}),
    ("stray_spill", {"max_stray_bytes": 4096}),
    ("empty", {})])
def test_leveldb_files_are_byte_equal_and_cross_read(tmp_path, case, kw):
    puts = _leveldb_puts(case)
    paths = {}
    for tag, mod in (("j", jl), ("t", tl)):
        paths[tag] = str(tmp_path / tag)
        with mod.LevelDbWriter(paths[tag], **kw) as w:
            for k, v in puts:
                w.put(k, v)
    files = _files(paths["t"])
    assert files == _files(paths["j"])
    assert "CURRENT" in files and "MANIFEST-000001" in files
    if kw.get("max_table_bytes") or case in ("unsorted", "stray_spill"):
        assert sum(n.endswith(".ldb") for n in files) > 2
    want = sorted(dict((k.encode(), v) for k, v in puts).items())
    for path in paths.values():
        got = tl.LevelDbReader(path, verify_checksums=True)
        ref = jl.LevelDbReader(path, verify_checksums=True)
        assert _dump(got) == _dump(ref) == want
        got.close()
        ref.close()


@pytest.mark.parametrize("backend", ["lmdb", "leveldb"])
def test_each_package_opens_the_others_stores_by_content(tmp_path, backend):
    rs = np.random.RandomState(2)
    items = [(f"{i:05d}", rs.bytes(rs.randint(1, 9000))) for i in range(60)]
    for writer, tag in ((jrec, "j"), (trec, "t")):
        with writer.open_store_writer(str(tmp_path / tag), backend) as w:
            for k, v in items:
                w.put(k, v)
    for tag in ("j", "t"):
        for opener in (trec.open_store, jrec.open_store):
            r = opener(str(tmp_path / tag))
            assert _dump(r) == [(k.encode(), v) for k, v in items]
            assert len(r) == 60 and r.index_of("00042") == 42
            r.close()


# -- the foreign fixtures ------------------------------------------------------

def test_foreign_lmdb_reads_identically(tmp_path):
    db = str(tmp_path / "env")
    fx = build_foreign_lmdb(db)
    got, ref = tm.LmdbReader(db), jm.LmdbReader(db)
    assert _dump(got) == _dump(ref) == fx["expect"]
    assert bytes(got.get(b"key2")) == b"beta"
    assert type(trec.open_store(db)).__name__ == "LmdbReader"


def test_foreign_leveldb_reads_identically(tmp_path):
    db = str(tmp_path / "db")
    build_foreign_leveldb(db)
    got = tl.LevelDbReader(db, verify_checksums=True)
    ref = jl.LevelDbReader(db, verify_checksums=True)
    assert _dump(got) == _dump(ref) == [
        (b"k2", b"v2-new"), (b"m1", b"mv1"), (b"n1", b"nv1")]
    assert type(trec.open_store(db)).__name__ == "LevelDbReader"


def _read_all(reader_cls, path, **kw):
    def run():
        r = reader_cls(path, **kw)
        out = _dump(r)
        r.close()
        return out
    return _outcome(run)


def test_foreign_lmdb_mutations_give_jax_outcomes(tmp_path):
    """Truncations and bit flips of the foreign data.mdb: the port reads
    what JAX's reader reads, or raises the same exception type."""
    db = str(tmp_path / "env")
    blob = build_foreign_lmdb(db)["bytes"]
    data = os.path.join(db, "data.mdb")
    rng = np.random.RandomState(0)
    psize = 4096
    cuts = [0, 15, 16, 100, psize - 1, psize + 40, 2 * psize + 20,
            3 * psize + 5, len(blob) - 1]
    for i in range(len(cuts) + 40):
        if i < len(cuts):
            mutated = blob[:cuts[i]]
        else:
            b = bytearray(blob)
            b[int(rng.randint(len(b)))] ^= 1 << int(rng.randint(8))
            mutated = bytes(b)
        with open(data, "wb") as f:
            f.write(mutated)
        assert _read_all(tm.LmdbReader, db) == _read_all(jm.LmdbReader, db), i
    (tmp_path / "zero").mkdir()
    (tmp_path / "zero" / "data.mdb").write_bytes(b"\x00" * 8192)
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="magic"):
            mod.LmdbReader(str(tmp_path / "zero"))


def test_foreign_leveldb_mutations_give_jax_outcomes(tmp_path):
    """Bit flips in the snappy table (checksums verified) and truncations
    of every file: the port's outcome is JAX's, and the CRCs do fire."""
    db = str(tmp_path / "db")
    build_foreign_leveldb(db)
    rng = np.random.RandomState(1)
    caught = 0
    for fname, flips in (("000005.ldb", 40), ("000004.ldb", 0),
                         ("MANIFEST-000002", 10), ("000006.log", 10),
                         ("CURRENT", 0)):
        path = os.path.join(db, fname)
        raw = open(path, "rb").read()
        muts = [raw[:c] for c in range(0, len(raw), max(1, len(raw) // 9))]
        for _ in range(flips):
            b = bytearray(raw)
            b[int(rng.randint(len(b)))] ^= 1 << int(rng.randint(8))
            muts.append(bytes(b))
        for m in muts:
            with open(path, "wb") as f:
                f.write(m)
            got = _read_all(tl.LevelDbReader, db, verify_checksums=True)
            assert got == _read_all(jl.LevelDbReader, db,
                                    verify_checksums=True), (fname, m)
            caught += got[0] != "ok"
        with open(path, "wb") as f:
            f.write(raw)
    assert caught > 0


def test_writer_corruptions_raise_as_jax(tmp_path):
    """test_leveldb.py's corruption cases: a bad table magic, a flipped
    data byte under verify_checksums, a missing live table."""
    outcomes = {}
    for tag, mod in (("j", jl), ("t", tl)):
        db = str(tmp_path / tag)
        with mod.LevelDbWriter(db) as w:
            for i in range(200):
                w.put(f"{i:05d}", (f"val{i}" * 9).encode())
        ldb = os.path.join(db, "000002.ldb")
        raw = bytearray(open(ldb, "rb").read())
        bad = raw.copy()
        bad[-1] ^= 0xFF
        open(ldb, "wb").write(bad)
        with pytest.raises(ValueError, match="magic"):
            mod.LevelDbReader(db)
        bad = raw.copy()
        bad[50] ^= 0xFF
        open(ldb, "wb").write(bad)
        with pytest.raises(ValueError, match="checksum"):
            mod.LevelDbReader(db, verify_checksums=True)
        outcomes[tag] = _read_all(mod.LevelDbReader, db)
        os.unlink(ldb)
        with pytest.raises(FileNotFoundError):
            mod.LevelDbReader(db)
    assert outcomes["t"] == outcomes["j"]


# -- CRC32C, snappy and the native twins ------------------------------------------

def test_crc32c_vectors_extend_and_mask():
    assert tl.crc32c(b"123456789") == 0xE3069283
    assert tl.crc32c(b"") == 0
    assert tl.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tl.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert tl.crc32c(bytes(range(32))) == 0x46DD794E
    assert tl.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    data = bytes(range(256)) * 7 + b"hello world" * 7
    for split in (0, 1, 5, 11, 300, len(data)):
        assert tl.crc32c(data[split:], tl.crc32c(data[:split])) == \
            tl.crc32c(data) == jl.crc32c(data)
    crc = tl.crc32c(b"foo")
    assert tl.crc32c_mask(crc) == jl.crc32c_mask(crc) != crc
    assert tl.crc32c_unmask(tl.crc32c_mask(crc)) == crc


def _enc(ulen, body):
    out = bytearray()
    tl._put_uvarint(out, ulen)
    return bytes(out) + body


@pytest.mark.parametrize("stream,want", [
    (_enc(3, bytes([2 << 2]) + b"abc"), b"abc"),
    (_enc(12, bytes([3 << 2]) + b"abcd" + bytes([((8 - 4) << 2) | 1, 4])),
     b"abcd" * 3),
    (_enc(8, bytes([1 << 2]) + b"xy" + bytes([(5 << 2) | 2]) + b"\x02\x00"),
     b"xyxyxyxy"),
    (_enc(8, bytes([1 << 2]) + b"xy" + bytes([(5 << 2) | 3])
          + (2).to_bytes(4, "little")), b"xyxyxyxy"),
    (_enc(61, bytes([60 << 2, 60]) + bytes(range(61))), bytes(range(61))),
    (bytes([13, (3 - 1) << 2]) + b"abc" + bytes([(5 << 2) | 1, 3, 0]) + b"X",
     b"abcabcabcabcX"),
    # long enough for the native decoder
    (_enc(200, bytes([59 << 2]) + bytes(range(60))
          + bytes([((64 - 1) << 2) | 2]) + b"\x3c\x00"
          + bytes([((64 - 1) << 2) | 2]) + b"\x3c\x00"
          + bytes([((12 - 1) << 2) | 2]) + b"\x3c\x00"),
     (bytes(range(60)) * 4)[:200])])
def test_snappy_known_answers(stream, want):
    assert tl.snappy_decompress(stream) == jl.snappy_decompress(stream) == want
    assert tl._snappy_decompress_py(stream) == want


@pytest.mark.parametrize("stream", [
    bytes([4, (3 << 2) | 1, 9]),                       # offset before start
    bytes([99, (3 - 1) << 2]) + b"abc",                # length mismatch
    _enc(5000, bytes([59 << 2]) + bytes(64)),          # short, native path
    bytes([0xFF] * 10) + bytes(70)])                   # implausible ulen
def test_snappy_rejects_corrupt_streams(stream):
    for mod in (tl, jl):
        with pytest.raises(ValueError):
            mod.snappy_decompress(stream)


def test_snappy_compress_bytes_equal_jax():
    rng = random.Random(3)
    for data in (b"", b"a", b"abcabcabcabc" * 100,
                 bytes(rng.randrange(256) for _ in range(5000)),
                 b"\x00" * 3000 + b"the quick brown fox " * 40):
        comp = tl.snappy_compress(data)
        assert comp == jl.snappy_compress(data)
        assert tl.snappy_decompress(comp) == data


def test_the_native_twins_are_taken_when_the_library_is_built(monkeypatch):
    """With the port's library built, CRC32C (>= 256 bytes) and snappy
    (>= 64 bytes) never reach the Python twins, and agree with them; with
    no library they fall back to Python with a warning."""
    if not tnative.available():
        pytest.skip("the native library does not build here (no g++)")
    rng = random.Random(11)
    data = bytes(rng.randrange(256) for _ in range(70000))
    comp = tl.snappy_compress(data + data[:30000])
    want_crc = tl._crc32c_py(data, 12345)
    want_snappy = tl._snappy_decompress_py(comp)

    def forbidden(*a, **kw):
        raise AssertionError("the Python twin ran")
    monkeypatch.setattr(tl, "_crc32c_py", forbidden)
    monkeypatch.setattr(tl, "_snappy_decompress_py", forbidden)
    assert tl.crc32c(data, 12345) == want_crc == jl._crc32c_py(data, 12345)
    assert tl.snappy_decompress(comp) == want_snappy == data + data[:30000]
    assert tnative.crc32c(memoryview(data)[:300]) == jl._crc32c_py(data[:300])
    monkeypatch.undo()
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tl, "_WARNED", [])
    monkeypatch.setattr(tnative, "crc32c", forbidden)
    assert tl.crc32c(data, 12345) == want_crc
    assert tl._WARNED


def test_log_batch_and_version_edit_bytes_equal_jax():
    records = [b"", b"short", b"x" * 30000, b"y" * 100000, b"tail"]
    out = {}
    for tag, mod in (("j", jl), ("t", tl)):
        f = io.BytesIO()
        w = mod.LogWriter(f)
        for r in records:
            w.add_record(r)
        out[tag] = f.getvalue()
    assert out["t"] == out["j"]
    assert list(tl.read_log_records(out["t"], verify_checksums=True)) == \
        records
    ops = [(b"a", b"1"), (b"b", None), (b"c" * 300, b"v" * 1000)]
    batch = tl.encode_write_batch(77, ops)
    assert batch == jl.encode_write_batch(77, ops)
    assert list(tl.decode_write_batch(batch)) == \
        list(jl.decode_write_batch(batch))
    e = tl.VersionEdit()
    e.comparator, e.log_number, e.next_file_number = "leveldb.Bytewise", 3, 9
    e.last_sequence, e.prev_log_number = 1 << 40, 0
    e.deleted_files = [(0, 2)]
    e.new_files = [(1, 5, 1234, b"a" * 9, b"z" * 9)]
    assert jl.VersionEdit.decode(e.encode()).encode() == e.encode()
    assert struct.unpack_from("<Q", tl._internal_key(b"k", 5), 1)[0] == \
        (5 << 8) | 1
