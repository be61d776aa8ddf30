"""VVR, the framework's indexed record-file format; counterpart of
videovector_tpu/data/records.py, whose files it writes byte for byte and
reads.

Replaces the reference's LMDB/LevelDB stores (which held serialized protos
keyed by string, read via forward cursors): one mmap-friendly file, records
read by index or, through a lazily built dict, by key, in a layout the C++
native reader (native/vvdata.cpp) and Python agree on byte for byte.

Layout (little-endian):
  [8s magic "VVREC001"]
  [records: concatenated value bytes]
  [index: per record -- u64 offset, u32 length, u32 key_length, key bytes]
  [footer: u64 index_offset, u64 count, 8s magic]

Records are stored in append order; the index preserves that order (cursor
iteration order == insertion order).

The LMDB and LevelDB backends of the JAX package are not ported yet
(ROADMAP item 1b): `open_store` and `open_store_writer` recognise them and
raise NotImplementedError.
"""

from __future__ import annotations

import mmap
import os
import struct

MAGIC = b"VVREC001"
_FOOTER = struct.Struct("<QQ8s")
_IDX_HEAD = struct.Struct("<QII")


class RecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._index: list[tuple[int, int, bytes]] = []
        self._closed = False

    def append(self, key, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode()
        off = self._f.tell()
        self._f.write(value)
        self._index.append((off, len(value), key))

    # uniform writer protocol shared with LmdbWriter / LevelDbWriter
    put = append

    def close(self) -> None:
        if self._closed:
            return
        index_offset = self._f.tell()
        for off, ln, key in self._index:
            self._f.write(_IDX_HEAD.pack(off, ln, len(key)))
            self._f.write(key)
        self._f.write(_FOOTER.pack(index_offset, len(self._index), MAGIC))
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """mmap-backed reader; values are returned as memoryview-backed bytes."""

    def __init__(self, path: str):
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:8] != MAGIC:
            raise ValueError(f"{path}: not a VVR file")
        foot = self._mm[-_FOOTER.size:]
        index_offset, count, magic = _FOOTER.unpack(foot)
        if magic != MAGIC:
            raise ValueError(f"{path}: corrupt footer")
        self._entries: list[tuple[int, int, bytes]] = []
        pos = index_offset
        for _ in range(count):
            off, ln, klen = _IDX_HEAD.unpack_from(self._mm, pos)
            pos += _IDX_HEAD.size
            key = bytes(self._mm[pos:pos + klen])
            pos += klen
            self._entries.append((off, ln, key))
        self._key_to_idx: dict[bytes, int] | None = None

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, i: int) -> bytes:
        return self._entries[i][2]

    def value(self, i: int) -> bytes:
        off, ln, _ = self._entries[i]
        return self._mm[off:off + ln]

    def __getitem__(self, i: int) -> tuple[bytes, bytes]:
        off, ln, key = self._entries[i]
        return key, self._mm[off:off + ln]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def index_of(self, key) -> int:
        if isinstance(key, str):
            key = key.encode()
        if self._key_to_idx is None:
            self._key_to_idx = {k: i for i, (_, _, k) in enumerate(self._entries)}
        return self._key_to_idx[key]

    def get(self, key) -> bytes:
        return self.value(self.index_of(key))

    def close(self):
        self._mm.close()
        self._file.close()


def write_records(path: str, items) -> None:
    """items: iterable of (key, value_bytes)."""
    with RecordWriter(path) as w:
        for k, v in items:
            w.append(k, v)


def convert_dir_or_file(source: str) -> str:
    """Dataset paths in reference prototxts point at LMDB/LevelDB dirs; our
    stores are single .vvr files. Accept `<path>.vvr`, a directory containing
    `data.vvr`, a reference LMDB environment (directory with data.mdb /
    direct .mdb file), or a LevelDB directory (has CURRENT) — `open_store`
    dispatches on content."""
    if os.path.isdir(source):
        cand = os.path.join(source, "data.vvr")
        if os.path.exists(cand):
            return cand
        mdb = os.path.join(source, "data.mdb")
        if os.path.exists(mdb):
            return mdb
    return source


def is_vvr(path: str) -> bool:
    """True when the (resolved) path is a VVR file — gates fast paths that
    speak only the native record format (e.g. the C++ sampler)."""
    path = convert_dir_or_file(path)
    try:
        with open(path, "rb") as f:
            return f.read(8) == MAGIC
    except OSError:
        return False


_NOT_PORTED = ("the {} backend is not ported to videovector_tpu_torch yet "
               "(ROADMAP queue 1, item 1b); convert the store to VVR")
# LMDB's meta-page magic (u32 at byte 16 of data.mdb)
_MDB_MAGIC = 0xBEEFC0DE


def open_store_writer(path: str, backend: str = "vvr"):
    """Uniform writer factory: `put(key, value)` + close/context-manager.
    backend: "vvr" (native records); "lmdb" and "leveldb" raise until
    ROADMAP item 1b."""
    if backend == "vvr":
        return RecordWriter(path)
    if backend in ("lmdb", "leveldb"):
        raise NotImplementedError(_NOT_PORTED.format(backend))
    raise ValueError(f"unknown store backend {backend!r}")


def open_store(path: str):
    """Open a key->value store by content sniffing: VVR magic ->
    RecordReader. An LMDB database (meta magic) or a LevelDB directory
    (CURRENT file) raises NotImplementedError until ROADMAP item 1b.
    RecordReader exposes len/key/value/__getitem__/__iter__/index_of/get."""
    path = convert_dir_or_file(path)
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "CURRENT")):
            raise NotImplementedError(_NOT_PORTED.format("leveldb"))
        raise ValueError(f"{path}: directory is not a LevelDB environment "
                         "and holds no data.vvr / data.mdb")
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == MAGIC:
        return RecordReader(path)
    if len(head) >= 20 and struct.unpack_from("<I", head, 16)[0] == _MDB_MAGIC:
        raise NotImplementedError(_NOT_PORTED.format("lmdb"))
    raise ValueError(f"{path}: neither a VVR file nor an LMDB database")
