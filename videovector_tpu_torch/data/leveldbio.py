"""LevelDB interop in Python (read and write, no LevelDB library);
counterpart of videovector_tpu/data/leveldbio.py, whose files it writes
byte for byte and reads.

The reference stores datasets in LevelDB or LMDB interchangeably: every
data layer takes a `backend:` switch (ref:src/caffe/layers/data_layer.cpp:
35-75, ref:src/caffe/layers/video_sampled_shots_data_layer.cpp:88-135),
and `extract_features` writes its output as a LevelDB of Datum protos
(ref:tools/extract_features.cpp:127-198). This module speaks the LevelDB
1.x on-disk format:

  CURRENT            -> name of the live MANIFEST
  MANIFEST-NNNNNN    -> log-format file of VersionEdit records (live tables,
                        log number, last sequence)
  NNNNNN.ldb / .sst  -> sorted-string tables: data blocks (prefix-compressed,
                        optionally snappy), index block, 48-byte footer with
                        magic 0xdb4775248b80fb57
  NNNNNN.log         -> write-ahead log of WriteBatches not yet compacted

Reads merge all live tables and the unflushed log by internal key (user
key ascending, sequence descending): the newest sequence wins and a
deletion hides older values, leveldb's read semantics. Checksums are
CRC32C (masked); verification is off by default, as leveldb's
`ReadOptions::verify_checksums = false`.

The two hot primitives, CRC32C (every block trailer and log record) and
snappy decoding, run in the port's native library (data/native.py's
twins of native/vvdata.cpp) whenever it is built; without it (no g++)
they run in Python, with the same results, and a warning says so once.

The writer emits a compacted database: one or more level-0 tables and a
minimal MANIFEST, which the C++ library opens (it recovers no log and sees
the tables through VersionEdit kNewFile entries). Keys are sorted on close,
so callers may `put` in any order (as lmdbio.LmdbWriter). Iteration order
is key order (bytewise), the order of the reference's `leveldb::Iterator`
and `MDB_NEXT` cursors.
"""

from __future__ import annotations

import heapq
import mmap
import os
import re
import struct
from typing import Iterable, Iterator

from videovector_tpu_torch.data import native
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

TABLE_MAGIC = 0xDB4775248B80FB57
_BLOCK_SIZE = 32768  # log-format block size
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4
_TYPE_DELETION, _TYPE_VALUE = 0, 1
_MAX_SEQ = (1 << 56) - 1

# VersionEdit tags (leveldb/db/version_edit.cc)
_TAG_COMPARATOR = 1
_TAG_LOG_NUMBER = 2
_TAG_NEXT_FILE = 3
_TAG_LAST_SEQ = 4
_TAG_COMPACT_POINTER = 5
_TAG_DELETED_FILE = 6
_TAG_NEW_FILE = 7
_TAG_PREV_LOG = 9


# --------------------------------------------------------------- CRC32C
def _make_crc32c_tables():
    poly = 0x82F63B78  # reflected Castagnoli
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    tables = [table]
    for t in range(1, 8):
        prev = tables[t - 1]
        tables.append([table[prev[n] & 0xFF] ^ (prev[n] >> 8)
                       for n in range(256)])
    return tables


_CRC_TABLES = _make_crc32c_tables()


_WARNED = []


def _native_twins() -> bool:
    """Whether the port's native library (data/native.py) is built, so that
    CRC32C and snappy run in C; warns once when it is not."""
    if native.available():
        return True
    if not _WARNED:
        _WARNED.append(True)
        log.warning("LevelDB: the native library is not built; CRC32C and "
                    "snappy run in Python (slow on large stores)")
    return False


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli); in C when the native library is built."""
    if len(data) >= 256 and _native_twins():
        return native.crc32c(data, crc)
    return _crc32c_py(data, crc)


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), slicing-by-8, pure Python."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC_TABLES
    crc ^= 0xFFFFFFFF
    n = len(data)
    i = 0
    end8 = n - (n % 8)
    while i < end8:
        crc ^= data[i] | (data[i + 1] << 8) | (data[i + 2] << 16) | \
            (data[i + 3] << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF] ^
               t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF] ^
               t3[data[i + 4]] ^ t2[data[i + 5]] ^
               t1[data[i + 6]] ^ t0[data[i + 7]])
        i += 8
    while i < n:
        crc = (crc >> 8) ^ t0[(crc ^ data[i]) & 0xFF]
        i += 1
    return crc ^ 0xFFFFFFFF


def crc32c_mask(crc: int) -> int:
    """leveldb stores masked CRCs (util/crc32c.h): rotate right 15, add a
    constant — so CRCs of data that itself contains CRCs stay well-mixed."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def crc32c_unmask(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# --------------------------------------------------------------- varints
def _uvarint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _put_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _length_prefixed(out: bytearray, s: bytes) -> None:
    _put_uvarint(out, len(s))
    out += s


def _get_length_prefixed(buf, pos: int) -> tuple[bytes, int]:
    n, pos = _uvarint(buf, pos)
    return bytes(buf[pos:pos + n]), pos + n


# --------------------------------------------------------------- snappy
def snappy_decompress(data) -> bytes:
    """Raw-format snappy decompressor (the format of leveldb's block
    compression); in C when the native library is built."""
    if len(data) >= 64 and _native_twins():
        ulen, _ = _uvarint(data, 0)
        if ulen == 0:
            return _snappy_decompress_py(data)
        # ulen comes from untrusted bytes: bound it before allocating, so
        # that a corrupt varint raises ValueError, not a MemoryError (a
        # snappy copy expands at most ~255x a tag byte; 16384x is far above
        # any real block's ratio)
        if ulen > max(len(data) * 16384, 1 << 20):
            raise ValueError(
                f"corrupt snappy data: declared uncompressed length {ulen} "
                f"implausible for {len(data)} compressed bytes")
        return native.snappy_decompress(data, ulen)
    return _snappy_decompress_py(data)


def _snappy_decompress_py(data) -> bytes:
    """Pure-Python raw snappy: varint uncompressed length, then literal/copy
    tagged elements."""
    ulen, pos = _uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("corrupt snappy data: bad copy offset")
        if off >= ln:
            start = len(out) - off
            out += out[start:start + ln]
        else:  # overlapping copy: byte-at-a-time semantics (run extension)
            for _ in range(ln):
                out.append(out[-off])
    if len(out) != ulen:
        raise ValueError(
            f"corrupt snappy data: length {len(out)} != declared {ulen}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Minimal valid snappy encoder: greedy hash-match with literal
    fallback. Output is always decodable by any snappy implementation;
    compression ratio is modest (enough for leveldb's ≥12.5% gate on
    repetitive proto data)."""
    out = bytearray()
    _put_uvarint(out, len(data))
    n = len(data)
    if n == 0:
        return bytes(out)

    def emit_literal(start: int, end: int) -> None:
        ln = end - start - 1
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out.append(ln)
        elif ln < (1 << 16):
            out.append(61 << 2)
            out.extend(ln.to_bytes(2, "little"))
        elif ln < (1 << 24):
            out.append(62 << 2)
            out.extend(ln.to_bytes(3, "little"))
        else:
            out.append(63 << 2)
            out.extend(ln.to_bytes(4, "little"))
        out.extend(data[start:end])

    table: dict[bytes, int] = {}
    i = 0
    lit_start = 0
    while i + 4 <= n:
        quad = data[i:i + 4]
        cand = table.get(quad)
        table[quad] = i
        if cand is not None and i - cand <= 0xFFFF and data[cand:cand + 4] == quad:
            # extend the match
            m = 4
            limit = n - i
            while m < limit and data[cand + m] == data[i + m]:
                m += 1
            if lit_start < i:
                emit_literal(lit_start, i)
            off = i - cand
            while m > 0:
                ln = min(m, 64)
                if ln < 4:  # tail too short for a copy tag: literal it
                    break
                out.append(((ln - 1) << 2) | 2)
                out.extend(off.to_bytes(2, "little"))
                i += ln
                m -= ln
            lit_start = i
        else:
            i += 1
    if lit_start < n:
        emit_literal(lit_start, n)
    return bytes(out)


# --------------------------------------------------------------- log format
class LogWriter:
    """leveldb log_writer: 32KB blocks, 7-byte record headers
    (crc u32 | length u16 | type u8), records fragmented across blocks."""

    def __init__(self, f):
        self._f = f
        self._block_off = 0

    def add_record(self, data: bytes) -> None:
        pos = 0
        first = True
        while True:
            leftover = _BLOCK_SIZE - self._block_off
            if leftover < 7:
                if leftover:
                    self._f.write(b"\x00" * leftover)
                self._block_off = 0
                leftover = _BLOCK_SIZE
            avail = leftover - 7
            frag = min(len(data) - pos, avail)
            end = pos + frag == len(data)
            rtype = (_FULL if first and end else
                     _FIRST if first else _LAST if end else _MIDDLE)
            payload = data[pos:pos + frag]
            crc = crc32c_mask(crc32c(payload, crc32c(bytes([rtype]))))
            self._f.write(struct.pack("<IHB", crc, frag, rtype))
            self._f.write(payload)
            self._block_off += 7 + frag
            pos += frag
            first = False
            if end:
                return


def read_log_records(buf, verify_checksums: bool = False) -> Iterator[bytes]:
    """Yield whole records from a log-format file's bytes."""
    n = len(buf)
    block_start = 0
    pending: bytearray | None = None
    while block_start < n:
        pos = block_start
        block_end = min(block_start + _BLOCK_SIZE, n)
        while pos + 7 <= block_end:
            crc, length, rtype = struct.unpack_from("<IHB", buf, pos)
            if rtype == 0 and length == 0 and crc == 0:
                break  # zero-padded block trailer
            payload = buf[pos + 7:pos + 7 + length]
            if len(payload) < length:
                raise ValueError("truncated log record")
            if verify_checksums:
                want = crc32c_mask(crc32c(payload, crc32c(bytes([rtype]))))
                if want != crc:
                    raise ValueError("log record checksum mismatch")
            pos += 7 + length
            if rtype == _FULL:
                yield bytes(payload)
            elif rtype == _FIRST:
                pending = bytearray(payload)
            elif rtype == _MIDDLE:
                if pending is not None:
                    pending += payload
            elif rtype == _LAST:
                if pending is not None:
                    pending += payload
                    yield bytes(pending)
                    pending = None
            # other types: skippable (kZeroType padding)
        block_start += _BLOCK_SIZE
    return


# --------------------------------------------------------------- WriteBatch
def encode_write_batch(seq: int, ops: Iterable[tuple[bytes, bytes | None]]) -> bytes:
    """ops: (key, value) with value=None meaning deletion."""
    out = bytearray(struct.pack("<Q", seq))
    count = 0
    body = bytearray()
    for key, value in ops:
        count += 1
        if value is None:
            body.append(_TYPE_DELETION)
            _length_prefixed(body, key)
        else:
            body.append(_TYPE_VALUE)
            _length_prefixed(body, key)
            _length_prefixed(body, value)
    out += struct.pack("<I", count)
    out += body
    return bytes(out)


def decode_write_batch(rec) -> Iterator[tuple[bytes, int, int, bytes]]:
    """Yield (user_key, seq, type, value) for each op in a batch record."""
    seq, count = struct.unpack_from("<QI", rec, 0)
    pos = 12
    for i in range(count):
        t = rec[pos]
        pos += 1
        key, pos = _get_length_prefixed(rec, pos)
        if t == _TYPE_VALUE:
            value, pos = _get_length_prefixed(rec, pos)
        else:
            value = b""
        yield key, seq + i, t, value


# --------------------------------------------------------------- VersionEdit
class VersionEdit:
    def __init__(self):
        self.comparator: str | None = None
        self.log_number: int | None = None
        self.prev_log_number: int | None = None
        self.next_file_number: int | None = None
        self.last_sequence: int | None = None
        self.new_files: list[tuple[int, int, int, bytes, bytes]] = []
        self.deleted_files: list[tuple[int, int]] = []

    def encode(self) -> bytes:
        out = bytearray()
        if self.comparator is not None:
            _put_uvarint(out, _TAG_COMPARATOR)
            _length_prefixed(out, self.comparator.encode())
        if self.log_number is not None:
            _put_uvarint(out, _TAG_LOG_NUMBER)
            _put_uvarint(out, self.log_number)
        if self.prev_log_number is not None:
            _put_uvarint(out, _TAG_PREV_LOG)
            _put_uvarint(out, self.prev_log_number)
        if self.next_file_number is not None:
            _put_uvarint(out, _TAG_NEXT_FILE)
            _put_uvarint(out, self.next_file_number)
        if self.last_sequence is not None:
            _put_uvarint(out, _TAG_LAST_SEQ)
            _put_uvarint(out, self.last_sequence)
        for level, number in self.deleted_files:
            _put_uvarint(out, _TAG_DELETED_FILE)
            _put_uvarint(out, level)
            _put_uvarint(out, number)
        for level, number, size, smallest, largest in self.new_files:
            _put_uvarint(out, _TAG_NEW_FILE)
            _put_uvarint(out, level)
            _put_uvarint(out, number)
            _put_uvarint(out, size)
            _length_prefixed(out, smallest)
            _length_prefixed(out, largest)
        return bytes(out)

    @classmethod
    def decode(cls, rec) -> "VersionEdit":
        e = cls()
        pos = 0
        n = len(rec)
        while pos < n:
            tag, pos = _uvarint(rec, pos)
            if tag == _TAG_COMPARATOR:
                s, pos = _get_length_prefixed(rec, pos)
                e.comparator = s.decode()
            elif tag == _TAG_LOG_NUMBER:
                e.log_number, pos = _uvarint(rec, pos)
            elif tag == _TAG_PREV_LOG:
                e.prev_log_number, pos = _uvarint(rec, pos)
            elif tag == _TAG_NEXT_FILE:
                e.next_file_number, pos = _uvarint(rec, pos)
            elif tag == _TAG_LAST_SEQ:
                e.last_sequence, pos = _uvarint(rec, pos)
            elif tag == _TAG_COMPACT_POINTER:
                _, pos = _uvarint(rec, pos)
                _, pos = _get_length_prefixed(rec, pos)
            elif tag == _TAG_DELETED_FILE:
                level, pos = _uvarint(rec, pos)
                number, pos = _uvarint(rec, pos)
                e.deleted_files.append((level, number))
            elif tag == _TAG_NEW_FILE:
                level, pos = _uvarint(rec, pos)
                number, pos = _uvarint(rec, pos)
                size, pos = _uvarint(rec, pos)
                smallest, pos = _get_length_prefixed(rec, pos)
                largest, pos = _get_length_prefixed(rec, pos)
                e.new_files.append((level, number, size, smallest, largest))
            else:
                raise ValueError(f"unknown VersionEdit tag {tag}")
        return e


# --------------------------------------------------------------- blocks
def decode_block(data) -> list[tuple[bytes, bytes]]:
    """Decode a table block (prefix-compressed entries + restart array)."""
    n_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    limit = len(data) - 4 - 4 * n_restarts
    entries = []
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _uvarint(data, pos)
        non_shared, pos = _uvarint(data, pos)
        value_len, pos = _uvarint(data, pos)
        key = key[:shared] + bytes(data[pos:pos + non_shared])
        pos += non_shared
        value = bytes(data[pos:pos + value_len])
        pos += value_len
        entries.append((key, value))
    return entries


class BlockBuilder:
    def __init__(self, restart_interval: int = 16):
        self._interval = restart_interval
        self.reset()

    def reset(self):
        self._buf = bytearray()
        self._restarts = [0]
        self._counter = 0
        self._last_key = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self._counter < self._interval:
            m = min(len(key), len(self._last_key))
            while shared < m and key[shared] == self._last_key[shared]:
                shared += 1
        else:
            self._restarts.append(len(self._buf))
            self._counter = 0
        _put_uvarint(self._buf, shared)
        _put_uvarint(self._buf, len(key) - shared)
        _put_uvarint(self._buf, len(value))
        self._buf += key[shared:]
        self._buf += value
        self._counter += 1
        self._last_key = key

    def finish(self) -> bytes:
        out = bytes(self._buf)
        out += b"".join(struct.pack("<I", r) for r in self._restarts)
        out += struct.pack("<I", len(self._restarts))
        return out

    def size_estimate(self) -> int:
        return len(self._buf) + 4 * len(self._restarts) + 4

    def empty(self) -> bool:
        return not self._buf


# --------------------------------------------------------------- tables
def _read_raw_block(buf, offset: int, size: int,
                    verify_checksums: bool = False) -> bytes:
    data = buf[offset:offset + size]
    ctype = buf[offset + size]
    if verify_checksums:
        stored = struct.unpack_from("<I", buf, offset + size + 1)[0]
        want = crc32c_mask(crc32c(bytes([ctype]), crc32c(data)))
        if stored != want:
            raise ValueError("block checksum mismatch")
    if ctype == 0:
        return bytes(data)
    if ctype == 1:
        return snappy_decompress(data)
    raise ValueError(f"unknown block compression type {ctype}")


class TableFile:
    """One .ldb/.sst sorted-string table, mmap-backed, lazily
    block-decoded — multi-GB reference feature tables never fully load."""

    def __init__(self, path: str, verify_checksums: bool = False):
        self._file = open(path, "rb")
        self._buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._verify = verify_checksums
        footer = self._buf[-48:]
        if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
            raise ValueError(f"{path}: bad table magic")
        pos = 0
        _mi_off, pos = _uvarint(footer, pos)
        _mi_size, pos = _uvarint(footer, pos)
        ix_off, pos = _uvarint(footer, pos)
        ix_size, pos = _uvarint(footer, pos)
        index = decode_block(_read_raw_block(self._buf, ix_off, ix_size,
                                             verify_checksums))
        # index entries: last-key-of-block (internal key) → BlockHandle
        self.block_handles: list[tuple[int, int]] = []
        for _key, hval in index:
            off, p = _uvarint(hval, 0)
            size, _ = _uvarint(hval, p)
            self.block_handles.append((off, size))

    def block(self, i: int) -> list[tuple[bytes, bytes]]:
        off, size = self.block_handles[i]
        return decode_block(_read_raw_block(self._buf, off, size, self._verify))

    def iter_internal(self, table_idx: int):
        """Yield (user_key, seq, type, (table_idx, block_idx, entry_idx))."""
        for bi in range(len(self.block_handles)):
            for ei, (ikey, _value) in enumerate(self.block(bi)):
                packed = struct.unpack_from("<Q", ikey, len(ikey) - 8)[0]
                yield ikey[:-8], packed >> 8, packed & 0xFF, (table_idx, bi, ei)

    def close(self) -> None:
        try:
            self._buf.close()
            self._file.close()
        except Exception:
            pass


class TableWriter:
    """Writes one sorted-string table; add() keys must arrive in ascending
    internal-key order."""

    def __init__(self, path: str, *, block_size: int = 4096,
                 restart_interval: int = 16, compression: str = "none"):
        self._f = open(path, "wb")
        self._block_size = block_size
        self._data = BlockBuilder(restart_interval)
        self._index = BlockBuilder(1)
        self._pending: list[tuple[bytes, bytes]] = []  # (last_key, handle)
        self._offset = 0
        self._compression = compression
        self._last_key = b""
        self.first_key: bytes | None = None
        self.last_key: bytes | None = None

    def add(self, ikey: bytes, value: bytes) -> None:
        if self.first_key is None:
            self.first_key = ikey
        self.last_key = ikey
        self._data.add(ikey, value)
        self._last_key = ikey
        if self._data.size_estimate() >= self._block_size:
            self._flush_data_block()

    def _write_block(self, contents: bytes) -> bytes:
        ctype = 0
        if self._compression == "snappy":
            compressed = snappy_compress(contents)
            if len(compressed) < len(contents) - len(contents) // 8:
                contents, ctype = compressed, 1
        crc = crc32c_mask(crc32c(bytes([ctype]), crc32c(contents)))
        handle = bytearray()
        _put_uvarint(handle, self._offset)
        _put_uvarint(handle, len(contents))
        self._f.write(contents)
        self._f.write(struct.pack("<BI", ctype, crc))
        self._offset += len(contents) + 5
        return bytes(handle)

    def _flush_data_block(self) -> None:
        if self._data.empty():
            return
        handle = self._write_block(self._data.finish())
        self._pending.append((self._last_key, handle))
        self._data.reset()

    def finish(self) -> int:
        self._flush_data_block()
        meta_handle = self._write_block(BlockBuilder().finish())
        for last_key, handle in self._pending:
            self._index.add(last_key, handle)
        index_handle = self._write_block(self._index.finish())
        footer = bytearray()
        footer += meta_handle
        footer += index_handle
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", TABLE_MAGIC)
        self._f.write(footer)
        size = self._offset + 48
        self._f.close()
        return size


# --------------------------------------------------------------- reader
def _internal_key(ukey: bytes, seq: int, vtype: int = _TYPE_VALUE) -> bytes:
    return ukey + struct.pack("<Q", (seq << 8) | vtype)


def resolve_leveldb_path(path: str) -> str | None:
    """Return the database directory when `path` is a LevelDB environment."""
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "CURRENT")):
        return path
    return None


class LevelDbReader:
    """Read-only merged view of a LevelDB directory.

    Exposes the store protocol shared with RecordReader/LmdbReader:
    len / key(i) / value(i) / __getitem__ / __iter__ / index_of / get.
    Iteration order is bytewise key order (leveldb cursor order,
    ref:src/caffe/layers/data_layer.cpp:50-66 SeekToFirst/Next).

    Cost model: __init__ walks every block of every live table once to build
    the merged key index — open is O(total DB bytes) in time (each block is
    decompressed once to enumerate its keys) but only O(#keys) in memory;
    values stay lazy (block reads via mmap on access, with an LRU block
    cache). For the shipped feature DBs (≤ a few GB) open costs seconds;
    random access afterwards is O(1) index lookups.
    """

    def __init__(self, path: str, verify_checksums: bool = False):
        self._dir = path
        current = os.path.join(path, "CURRENT")
        with open(current, "rb") as f:
            manifest_name = f.read().strip().decode()
        with open(os.path.join(path, manifest_name), "rb") as f:
            manifest = f.read()

        live: dict[int, int] = {}  # file number → level
        log_number = 0
        prev_log = 0
        for rec in read_log_records(manifest, verify_checksums):
            edit = VersionEdit.decode(rec)
            if edit.log_number is not None:
                log_number = edit.log_number
            if edit.prev_log_number is not None:
                prev_log = edit.prev_log_number
            for level, number in edit.deleted_files:
                live.pop(number, None)
            for level, number, _size, _sm, _lg in edit.new_files:
                live[number] = level

        self._tables: list[TableFile] = []
        iters = []
        for number in sorted(live):
            fname = None
            for ext in (".ldb", ".sst"):
                cand = os.path.join(path, f"{number:06d}{ext}")
                if os.path.exists(cand):
                    fname = cand
                    break
            if fname is None:
                raise FileNotFoundError(
                    f"{path}: live table {number:06d} missing")
            t = TableFile(fname, verify_checksums)
            iters.append(t.iter_internal(len(self._tables)))
            self._tables.append(t)

        # unflushed memtable: replay logs ≥ log_number (+ the prev log)
        self._mem_values: list[bytes] = []
        mem_entries = []
        log_files = []
        for fn in os.listdir(path):
            if fn.endswith(".log"):
                try:
                    num = int(fn[:-4])
                except ValueError:
                    continue
                if num >= log_number or (prev_log and num == prev_log):
                    log_files.append(num)
        for num in sorted(log_files):
            with open(os.path.join(path, f"{num:06d}.log"), "rb") as f:
                buf = f.read()
            for rec in read_log_records(buf, verify_checksums):
                for ukey, seq, vtype, value in decode_write_batch(rec):
                    loc = None
                    if vtype == _TYPE_VALUE:
                        loc = ("m", len(self._mem_values))
                        self._mem_values.append(value)
                    mem_entries.append((ukey, seq, vtype, loc))
        mem_entries.sort(key=lambda e: (e[0], _MAX_SEQ - e[1]))

        merged = heapq.merge(*iters, iter(mem_entries),
                             key=lambda e: (e[0], _MAX_SEQ - e[1]))
        self._entries: list[tuple[bytes, tuple]] = []
        last_ukey = None
        for ukey, _seq, vtype, loc in merged:
            if ukey == last_ukey:
                continue  # older sequence of the same key: shadowed
            last_ukey = ukey
            if vtype == _TYPE_VALUE:
                self._entries.append((ukey, loc))
        self._key_to_idx: dict[bytes, int] | None = None
        self._block_cache: dict[tuple[int, int], list[bytes]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, i: int) -> bytes:
        return self._entries[i][0]

    def _block_values(self, table_idx: int, block_idx: int) -> list[bytes]:
        ck = (table_idx, block_idx)
        vals = self._block_cache.pop(ck, None)
        if vals is None:
            vals = [v for _k, v in self._tables[table_idx].block(block_idx)]
            if len(self._block_cache) >= 32:
                # evict least-recently-used: hits reinsert at the end, so
                # the first dict key is the coldest block
                self._block_cache.pop(next(iter(self._block_cache)))
        self._block_cache[ck] = vals  # (re)insert at the end = most recent
        return vals

    def value(self, i: int) -> bytes:
        loc = self._entries[i][1]
        if loc[0] == "m":
            return self._mem_values[loc[1]]
        table_idx, block_idx, entry_idx = loc
        return self._block_values(table_idx, block_idx)[entry_idx]

    def __getitem__(self, i: int) -> tuple[bytes, bytes]:
        return self.key(i), self.value(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def index_of(self, key) -> int:
        if isinstance(key, str):
            key = key.encode()
        if self._key_to_idx is None:
            self._key_to_idx = {k: i
                                for i, (k, _) in enumerate(self._entries)}
        return self._key_to_idx[key]

    def get(self, key) -> bytes:
        return self.value(self.index_of(key))

    def close(self) -> None:
        for t in self._tables:
            t.close()
        self._entries = []
        self._tables = []
        self._block_cache.clear()


# --------------------------------------------------------------- writer
class LevelDbWriter:
    """Writes a fresh LevelDB: level-0 tables + MANIFEST + CURRENT.

    `put` in any order. Keys arriving in ascending order (the common case —
    converters iterate stores in key order) STREAM straight to disk with
    O(1) memory; out-of-order keys buffer up to `max_stray_bytes` and then
    spill as their own sorted level-0 table (so fully-unsorted input — e.g.
    the reference extract_features' decimal "10" < "9" keys — is bounded
    at O(max_stray_bytes) memory, not O(dataset)). Level-0 tables may
    overlap — readers (ours and C++ leveldb) resolve by sequence number,
    and sequence numbers here are assigned at put() time, so duplicate
    keys keep last-put-wins semantics exactly. Existing files are
    replaced."""

    def __init__(self, path: str, *, block_size: int = 4096,
                 compression: str = "none",
                 max_table_bytes: int = 64 << 20,
                 max_stray_bytes: int = 64 << 20):
        self._dir = path
        self._block_size = block_size
        self._compression = compression
        self._max_table_bytes = max_table_bytes
        self._max_stray_bytes = max_stray_bytes
        self._stray: dict[bytes, tuple[int, bytes]] = {}  # out-of-order puts
        self._stray_bytes = 0
        self._closed = False
        self._last_key: bytes | None = None
        self._tw: TableWriter | None = None
        self._tw_bytes = 0
        self._file_number = 2  # MANIFEST is 1, tables from 2 (NewDB layout)
        self._seq = 0
        self._edit = VersionEdit()
        self._edit.comparator = "leveldb.BytewiseComparator"
        self._edit.log_number = 0
        self._edit.prev_log_number = 0
        os.makedirs(path, exist_ok=True)
        # "Existing files are replaced" must mean ALL of them: a stale
        # .log left by a previous DB would be replayed by every reader
        # (ours AND C++ leveldb filter logs by num >= log_number, which
        # we write as 0) and its high sequence numbers would shadow the
        # fresh values — silent resurrection of old keys. Same effect as
        # leveldb::DestroyDB before a re-export.
        for name in os.listdir(path):
            if (name in ("CURRENT", "LOCK", "LOG", "LOG.old")
                    or re.fullmatch(
                        r"MANIFEST-\d+|\d{6,}\.(log|ldb|sst|tmp)", name)):
                os.unlink(os.path.join(path, name))

    def _emit(self, key: bytes, seq: int, value: bytes) -> None:
        if self._tw is None:
            tpath = os.path.join(self._dir, f"{self._file_number:06d}.ldb")
            self._tw = TableWriter(tpath, block_size=self._block_size,
                                   compression=self._compression)
            self._tw_bytes = 0
        self._tw.add(_internal_key(key, seq), value)
        self._tw_bytes += len(key) + len(value) + 16
        if self._tw_bytes >= self._max_table_bytes:
            self._finish_table()

    def _finish_table(self) -> None:
        if self._tw is None:
            return
        size = self._tw.finish()
        self._edit.new_files.append(
            (0, self._file_number, size, self._tw.first_key,
             self._tw.last_key))
        self._file_number += 1
        self._tw = None

    def put(self, key, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode()
        self._seq += 1
        if self._last_key is None or key > self._last_key:
            self._emit(key, self._seq, bytes(value))  # ascending fast path
            self._last_key = key
        else:
            # a key ≤ _last_key can never re-enter the ascending stream
            # (_last_key only grows), so its stray seq always exceeds any
            # streamed seq of the same key — last-put-wins holds
            prev = self._stray.get(key)
            if prev is not None:  # replacement: re-account the value size
                self._stray_bytes -= len(prev[1])
            else:
                self._stray_bytes += len(key) + 48
            self._stray_bytes += len(value)
            self._stray[key] = (self._seq, bytes(value))
            if self._stray_bytes >= self._max_stray_bytes:
                self._flush_strays()

    def _flush_strays(self) -> None:
        """Spill the out-of-order buffer as sorted level-0 table(s).
        Overlap with other tables (and other spills) is fine: the merged
        reader resolves duplicates by sequence number."""
        if not self._stray:
            return
        self._finish_table()          # close the in-flight ascending run
        for k in sorted(self._stray):
            seq, value = self._stray[k]
            self._emit(k, seq, value)
        self._stray.clear()
        self._stray_bytes = 0
        self._finish_table()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._finish_table()          # the ascending-run table(s)
        self._flush_strays()          # overlapping level-0 table(s)
        self._edit.last_sequence = self._seq
        self._edit.next_file_number = self._file_number

        manifest_name = "MANIFEST-000001"
        with open(os.path.join(self._dir, manifest_name), "wb") as f:
            LogWriter(f).add_record(self._edit.encode())
        with open(os.path.join(self._dir, "CURRENT"), "wb") as f:
            f.write(manifest_name.encode() + b"\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
