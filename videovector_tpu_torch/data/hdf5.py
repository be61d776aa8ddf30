"""A minimal HDF5 writer and reader: named n-d numeric arrays in the root
group of a file, in pure Python, numpy and zlib.

The port writes HDF5_OUTPUT's files and reads HDF5_DATA's with it, so that
it needs no h5py (the card's machine has none). The writer's file is what
libhdf5 writes with libver="latest" for the same datasets,
less the optional messages (times, attributes, filters): a version-2
superblock, a root group of compact links (version-2 object headers, a
Link Info, a Group Info and one Link message per dataset), and one object
header per dataset (Dataspace, Datatype, Fill Value and a contiguous Data
Layout) followed by its raw little-endian data. The structures and the
Jenkins lookup3 checksum are those of the HDF5 File Format Specification,
version 3.0 (superblock II.A, object header IV.A.1.b, messages IV.A.2).

`read_hdf5` reads the root group's datasets of the files h5py writes with
its defaults (superblock version 0 or 1, a symbol-table root group: a
version-1 B-tree of SNOD nodes over a local heap, version-1 object headers)
and of the writer's files (superblock version 2 or 3, compact links in a
version-2 object header): fixed-point and IEEE float datatypes of either
byte order, contiguous or compact layout, and chunked layout (layout
message version 1-3) indexed by a version-1 B-tree, with the deflate and
shuffle filters. Anything else (dense link storage, nested groups,
variable-length or compound types, other filters, the version-4 chunk
indexes) raises ValueError naming the structure.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF

# header message types (IV.A.2)
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_VALUE = 0x01, 0x02, 0x03, 0x05
_LINK, _LAYOUT, _GROUP_INFO = 0x06, 0x08, 0x0A


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hashlittle, HDF5's metadata checksum
    (H5_checksum_lookup3)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    i = 0
    while n - i > 12:
        x, y, z = struct.unpack_from("<3I", data, i)
        a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4); c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6); a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8); b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16); c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19); a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4); b = (b + a) & _M32
        i += 12
    if n - i == 0:
        return c
    x, y, z = struct.unpack("<3I", data[i:].ljust(12, b"\0"))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


def _datatype(dtype: np.dtype) -> bytes:
    """A Datatype message (version 1) for a little-endian IEEE float or a
    two's-complement integer."""
    size = dtype.itemsize
    if dtype.kind == "f" and size in (4, 8):
        bits = size * 8
        exp_bits, mant_bits, bias = (8, 23, 127) if size == 4 else (11, 52, 1023)
        # class 1 (floating point); flags: little-endian, mantissa
        # normalization "msb implied" (2 << 4), sign bit at bits - 1
        head = bytes([0x10 | 1, 0x20, bits - 1, 0]) + struct.pack("<I", size)
        return head + struct.pack("<HHBBBBI", 0, bits, mant_bits, exp_bits, 0,
                                  mant_bits, bias)
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        # class 0 (fixed point); flag bit 3 = signed
        head = bytes([0x10 | 0, 0x08 if dtype.kind == "i" else 0, 0, 0]) \
            + struct.pack("<I", size)
        return head + struct.pack("<HH", 0, size * 8)
    raise TypeError(f"no HDF5 datatype here for {dtype}")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    return struct.pack("<BHB", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    """A version-2 object header ("OHDR"), its chunk size in 4 bytes, and
    its checksum."""
    body = b"".join(messages)
    head = b"OHDR" + bytes([2, 0x02]) + struct.pack("<I", len(body))
    block = head + body
    return block + struct.pack("<I", lookup3(block))


def _dataset_header(shape: tuple, dtype: np.dtype, address: int,
                    nbytes: int) -> bytes:
    rank = len(shape)
    space = struct.pack("<BBBB", 2, rank, 0, 1 if rank else 0) + b"".join(
        struct.pack("<Q", d) for d in shape)
    # fill value version 3: early allocation, written if set, none defined
    fill = struct.pack("<BB", 3, 0x01 | (2 << 2))
    layout = struct.pack("<BBQQ", 3, 1, address if nbytes else _UNDEF, nbytes)
    return _object_header([_message(_DATASPACE, space),
                           _message(_DATATYPE, _datatype(dtype), flags=1),
                           _message(_FILL_VALUE, fill, flags=1),
                           _message(_LAYOUT, layout)])


def _root_header(links: list[tuple[str, int]]) -> bytes:
    msgs = [_message(_LINK_INFO, struct.pack("<BBQQ", 0, 0, _UNDEF, _UNDEF)),
            _message(_GROUP_INFO, struct.pack("<BB", 0, 0))]
    for name, address in links:
        raw = name.encode("utf-8")
        if not 0 < len(raw) < 256:
            raise ValueError(f"dataset name {name!r}: 1..255 bytes")
        # link version 1, flags: a 1-byte name length (0) and the character
        # set field present (bit 4, 1 = UTF-8); a hard link (no type field)
        msgs.append(_message(_LINK, struct.pack("<BBBB", 1, 0x10, 1, len(raw))
                             + raw + struct.pack("<Q", address)))
    return _object_header(msgs)


def write_hdf5(path: str, datasets: dict[str, np.ndarray]) -> None:
    """Write `datasets` ({name: array}) as the root group's datasets of a
    new HDF5 file at `path` (truncated if it exists). Arrays are stored
    little-endian, C order, contiguous."""
    arrays = {k: np.array(v, dtype=np.asarray(v).dtype.newbyteorder("<"),
                          order="C")
              for k, v in datasets.items()}
    superblock_size = 48
    # the root header's size depends only on the names, not the addresses
    root_size = len(_root_header([(k, 0) for k in arrays]))
    headers = [len(_dataset_header(a.shape, a.dtype, 0, a.nbytes))
               for a in arrays.values()]
    pos = superblock_size + root_size + sum(headers)
    pos = (pos + 7) & ~7
    addresses, data_at = [], []
    offset = superblock_size + root_size
    for a, hsize in zip(arrays.values(), headers):
        addresses.append(offset)
        offset += hsize
        data_at.append(pos)
        pos = (pos + a.nbytes + 7) & ~7
    eof = pos
    root = _root_header(list(zip(arrays, addresses)))
    sb = _SIGNATURE + struct.pack("<BBBB", 2, 8, 8, 0) + struct.pack(
        "<QQQQ", 0, _UNDEF, eof, superblock_size)
    sb += struct.pack("<I", lookup3(sb))
    with open(path, "wb") as f:
        f.write(sb)
        f.write(root)
        for a, at in zip(arrays.values(), data_at):
            f.write(_dataset_header(a.shape, a.dtype, at, a.nbytes))
        for a, at in zip(arrays.values(), data_at):
            f.write(b"\0" * (at - f.tell()))
            f.write(a.tobytes())
        f.write(b"\0" * (eof - f.tell()))



# -- reader -------------------------------------------------------------

_SYMBOL_TABLE, _CONTINUATION, _FILTERS = 0x11, 0x10, 0x0B
_DEFLATE, _SHUFFLE = 1, 2


class _File:
    """Byte-level access to one HDF5 file with 8-byte offsets and lengths."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.path = path
        self.base = self._superblock()

    def fail(self, what: str):
        return ValueError(f"{self.path}: unsupported HDF5 structure: {what}")

    def u(self, fmt: str, pos: int):
        return struct.unpack_from("<" + fmt, self.buf, pos)

    def _superblock(self) -> int:
        # the signature sits at 0, 512, 1024, ... (II.A)
        at = 0
        while self.buf[at:at + 8] != _SIGNATURE:
            at = 512 if at == 0 else at * 2
            if at + 8 > len(self.buf):
                raise ValueError(f"{self.path}: not an HDF5 file")
        version = self.buf[at + 8]
        if version in (0, 1):
            sizes = self.buf[at + 13], self.buf[at + 14]
            if sizes != (8, 8):
                raise self.fail(f"offset/length sizes {sizes}")
            pos = at + 24 + (4 if version == 1 else 0)
            base, = self.u("Q", pos)
            # the root group's symbol table entry follows the four addresses
            self.root = self.u("Q", pos + 32 + 8)[0] + base
            return base
        if version in (2, 3):
            sizes = self.buf[at + 9], self.buf[at + 10]
            if sizes != (8, 8):
                raise self.fail(f"offset/length sizes {sizes}")
            base, _ext, _eof, root = self.u("QQQQ", at + 12)
            self.root = root + base
            return base
        raise self.fail(f"superblock version {version}")

    def addr(self, a: int) -> int:
        return a + self.base

    # -- object headers (IV.A.1) --
    def messages(self, at: int) -> list[tuple[int, bytes]]:
        """(type, body) of each message of the object header at `at`,
        continuation blocks followed."""
        out: list[tuple[int, bytes]] = []
        if self.buf[at:at + 4] == b"OHDR":
            self._v2_messages(at, out)
            return out
        if self.buf[at] != 1:
            raise self.fail(f"object header version {self.buf[at]}")
        _v, _r, count, _refs, size = self.u("BBHII", at)
        blocks = [(at + 16, size)]
        while blocks and len(out) < count:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < count:
                mtype, msize, _flags = self.u("HHB", pos)
                body = self.buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    off, ln = struct.unpack_from("<QQ", body)
                    blocks.append((self.addr(off), ln))
                out.append((mtype, body))
        return out

    def _v2_messages(self, at: int, out: list) -> None:
        flags = self.buf[at + 5]
        pos = at + 6
        if flags & 0x20:
            pos += 16                       # times
        if flags & 0x10:
            pos += 4                        # attribute phase change values
        width = 1 << (flags & 3)
        size = int.from_bytes(self.buf[pos:pos + width], "little")
        pos += width
        blocks = [(pos, pos + size)]
        while blocks:
            pos, end = blocks.pop(0)
            while pos + 4 <= end:
                mtype, msize = self.u("BH", pos)
                pos += 4 + (2 if flags & 0x04 else 0)
                body = self.buf[pos:pos + msize]
                pos += msize
                if mtype == _CONTINUATION:
                    off, ln = struct.unpack_from("<QQ", body)
                    start = self.addr(off)
                    if self.buf[start:start + 4] != b"OCHK":
                        raise self.fail("continuation block without OCHK")
                    blocks.append((start + 4, start + ln - 4))
                out.append((mtype, body))

    # -- groups --
    def root_members(self) -> list[tuple[str, int]]:
        """(name, object header address) of the root group's members, in
        name order (h5py's default iteration order)."""
        msgs = self.messages(self.root)
        members: list[tuple[str, int]] = []
        types = {t for t, _ in msgs}
        if _SYMBOL_TABLE in types:
            body = next(b for t, b in msgs if t == _SYMBOL_TABLE)
            btree, heap = struct.unpack_from("<QQ", body)
            heap_data = self._local_heap(self.addr(heap))
            self._group_btree(self.addr(btree), heap_data, members)
        elif _LINK in types:
            for t, body in msgs:
                if t == _LINK:
                    members.append(self._link(body))
        elif _LINK_INFO in types:
            body = next(b for t, b in msgs if t == _LINK_INFO)
            heap, = struct.unpack_from("<Q", body, 2 + (8 if body[1] & 1 else 0))
            if heap != _UNDEF:
                raise self.fail("dense link storage (fractal heap)")
        else:
            raise self.fail("root group without a symbol table or links")
        return sorted(members, key=lambda m: m[0].encode("utf-8"))

    def _local_heap(self, at: int) -> bytes:
        if self.buf[at:at + 4] != b"HEAP":
            raise self.fail("local heap signature")
        size, _free, data = self.u("QQQ", at + 8)
        data = self.addr(data)
        return self.buf[data:data + size]

    def _group_btree(self, at: int, heap: bytes, out: list) -> None:
        if self.buf[at:at + 4] != b"TREE" or self.buf[at + 4] != 0:
            raise self.fail("group B-tree node")
        level, used = self.buf[at + 5], self.u("H", at + 6)[0]
        pos = at + 24 + 8                   # past the header and key 0
        for _ in range(used):
            child = self.addr(self.u("Q", pos)[0])
            pos += 16                       # the child and the next key
            if level:
                self._group_btree(child, heap, out)
            else:
                self._symbol_node(child, heap, out)

    def _symbol_node(self, at: int, heap: bytes, out: list) -> None:
        if self.buf[at:at + 4] != b"SNOD":
            raise self.fail("symbol table node signature")
        count, = self.u("H", at + 6)
        for i in range(count):
            name_off, header = self.u("QQ", at + 8 + 40 * i)
            name = heap[name_off:heap.index(b"\0", name_off)].decode("utf-8")
            out.append((name, self.addr(header)))

    def _link(self, body: bytes) -> tuple[str, int]:
        flags = body[1]
        pos = 2
        if flags & 0x08:
            if body[pos] != 0:
                raise self.fail("soft or external link")
            pos += 1
        if flags & 0x04:
            pos += 8                        # creation order
        if flags & 0x10:
            pos += 1                        # character set
        width = 1 << (flags & 3)
        n = int.from_bytes(body[pos:pos + width], "little")
        pos += width
        name = body[pos:pos + n].decode("utf-8")
        return name, self.addr(struct.unpack_from("<Q", body, pos + n)[0])

    # -- datasets --
    def dataset(self, name: str, at: int) -> np.ndarray:
        msgs = {}
        for t, body in self.messages(at):
            msgs.setdefault(t, body)
        if _DATASPACE not in msgs or _LAYOUT not in msgs:
            raise self.fail(f"{name!r} is not a dataset (a nested group?)")
        shape = self._dataspace(msgs[_DATASPACE])
        dtype = self._datatype(msgs[_DATATYPE])
        filters = self._filters(msgs[_FILTERS]) if _FILTERS in msgs else []
        return self._layout(name, msgs[_LAYOUT], shape, dtype, filters)

    def _dataspace(self, body: bytes) -> tuple:
        version, rank, flags = body[0], body[1], body[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if body[3] == 2:
                raise self.fail("null dataspace")
            pos = 4
        else:
            raise self.fail(f"dataspace version {version}")
        return struct.unpack_from(f"<{rank}Q", body, pos)

    def _datatype(self, body: bytes) -> np.dtype:
        cls, bits0 = body[0] & 0x0F, body[1]
        size, = struct.unpack_from("<I", body, 4)
        order = ">" if bits0 & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            kind = "i" if bits0 & 0x08 else "u"
            return np.dtype(f"{order}{kind}{size}")
        if cls == 1 and size in (2, 4, 8) and not bits0 & 0x40:
            return np.dtype(f"{order}f{size}")
        raise self.fail(f"datatype class {cls} of {size} bytes")

    def _filters(self, body: bytes) -> list[int]:
        version, count = body[0], body[1]
        pos = 8 if version == 1 else 2
        ids = []
        for _ in range(count):
            fid, = struct.unpack_from("<H", body, pos)
            if version == 1:
                name_len, _flags, nvals = struct.unpack_from("<HHH", body, pos + 2)
                pos += 8 + ((name_len + 7) & ~7) + 4 * nvals + 4 * (nvals & 1)
            else:
                name_len = 0
                pos += 2
                if fid >= 256:
                    name_len, = struct.unpack_from("<H", body, pos)
                    pos += 2
                _flags, nvals = struct.unpack_from("<HH", body, pos)
                pos += 4 + name_len + 4 * nvals
            if fid not in (_DEFLATE, _SHUFFLE):
                raise self.fail(f"filter {fid} (deflate and shuffle are read)")
            ids.append(fid)
        return ids

    def _layout(self, name, body, shape, dtype, filters) -> np.ndarray:
        version = body[0]
        count = int(np.prod(shape, dtype=np.int64))
        if version in (1, 2):
            ndims, cls = body[1], body[2]
            addr, = struct.unpack_from("<Q", body, 8)
            dims = struct.unpack_from(f"<{ndims}I", body, 16)
            if cls == 1:
                return self._contiguous(addr, count * dtype.itemsize, shape,
                                        dtype)
            if cls == 2:
                return self._chunked(addr, dims[:-1], shape, dtype, filters)
            raise self.fail(f"layout class {cls} in layout version {version}")
        if version in (3, 4):
            cls = body[1]
            if cls == 0:
                size, = struct.unpack_from("<H", body, 2)
                return np.frombuffer(body[4:4 + size], dtype,
                                     count).reshape(shape).copy()
            if cls == 1:
                addr, size = struct.unpack_from("<QQ", body, 2)
                return self._contiguous(addr, size, shape, dtype)
            if cls == 2 and version == 3:
                ndims = body[2]
                addr, = struct.unpack_from("<Q", body, 3)
                dims = struct.unpack_from(f"<{ndims}I", body, 11)
                return self._chunked(addr, dims[:-1], shape, dtype, filters)
        raise self.fail(f"layout class {body[1]} in layout version {version} "
                        f"(dataset {name!r})")

    def _contiguous(self, addr, size, shape, dtype) -> np.ndarray:
        count = int(np.prod(shape, dtype=np.int64))
        if addr == _UNDEF:                  # never written: the fill, 0
            return np.zeros(shape, dtype)
        start = self.addr(addr)
        if size < count * dtype.itemsize or start + size > len(self.buf):
            raise ValueError(f"{self.path}: contiguous data out of bounds")
        return np.frombuffer(self.buf, dtype, count, start).reshape(shape).copy()

    def _chunked(self, addr, chunk, shape, dtype, filters) -> np.ndarray:
        out = np.zeros(shape, dtype)
        if addr == _UNDEF:
            return out
        rank = len(shape)
        if len(chunk) != rank:
            raise ValueError(f"{self.path}: chunk rank {len(chunk)} for a "
                             f"rank-{rank} dataset")
        for size, mask, offsets, at in self._chunk_btree(self.addr(addr), rank):
            raw = self.buf[at:at + size]
            for i, fid in reversed(list(enumerate(filters))):
                if mask & (1 << i):
                    continue                # the filter was skipped
                if fid == _DEFLATE:
                    raw = zlib.decompress(raw)
                else:
                    raw = _unshuffle(raw, dtype.itemsize)
            n = int(np.prod(chunk, dtype=np.int64))
            if len(raw) < n * dtype.itemsize:
                raise ValueError(f"{self.path}: short chunk at {offsets}")
            block = np.frombuffer(raw, dtype, n).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _chunk_btree(self, at: int, rank: int):
        if self.buf[at:at + 4] != b"TREE" or self.buf[at + 4] != 1:
            raise self.fail("chunk B-tree node")
        level, used = self.buf[at + 5], self.u("H", at + 6)[0]
        key = 8 + 8 * (rank + 1)
        pos = at + 24
        for _ in range(used):
            size, mask = self.u("II", pos)
            offsets = self.u(f"{rank}Q", pos + 8)
            child = self.addr(self.u("Q", pos + key)[0])
            pos += key + 8
            if level:
                yield from self._chunk_btree(child, rank)
            else:
                yield size, mask, offsets, child


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    """The shuffle filter undone: byte k of every element was stored
    together, for each k in turn; a tail shorter than an element stays."""
    if itemsize == 1:
        return raw
    n = len(raw) // itemsize
    arr = np.frombuffer(raw, np.uint8)
    body = arr[:n * itemsize].reshape(itemsize, n).T.tobytes()
    return body + bytes(arr[n * itemsize:])


def read_hdf5(path: str) -> dict[str, np.ndarray]:
    """{name: array} of the root group's datasets, in name order, in their
    stored dtypes (native byte order). Raises ValueError for any structure
    the module does not read (module docstring)."""
    f = _File(path)
    out = {}
    for name, at in f.root_members():
        arr = f.dataset(name, at)
        out[name] = arr.astype(arr.dtype.newbyteorder("="), copy=False)
    return out
