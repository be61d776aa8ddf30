"""A minimal HDF5 writer: named n-d numeric arrays as contiguous datasets in
the root group of a new file, in pure Python and numpy.

The port writes HDF5_OUTPUT's files with it, so that it needs no h5py. The
file is what libhdf5 writes with libver="latest" for the same datasets,
less the optional messages (times, attributes, filters): a version-2
superblock, a root group of compact links (version-2 object headers, a
Link Info, a Group Info and one Link message per dataset), and one object
header per dataset (Dataspace, Datatype, Fill Value and a contiguous Data
Layout) followed by its raw little-endian data. The structures and the
Jenkins lookup3 checksum are those of the HDF5 File Format Specification,
version 3.0 (superblock II.A, object header IV.A.1.b, messages IV.A.2).
"""

from __future__ import annotations

import struct

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
