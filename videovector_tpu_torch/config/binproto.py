"""Schema-driven proto2 binary codec over textformat.Message; counterpart of
videovector_tpu/config/binproto.py, whose bytes it writes and reads.

Encodes and decodes any message that the schema tables describe
(config/proto_schema.py, field numbers from ref:src/caffe/proto/*.proto) to
and from proto2 wire format. Net::ToProto writes the layer configs and the
learned blobs into one binary NetParameter (ref:src/caffe/net.cpp:774-801),
and the reference reads nets and solvers from binary files
(ReadNetParamsFromBinaryFileOrDie, ref:include/caffe/util/io.hpp:51-90).
With this codec the port writes .caffemodel snapshots that carry configs
and blobs (and diffs with snapshot_diff, ref:src/caffe/solver.cpp:321-341)
and reads binary net and solver protos.

Values follow the text parser's conventions: enums are their NAME strings,
bools are bools, sub-messages are Message. An unknown field raises on
decode: the schema covers every field the reference defines.
"""

from __future__ import annotations

import struct

import numpy as np

from videovector_tpu_torch.config.proto_schema import ENUMS, MESSAGES
from videovector_tpu_torch.config.textformat import Message, _escape
from videovector_tpu_torch.data.wire import (
    iter_fields, read_varint, write_varint, _decode_int32,
)

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5

# scalar kind -> wire type for non-packed encoding
_WIRE = {"d": _WT_I64, "f": _WT_I32, "i": _WT_VARINT, "u": _WT_VARINT,
         "si": _WT_VARINT, "x32": _WT_I32, "x64": _WT_I64, "b": _WT_VARINT,
         "s": _WT_LEN, "y": _WT_LEN}


def _tag(buf: bytearray, fnum: int, wt: int) -> None:
    write_varint(buf, (fnum << 3) | wt)


def _enc_scalar(buf: bytearray, fnum: int, kind: str, v) -> None:
    if kind == "f":
        _tag(buf, fnum, _WT_I32)
        buf += struct.pack("<f", float(v))
    elif kind == "d":
        _tag(buf, fnum, _WT_I64)
        buf += struct.pack("<d", float(v))
    elif kind in ("i", "u"):
        _tag(buf, fnum, _WT_VARINT)
        write_varint(buf, int(v) & 0xFFFFFFFFFFFFFFFF)
    elif kind == "si":
        _tag(buf, fnum, _WT_VARINT)
        n = int(v)
        write_varint(buf, (n << 1) ^ (n >> 63))
    elif kind == "b":
        _tag(buf, fnum, _WT_VARINT)
        write_varint(buf, 1 if _truthy(v) else 0)
    elif kind == "s":
        # surrogateescape inverts textformat._unquote for byte-escaped
        # literals that aren't valid UTF-8 (plain .encode() would raise)
        data = str(v).encode("utf-8", "surrogateescape")
        _tag(buf, fnum, _WT_LEN)
        write_varint(buf, len(data))
        buf += data
    elif kind == "y":
        data = v if isinstance(v, (bytes, bytearray)) \
            else str(v).encode("utf-8", "surrogateescape")
        _tag(buf, fnum, _WT_LEN)
        write_varint(buf, len(data))
        buf += bytes(data)
    elif kind == "x32":
        _tag(buf, fnum, _WT_I32)
        buf += struct.pack("<i", int(v))
    elif kind == "x64":
        _tag(buf, fnum, _WT_I64)
        buf += struct.pack("<q", int(v))
    else:
        raise ValueError(f"unknown scalar kind {kind}")


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.lower() == "true" or v == "1"
    return bool(v)


def encode(msg: Message, msg_type: str) -> bytes:
    """Message (text-parser conventions) -> proto2 wire bytes."""
    schema = MESSAGES[msg_type]
    buf = bytearray()
    for fname, values in msg.fields.items():
        if fname not in schema:
            raise ValueError(f"{msg_type} has no field {fname!r}")
        fnum, label, (kind, detail), packed, _default = schema[fname]
        if kind == "msg":
            for v in values:
                if not isinstance(v, Message):
                    raise ValueError(f"{msg_type}.{fname}: expected message")
                sub = encode(v, detail)
                _tag(buf, fnum, _WT_LEN)
                write_varint(buf, len(sub))
                buf += sub
        elif kind == "enum":
            table = ENUMS[detail]
            for v in values:
                n = table[v] if isinstance(v, str) else int(v)
                _tag(buf, fnum, _WT_VARINT)
                write_varint(buf, n & 0xFFFFFFFFFFFFFFFF)
        elif packed and len(values) and kind == "scalar":
            sub = bytearray()
            if detail == "f":
                sub += np.asarray(values, "<f4").tobytes()
            elif detail == "d":
                sub += np.asarray(values, "<f8").tobytes()
            else:
                for v in values:
                    write_varint(sub, int(v) & 0xFFFFFFFFFFFFFFFF)
            _tag(buf, fnum, _WT_LEN)
            write_varint(buf, len(sub))
            buf += sub
        else:
            for v in values:
                _enc_scalar(buf, fnum, detail, v)
    return bytes(buf)


def decode(data: bytes, msg_type: str) -> Message:
    """proto2 wire bytes -> Message (text-parser conventions)."""
    schema = MESSAGES[msg_type]
    by_num = {f[0]: (name, f) for name, f in schema.items()}
    msg = Message()
    for fnum, wt, v in iter_fields(data):
        if fnum not in by_num:
            raise ValueError(f"{msg_type}: unknown field number {fnum}")
        fname, (num, label, (kind, detail), packed, _default) = by_num[fnum]
        if kind == "msg":
            msg.add(fname, decode(v, detail))
        elif kind == "enum":
            rev = {n: s for s, n in ENUMS[detail].items()}
            msg.add(fname, rev.get(_decode_int32(v), _decode_int32(v)))
        else:
            _dec_scalar(msg, fname, detail, wt, v)
    return msg


def _f32(x):
    """Shortest value for an f32 (protobuf text-printer style: 0.001f
    prints as 0.001, not 0.0010000000474974513; integral floats print as
    ints — matching the text parser's auto-typing so text→bin→text is
    byte-identical)."""
    f = float(np.format_float_positional(np.float32(x)))
    if f.is_integer() and abs(f) < 2**53 and not (f == 0.0 and np.signbit(f)):
        return int(f)
    return f  # -0.0 stays a float: int() would drop the sign bit


def _dec_scalar(msg: Message, fname: str, kind: str, wt: int, v) -> None:
    if kind == "f":
        if wt == _WT_LEN:  # packed
            for x in np.frombuffer(v, "<f4"):
                msg.add(fname, _f32(x))
        else:
            msg.add(fname, _f32(struct.unpack("<f", v)[0]))
    elif kind == "d":
        if wt == _WT_LEN:
            for x in np.frombuffer(v, "<f8"):
                msg.add(fname, float(x))
        else:
            msg.add(fname, struct.unpack("<d", v)[0])
    elif kind in ("i", "u"):
        if wt == _WT_LEN:  # packed varints
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                msg.add(fname, _decode_int32(x) if kind == "i" else x)
        else:
            msg.add(fname, _decode_int32(v) if kind == "i" else v)
    elif kind == "si":
        n = v if isinstance(v, int) else read_varint(v, 0)[0]
        msg.add(fname, (n >> 1) ^ -(n & 1))
    elif kind == "b":
        msg.add(fname, bool(v))
    elif kind == "s":
        msg.add(fname, v.decode())
    elif kind == "y":
        msg.add(fname, bytes(v))
    elif kind == "x32":
        msg.add(fname, struct.unpack("<i", v)[0])
    elif kind == "x64":
        msg.add(fname, struct.unpack("<q", v)[0])
    else:
        raise ValueError(f"unknown scalar kind {kind}")


def _escape_bytes(raw: bytes) -> str:
    """Protobuf TextFormat byte-escape (C++ CEscape semantics): printable
    ASCII raw except quote/backslash, \\n \\r \\t named, everything else
    3-digit octal — parseable by both textformat._unquote and the
    reference's strict reader."""
    out = []
    for byte in raw:
        if byte == 0x22:
            out.append('\\"')
        elif byte == 0x5C:
            out.append("\\\\")
        elif byte == 0x0A:
            out.append("\\n")
        elif byte == 0x0D:
            out.append("\\r")
        elif byte == 0x09:
            out.append("\\t")
        elif 0x20 <= byte < 0x7F:
            out.append(chr(byte))
        else:
            out.append("\\%03o" % byte)
    return "".join(out)


def to_text(msg: Message, msg_type: str, indent: int = 0) -> str:
    """Schema-aware prototxt printer: string fields are ALWAYS quoted and
    enums never are — strict protobuf TextFormat, parseable by the
    reference's ReadProtoFromTextFile (the schema-free Message.dumps can't
    tell a bare-identifier string from an enum and prints it unquoted,
    which strict TextFormat rejects for string fields)."""
    schema = MESSAGES[msg_type]
    pad = "  " * indent
    lines = []
    for fname, values in msg.fields.items():
        if fname not in schema:
            raise ValueError(f"{msg_type} has no field {fname!r}")
        _num, _label, (kind, detail), _packed, _default = schema[fname]
        for v in values:
            if kind == "msg":
                lines.append(f"{pad}{fname} {{")
                lines.append(to_text(v, detail, indent + 1))
                lines.append(f"{pad}}}")
            elif kind == "enum":
                name = v if isinstance(v, str) else \
                    {n: s for s, n in ENUMS[detail].items()}[int(v)]
                lines.append(f"{pad}{fname}: {name}")
            elif detail == "s":
                # textformat's escape (a raw newline inside the quoted
                # literal breaks the reference's strict TextFormat reader)
                lines.append(f'{pad}{fname}: "{_escape(str(v))}"')
            elif detail == "y":
                # bytes print as a protobuf-escaped quoted literal
                # (printable ASCII raw, the rest 3-digit octal) — NOT a
                # Python repr, which no TextFormat parser reads back
                raw = v if isinstance(v, (bytes, bytearray)) \
                    else str(v).encode("utf-8", "surrogateescape")
                lines.append(f'{pad}{fname}: "{_escape_bytes(raw)}"')
            elif detail == "b":
                lines.append(
                    f"{pad}{fname}: {'true' if _truthy(v) else 'false'}")
            else:
                lines.append(f"{pad}{fname}: {v}")
    return "\n".join(lines)


# -- file helpers -------------------------------------------------------


def write_binary(path: str, msg: Message, msg_type: str) -> None:
    with open(path, "wb") as f:
        f.write(encode(msg, msg_type))


def read_binary(path: str, msg_type: str) -> Message:
    with open(path, "rb") as f:
        return decode(f.read(), msg_type)
