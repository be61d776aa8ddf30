"""Protobuf wire-format codec and the dataset message types; counterpart of
videovector_tpu/data/wire.py, whose bytes and values it keeps.

The reference stores datasets as serialized proto2 messages (Datum,
ref:src/caffe/proto/caffe.proto:23-37; VideoShotWindow / VideoShots /
TestVideoShotWindows, ref:src/caffe/proto/video_shot_sentences.proto:7-30;
TrackPositions / TrackingWindow, ref:src/caffe/proto/tracking_windows.proto:
7-21; BlobProto, ref:caffe.proto:5-15). This module is a small proto2 wire
codec (varint / 64-bit / length-delimited / 32-bit, packed repeated scalars)
plus plain-dataclass message types with the reference's field numbers, so
bytes written by either package, or by the reference's tools, decode here.

Unpacked repeated floats (Datum.float_data: one 5-byte field, a 1-byte key
and 4 bytes of f32, per value) are encoded and decoded with numpy, a run of
fields at a time, as a (k, 5) byte array whose column 0 is the key. The
bytes and values are those of the JAX package's one-field-at-a-time loop:
like it, each value passes through a Python float (f32 -> f64 -> f32), which
leaves every value as it was but a signalling NaN, which comes back quiet.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dfield

import numpy as np

# -- wire primitives --------------------------------------------------------

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_F32_RUN = -1          # a run of unpacked floats, decoded as one f32 array
_RUN_PROBE = 64        # records checked first when measuring a run


def write_varint(buf: bytearray, value: int) -> None:
    value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _tag(buf: bytearray, fnum: int, wt: int) -> None:
    write_varint(buf, (fnum << 3) | wt)


def write_int(buf, fnum, value):
    _tag(buf, fnum, _WT_VARINT)
    # proto2 int32: negatives encode as 10-byte two's complement varint
    write_varint(buf, value if value >= 0 else value + (1 << 64))


def write_float(buf, fnum, value):
    _tag(buf, fnum, _WT_I32)
    buf += struct.pack("<f", value)


def write_bytes(buf, fnum, value: bytes):
    _tag(buf, fnum, _WT_LEN)
    write_varint(buf, len(value))
    buf += value


def write_packed_floats(buf, fnum, values):
    arr = np.asarray(values, dtype="<f4")
    _tag(buf, fnum, _WT_LEN)
    write_varint(buf, arr.nbytes)
    buf += arr.tobytes()


def _through_python_float(arr: np.ndarray) -> np.ndarray:
    """f32 values as a round trip through a Python float leaves them (only
    a signalling NaN changes: it comes back quiet)."""
    with np.errstate(invalid="ignore"):     # the signalling NaN's flag
        return np.asarray(arr, np.float32).astype(np.float64).astype(np.float32)


def write_repeated_floats(buf, fnum, values):
    """Non-packed repeated floats (proto2's default for the reference's
    repeated float fields without [packed=true], e.g. Datum.float_data):
    one key + f32 field per value, all k fields written as one (k, key + 4)
    byte array."""
    arr = np.asarray(values, dtype=np.float32)
    if arr.ndim != 1:
        raise ValueError(f"repeated floats must be 1-D, got shape {arr.shape}")
    key = bytearray()
    _tag(key, fnum, _WT_I32)
    recs = np.empty((len(arr), len(key) + 4), np.uint8)
    recs[:, :len(key)] = np.frombuffer(bytes(key), np.uint8)
    recs[:, len(key):] = _through_python_float(arr).astype("<f4", copy=False) \
        .view(np.uint8).reshape(-1, 4)
    buf += recs.tobytes()


def write_msg(buf, fnum, encoded: bytes):
    write_bytes(buf, fnum, encoded)


def _decode_int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _run_length(data, pos: int, key: int) -> int:
    """How many 5-byte [key, f32] fields follow one another from `pos`;
    the bytes looked at grow with the run (64 fields, then doubling), so a
    short run costs little wherever it sits."""
    total = (len(data) - pos) // 5
    k, step = 0, _RUN_PROBE
    while k < total:
        m = min(step, total - k)
        keys = np.frombuffer(data, np.uint8, count=m * 5, offset=pos + k * 5)[::5]
        off = np.flatnonzero(keys != key)
        if len(off):
            return k + int(off[0])
        k += m
        step *= 2
    return total


def _fields(data: bytes, float_fields=()):
    """iter_fields, except that a run of unpacked (I32) fields of a field
    number in `float_fields` with a 1-byte key comes as one
    (fnum, _F32_RUN, raw '<f4' array)."""
    pos = 0
    n = len(data)
    while pos < n:
        start = pos
        key, pos = read_varint(data, pos)
        fnum, wt = key >> 3, key & 7
        if wt == _WT_I32 and fnum in float_fields and pos == start + 1:
            k = _run_length(data, start, key)
            if k:     # else truncated: raised below, as the field loop does
                recs = np.frombuffer(data, np.uint8, count=5 * k,
                                     offset=start).reshape(k, 5)
                yield fnum, _F32_RUN, \
                    np.ascontiguousarray(recs[:, 1:]).view("<f4").reshape(-1)
                pos = start + 5 * k
                continue
        if wt == _WT_VARINT:
            v, pos = read_varint(data, pos)
            yield fnum, wt, v
        elif wt == _WT_I64:
            if pos + 8 > n:
                raise ValueError("truncated I64 field")
            yield fnum, wt, data[pos:pos + 8]
            pos += 8
        elif wt == _WT_LEN:
            # a short slice would decode a truncated record into a
            # plausible-but-wrong message; proto2 parsers fail instead
            # (ParseFromString returns false -> the reference CHECK-fails)
            ln, pos = read_varint(data, pos)
            if pos + ln > n:
                raise ValueError(
                    f"truncated LEN field {fnum}: declares {ln} bytes, "
                    f"{n - pos} remain")
            yield fnum, wt, data[pos:pos + ln]
            pos += ln
        elif wt == _WT_I32:
            if pos + 4 > n:
                raise ValueError("truncated I32 field")
            yield fnum, wt, data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) where value is int (varint),
    bytes (LEN), or raw 4/8-byte chunks."""
    return _fields(data)


def _floats_from(wt, v, out: list):
    """Accept both packed (LEN of f4s) and unpacked (I32, or a run of them)
    repeated floats; appends the raw '<f4' values to out."""
    if wt == _F32_RUN:
        out.append(v)
    elif wt in (_WT_I32, _WT_LEN):
        out.append(np.frombuffer(v, dtype="<f4"))
    else:
        raise ValueError("bad float field encoding")


def _f32(parts: list) -> np.ndarray:
    """The decoded values of a repeated float field, as an f32 array."""
    if not parts:
        return np.zeros(0, np.float32)
    return _through_python_float(np.concatenate(parts))


def _float_list(parts: list) -> list:
    """The decoded values of a repeated float field, as Python floats."""
    return _f32(parts).astype(np.float64).tolist()


def _ints_from(wt, v, out: list):
    if wt == _WT_VARINT:
        out.append(_decode_int32(v))
    elif wt == _WT_LEN:
        pos = 0
        while pos < len(v):
            x, pos = read_varint(v, pos)
            out.append(_decode_int32(x))
    else:
        raise ValueError("bad int field encoding")


# -- messages ---------------------------------------------------------------

@dataclass
class Datum:
    """caffe.Datum (ref:caffe.proto:23-37). Field numbers: channels=1,
    height=2, width=3, data=4, label=5, float_data=6, mean=7, min=8, max=9."""
    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int | None = None
    float_data: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))
    mean: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))
    min: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))
    max: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))

    def encode(self) -> bytes:
        buf = bytearray()
        if self.channels:
            write_int(buf, 1, self.channels)
        if self.height:
            write_int(buf, 2, self.height)
        if self.width:
            write_int(buf, 3, self.width)
        if self.data:
            write_bytes(buf, 4, self.data)
        if self.label is not None:
            write_int(buf, 5, self.label)
        if len(self.float_data):
            write_repeated_floats(buf, 6, self.float_data)
        for fnum, arr in ((7, self.mean), (8, self.min), (9, self.max)):
            if len(arr):
                write_repeated_floats(buf, fnum, arr)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Datum":
        m = cls()
        floats: dict[int, list] = {6: [], 7: [], 8: [], 9: []}
        for fnum, wt, v in _fields(data, floats):
            if fnum == 1:
                m.channels = _decode_int32(v)
            elif fnum == 2:
                m.height = _decode_int32(v)
            elif fnum == 3:
                m.width = _decode_int32(v)
            elif fnum == 4:
                m.data = v
            elif fnum == 5:
                m.label = _decode_int32(v)
            elif fnum in floats:
                _floats_from(wt, v, floats[fnum])
        m.float_data, m.mean, m.min, m.max = (_f32(floats[f])
                                              for f in (6, 7, 8, 9))
        return m


@dataclass
class VideoShotWindow:
    """video_shot_sentences.VideoShotWindow (ref video_shot_sentences.proto:7-14):
    video_id=1, shot_id=2, video_name=3, target_shot_word=4,
    context_shot_words=5 (repeated)."""
    video_id: int = 0
    shot_id: int = 0
    video_name: str = ""
    target_shot_word: Datum | None = None
    context_shot_words: list = dfield(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        write_int(buf, 1, self.video_id)
        write_int(buf, 2, self.shot_id)
        if self.video_name:
            write_bytes(buf, 3, self.video_name.encode())
        if self.target_shot_word is not None:
            write_msg(buf, 4, self.target_shot_word.encode())
        for d in self.context_shot_words:
            write_msg(buf, 5, d.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "VideoShotWindow":
        m = cls()
        for fnum, wt, v in iter_fields(data):
            if fnum == 1:
                m.video_id = _decode_int32(v)
            elif fnum == 2:
                m.shot_id = _decode_int32(v)
            elif fnum == 3:
                m.video_name = v.decode()
            elif fnum == 4:
                m.target_shot_word = Datum.decode(v)
            elif fnum == 5:
                m.context_shot_words.append(Datum.decode(v))
        return m


@dataclass
class VideoShots:
    """video_shot_sentences.VideoShots (ref video_shot_sentences.proto:16-21):
    video_id=1, shot_ids=2 (repeated), shot_words=3 (repeated), video_name=4."""
    video_id: int = 0
    shot_ids: list = dfield(default_factory=list)
    shot_words: list = dfield(default_factory=list)
    video_name: str = ""

    def encode(self) -> bytes:
        buf = bytearray()
        write_int(buf, 1, self.video_id)
        for s in self.shot_ids:
            write_int(buf, 2, s)
        for d in self.shot_words:
            write_msg(buf, 3, d.encode())
        if self.video_name:
            write_bytes(buf, 4, self.video_name.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "VideoShots":
        m = cls()
        for fnum, wt, v in iter_fields(data):
            if fnum == 1:
                m.video_id = _decode_int32(v)
            elif fnum == 2:
                _ints_from(wt, v, m.shot_ids)
            elif fnum == 3:
                m.shot_words.append(Datum.decode(v))
            elif fnum == 4:
                m.video_name = v.decode()
        return m


@dataclass
class TestVideoShotWindows:
    """video_shot_sentences.TestVideoShotWindows
    (ref video_shot_sentences.proto:23-30): video_id=1, positive_shot_id=2,
    video_name=3, positive_shot_words=4, context_shot_words=5,
    negative_shot_words=6, negative_shot_id=7."""
    video_id: int = 0
    positive_shot_id: list = dfield(default_factory=list)
    video_name: str = ""
    positive_shot_words: list = dfield(default_factory=list)
    context_shot_words: list = dfield(default_factory=list)
    negative_shot_words: list = dfield(default_factory=list)
    negative_shot_id: list = dfield(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        write_int(buf, 1, self.video_id)
        for s in self.positive_shot_id:
            write_int(buf, 2, s)
        if self.video_name:
            write_bytes(buf, 3, self.video_name.encode())
        for d in self.positive_shot_words:
            write_msg(buf, 4, d.encode())
        for d in self.context_shot_words:
            write_msg(buf, 5, d.encode())
        for d in self.negative_shot_words:
            write_msg(buf, 6, d.encode())
        for s in self.negative_shot_id:
            write_int(buf, 7, s)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TestVideoShotWindows":
        m = cls()
        for fnum, wt, v in iter_fields(data):
            if fnum == 1:
                m.video_id = _decode_int32(v)
            elif fnum == 2:
                _ints_from(wt, v, m.positive_shot_id)
            elif fnum == 3:
                m.video_name = v.decode()
            elif fnum == 4:
                m.positive_shot_words.append(Datum.decode(v))
            elif fnum == 5:
                m.context_shot_words.append(Datum.decode(v))
            elif fnum == 6:
                m.negative_shot_words.append(Datum.decode(v))
            elif fnum == 7:
                _ints_from(wt, v, m.negative_shot_id)
        return m


@dataclass
class TrackPositions:
    """tracking_windows.TrackPositions (ref tracking_windows.proto:7-13):
    id=1, x=2, y=3, cl=4, static_scene=5."""
    id: int = 0
    x: list = dfield(default_factory=list)
    y: list = dfield(default_factory=list)
    cl: int = 0
    static_scene: Datum | None = None

    def encode(self) -> bytes:
        buf = bytearray()
        write_int(buf, 1, self.id)
        write_repeated_floats(buf, 2, self.x)
        write_repeated_floats(buf, 3, self.y)
        write_int(buf, 4, self.cl)
        if self.static_scene is not None:
            write_msg(buf, 5, self.static_scene.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TrackPositions":
        m = cls()
        xs: list = []
        ys: list = []
        for fnum, wt, v in _fields(data, (2, 3)):
            if fnum == 1:
                m.id = _decode_int32(v)
            elif fnum == 2:
                _floats_from(wt, v, xs)
            elif fnum == 3:
                _floats_from(wt, v, ys)
            elif fnum == 4:
                m.cl = _decode_int32(v)
            elif fnum == 5:
                m.static_scene = Datum.decode(v)
        m.x, m.y = _float_list(xs), _float_list(ys)
        return m


@dataclass
class TrackingWindow:
    """tracking_windows.TrackingWindow (ref tracking_windows.proto:15-21):
    observed_time=1, prediction_time=2, scene_id=3, track_positions=4."""
    observed_time: list = dfield(default_factory=list)
    prediction_time: list = dfield(default_factory=list)
    scene_id: int = 0
    track_positions: list = dfield(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        write_repeated_floats(buf, 1, self.observed_time)
        write_repeated_floats(buf, 2, self.prediction_time)
        write_int(buf, 3, self.scene_id)
        for t in self.track_positions:
            write_msg(buf, 4, t.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TrackingWindow":
        m = cls()
        obs: list = []
        pred: list = []
        for fnum, wt, v in _fields(data, (1, 2)):
            if fnum == 1:
                _floats_from(wt, v, obs)
            elif fnum == 2:
                _floats_from(wt, v, pred)
            elif fnum == 3:
                m.scene_id = _decode_int32(v)
            elif fnum == 4:
                m.track_positions.append(TrackPositions.decode(v))
        m.observed_time, m.prediction_time = _float_list(obs), _float_list(pred)
        return m


@dataclass
class BlobProto:
    """caffe.BlobProto (ref:caffe.proto:5-15): num=1, channels=2, height=3,
    width=4, data=5 [packed], diff=6 [packed]."""
    num: int = 0
    channels: int = 0
    height: int = 0
    width: int = 0
    data: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))
    diff: np.ndarray = dfield(default_factory=lambda: np.zeros(0, np.float32))

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "BlobProto":
        """4-D (or fewer, left-padded with 1s) array -> BlobProto."""
        shape = (1,) * (4 - arr.ndim) + arr.shape
        n, c, h, w = shape
        return cls(num=n, channels=c, height=h, width=w,
                   data=np.ascontiguousarray(arr, np.float32).reshape(-1))

    def to_array(self) -> np.ndarray:
        return np.asarray(self.data, np.float32).reshape(
            self.num or 1, self.channels or 1, self.height or 1, self.width or 1)

    def encode(self) -> bytes:
        buf = bytearray()
        write_int(buf, 1, self.num)
        write_int(buf, 2, self.channels)
        write_int(buf, 3, self.height)
        write_int(buf, 4, self.width)
        if len(self.data):
            write_packed_floats(buf, 5, self.data)
        if len(self.diff):
            write_packed_floats(buf, 6, self.diff)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "BlobProto":
        m = cls()
        d: list = []
        df: list = []
        for fnum, wt, v in _fields(data, (5, 6)):
            if fnum == 1:
                m.num = _decode_int32(v)
            elif fnum == 2:
                m.channels = _decode_int32(v)
            elif fnum == 3:
                m.height = _decode_int32(v)
            elif fnum == 4:
                m.width = _decode_int32(v)
            elif fnum == 5:
                _floats_from(wt, v, d)
            elif fnum == 6:
                _floats_from(wt, v, df)
        m.data, m.diff = _f32(d), _f32(df)
        return m
