"""ctypes binding of the C++ data plane (native/vvdata.cpp); counterpart of
videovector_tpu/data/native.py.

`NativeSampledShotsSource` is the flagship WINDOW sampler with its negative
reservoir, running in a C++ prefetch thread: the same source as the JAX
package's, so the same store and seed give the same batches bit for bit.
`decode_jpeg_bgr` is the IMAGE_DATA source's libjpeg decoder (with cv2's
bilinear resize), `jpeg_available()` whether the library has it.
`crc32c` and `snappy_decompress` are the C twins of data/leveldbio.py's
LevelDB primitives (vv_crc32c, vv_snappy_decompress), which that module
takes whenever the library is built.

The port builds its own library from the repo's native/vvdata.cpp at first
use, as native/Makefile does: g++ with its flags and `-DVV_WITH_JPEG
-ljpeg`, and without those where libjpeg's headers or library are missing
(found by compiling and linking a probe; the decoder then reports itself
unavailable). The library goes into `_build/` beside the package, named
after a hash of the source and the flags and after whether the decoder is
in (`libvvdata_<hash>_jpeg.so` or `_nojpeg.so`), built under a temporary
name and renamed into place so that concurrent builders never load a
half-written file. A `_jpeg` build that does not load (made where libjpeg
was, loaded where it is not) gives way to a `_nojpeg` build. It never
loads or writes anything under native/. A failed build is logged with the
compiler's output, and `available()` is then false: the data factory takes
the Python sampler, as the JAX package's does when its library is missing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "vvdata.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
# the JPEG decoder's flags, native/Makefile's; left out where libjpeg does
# not link
JPEG_FLAGS = ("-DVV_WITH_JPEG",)
JPEG_LIBS = ("-ljpeg",)


# a program that compiles and links only where libjpeg's headers and library
# are both present
_JPEG_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n"
               "int main() { jpeg_decompress_struct c; "
               "jpeg_create_decompress(&c); return 0; }\n")


def _has_libjpeg(cxx: str) -> bool:
    """Whether `cxx` can build and link against libjpeg here."""
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cpp"
        src.write_text(_JPEG_PROBE)
        proc = subprocess.run([cxx, str(src), "-o", str(Path(tmp) / "probe"),
                               *JPEG_LIBS], capture_output=True, timeout=120)
    return proc.returncode == 0


def library_path(build_dir: Path, jpeg: bool) -> Path:
    """The library's name: a hash of the source and the flags, and whether
    the JPEG decoder is in, so that builds with and without libjpeg never
    stand in for each other."""
    digest = hashlib.sha256(
        " ".join(CXX_FLAGS + JPEG_FLAGS + JPEG_LIBS).encode()
        + SOURCE.read_bytes()).hexdigest()[:16]
    kind = "jpeg" if jpeg else "nojpeg"
    return Path(build_dir) / f"libvvdata_{digest}_{kind}.so"


def build_library(build_dir: Path | None = None,
                  jpeg: bool | None = None) -> Path | None:
    """Compiles native/vvdata.cpp into `build_dir` (default BUILD_DIR)
    unless a build of the same source and flags is there already; returns
    the library's path, or None (with a warning carrying the compiler's
    output) if it cannot be built. `jpeg` None builds with the JPEG decoder
    where libjpeg links here, False without it."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    if not SOURCE.is_file():
        log.warning("native sampler: %s not found; using the Python sampler",
                    SOURCE)
        return None
    cxx = shutil.which("g++")
    if cxx is None:
        log.warning("native sampler: g++ not found; using the Python sampler")
        return None
    if jpeg is None:
        jpeg = _has_libjpeg(cxx)
        if not jpeg:
            log.info("native library: libjpeg does not link here; building "
                     "without the JPEG decoder")
    lib = library_path(build_dir, jpeg)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=lib.name, suffix=".tmp")
    os.close(fd)
    extra = (JPEG_FLAGS, JPEG_LIBS) if jpeg else ((), ())
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, *extra[0], "-o", tmp, str(SOURCE), *extra[1]],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            log.warning("native sampler: g++ failed (%d); using the Python "
                        "sampler:\n%s%s", proc.returncode, proc.stderr,
                        proc.stdout)
            return None
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load(path: Path) -> ctypes.CDLL | None:
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        log.warning("native library %s does not load: %s", path, e)
        return None


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL | None:
    path = build_library()
    if path is None:
        return None
    lib = _load(path)
    if lib is None and path.name.endswith("_jpeg.so"):
        # built where libjpeg was and loaded where it is not
        log.warning("native library: building it without the JPEG decoder")
        path = build_library(jpeg=False)
        lib = None if path is None else _load(path)
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.vv_sampler_create.restype = ctypes.c_void_p
    lib.vv_sampler_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int]
    lib.vv_sampler_feature_dim.restype = ctypes.c_int
    lib.vv_sampler_feature_dim.argtypes = [ctypes.c_void_p]
    lib.vv_sampler_channels.restype = ctypes.c_int
    lib.vv_sampler_channels.argtypes = [ctypes.c_void_p]
    lib.vv_sampler_next.restype = ctypes.c_int
    lib.vv_sampler_next.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.vv_sampler_destroy.restype = None
    lib.vv_sampler_destroy.argtypes = [ctypes.c_void_p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vv_jpeg_available.restype = ctypes.c_int
    lib.vv_jpeg_available.argtypes = []
    lib.vv_jpeg_dims.restype = ctypes.c_int
    lib.vv_jpeg_dims.argtypes = [u8p, ctypes.c_int64, i32p, i32p]
    lib.vv_decode_jpeg_bgr.restype = ctypes.c_int
    lib.vv_decode_jpeg_bgr.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, u8p]
    lib.vv_crc32c.restype = ctypes.c_uint32
    lib.vv_crc32c.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32]
    lib.vv_snappy_decompress.restype = ctypes.c_int64
    lib.vv_snappy_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int64]
    return lib


def available() -> bool:
    """True when the port's native library is built (building it if
    needed)."""
    return _library() is not None


def jpeg_available() -> bool:
    """True when the port's native library was built against libjpeg."""
    lib = _library()
    return lib is not None and bool(lib.vv_jpeg_available())


def decode_jpeg_bgr(payload: bytes, out_w: int = 0,
                    out_h: int = 0) -> np.ndarray | None:
    """A JPEG decoded to (out_h, out_w, 3) uint8 BGR HWC, cv::imread's layout
    (ref:src/caffe/util/io.cpp:69-88), with libjpeg's DCT prescaling and
    cv2's bilinear convention (native/vvdata.cpp). out_w/out_h 0 decodes at
    the natural size. None when the decoder is unavailable or the stream is
    corrupt (the caller goes on to cv2, then PIL)."""
    if not jpeg_available():
        return None
    lib = _library()
    buf = np.frombuffer(payload, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if out_w <= 0 or out_h <= 0:
        w, h = ctypes.c_int32(0), ctypes.c_int32(0)
        if lib.vv_jpeg_dims(bp, len(payload), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
            return None
        out_w, out_h = int(w.value), int(h.value)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.vv_decode_jpeg_bgr(
        bp, len(payload), out_w, out_h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def _u8(buf) -> tuple[np.ndarray, ctypes.c_void_p]:
    """A bytes-like object as a uint8 array (no copy) and its pointer."""
    arr = np.frombuffer(buf, np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _require() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("the native library could not be built (see the "
                           "logged compiler output)")
    return lib


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object, continuing from `crc`
    (vv_crc32c). Raises RuntimeError when the library is not built."""
    lib = _require()
    arr, ptr = _u8(data)
    return int(lib.vv_crc32c(ptr, len(arr), crc))


def snappy_decompress(data, ulen: int) -> bytes:
    """Raw snappy `data` whose preamble declares `ulen` bytes, decoded by
    vv_snappy_decompress; ValueError on corrupt input. Raises RuntimeError
    when the library is not built."""
    lib = _require()
    arr, ptr = _u8(data)
    out = np.empty(max(ulen, 1), np.uint8)
    got = lib.vv_snappy_decompress(
        ptr, len(arr), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ulen)
    if got < 0:
        raise ValueError("corrupt snappy data (native decoder)")
    return out[:got].tobytes()


class NativeSampledShotsSource:
    """Native flagship WINDOW sampler with a C++ prefetch thread. Drop-in
    for data.shots.VideoSampledShotsSource (WINDOW mode) batches:
    {"data": (B, context_size + num_negative_samples, D) f32,
    "video_id": (B,) f32}."""

    def __init__(self, path: str, *, batch_size: int = 128,
                 context_size: int = 5, num_negative_samples: int = 10,
                 max_buffer_size: int = 5000, negative_swap_percentage: int = 50,
                 max_same_video_negs: int = 6, seed: int = 1234,
                 prefetch_depth: int = 2):
        lib = _library()
        if lib is None:
            raise RuntimeError("the native sampler library could not be built "
                               "(see the logged compiler output)")
        self._lib = lib
        self._h = lib.vv_sampler_create(
            path.encode(), batch_size, context_size, num_negative_samples,
            max_buffer_size, negative_swap_percentage, max_same_video_negs,
            seed, prefetch_depth)
        if not self._h:
            raise IOError(
                f"cannot open shot dataset {path} (or too few distinct "
                "shots to fill the negative reservoir of "
                f"{max_buffer_size}; the reference CHECK-fails too, "
                "video_shot_window_data_layer.cpp:338)")
        self.batch_size = batch_size
        self.feature_dim = int(lib.vv_sampler_feature_dim(self._h))
        self.channels = int(lib.vv_sampler_channels(self._h))

    def next_batch(self) -> dict:
        if not self._h:
            raise RuntimeError("native sampler closed")
        data = np.empty((self.batch_size, self.channels, self.feature_dim),
                        np.float32)
        vids = np.empty((self.batch_size,), np.float32)
        rc = self._lib.vv_sampler_next(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vids.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError("native sampler stopped")
        return {"data": data, "video_id": vids}

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        """Stops the prefetch thread and frees the sampler."""
        if self._h:
            self._lib.vv_sampler_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
