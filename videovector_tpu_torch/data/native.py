"""ctypes binding of the C++ flagship sampler (native/vvdata.cpp); counterpart
of the sampler part of videovector_tpu/data/native.py.

`NativeSampledShotsSource` is the flagship WINDOW sampler with its negative
reservoir, running in a C++ prefetch thread: the same source as the JAX
package's, so the same store and seed give the same batches bit for bit.

The port builds its own library from the repo's native/vvdata.cpp at first
use: g++ with native/Makefile's flags, without the JPEG decoder (ROADMAP
item 1b), into `_build/` beside the package, named after a hash of the
source and the flags, built under a temporary name and renamed into place
so that concurrent builders never load a half-written file. It never loads
or writes anything under native/. A failed build is logged with the
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


def build_library(build_dir: Path = BUILD_DIR) -> Path | None:
    """Compiles native/vvdata.cpp into `build_dir` unless a build of the same
    source and flags is there already; returns the library's path, or None
    (with a warning carrying the compiler's output) if it cannot be built."""
    if not SOURCE.is_file():
        log.warning("native sampler: %s not found; using the Python sampler",
                    SOURCE)
        return None
    digest = hashlib.sha256(
        " ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = Path(build_dir) / f"libvvdata_{digest}.so"
    if lib.is_file():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        log.warning("native sampler: g++ not found; using the Python sampler")
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=lib.name, suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL | None:
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
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
    return lib


def available() -> bool:
    """True when the port's native library is built (building it if
    needed)."""
    return _library() is not None


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
