"""Builds the Hopper kernels in `csrc/` at first use and loads them.

Each `csrc/*.cu` source compiles with its own `nvcc`, all started together,
and the objects link into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), which is loaded through
`ctypes`. The library lands in `_build/` beside this file,
named after a hash of the sources and the flags, so an edited source
rebuilds and an unchanged one is reused. There is no fallback: a missing
`nvcc` or a failed build raises with the compiler's output.
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

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the kernels' entry points (csrc/*.cu). Every pointer and
# the stream is a c_void_p: an undeclared pointer would be cut to 32 bits.
SIGNATURES = {
    "vv_matmul": [_P, _P, _P, _P, _I, _I, _I] + [_L] * 6 + [_I] * 4 + [_P],
    "vv_conv_gemm": [_P, _P, _P, _P] + [_I] * 13 + [_L] * 12 + [_I] * 4 + [_P],
    "vv_matmul_sm90": [_P] * 5 + [_I] * 3 + [_L] * 4 + [_I] * 5 + [_P],
    "vv_matmul_f32_sm90": [_P] * 5 + [_I] * 3 + [_L] * 4 + [_I] * 4 + [_P],
    "vv_conv_gemm_sm90": [_P] * 4 + [_I] * 14 + [_L] * 3 + [_I] * 5 + [_P],
    "vv_conv_gemm_f32_sm90": [_P] * 5 + [_I] * 14 + [_L] * 3 + [_I] * 5 + [_P],
    "vv_space_to_depth": [_P] * 4 + [_I] * 10 + [_P],
    "vv_conv3d_gemm_sm90": [_P] * 4 + [_I] * 18 + [_L] * 4 + [_I] * 5 + [_P],
    "vv_space_to_depth_3d": [_P] * 4 + [_I] * 16 + [_P],
    "vv_max_pool_nhwc": [_P] * 2 + [_I] * 12 + [_L] * 4 + [_I] * 2 + [_P],
    "vv_max_pool_ndhwc": [_P] * 2 + [_I] * 17 + [_L] * 5 + [_I] * 2 + [_P],
    "vv_lrn_nhwc": [_P] * 2 + [_I] * 4 + [_L] * 4 + [_I] + [_F] * 2
    + [_I] * 2 + [_P],
    "vv_top_k_rows": [_P, _L] + [_I] * 4 + [_P] * 3 + [_I, _P],
}


def _find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _raise_on_failure(cmd: list[str], returncode: int, out: str,
                      err: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n"
                           f"{err}{out}")


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compiles csrc/*.cu into `build_dir` unless a build of the same sources
    is there already; returns the library's path."""
    lib = Path(build_dir) / f"libvvtorch_{_digest()}.so"
    if lib.is_file():
        return lib
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in CUDA_HOME/bin): the Hopper "
            "kernels of videovector_tpu_torch cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj),
                 str(src)] for obj, src in zip(objs, _sources())]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outs = [proc.communicate() for proc in procs]
        for cmd, proc, (out, err) in zip(cmds, procs, outs):
            _raise_on_failure(cmd, proc.returncode, out, err)
        so = Path(tmp) / lib.name
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(so), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_on_failure(link, proc.returncode, proc.stdout, proc.stderr)
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with argument types declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raises if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
