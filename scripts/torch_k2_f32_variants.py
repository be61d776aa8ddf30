#!/usr/bin/env python3
"""Times K2's f32 route (videovector_tpu_torch/csrc/conv_gemm_f32_sm90.cu)
against variants of its producer, on one CUDA card, to find what holds the
route below K1's f32 route (the same FFMA consumers, fed by TMA alone):

    python3 scripts/torch_k2_f32_variants.py

Each variant is the source with a few lines edited, built into its own
library under videovector_tpu_torch/_build/k2_f32_variants/ (registers and
spills as ptxas reports them): the shipped kernel (4 producer warps in a
block that has its SM alone, 2 where two blocks share one); 1 producer
warp; 2 producer warps in every tile; and, for timing only (wrong sums, so its
output is not checked), a producer that gathers no A at all, which leaves
the consumers as K1's f32 route has them. Every variant runs the f32 Net's
INNER_PRODUCT shape as a 1x1 conv, (1920 x 4096) . (4096 x 4096), at the
128 x 128 and 64 x 128 tiles, and CaffeNet's conv2 and conv3 at batch 50 and 256 under
`k2_f32_plan`'s tiles and splits, held against the plain version with
chip_smoke.py's tolerance where checked, timed by CUDA-graph replay in
turns (all variants in order, then in reverse), with K1's f32 route at the
GEMM shape beside them. Exits non-zero without a card or nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from videovector_tpu_torch import _build  # noqa: E402
from videovector_tpu_torch.ops.hopper import conv_gemm as k2  # noqa: E402
from videovector_tpu_torch.ops.hopper import matmul as k1  # noqa: E402

SOURCE = _build.CSRC_DIR / "conv_gemm_f32_sm90.cu"
OUT = _build.BUILD_DIR / "k2_f32_variants"
PW = "  static constexpr int PW = BLOCKS == 1 ? 4 : 2;"
COPY = "        cp_async_16(a_dst + row * ROW + ((q ^ (row & 7)) << 4),"
# name: (source edits, whether its output is checked)
VARIANTS = {
    "shipped": ((), True),
    "1 producer warp": (((PW, "  static constexpr int PW = 1;"),), True),
    "2 producer warps": (((PW, "  static constexpr int PW = 2;"),), True),
    "no A gathered (timing only)": (
        ((COPY, COPY.replace("cp_async_16", "if (r < 0) cp_async_16")),),
        False),
}


def _edit(extra) -> str:
    src = SOURCE.read_text()
    for old, new in extra:
        if old not in src:
            raise RuntimeError(f"{SOURCE.name} no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def _build_variants(nvcc: str) -> dict:
    procs = {}
    for i, (name, (extra, _)) in enumerate(VARIANTS.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(_edit(extra))
        so = OUT / f"libv{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(_build.CSRC_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        regs = sorted({l.split("Used")[-1].split(",")[0].strip()
                       for l in err.splitlines() if "registers" in l})
        spills = sorted({l.strip() for l in err.splitlines() if "spill" in l})
        smoke.log(f"  {name}: {', '.join(regs)}; {'; '.join(spills)}")
        lib = ctypes.CDLL(str(so))
        fn = lib.vv_conv_gemm_f32_sm90
        fn.argtypes = _build.SIGNATURES["vv_conv_gemm_f32_sm90"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


class _Lib:
    """The package's library with the f32 route's entry point swapped."""

    def __init__(self, base, fn):
        self._base, self.vv_conv_gemm_f32_sm90 = base, fn

    def __getattr__(self, name):
        return getattr(self._base, name)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k2_f32_variants: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = _build._find_nvcc()
    if nvcc is None:
        print("torch_k2_f32_variants: needs nvcc", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smoke.log(f"gpu: {smoke.gpu_name_and_power_limit()}")
    OUT.mkdir(parents=True, exist_ok=True)
    smoke.log("variants (ptxas: registers by kernel; spills):")
    fns = _build_variants(nvcc)
    base = _build.load_library()
    load, plan = _build.load_library, k2.k2_f32_plan
    gen = torch.Generator(device=dev).manual_seed(5)
    # (label, x NHWC, w HWIO, conv kwargs, fixed (block_m, block_n, splits)
    # or None for the plan's)
    m, k, n = 1920, 4096, 4096
    xg = torch.randn(m, k, generator=gen, device=dev)
    wg = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    cases = [(f"GEMM {m}x{k}x{n} {t[0]}x{t[1]}", xg[:, None, None, :],
              wg[None, None], {}, (*t, 1)) for t in ((128, 128), (64, 128))]
    for batch in (50, 256):
        for name, hw, c, o, ksz, s, p, g in smoke.CAFFENET_CONVS[1:3]:
            x = torch.randn(batch, hw, hw, c, generator=gen, device=dev)
            w = torch.randn(ksz, ksz, c // g, o, generator=gen, device=dev) \
                * (ksz * ksz * c // g) ** -0.5
            cases.append((f"{name} b{batch} (plan)", x, w,
                          dict(stride=(s, s), pad=(p, p), groups=g), None))
    try:
        with torch.no_grad():
            for label, x, w, kw, fixed in cases:
                b = torch.randn(w.shape[3], generator=gen, device=dev) * 0.1
                ref = k2.conv2d_gemm_nhwc_plain(x, w, b, **kw)
                k2.k2_f32_plan = plan if fixed is None else (lambda *a, f=fixed: f)
                times: dict[str, list[float]] = {}
                for name in list(VARIANTS) + list(VARIANTS)[::-1]:
                    lib = _Lib(base, fns[name])
                    _build.load_library = lambda lib=lib: lib
                    if VARIANTS[name][1] and name not in times:
                        smoke.compare(f"{label} {name}",
                                      k2.conv2d_gemm_nhwc(x, w, b, **kw), ref)
                    times.setdefault(name, []).append(smoke.time_graph_ms(
                        lambda _: k2.conv2d_gemm_nhwc(x, w, b, **kw), [0, 1]))
                _build.load_library, k2.k2_f32_plan = load, plan
                ohw = ref.shape[1]
                flops = 2 * ref.numel() * w.shape[0] * w.shape[1] * w.shape[2]
                bound = flops / smoke.PEAK_FLOPS_F32 * 1e3
                line = f"{label} (FFMA bound {bound:.4f} ms, {ohw}x{ohw} out)"
                if fixed is not None and label.startswith("GEMM"):
                    k1_ms = smoke.time_graph_ms(
                        lambda _: k1.matmul(xg, wg, b), [0, 1])
                    line += f"; K1's f32 route {k1_ms:.4f} ms " \
                            f"({bound / k1_ms:.3f} of bound)"
                smoke.log(line + ":")
                for name, t in times.items():
                    mean = sum(t) / len(t)
                    smoke.log(f"  {name:28s} {mean:.4f} ms ({t[0]:.4f}, "
                              f"{t[1]:.4f}; {bound / mean:.3f} of bound)")
    finally:
        _build.load_library, k2.k2_f32_plan = load, plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
