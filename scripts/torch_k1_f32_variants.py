#!/usr/bin/env python3
"""Times K1's f32 route (videovector_tpu_torch/csrc/matmul_f32_sm90.cu) at
the f32 Net's two INNER_PRODUCT shapes, (1920 x 4096) . (4096 x 4096) and
(673 x 4096) . (4096 x 4096), against variants of its design, on one CUDA
card:

    python3 scripts/torch_k1_f32_variants.py

1. The instruction mix of the shipped kernel's K loop, from `cuobjdump
   -sass` of a cubin built with the package's nvcc flags: FFMA against
   shared-memory loads and the rest, per 32-k stage of a thread.
2. Variants of the source, each built into its own library under
   videovector_tpu_torch/_build/k1_f32_variants/ (registers and spills as
   ptxas reports them): the shipped kernel; 3 and 6 stages; 192- and
   256-row blocks with 12 and 16 consumer warps; and, for timing only,
   one that reads w once per 4 k (10 LDS.128 per 256 FFMA instead of 16:
   wrong sums, so its output is not checked).
3. Each variant at every split count from 1 to 4 and at the plan's (the
   fewest splits whose blocks fill their waves to F32_FILL, for that
   block height), held against the plain version with chip_smoke.py's
   tolerance and timed by CUDA-graph replay in turns (all variants in
   order, then in reverse), with cuBLAS f32 (TF32 off) beside them. "*"
   marks the plan's split count.

Exits non-zero without a card or nvcc.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from videovector_tpu_torch import _build  # noqa: E402
from videovector_tpu_torch.ops.hopper import matmul as k1  # noqa: E402

SOURCE = _build.CSRC_DIR / "matmul_f32_sm90.cu"
OUT = _build.BUILD_DIR / "k1_f32_variants"
ROWS_AND_STAGES = ("constexpr int BM = 128;", "constexpr int CONSUMERS = 256;",
                   "constexpr int STAGES = 4;")
# name: (block rows, consumer threads, stages, extra source edits), and
# whether its output is checked
VARIANTS = {
    "shipped": ((128, 256, 4, ()), True),
    "3 stages": ((128, 256, 3, ()), True),
    "6 stages": ((128, 256, 6, ()), True),
    "BM 192, 12 warps": ((192, 384, 4, ()), True),
    "BM 256, 16 warps": ((256, 512, 4, ()), True),
    "fewer LDS (wrong sums)": ((128, 256, 4, (
        ("        const int k = 4 * g + kk;", "        const int k = 4 * g;"),)),
        False),
}
SPLITS = (1, 2, 3, 4)


def _edit(bm: int, consumers: int, stages: int, extra) -> str:
    src = SOURCE.read_text()
    for old, new in zip(ROWS_AND_STAGES,
                        (f"constexpr int BM = {bm};",
                         f"constexpr int CONSUMERS = {consumers};",
                         f"constexpr int STAGES = {stages};")):
        if old not in src:
            raise RuntimeError(f"{SOURCE.name} no longer holds {old!r}")
        src = src.replace(old, new)
    for old, new in extra:
        if old not in src:
            raise RuntimeError(f"{SOURCE.name} no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def _build_variants(nvcc: str) -> dict:
    procs = {}
    for i, (name, ((bm, cons, st, extra), _)) in enumerate(VARIANTS.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(_edit(bm, cons, st, extra))
        procs[name] = (OUT / f"libv{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(_build.CSRC_DIR), "-o", str(OUT / f"libv{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        # ptxas reports the four instantiations alike; the first suffices
        info = [l.split("info    :")[-1].strip() for l in err.splitlines()
                if "registers" in l or "spill" in l][:2]
        smoke.log(f"  {name}: {'; '.join(info)}")
        lib = ctypes.CDLL(str(so))
        lib.vv_matmul_f32_sm90.argtypes = _build.SIGNATURES["vv_matmul_f32_sm90"]
        lib.vv_matmul_f32_sm90.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _sass_mix(nvcc: str) -> None:
    cubin = OUT / "shipped.cubin"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-I",
                    str(_build.CSRC_DIR), "-o", str(cubin), str(SOURCE)],
                   check=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass):
        head = func.splitlines()[0]
        if "gemm_f32" not in head:
            continue
        ops = [m.group(2) for m in
               (re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", l)
                for l in func.splitlines()) if m]
        first = ops.index("FFMA")
        last = len(ops) - 1 - ops[::-1].index("FFMA")
        loop = collections.Counter(ops[first:last + 1])
        smoke.log(f"  {head.strip()[:60]}: {len(ops)} instructions; the K "
                  f"loop (first to last FFMA) {last - first + 1}: "
                  f"{dict(loop.most_common(8))}")


def _plan(bm: int, m: int, n: int, k: int, sms: int) -> int:
    tiles = -(-m // bm) * -(-n // k1.F32_BN)
    k_tiles = -(-k // k1.F32_BK)
    return next((s for s in range(1, k_tiles + 1)
                 if tiles * s >= k1.F32_FILL * -(-tiles * s // sms) * sms),
                k_tiles)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_f32_variants: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = _build._find_nvcc()
    if nvcc is None:
        print("torch_k1_f32_variants: needs nvcc", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smoke.log(f"gpu: {smoke.gpu_name_and_power_limit()}")
    OUT.mkdir(parents=True, exist_ok=True)
    smoke.log("SASS of the shipped kernel (per thread):")
    _sass_mix(nvcc)
    smoke.log("variants (ptxas):")
    libs = _build_variants(nvcc)
    load, plan = _build.load_library, k1.k1_f32_plan
    gen = torch.Generator(device=dev).manual_seed(21)
    try:
        with torch.no_grad():
            for rows in (smoke.NET_ROWS, smoke.TEST_BATCH):
                k = n = 4096
                x = torch.randn((rows, k), generator=gen, device=dev)
                b = torch.randn(n, generator=gen, device=dev)
                ws = [torch.randn((k, n), generator=gen, device=dev)
                      for _ in range(2)]
                ref = k1.matmul_plain(x, ws[0], b)
                runs = []
                for name, ((bm, *_), checked) in VARIANTS.items():
                    pick = _plan(bm, rows, n, k, sms)
                    runs += [(name, s, s == pick, checked)
                             for s in sorted({*SPLITS, pick})]
                times: dict[tuple, list[float]] = {}
                for name, s, _, checked in runs + runs[::-1]:
                    bm = VARIANTS[name][0][0]
                    _build.load_library = lambda lib=libs[name]: lib
                    k1.k1_f32_plan = lambda *a, t=(bm, k1.F32_BN), s=s: (t, s)
                    if checked and (name, s) not in times:
                        smoke.compare(f"{name} {rows} rows, {s} splits",
                                      k1.matmul(x, ws[0], b), ref)
                    times.setdefault((name, s), []).append(smoke.time_graph_ms(
                        lambda w: k1.matmul(x, w, b), ws, iters=20))
                _build.load_library, k1.k1_f32_plan = load, plan
                lib_ms = smoke.time_graph_ms(lambda w: torch.matmul(x, w), ws,
                                             iters=20)
                bound = 2 * rows * k * n / smoke.PEAK_FLOPS_F32 * 1e3
                smoke.log(f"{rows} x {k} x {n} (bound {bound:.4f} ms at "
                          f"{smoke.PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s; cuBLAS "
                          f"f32 {lib_ms:.4f} ms):")
                for name, s, picked, _ in runs:
                    t = times[(name, s)]
                    smoke.log(f"  {name:24s} {s} splits{'*' if picked else ' '}"
                              f" {sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                              f"{t[1]:.4f})")
    finally:
        _build.load_library, k1.k1_f32_plan = load, plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
