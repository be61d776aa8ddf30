#!/usr/bin/env python3
"""Times K2's f32 route (videovector_tpu_torch/csrc/conv_gemm_f32_sm90.cu)
at CaffeNet's five convs under every tile shape and split count the kernel
takes, on one CUDA card:

    python3 scripts/torch_k2_f32_tiles.py [--batch 50 256] [--splits 8]

For each conv and batch (NHWC/HWIO f32 operands, bias, f32 out), every
(block_m, block_n) of F32_TILES at 1 to --splits splits (no more than the
conv's K tiles) is held against the plain version (chip_smoke.py's f32
tolerance) and timed by CUDA-graph replay, in turns: all candidates in
order, then in reverse. Each line gives the mean, both turns, the share of
the FFMA bound and `k2_f32_plan`'s modelled time; the last column marks the
plan's pick. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from videovector_tpu_torch.ops.hopper import conv_gemm as k2  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[50, 256])
    ap.add_argument("--splits", type=int, default=k2.F32_MAX_SPLITS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_f32_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smoke.log(f"gpu: {smoke.gpu_name_and_power_limit()}")
    gen = torch.Generator(device=dev).manual_seed(3)
    plan = k2.k2_f32_plan
    with torch.no_grad():
        for batch in args.batch:
            for name, hw, c, o, ksz, s, p, g in smoke.CAFFENET_CONVS:
                x = torch.randn(batch, hw, hw, c, generator=gen, device=dev)
                w = torch.randn(ksz, ksz, c // g, o, generator=gen, device=dev) \
                    * (ksz * ksz * c // g) ** -0.5
                b = torch.randn(o, generator=gen, device=dev) * 0.1
                kw = dict(stride=(s, s), pad=(p, p), groups=g)
                ref = k2.conv2d_gemm_nhwc_plain(x, w, b, **kw)
                # the GEMM the route runs: conv1 after its repack
                if name == "conv1":
                    xs, ws = k2.space_to_depth_plain(x, w, s)
                    geo_hw, geo_k, geo_s = xs.shape[1], ws.shape[0], 1
                    k = ws.shape[0] * ws.shape[1] * ws.shape[2]
                else:
                    geo_hw, geo_k, geo_s = hw, ksz, s
                    k = ksz * ksz * c // g
                ohw = (geo_hw + 2 * p - geo_k) // geo_s + 1
                m = batch * ohw * ohw
                k_tiles = -(-k // k2.F32_BK)
                cands = [(tile, sp) for tile in k2.F32_TILES
                         for sp in range(1, min(args.splits, k_tiles) + 1)]
                times: dict[tuple, list[float]] = {}
                try:
                    for cand in cands + cands[::-1]:
                        k2.k2_f32_plan = lambda *a, c_=cand: (*c_[0], c_[1])
                        if cand not in times:
                            smoke.compare(f"{name} b{batch} {cand}",
                                          k2.conv2d_gemm_nhwc(x, w, b, **kw), ref)
                        times.setdefault(cand, []).append(smoke.time_graph_ms(
                            lambda _: k2.conv2d_gemm_nhwc(x, w, b, **kw),
                            [0, 1]))
                finally:
                    k2.k2_f32_plan = plan
                flops = 2 * batch * ((hw + 2 * p - ksz) // s + 1) ** 2 * o \
                    * (c // g) * ksz * ksz
                bound = flops / smoke.PEAK_FLOPS_F32 * 1e3
                bm, bn, sp = plan(m, o // g, g, k, sms)
                smoke.log(f"{name} b{batch} (FFMA bound {bound:.4f} ms; m {m}, "
                          f"og {o // g}, groups {g}, k {k}):")
                for cand in sorted(cands, key=lambda c_: sum(times[c_])):
                    t = times[cand]
                    mean = sum(t) / len(t)
                    mark = "  <- plan" if cand == ((bm, bn), sp) else ""
                    model_ms = k2.f32_plan_seconds(m, o // g, g, k, sms,
                                                   *cand[0], cand[1]) * 1e3
                    smoke.log(
                        f"  block {cand[0][0]:3d}x{cand[0][1]:3d} splits "
                        f"{cand[1]}: {mean:.4f} ms ({t[0]:.4f}, {t[1]:.4f}; "
                        f"{bound / mean:.3f} of bound; model {model_ms:.4f})"
                        f"{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
