#!/usr/bin/env python3
"""Times K2's sm90 route (videovector_tpu_torch/csrc/conv_gemm_sm90.cu) at
CaffeNet's five convs under every tile shape the kernel has, on one CUDA
card:

    python3 scripts/torch_k2_tiles.py [--batch 50 256]

For each conv and batch, every (block_m, block_n) of SM90_TILES is held
against the plain version (chip_smoke.py's bf16 tolerance) and timed by
CUDA-graph replay, in turns: all tiles in order, then in reverse. The last
column marks the tile that `k2_sm90_plan` picks. Exits non-zero without a
card.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smoke.log(f"gpu: {smoke.gpu_name_and_power_limit()}")
    gen = torch.Generator(device=dev).manual_seed(3)
    plan = k2.k2_sm90_plan
    bf = torch.bfloat16
    with torch.no_grad():
        for batch in args.batch:
            for name, hw, c, o, ksz, s, p, g in smoke.CAFFENET_CONVS:
                x = (torch.randn(batch, hw, hw, c, generator=gen, device=dev)).to(bf)
                w = (torch.randn(ksz, ksz, c // g, o, generator=gen, device=dev)
                     * (2.0 / (ksz * ksz * c // g)) ** 0.5).to(bf)
                b = torch.randn(o, generator=gen, device=dev) * 0.1
                kw = dict(stride=(s, s), pad=(p, p), groups=g, fuse_relu=True,
                          out_dtype=bf)
                ref = k2.conv2d_gemm_nhwc_plain(x, w, b, **kw)
                times: dict[tuple[int, int], list[float]] = {}
                tiles = list(k2.SM90_TILES)
                for tile in tiles + tiles[::-1]:
                    k2.k2_sm90_plan = lambda *a, t=tile: (*t, plan(*a)[2])
                    try:
                        if tile not in times:
                            smoke.compare(f"{name} b{batch} {tile}",
                                          k2.conv2d_gemm_nhwc(x, w, b, **kw), ref)
                        times.setdefault(tile, []).append(smoke.time_graph_ms(
                            lambda _: k2.conv2d_gemm_nhwc(x, w, b, **kw),
                            [0, 1, 2, 3]))
                    finally:
                        k2.k2_sm90_plan = plan
                bound, _ = smoke.conv_bound_ms(batch, hw, c, o, ksz, s, p, g)
                m = batch * ((hw + 2 * p - ksz) // s + 1) ** 2
                pick = plan(m, o // g, g, sms)[:2]
                smoke.log(f"{name} b{batch} (bound {bound:.4f} ms):")
                for tile in tiles:
                    t = times[tile]
                    mark = "  <- plan" if tile == pick else ""
                    smoke.log(f"  block {tile[0]:3d}x{tile[1]:3d}: "
                              f"{sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                              f"{t[1]:.4f}){mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
