"""Faults planted in the program's I3D for the check of
`serve-i3d-t250-g20k`, each a function of a pytest MonkeyPatch: conv1
padded 3 and 3 on each axis as Caffe would (TF's SAME pads it 2 before and
3 after), BatchNorm's variance taken as a deviation in the fold, one
temporal tap of one 3x3x3 conv dropped, each clip's frames reversed in
time, and a crop of each frame's own in place of the clip's. Each has to
fail at least one of the cell's limits: the toy CPU tests run them, and on
the card

    python3 -m vvbench.tests.i3d_faults --seeds 11,12,13

runs the cell at its own sizes under each fault and prints its checks.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

NO_TAP = "Mixed_4c/Branch_1/Conv3d_0b_3x3"   # the conv whose first tap goes


def conv1_caffe_pads(mp):
    """Conv3d_1a_7x7 pads 3 before and 3 after on every axis: the same
    output sizes, every window one voxel earlier."""
    from videovector_tpu_torch.models import i3d
    conv = i3d.conv3d_gemm_ndhwc

    def caffe(x, w, b=None, *, pad, **kw):
        if w.shape[0] == 7:
            pad = ((3, 3),) * 3
        return conv(x, w, b, pad=pad, **kw)
    mp.setattr(i3d, "conv3d_gemm_ndhwc", caffe)


def variance_as_deviation(mp):
    """The fold divides by var + eps, not by its square root."""
    from videovector_tpu_torch.models import i3d

    def fold(self, params):
        out = {}
        for name, p in params.items():
            inv = 1.0 / (p["moving_variance"].float() + self.cfg.bn_eps)
            out[name] = {"w": p["w"].float() * inv,
                         "b": (p["beta"].float()
                               - p["moving_mean"].float() * inv)}
        return out
    mp.setattr(i3d.I3D, "fold_batch_norm", fold)


def temporal_tap_dropped(mp):
    """One 3x3x3 conv of module 4c reads no earlier frame: its first tap
    in time is zero."""
    from videovector_tpu_torch.models import i3d
    conv = i3d.I3D._conv

    def no_tap(self, params, name, x, stride=1):
        if name == NO_TAP:
            w = params[name]["w"].clone()
            w[0] = 0
            params = {**params, name: {**params[name], "w": w}}
        return conv(self, params, name, x, stride)
    mp.setattr(i3d.I3D, "_conv", no_tap)


def clip_reversed(mp):
    """Each clip's frames run last to first."""
    from videovector_tpu_torch.models import i3d
    head_windows = i3d.I3D.head_windows

    def reversed_clips(self, params, clips):
        return head_windows(self, params, clips.flip(1))
    mp.setattr(i3d.I3D, "head_windows", reversed_clips)


def per_frame_crops(mp):
    """Each frame of a clip cropped at offsets of its own (the clip's moved
    by 5 pixels a frame, wrapped), as the frame backbones' queries are."""
    from videovector_tpu_torch.models import retrieval_pipeline as rp
    per_frame = rp.RetrievalPipeline._per_frame

    def own(self, pixels_u8, h_off, w_off, mirror):
        h, w, m, t = per_frame(self, pixels_u8, h_off, w_off, mirror)
        step = 5 * torch.arange(h.shape[0], device=h.device) % t
        span_h = self.cfg.image_hw[0] - self.cfg.crop + 1
        span_w = self.cfg.image_hw[1] - self.cfg.crop + 1
        return (h + step) % span_h, (w + 3 * step) % span_w, m, t
    mp.setattr(rp.RetrievalPipeline, "_per_frame", own)


FAULTS = {f.__name__: f for f in (conv1_caffe_pads, variance_as_deviation,
                                  temporal_tap_dropped, clip_reversed,
                                  per_frame_crops)}


def main(argv=None) -> int:
    from _pytest.monkeypatch import MonkeyPatch

    from vvbench.harness import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--workload", default="serve-i3d-t250-g20k")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, plant in FAULTS.items():
            mp = MonkeyPatch()
            plant(mp)
            try:
                line = run_cell(Path.cwd(), args.workload, seed,
                                args.seconds, False, "cuda")
            finally:
                mp.undo()
            print(json.dumps({"seed": seed, "fault": name,
                              "correct": line["correct"],
                              "checks": line["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
