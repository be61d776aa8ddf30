"""Faults planted in the program's TimeSformer for the check of
`serve-timesformer-t96-g20k`, each a function of a pytest MonkeyPatch:
`temporal_fc` dropped from the temporal half, `time_embed` dropped, the
temporal heads reading their tokens in (t h w) order where the rows are in
(h w t), frame 0's class output taken in place of the mean over the
frames, the attention scale dropped, and the spatial heads without the
class token's key and value row. Each has to fail at least one of the
cell's limits: the toy CPU tests run them, and on the card

    python3 -m vvbench.tests.timesformer_faults --seeds 11,12,13

runs the cell at its own sizes under each fault and prints its checks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch


def temporal_fc_dropped(mp):
    """The temporal half adds proj's output without temporal_fc."""
    from videovector_tpu_torch.models import timesformer as tt

    def half(self, bp, x, n, patches, t):
        qkv = self._linear(self._rows(x[:, 1:], bp["temporal_norm1"]),
                           bp["temporal_attn"]["qkv"])
        o, _ = tt.attention(qkv, self.cfg.heads,
                            tt.Sequences.temporal(n, patches, t))
        r = self._linear(o, bp["temporal_attn"]["proj"])
        x[:, 1:] += r.view(n, patches * t, self.cfg.dim)
    mp.setattr(tt.TimeSformer, "_temporal_half", half)


def time_embed_dropped(mp):
    """The patch tokens take no time_embed."""
    from videovector_tpu_torch.models import timesformer as tt
    embed = tt.TimeSformer._embed

    def no_time(self, params, clips, n, t, grid):
        return embed(self, {**params, "time_embed": torch.zeros_like(
            params["time_embed"])}, clips, n, t, grid)
    mp.setattr(tt.TimeSformer, "_embed", no_time)


def temporal_over_thw(mp):
    """The temporal heads read a patch's tokens as if the rows were in (t h
    w) order, P rows apart from the patch's row in frame 0."""
    from videovector_tpu_torch.models import timesformer as tt

    def thw(cls, n, patches, t):
        return cls("temporal", t, n, patches, 0, patches * t, 1, patches)
    mp.setattr(tt.Sequences, "temporal", classmethod(thw))


def class_from_frame0(mp):
    """The class row takes frame 0's class output, not the mean over the
    frames."""
    from videovector_tpu_torch.models import timesformer as tt

    def frame0(self, cls, n, t):
        return cls.view(n, t, self.cfg.dim)[:, 0]
    mp.setattr(tt.TimeSformer, "_class_mean", frame0)


def scale_dropped(mp):
    """Both kinds of head take softmax(q k^T) v, without 64^-0.5."""
    from videovector_tpu_torch.models import timesformer as tt
    real = tt.attention

    def unscaled(qkv, heads, seqs, scale=None):
        return real(qkv, heads, seqs, 1.0)
    mp.setattr(tt, "attention", unscaled)


def spatial_without_class_key(mp):
    """The spatial heads leave out the class token's key and value: the
    patch queries attend over their frame's patches alone, and the class
    query too."""
    from videovector_tpu_torch.models import timesformer as tt
    real = tt.attention

    def no_class_key(qkv, heads, seqs, scale=None):
        if seqs.kind != "spatial":
            return real(qkv, heads, seqs, scale)
        out, _ = real(qkv, heads, dataclasses.replace(seqs, extra_base=-1),
                      scale)
        d = qkv.shape[1] // 3
        hd = d // heads
        rows = seqs.token_rows(qkv.device)
        q = qkv[seqs.extra_rows(qkv.device), :d].float().view(-1, heads, hd)
        kv = qkv[rows].float().view(*rows.shape, 3, heads, hd)
        p = torch.softmax(torch.einsum("shd,slhd->shl", q, kv[:, :, 1])
                          * (scale or hd ** -0.5), dim=-1)
        cls = torch.einsum("shl,slhd->shd", p, kv[:, :, 2])
        return out, cls.reshape(-1, d)
    mp.setattr(tt, "attention", no_class_key)


FAULTS = {f.__name__: f for f in (temporal_fc_dropped, time_embed_dropped,
                                  temporal_over_thw, class_from_frame0,
                                  scale_dropped, spatial_without_class_key)}


def main(argv=None) -> int:
    from _pytest.monkeypatch import MonkeyPatch

    from vvbench.harness import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--workload", default="serve-timesformer-t96-g20k")
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
