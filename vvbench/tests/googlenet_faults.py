"""Faults planted in the program's GoogLeNet for the check of
`serve-googlenet-b50-g20k`, each a function of a pytest MonkeyPatch:
a branch of one module dropped, the branches concatenated in another
order, one LRN skipped, one conv's bias dropped. Each has to fail at
least one of the cell's limits: the toy CPU tests run them, and on the
card

    python3 -m vvbench.tests.googlenet_faults --seeds 11,12,13

runs the cell at its own sizes under each fault and prints its checks.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

MODULE = "4c"          # the module whose branch is dropped
NO_BIAS = "inception_4c/1x1"


def branch_dropped(mp):
    """Module 4c's 5x5 branch reads zero."""
    from videovector_tpu_torch.models import googlenet

    def inception(self, params, m, x):
        b = list(self._branches(params, m, x))
        if m.name == MODULE:
            b[2] = torch.zeros_like(b[2])
        return torch.cat(b, dim=3)
    mp.setattr(googlenet.GoogLeNet, "_inception", inception)


def concat_swapped(mp):
    """Every module's 1x1 and 3x3 branches change places."""
    from videovector_tpu_torch.models import googlenet

    def inception(self, params, m, x):
        b = self._branches(params, m, x)
        return torch.cat([b[1], b[0], b[2], b[3]], dim=3)
    mp.setattr(googlenet.GoogLeNet, "_inception", inception)


def lrn_skipped(mp):
    """The stem's first LRN (pool1/norm1) returns its input; the second
    runs."""
    from videovector_tpu_torch.models import googlenet
    lrn, calls = googlenet.lrn, []

    def first_skipped(x):
        calls.append(1)
        return x if len(calls) % 2 == 1 else lrn(x)
    mp.setattr(googlenet, "lrn", first_skipped)


def bias_dropped(mp):
    """Module 4c's 1x1 conv runs without its bias."""
    from videovector_tpu_torch.models import googlenet
    conv = googlenet.GoogLeNet._conv

    def no_bias(self, params, name, x, stride=1, pad=0):
        if name == NO_BIAS:
            params = {**params, name: {**params[name],
                                       "b": torch.zeros_like(
                                           params[name]["b"])}}
        return conv(self, params, name, x, stride, pad)
    mp.setattr(googlenet.GoogLeNet, "_conv", no_bias)


FAULTS = {f.__name__: f for f in (branch_dropped, concat_swapped,
                                  lrn_skipped, bias_dropped)}


def main(argv=None) -> int:
    from _pytest.monkeypatch import MonkeyPatch

    from vvbench.harness import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--workload", default="serve-googlenet-b50-g20k")
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
