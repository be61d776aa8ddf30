"""The control and the faults of the check that decides `correct`, read on
many seeds in one process.

    python3 -m vvbench.control --workload <name> --seeds 11,12,13 --seconds 3

Each seed runs the cell as `vvbench.run` does (set-up, a short window, the
check) and prints one JSON line: the program's numbers against the plain
reference (the lower readings of the limits), and the control's numbers
(the reference in the program's place, one precision below the
configuration's: fp8 for the bf16 serving pipeline, TF32 for the f32
training step) with, for training, the half-batch fault's. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

from vvbench.harness import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vvbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("vvbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run_cell(Path.cwd(), args.workload, seed, args.seconds,
                        False, "cuda", control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {k: v["value"] for k, v in
                                      line["checks"].items()},
                          "control": line["control"],
                          "metrics": line["metrics"]}), flush=True)
        del line
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
