"""One run of one cell of the benchmark of videovector_tpu_torch.

    python3 -m vvbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The cell,
its configuration, its traffic mix and its metrics are found by name
(vvbench/spec.py). Set-up makes the inputs and weights from --seed, warms
up every shape the cell uses, then the window measures for --seconds.
With --trace 0 the last line of stdout is the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, read from a traced window that
follows the measured one. Every run then compares what the timed path
produced with the plain reference (vvbench/reference/) and prints each
number compared beside its limit.

Exit codes: 0 with a result line; 2 for a wrong command or specification;
3 without the CUDA cards the cell asks for; 4 when `jax`, `jaxlib`, `flax`
or the JAX package `videovector_tpu` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), so that set-up counts
    the interpreter's start and the imports."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from vvbench import spec  # noqa: E402
from vvbench.harness import forbidden_modules, run_cell  # noqa: E402


def _check_cards(chips: int) -> str | None:
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {chips}")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vvbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        cell = spec.cell(root, args.workload)
    except (spec.SpecError, OSError, KeyError, ValueError) as err:
        print(f"vvbench: {err}", file=sys.stderr)
        return 2
    missing = _check_cards(int(cell.workload.get("chips", 1)))
    if missing:
        print(f"vvbench: no result: {missing}", file=sys.stderr)
        return 3
    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", clock=(_T0, _AGE0))
    found = forbidden_modules()
    if found:
        print(f"vvbench: no result: modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, t in line.pop("setup_phases"):
        print(f"set-up: {name} at {t:.3f} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {str(line['correct']).lower()}", file=sys.stderr,
          flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
