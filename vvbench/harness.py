"""What a run of a cell is made of: the run as a driver sees it
(`Run`), what a driver hands back (`Outcome`), what a per-layer metric's
reader gets (`Reading`), and the result line."""

from __future__ import annotations

import math
import sys
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from vvbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "videovector_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `videovector_tpu_torch` is not
    `videovector_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Outcome:
    """What a driver hands back."""
    end_to_end: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict                      # name -> (value, limit)
    trace: object = None              # vvbench.trace.Trace, traced runs
    layer: dict = field(default_factory=dict)
    window: dict = field(default_factory=dict)


class Run:
    """One run as its driver sees it."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device, clock: tuple | None = None):
        import torch
        # (perf_counter at the process's start of work, the process's age
        # then): set-up runs from the process's start
        self.clock = clock or (time.perf_counter(), 0.0)
        self.cell, self.seed, self.seconds, self.trace = (cell, seed,
                                                          seconds, trace)
        self.device = torch.device(device)
        self.config, self.mix = cell.config, cell.mix
        self.limits = cell.limits()
        self.setup_s = None
        self.phases: list = []
        # control runs: the driver adds the control's and the faults'
        # numbers against the reference (vvbench/control.py)
        self.control = False
        self.readings: dict = {}

    def seed_for(self, name: str) -> int:
        """A 31-bit seed of its own for each use, from --seed (any whole
        number) and the use's name."""
        seq = np.random.SeedSequence([self.seed % 2**64, zlib.crc32(
            name.encode())])
        return int(seq.generate_state(1, np.uint32)[0] & 0x7FFFFFFF)

    def generator(self, name: str):
        import torch
        return torch.Generator(device=self.device).manual_seed(
            self.seed_for(name))

    def sync(self) -> None:
        """Waits for the device's queued work."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def since_start(self) -> float:
        t0, age0 = self.clock
        return age0 + time.perf_counter() - t0

    def phase(self, name: str) -> None:
        """Marks the end of a part of set-up (seconds since the process
        started), for the log."""
        self.phases.append((name, self.since_start()))

    def window_starts(self) -> None:
        """Set-up ends here: from the process's start to the window's."""
        self.setup_s = self.since_start()
        self.phases.append(("window opens", self.setup_s))


@dataclass
class Reading:
    """What a per-layer metric's reader gets."""
    config: dict
    mix: dict
    trace: object
    window: dict
    layer: dict


def _json_number(x: float) -> float:
    """JSON has no inf or nan: a number that never came out (an answer
    that is no gallery row reads inf) is written as 1e300."""
    return float(x) if math.isfinite(x) else 1e300


def result(cell: spec.Cell, run: Run, out: Outcome) -> dict:
    import torch
    checks = {k: {"value": _json_number(v), "limit": lim}
              for k, (v, lim) in out.checks.items()}
    correct = bool(out.checks) and out.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in out.checks.values())
    metrics = {}
    if not run.trace:
        values = dict(out.end_to_end, setup_s=run.setup_s)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        reading = Reading(run.config, run.mix, out.trace, out.window,
                          out.layer)
        for m in cell.per_layer():
            value = spec.metric_reader(cell.root, m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    if run.control:
        line["control"] = run.readings
    line["setup_phases"] = [[n, t] for n, t in run.phases]
    line["checks"] = checks
    return line


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device, clock: tuple | None = None,
             control: bool = False) -> dict:
    """Set-up, window, traced window (trace) and check of one cell on
    `device`; the result line as a dict. `main` asks for the card; tests
    call this on the CPU at toy sizes."""
    cell = spec.cell(root, workload)
    run = Run(cell, seed, seconds, trace, device, clock)
    run.control = control
    out = cell.driver().run(run)
    return result(cell, run, out)
