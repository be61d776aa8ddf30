"""The traced window of a `--trace 1` run: torch.profiler over a fixed
amount of the cell's work, read into device busy time, device operations
by name and idle gaps labelled by what the host was doing.

Spans come from the benchmark's own files (`span`, around its calls into
the program); the program records none yet.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

# host events that only wait for or launch device work: a gap is labelled
# by the operation that was running around them
_RUNTIME_PREFIXES = ("cuda", "cu", "Memcpy", "Memset")


def span(name: str):
    """A host span in the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(f"vvbench.{name}")


@dataclass
class Trace:
    """What the metric readers see of the traced window."""
    window_s: float = 0.0
    busy_s: float = 0.0
    # (name, seconds) of every device operation in the window
    device_ops: list = field(default_factory=list)
    # idle seconds between device operations, by the host operation
    idle_by_host: dict = field(default_factory=dict)
    # counts of the work in the window (steps, evals, queries, ...)
    counts: dict = field(default_factory=dict)

    def kernel_seconds(self, patterns) -> tuple[float, int]:
        """Summed seconds and number of device operations whose name holds
        any of `patterns`."""
        total, n = 0.0, 0
        for name, sec in self.device_ops:
            if any(p in name for p in patterns):
                total += sec
                n += 1
        return total, n

    def kernels(self) -> int:
        """Kernels in the window (device operations other than copies and
        fills)."""
        return sum(1 for name, _ in self.device_ops
                   if not name.startswith(("Memcpy", "Memset")))

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for name, sec in self.device_ops:
            key = name[:120]
            by_name[key] = by_name.get(key, 0.0) + sec
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


class TracedWindow:
    """Start, stop and read the profiler around a fixed amount of work."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()

    def stop(self, counts: dict) -> Trace:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        return read(self.prof.events(), self.t1 - self.t0, counts)


def _merged(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(events, window_s: float, counts: dict) -> Trace:
    """A Trace from the profiler's events (FunctionEvents, times in us)."""
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's range on the device's timeline is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("vvbench.")):
                dev.append((e.name, s, t))
        elif not e.name.startswith(_RUNTIME_PREFIXES):
            host.append((s, t, e.name))
    busy = _merged([[s, t] for _, s, t in dev])
    trace = Trace(window_s=window_s,
                  busy_s=sum(t - s for s, t in busy) / 1e6,
                  device_ops=[(n, (t - s) / 1e6) for n, s, t in dev],
                  counts=dict(counts))
    host.sort()
    starts = [s for s, _, _ in host]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        label = "python between operations"
        best = None
        i = bisect.bisect_right(starts, mid)
        # the innermost host operation around the gap's middle: among the
        # last few that started before it, the shortest that still runs
        for s, t, name in host[max(0, i - 64):i]:
            if t >= mid and (best is None or t - s < best):
                best, label = t - s, name
        trace.idle_by_host[label] = (trace.idle_by_host.get(label, 0.0)
                                     + (b - a) / 1e6)
    return trace
