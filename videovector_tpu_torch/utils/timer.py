"""Timing and profiling utilities; counterpart of
videovector_tpu/utils/timer.py.

ref:include/caffe/util/benchmark.hpp:10-36 (a Timer over boost ptime and
cudaEvent pairs) and the `caffe time` loops (tools/caffe.cpp:194-266,
reimplemented in tools/cli.py). On a card the work is asynchronous: a
`Timer` or `StepTimer` on a CUDA device times with CUDA events (the span
between two points of the stream's work), and on the CPU with the host
clock. `device_fence` waits for the work behind some tensors; `trace`
records a torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def device_fence(x) -> None:
    """Wait for everything the tensors in `x` (a tensor, or nested dicts,
    lists and tuples of them) depend on: a synchronize of each CUDA device
    they are on. CPU tensors are computed when they exist."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@dataclass
class Timer:
    """start/stop accumulator in milliseconds (the ref Timer API). With a
    CUDA `device`, start and stop record events on its current stream and
    stop synchronizes on the second; else the host clock."""
    device: object = None
    total_ms: float = 0.0
    calls: int = 0
    _t0: object = field(default=None, repr=False)
    _running: bool = field(default=False, repr=False)

    def start(self) -> None:
        if _is_cuda(self.device):
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        self._running = True

    def stop(self, fence=None) -> float:
        if fence is not None:
            device_fence(fence)
        if not self._running:
            return 0.0  # stop without start: no garbage delta
        if _is_cuda(self.device):
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            dt = self._t0.elapsed_time(end)
        else:
            dt = (time.perf_counter() - self._t0) * 1e3
        self.total_ms += dt
        self.calls += 1
        self._running = False
        return dt

    @property
    def average_ms(self) -> float:
        return self.total_ms / max(self.calls, 1)


class StepTimer:
    """Rolling steps/sec meter for training loops, over the last `window`
    ticks: CUDA events on a CUDA `device`, else the host clock."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.device = device
        self._marks: list = []

    def tick(self) -> None:
        if _is_cuda(self.device):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())
        if len(self._marks) > self.window:
            self._marks.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._marks) < 2:
            return 0.0
        first, last = self._marks[0], self._marks[-1]
        if _is_cuda(self.device):
            last.synchronize()
            span = first.elapsed_time(last) / 1e3
        else:
            span = last - first
        return (len(self._marks) - 1) / span if span > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA when there is a card),
    written as a Chrome trace into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
