"""Timing, profiling and the program's own spans and counters; counterpart
of videovector_tpu/utils/timer.py.

ref:include/caffe/util/benchmark.hpp:10-36 (a Timer over boost ptime and
cudaEvent pairs) and the `caffe time` loops (tools/caffe.cpp:194-266,
reimplemented in tools/cli.py). On a card the work is asynchronous: a
`Timer` on a CUDA device times with CUDA events (the span between two
points of the stream's work), and on the CPU with the host clock.
`device_fence` waits for the work behind some tensors; `trace` records a
torch.profiler trace.

`span(name, req=None)` and `count(name, n)` mark where the program spends
its host time and what it does, named `vvtpu.<layer>.<part>`. While no
profiler records they cost one check of the profiler's flag and record
nothing. While one records, a span is a RecordFunction range (what
`record_function` enters, at a tenth of its cost), so it lies in the
profiler's timeline beside the device's kernels (and in `trace`'s Chrome
trace); it and the counters also go into an in-memory table that
`recorded()` returns: each span's name, start and end in Unix-epoch ns
(`time.time_ns()`, the clock Kineto reports its events on:
`trace_start_ns()` plus an event's offset), the index of its parent span
and a request id that its children inherit. The table holds one profiled
stretch: the first span or count that finds the profiler on after one
that found it off starts a new one (so two stretches with no span or
count between them share one table). `tally()` collects what `count`
adds in its block whether or not a profiler records, so that work which
runs again without the code that counts it (a replayed CUDA graph) can
be counted again.
"""

from __future__ import annotations

import contextlib
import threading
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


# a RecordFunction range, the kind torch.profiler records for every aten
# op, entered from C++: about a tenth of the cost of record_function, whose
# Python wrapper dispatches an op to enter and another to leave
_Range = torch._C._profiler._RecordFunctionFast


@dataclass
class SpanRecord:
    """One span of the table: `parent` is the index of the span it ran
    inside (None at the top), `req` its request id or its parent's."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    req: object


@dataclass
class Recorded:
    """What `recorded()` returns: the newest profiled stretch's spans, in
    the order they were entered, and its counters."""
    spans: list
    counters: dict


class _Stretch:
    """The table of one profiled stretch: rows [name, start_ns, end_ns,
    parent, req], the counters, and a lock for the counters."""

    def __init__(self):
        self.rows: list[list] = []
        self.counters: dict[str, float] = {}
        self.lock = threading.Lock()


class _Recorder:
    """The process's table: the newest stretch, whether the last span or
    count found the profiler on, and each thread's open spans."""

    def __init__(self):
        self.stretch = _Stretch()
        self.on = False
        self.local = threading.local()

    def current(self) -> _Stretch:
        if not self.on:
            self.stretch = _Stretch()
            self.on = True
        return self.stretch

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def tallies(self) -> list:
        tallies = getattr(self.local, "tallies", None)
        if tallies is None:
            tallies = self.local.tallies = []
        return tallies


_RECORDER = _Recorder()
_NULL_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("row", "index", "stretch", "range")

    def __init__(self, name: str, req):
        self.row = [name, 0, None, None, req]

    def __enter__(self):
        stretch = _RECORDER.current()
        stack = _RECORDER.open_spans()
        row = self.row
        if stack and stack[-1].stretch is stretch:
            row[3] = stack[-1].index
            if row[4] is None:
                row[4] = stack[-1].row[4]
        self.stretch, self.index = stretch, len(stretch.rows)
        stretch.rows.append(row)
        stack.append(self)
        self.range = _Range(row[0])
        row[1] = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.row[2] = time.time_ns()
        stack = _RECORDER.open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        return False


def span(name: str, req=None):
    """A context manager around a part of the program's work (module
    docstring): a null context while no profiler records; else a
    RecordFunction range named `name`, also entered in the table with
    `req` (its parent span's when None). The check reads torch's own flag,
    a module global that torch.profiler sets on start and clears on
    stop."""
    if not torch.autograd.profiler._is_profiler_enabled:
        _RECORDER.on = False
        return _NULL_SPAN
    return _Span(name, req)


def count(name: str, n) -> None:
    """Adds `n` to the counter `name` of the profiled stretch (nothing while
    no profiler records) and of the innermost `tally` open in this thread.
    """
    tallies = getattr(_RECORDER.local, "tallies", None)
    if tallies:
        tallies[-1][name] = tallies[-1].get(name, 0) + n
    if not torch.autograd.profiler._is_profiler_enabled:
        _RECORDER.on = False
        return
    stretch = _RECORDER.current()
    with stretch.lock:
        stretch.counters[name] = stretch.counters.get(name, 0) + n


@contextlib.contextmanager
def tally():
    """Yields a dict that collects, by name, what `count` adds in this
    thread inside the block, whether or not a profiler records; a tally
    opened inside the block takes what is counted inside its own."""
    counts: dict[str, float] = {}
    tallies = _RECORDER.tallies()
    tallies.append(counts)
    try:
        yield counts
    finally:
        tallies.pop()


def recorded() -> Recorded:
    """The newest profiled stretch's spans and counters (copies)."""
    stretch = _RECORDER.stretch
    with stretch.lock:
        return Recorded([SpanRecord(*row) for row in stretch.rows],
                        dict(stretch.counters))
