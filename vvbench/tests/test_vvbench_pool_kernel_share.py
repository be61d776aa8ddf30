"""`pool_kernel_share.query`: 100 x the program's counter
`vvtpu.max_pool.launches` over `vvtpu.max_pool.calls`. It reads 100 when
every NHWC max pool of the traced queries launched the kernel, 0 on the
CPU (where each runs its plain version), and None with no trace or
against a program that keeps no such counters."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vvbench import spec
from vvbench.harness import Reading, run_cell
from vvbench.tests.toy import REPO, toy_root
from vvbench.trace import Trace

NAME = "pool_kernel_share.query"
SERVE = ["serve-query-b50-g20k", "serve-query-b50-g1m",
         "serve-googlenet-b50-g20k"]


def _reading(trace: bool = True) -> Reading:
    t = Trace(window_s=1.0, busy_s=0.5, counts={"queries": 2})
    return Reading({}, {}, t if trace else None, {}, {})


def _pools(calls: int, launches: int) -> None:
    """A profiled stretch of two queries whose pools counted `calls` and
    `launches` between them, as the program leaves its table (nothing
    counted when both are 0: an older program)."""
    from videovector_tpu_torch.utils import timer
    with timer.span("vvtpu.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with timer.span("vvtpu.query"):
                if calls:
                    timer.count("vvtpu.max_pool.calls", calls / 2)
                if launches:
                    timer.count("vvtpu.max_pool.launches", launches / 2)


def test_declared_for_the_three_serve_cells():
    assert spec.problems(REPO) == []
    (entry,) = [m for m in spec.load_bench(REPO)["per_layer"]
                if m["name"] == NAME]
    assert entry["workloads"] == SERVE
    assert (entry["unit"], entry["better"], entry["moves"], entry["layer"],
            entry["source"]) == ("%", "higher", "query_frames_per_s",
                                 "kernels", "program_counter")
    reader = spec.metric_reader(REPO, NAME)
    assert (reader.SOURCE, reader.LAYER, reader.MOVES) == (
        "program_counter", "kernels", "query_frames_per_s")


@pytest.mark.parametrize("calls, launches, share", [(26, 26, 100.0),
                                                    (6, 6, 100.0),
                                                    (26, 13, 50.0),
                                                    (6, 0, 0.0)])
def test_launches_over_calls(calls, launches, share):
    _pools(calls, launches)
    assert spec.metric_reader(REPO, NAME).read(_reading()) == share


def test_no_trace_reads_nothing():
    _pools(26, 26)
    assert spec.metric_reader(REPO, NAME).read(_reading(False)) is None


def test_a_program_without_the_counters_reads_nothing():
    _pools(0, 0)
    assert spec.metric_reader(REPO, NAME).read(_reading()) is None


def test_a_program_without_the_table_reads_nothing(monkeypatch):
    from videovector_tpu_torch.utils import timer
    _pools(26, 26)
    monkeypatch.delattr(timer, "recorded")
    assert spec.metric_reader(REPO, NAME).read(_reading()) is None


def test_a_traced_cpu_serve_run_reads_no_launches(tmp_path):
    torch.set_num_threads(1)
    root = toy_root(tmp_path)
    line = run_cell(root, "serve-query-b50-g20k", 2**31 + 93, 0.2, True,
                    "cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"][NAME]["value"] == 0.0
