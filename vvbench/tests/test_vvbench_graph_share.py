"""`graph_share.query`: 100 x the program's counter
`vvtpu.query.graph_replays` over the traced queries. It reads 100 when
every traced query was a replay, 0 on the CPU (where no query is
captured), and None with no trace or against a program that keeps no
graph of the query."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vvbench import spec
from vvbench.harness import Reading, run_cell
from vvbench.tests.toy import REPO, toy_root
from vvbench.trace import Trace

NAME = "graph_share.query"


def _reading(queries: int, trace: bool = True) -> Reading:
    t = Trace(window_s=1.0, busy_s=0.5, counts={"queries": queries})
    return Reading({}, {}, t if trace else None, {}, {})


def _queries(n: int, replays: int) -> None:
    """A profiled stretch of `n` queries of which the first `replays` were
    replays, as the program leaves its table."""
    from videovector_tpu_torch.utils import timer
    with timer.span("vvtpu.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            with timer.span("vvtpu.query"):
                if i < replays:
                    timer.count("vvtpu.query.graph_replays", 1)


def test_declared_for_both_serve_cells():
    assert spec.problems(REPO) == []
    (entry,) = [m for m in spec.load_bench(REPO)["per_layer"]
                if m["name"] == NAME]
    assert entry["workloads"] == ["serve-query-b50-g20k",
                                  "serve-query-b50-g1m"]
    assert (entry["unit"], entry["better"], entry["moves"]) == (
        "%", "higher", "query_frames_per_s")


@pytest.mark.parametrize("replays, queries, share", [(4, 4, 100.0),
                                                     (1, 4, 25.0),
                                                     (0, 4, 0.0)])
def test_replays_over_the_traced_queries(replays, queries, share):
    _queries(queries, replays)
    assert spec.metric_reader(REPO, NAME).read(_reading(queries)) == share


def test_no_trace_reads_nothing():
    _queries(4, 4)
    assert spec.metric_reader(REPO, NAME).read(_reading(4, False)) is None


def test_a_program_without_the_graph_reads_nothing(monkeypatch):
    from videovector_tpu_torch.models import retrieval_pipeline
    _queries(4, 4)
    monkeypatch.delattr(retrieval_pipeline, "query_graph_key")
    assert spec.metric_reader(REPO, NAME).read(_reading(4)) is None


def test_a_traced_cpu_serve_run_reads_no_replays(tmp_path):
    torch.set_num_threads(1)
    root = toy_root(tmp_path)
    line = run_cell(root, "serve-query-b50-g20k", 2**31 + 91, 0.2, True,
                    "cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"][NAME]["value"] == 0.0
