"""`topk_ms.query`: the device time of the port's top-k kernels
(`vv::topk::`) a traced query. It reads the kernels by name from the
trace, None without a trace, without the kernels (a program whose top-k
is a sort) and on the CPU; and `gallery_ms.query` leaves them out."""

from __future__ import annotations

import pytest
import torch

from vvbench import spec
from vvbench.harness import Reading, run_cell
from vvbench.tests.toy import REPO, toy_root
from vvbench.trace import Trace

NAME = "topk_ms.query"
SERVE = ["serve-query-b50-g20k", "serve-query-b50-g1m",
         "serve-googlenet-b50-g20k", "serve-i3d-t250-g20k"]
STAGE1 = ("void vv::topk::select_slices<5>(float const*, long long, int, "
          "int, int, unsigned long long*)")
STAGE2 = ("void vv::topk::merge_slices<5>(float const*, long long, int, "
          "unsigned long long const*, int, float*, long long*)")
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3"
SORT = "void cub::DeviceRadixSortOnesweepKernel<...>"


def _reading(ops, queries=50, trace=True) -> Reading:
    t = Trace(window_s=1.0, busy_s=0.5, device_ops=list(ops),
              counts={"queries": queries})
    return Reading({}, {}, t if trace else None, {}, {})


def test_declared_for_the_four_serve_cells():
    assert spec.problems(REPO) == []
    (entry,) = [m for m in spec.load_bench(REPO)["per_layer"]
                if m["name"] == NAME]
    assert entry["workloads"] == SERVE
    assert (entry["unit"], entry["better"], entry["moves"], entry["layer"],
            entry["source"]) == ("ms", "lower", "query_p95_ms",
                                 "gallery scoring", "device_trace")
    reader = spec.metric_reader(REPO, NAME)
    assert (reader.SOURCE, reader.LAYER, reader.MOVES) == (
        "device_trace", "gallery scoring", "query_p95_ms")


@pytest.mark.parametrize("queries, want", [(50, 0.002), (200, 0.0005)])
def test_the_two_stages_a_query(queries, want):
    ops = [(STAGE1, 0.04), (STAGE2, 0.01), (STAGE1, 0.04), (STAGE2, 0.01),
           (GEMM, 0.5)]
    got = spec.metric_reader(REPO, NAME).read(_reading(ops, queries))
    assert got == pytest.approx(want * 1e3)


def test_gallery_ms_leaves_the_selection_out():
    ops = [(STAGE1, 0.04), (STAGE2, 0.01), (GEMM, 0.5)]
    gallery = spec.metric_reader(REPO, "gallery_ms.query")
    assert gallery.read(_reading(ops)) == pytest.approx(1e3 * 0.5 / 50)


@pytest.mark.parametrize("ops, trace", [
    ([(STAGE1, 0.04), (STAGE2, 0.01)], False),
    ([(GEMM, 0.5), (SORT, 0.17)], True),
    ([], True)])
def test_nothing_to_read_reads_nothing(ops, trace):
    assert spec.metric_reader(REPO, NAME).read(_reading(ops,
                                                        trace=trace)) is None


def test_a_traced_cpu_serve_run_leaves_it_out(tmp_path):
    torch.set_num_threads(1)
    line = run_cell(toy_root(tmp_path), "serve-query-b50-g20k", 2**31 + 97,
                    0.2, True, "cpu")
    assert line["correct"], line["checks"]
    assert NAME not in line["metrics"]
