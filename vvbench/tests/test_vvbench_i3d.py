"""I3D's cell on the CPU at toy sizes (16 frames of 64 x 64 a clip, the
published widths): found by name, `correct` on the sound program, the fp8
control and every planted fault above a limit, its per-layer metrics read
from a traced run, and its flops file at the published count."""

from __future__ import annotations

import json

import pytest

from vvbench import flops_i3d, spec
from vvbench.harness import run_cell
from vvbench.tests import i3d_faults
from vvbench.tests.toy import REPO, _edit, toy_root

I3D = "serve-i3d-t250-g20k"
SEED = 2**31 + 8765


def _root(tmp_path):
    root = toy_root(tmp_path)
    _edit(root / "vvbench/configs/i3d-retrieval.json",
          {"image_hw": [72, 72], "crop": 64, "clip_frames": 16,
           "head_pool": [2, 2, 2]})
    _edit(root / "vvbench/mixes/query-i3d-t250-g20k.json",
          {"frames_per_query": 16, "clip_pool": 2, "gallery_rows": 64,
           "schedule_pool": 8, "warmup_queries": 1, "traced_queries": 2,
           "check_queries": 2})
    return root


def _above(numbers: dict, checks: dict) -> bool:
    return any(v > checks[k]["limit"] for k, v in numbers.items())


def test_the_cell_its_files_and_its_metrics_are_found():
    assert spec.problems(REPO) == []
    bench = spec.load_bench(REPO)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[I3D]["config"] == "i3d-retrieval"
    assert cells[I3D]["chips"] == 1
    (conf,) = [c for c in bench["configs"] if c["name"] == "i3d-retrieval"]
    assert conf["reduced"] == []
    cell = spec.cell(REPO, I3D)
    assert cell.config["name"] == "i3d-retrieval"
    assert cell.mix["driver"] == "serve_i3d" and cell.driver().run
    assert cell.mix["frames_per_query"] == cell.config["clip_frames"] == 250
    per_layer = {m["name"]: m.get("workloads") for m in bench["per_layer"]}
    for name in ("k2_roofline.i3d", "pool_roofline.i3d", "mfu.i3d"):
        assert per_layer[name] == [I3D]
        assert callable(spec.metric_reader(REPO, name).read)
    # the serve cells' host and device readings other than the end-to-end
    # metrics are not read in this cell
    for name in ("idle_share.query", "enqueue_ms.query", "gallery_ms.query",
                 "kernel_host_ms.query", "pool_kernel_share.query",
                 "graph_share.query", "weight_cast_mb.query"):
        assert I3D not in per_layer[name]
    assert {m["name"] for m in cell.end_to_end()} == {
        "query_frames_per_s", "query_p95_ms", "setup_s"}


def test_the_flops_file_at_the_published_count():
    cfg = json.loads((REPO / "vvbench/configs/i3d-retrieval.json")
                     .read_text())
    convs = flops_i3d.i3d_convs(1, cfg, frames=64)
    assert len(convs) == 57
    assert sum(c["ops"] for c in convs) / 2 / 1e9 == pytest.approx(111.2,
                                                                   abs=0.05)
    assert len(flops_i3d.i3d_pools(1, cfg)) == 13


def test_the_sound_program_is_correct_and_the_control_is_not(tmp_path):
    line = run_cell(_root(tmp_path), I3D, SEED, 0.3, False, "cpu",
                    control=True)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"query_frames_per_s", "query_p95_ms",
                                    "setup_s"}
    assert _above(line["control"]["fp8"], line["checks"]), line["control"]


@pytest.mark.parametrize("fault", sorted(i3d_faults.FAULTS))
def test_each_planted_fault_fails_a_limit(tmp_path, monkeypatch, fault):
    i3d_faults.FAULTS[fault](monkeypatch)
    line = run_cell(_root(tmp_path), I3D, SEED, 0.3, False, "cpu")
    assert not line["correct"]
    assert _above({k: c["value"] for k, c in line["checks"].items()},
                  line["checks"])


def test_a_traced_i3d_run_reads_its_metrics(tmp_path):
    line = run_cell(_root(tmp_path), I3D, SEED, 0.2, True, "cpu")
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["mfu.i3d"] > 0
    # the device's readers read kernel names; on the CPU there are none
    for name in ("k2_roofline.i3d", "pool_roofline.i3d"):
        assert name not in got
    assert not {"enqueue_ms.query", "gallery_ms.query",
                "idle_share.query"} & set(got)
