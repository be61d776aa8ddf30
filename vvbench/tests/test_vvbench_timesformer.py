"""TimeSformer's cell on the CPU at toy sizes (4 frames of 32 x 32 a
clip, 4 patches a frame, the published widths and depth): found by name,
`correct` on the sound program, the fp8 control and every planted fault
above a limit, its per-layer metrics read from a traced run, and its flops
file at the published count."""

from __future__ import annotations

import json

import pytest

from vvbench import flops_timesformer, spec
from vvbench.harness import run_cell
from vvbench.tests import timesformer_faults
from vvbench.tests.toy import REPO, _edit, toy_root

CELL = "serve-timesformer-t96-g20k"
SEED = 2**31 + 9876


def _root(tmp_path):
    root = toy_root(tmp_path)
    _edit(root / "vvbench/configs/timesformer-l-retrieval.json",
          {"image_hw": [40, 40], "crop": 32, "clip_frames": 4})
    _edit(root / "vvbench/mixes/query-timesformer-t96-g20k.json",
          {"frames_per_query": 4, "clip_pool": 2, "gallery_rows": 64,
           "schedule_pool": 8, "warmup_queries": 1, "traced_queries": 2,
           "check_queries": 2})
    return root


def _above(numbers: dict, checks: dict) -> bool:
    return any(v > checks[k]["limit"] for k, v in numbers.items())


def test_the_cell_its_files_and_its_metrics_are_found():
    assert spec.problems(REPO) == []
    bench = spec.load_bench(REPO)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["config"] == "timesformer-l-retrieval"
    assert cells[CELL]["traffic"] == "query-timesformer-t96-g20k"
    assert cells[CELL]["chips"] == 1
    (conf,) = [c for c in bench["configs"]
               if c["name"] == "timesformer-l-retrieval"]
    assert conf["reduced"] == []
    cell = spec.cell(REPO, CELL)
    assert cell.config["name"] == "timesformer-l-retrieval"
    assert cell.mix["driver"] == "serve_timesformer" and cell.driver().run
    assert cell.mix["frames_per_query"] == cell.config["clip_frames"] == 96
    assert cell.mix["clip_pool"] == 8
    assert cell.mix["gallery_rows"] == 20_000
    per_layer = {m["name"]: m.get("workloads") for m in bench["per_layer"]}
    for name in ("attn_roofline.timesformer", "k1_roofline.timesformer",
                 "mfu.timesformer", "layout_mb.timesformer"):
        assert per_layer[name] == [CELL]
        assert callable(spec.metric_reader(REPO, name).read)
    # no metric that was there before reads this cell
    assert {m["name"] for m in cell.per_layer()} == {
        "attn_roofline.timesformer", "k1_roofline.timesformer",
        "mfu.timesformer", "layout_mb.timesformer"}
    assert {m["name"] for m in cell.end_to_end()} == {
        "query_frames_per_s", "query_p95_ms", "setup_s"}


def test_the_flops_file_at_the_published_count():
    cfg = json.loads((REPO / "vvbench/configs/timesformer-l-retrieval.json")
                     .read_text())
    assert flops_timesformer.clip_ops(cfg) / 1e12 == pytest.approx(
        4.760, abs=5e-4)
    assert flops_timesformer.parameters(cfg) / 1e6 == pytest.approx(
        121.3, abs=0.05)
    assert len(flops_timesformer.gemms(1, cfg)) == 86


def test_the_sound_program_is_correct_and_the_control_is_not(tmp_path):
    line = run_cell(_root(tmp_path), CELL, SEED, 0.3, False, "cpu",
                    control=True)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"query_frames_per_s", "query_p95_ms",
                                    "setup_s"}
    assert _above(line["control"]["fp8"], line["checks"]), line["control"]


@pytest.mark.parametrize("fault", sorted(timesformer_faults.FAULTS))
def test_each_planted_fault_fails_a_limit(tmp_path, monkeypatch, fault):
    timesformer_faults.FAULTS[fault](monkeypatch)
    line = run_cell(_root(tmp_path), CELL, SEED, 0.3, False, "cpu")
    assert not line["correct"]
    assert _above({k: c["value"] for k, c in line["checks"].items()},
                  line["checks"])


def test_a_traced_timesformer_run_reads_its_metrics(tmp_path):
    line = run_cell(_root(tmp_path), CELL, SEED, 0.2, True, "cpu")
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["mfu.timesformer"] > 0
    # on the CPU the attention's plain version gathers its sequences and
    # scatters their outputs (bf16): 4 patches and 4 frames, 12 blocks
    p, t = 4, 4
    copied = p * t * 3 + p * t + t * (p + 1) * 3 + t * p
    assert got["layout_mb.timesformer"] == pytest.approx(
        12 * copied * 768 * 2 / 1e6)
    # the device's readers read kernel names; on the CPU there are none
    for name in ("attn_roofline.timesformer", "k1_roofline.timesformer"):
        assert name not in got
