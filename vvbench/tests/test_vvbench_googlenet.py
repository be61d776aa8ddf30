"""GoogLeNet's cell on the CPU at toy sizes: found by name, `correct` on
the sound program, the fp8 control and every planted fault above a limit,
and its per-layer metrics read from a traced run."""

from __future__ import annotations

import pytest

from vvbench import spec
from vvbench.harness import run_cell
from vvbench.tests import googlenet_faults
from vvbench.tests.toy import REPO, _edit, toy_root

GOOGLENET = "serve-googlenet-b50-g20k"
SEED = 2**31 + 4321


def _root(tmp_path):
    root = toy_root(tmp_path)
    _edit(root / "vvbench/mixes/query-googlenet-b50-g20k.json",
          {"frames_per_query": 2, "clip_pool": 2, "gallery_rows": 64,
           "schedule_pool": 8, "warmup_queries": 1, "traced_queries": 2,
           "check_queries": 2})
    return root


def _above(numbers: dict, checks: dict) -> bool:
    return any(v > checks[k]["limit"] for k, v in numbers.items())


def test_the_cell_and_its_metrics_are_declared():
    assert spec.problems(REPO) == []
    bench = spec.load_bench(REPO)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[GOOGLENET]["config"] == "googlenet-retrieval"
    assert cells[GOOGLENET]["chips"] == 1
    assert "serve-artifact-caffenet-b50-bf16" not in cells
    per_layer = {m["name"]: m.get("workloads") for m in bench["per_layer"]}
    for name in ("k2_roofline.googlenet", "mfu.googlenet",
                 "concat_mb.googlenet"):
        assert per_layer[name] == [GOOGLENET]
    for name in ("idle_share.query", "enqueue_ms.query", "gallery_ms.query"):
        assert per_layer[name][-1] == GOOGLENET


def test_the_sound_program_is_correct_and_the_control_is_not(tmp_path):
    line = run_cell(_root(tmp_path), GOOGLENET, SEED, 0.3, False, "cpu",
                    control=True)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"query_frames_per_s", "query_p95_ms",
                                    "setup_s"}
    assert _above(line["control"]["fp8"], line["checks"]), line["control"]


@pytest.mark.parametrize("fault", sorted(googlenet_faults.FAULTS))
def test_each_planted_fault_fails_a_limit(tmp_path, monkeypatch, fault):
    googlenet_faults.FAULTS[fault](monkeypatch)
    line = run_cell(_root(tmp_path), GOOGLENET, SEED, 0.3, False, "cpu")
    assert not line["correct"]
    assert _above({k: c["value"] for k, c in line["checks"].items()},
                  line["checks"])


def test_a_traced_googlenet_run_reads_its_metrics(tmp_path):
    line = run_cell(_root(tmp_path), GOOGLENET, SEED, 0.2, True, "cpu")
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    # the nine modules' bf16 outputs at 224, 2 frames a query
    assert got["concat_mb.googlenet"] == 2 * 2 * 1_235_584 / 1e6
    assert got["enqueue_ms.query"] > 0 and got["mfu.googlenet"] > 0
    # gallery_ms.query reads kernel names; on the CPU there are none
    assert "gallery_ms.query" not in got
    # on the CPU: no kernel to read
    assert "k2_roofline.googlenet" not in got

