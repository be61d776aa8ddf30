"""The benchmark finds every configuration, mix and per-layer metric by
name, and a later change adds a cell by adding files alone."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

from vvbench import spec
from vvbench.harness import run_cell
from vvbench.tests.toy import REPO


def test_benchmark_json_and_its_files_agree():
    assert spec.problems(REPO) == []


def test_every_cell_resolves_to_its_files():
    bench = spec.load_bench(REPO)
    for wl in bench["workloads"]:
        c = spec.cell(REPO, wl["name"])
        assert c.driver().run
        assert c.config["name"] == wl["config"]
        for m in c.per_layer():
            assert callable(spec.metric_reader(REPO, m["name"]).read)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


DUMMY_METRIC = '''"""A dummy per-layer metric: the frames of a query."""

SOURCE = "host_clock"
LAYER = "front door"
MOVES = "query_frames_per_s"


def read(reading):
    return float(reading.layer["frames_per_query"])
'''


def test_a_cell_is_added_by_adding_files(tmp_path):
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "vvbench", root / "vvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "vvbench")

    cfg = json.loads((root / "vvbench/configs/caffenet-retrieval.json")
                     .read_text())
    cfg["name"] = "dummy-caffenet"
    (root / "vvbench/configs/dummy-caffenet.json").write_text(json.dumps(cfg))
    mix = {"driver": "serve_query", "frames_per_query": 2, "clip_pool": 2,
           "gallery_rows": 32, "schedule_pool": 4, "warmup_queries": 1,
           "traced_queries": 2, "check_queries": 2}
    (root / "vvbench/mixes/dummy-query.json").write_text(json.dumps(mix))
    (root / "vvbench/metrics/frames.dummy.py").write_text(DUMMY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-caffenet", "source": "a test",
                             "file": "vvbench/configs/dummy-caffenet.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-caffenet",
                               "traffic": "dummy-query", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("query_frames_per_s", "query_p95_ms"):
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "frames.dummy", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "front door",
                               "moves": "query_frames_per_s",
                               "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root / "vvbench")
    assert {k: after[k] for k in before} == before
    assert spec.problems(root) == []
    plain = run_cell(root, "dummy-cell", 7, 0.2, False, "cpu")
    assert set(plain["metrics"]) == {"query_frames_per_s", "query_p95_ms",
                                     "setup_s"}
    traced = run_cell(root, "dummy-cell", 7, 0.2, True, "cpu")
    assert traced["metrics"]["frames.dummy"]["value"] == 2.0
    assert plain["correct"] and traced["correct"]
