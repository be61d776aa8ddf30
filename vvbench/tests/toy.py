"""A copy of the benchmark at toy sizes, for CPU tests: the configuration
and mix files of every cell cut down in place, in a temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TOY_CONFIG = {
    "videovec-embed-4096": {"batch_size": 8, "feature_dim": 32,
                            "embed_dim": 32, "max_buffer_size": 100,
                            "test_batch": 20},
    "caffenet-retrieval": {},
}
TOY_MIX = {
    "train-resident-b128": {"videos": 40, "test_videos": 10,
                            "pool_batches": 4, "warmup_steps": 6,
                            "traced_steps": 4},
    "query-b50-g20k": {"frames_per_query": 2, "clip_pool": 2,
                       "gallery_rows": 64, "schedule_pool": 8,
                       "warmup_queries": 1, "traced_queries": 2,
                       "check_queries": 2},
    "query-b50-g1m": {"frames_per_query": 2, "clip_pool": 2,
                      "gallery_rows": 128, "schedule_pool": 8,
                      "warmup_queries": 1, "traced_queries": 2,
                      "check_queries": 2},
}


def _edit(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


def toy_root(tmp: Path, solver: dict | None = None) -> Path:
    """BENCHMARK.json and vvbench/ copied under `tmp`, at toy sizes (the
    solver's test_interval 5 unless `solver` says otherwise)."""
    root = Path(tmp) / "bench"
    root.mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "vvbench", root / "vvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, changes in TOY_CONFIG.items():
        path = root / "vvbench" / "configs" / f"{name}.json"
        data = json.loads(path.read_text())
        if "solver" in data:
            data["solver"].update({"test_interval": 5, **(solver or {})})
        data.update(changes)
        path.write_text(json.dumps(data, indent=1))
    for name, changes in TOY_MIX.items():
        _edit(root / "vvbench" / "mixes" / f"{name}.json", changes)
    return root
