"""The per-layer metrics read from the program's own spans and counters
(videovector_tpu_torch/utils/timer.py): a toy traced run of each driver on
the CPU reads a number from each, `weight_cast_mb.query` exactly the
CaffeNet weights at 2 bytes; against a program without the table (an
older checkout) each reader returns None and raises nothing."""

from __future__ import annotations

import pytest

from vvbench import spec
from vvbench.flops import caffenet_fc_shapes
from vvbench.harness import Reading, run_cell
from vvbench.tests.toy import REPO, _edit, toy_root
from vvbench.trace import Trace

SERVE = ("kernel_host_ms.query", "weight_cast_mb.query")
TRAIN = ("step_host_ms.train", "eval_share.train")


def _caffenet_weights(cfg: dict) -> int:
    n, c_in = 0, 3
    for conv in cfg["convs"]:
        k, o, g = conv["kernel"], conv["num_output"], conv["group"]
        n += k * k * (c_in // g) * o
        c_in = o
    return n + sum(k * m for k, m in caffenet_fc_shapes(cfg))


def test_the_new_metrics_are_declared_for_their_cells():
    assert spec.problems(REPO) == []
    bench = spec.load_bench(REPO)
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for name in SERVE:
        assert cells[name] == ["serve-query-b50-g20k", "serve-query-b50-g1m"]
    for name in TRAIN:
        assert cells[name] == ["train-embed-b128-resident"]


def test_a_traced_serve_run_reads_the_programs_spans(tmp_path):
    root = toy_root(tmp_path)
    line = run_cell(root, "serve-query-b50-g20k", 2**31 + 77, 0.2, True,
                    "cpu")
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["kernel_host_ms.query"] > 0
    cfg = spec.cell(root, "serve-query-b50-g20k").config
    assert _caffenet_weights(cfg) == 73_635_872
    assert got["weight_cast_mb.query"] == 2 * 73_635_872 / 1e6


def test_a_traced_training_run_reads_the_programs_spans(tmp_path):
    root = toy_root(tmp_path)
    # 5 traced steps at the toy's test_interval of 5 hold one test eval
    _edit(root / "vvbench" / "mixes" / "train-resident-b128.json",
          {"traced_steps": 5})
    line = run_cell(root, "train-embed-b128-resident", 2**31 + 77, 0.3, True,
                    "cpu")
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["step_host_ms.train"] > 0
    assert 0 < got["eval_share.train"] < 100


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_program_without_the_table_reads_nothing(monkeypatch, name):
    from videovector_tpu_torch.utils import timer
    monkeypatch.delattr(timer, "recorded")
    trace = Trace(window_s=1.0, busy_s=0.5,
                  counts={"queries": 2, "steps": 4, "evals": 1})
    reading = Reading({}, {}, trace, {}, {})
    assert spec.metric_reader(REPO, name).read(reading) is None
