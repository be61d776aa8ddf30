"""Runs driven past the harness's look for a card (on the CPU, at toy
sizes) with the timed path broken underneath: `correct` comes out false
for each fault a cell can have. The cells run on one chip, so none has an
exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from vvbench.harness import run_cell
from vvbench.tests.toy import toy_root

TRAIN = ["train-embed-b128-resident"]
SERVE = ["serve-query-b50-g20k", "serve-query-b50-g1m"]


def _run(tmp_path, workload):
    return run_cell(toy_root(tmp_path), workload, 2**31 + 321, 0.3, False,
                    "cpu")


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_the_sound_program_is_correct(tmp_path, workload):
    line = _run(tmp_path, workload)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch,
                                                 workload):
    from videovector_tpu_torch.solver import train

    def unchanged(cfg, params, grads, state, **kw):
        return params, {"iter": state["iter"] + 1,
                        "history": state["history"]}
    monkeypatch.setattr(train, "solver_update", unchanged)
    line = _run(tmp_path, workload)
    assert not line["correct"]
    assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "momentum_frozen"])
def test_a_step_that_goes_wrong_once_warm(tmp_path, monkeypatch, workload,
                                          fault):
    """From the window's first iteration on, the step returns its state
    unchanged, or stops updating its momentum history: the run's first
    steps hold, the window's do not."""
    from vvbench import spec
    from videovector_tpu_torch.solver import train
    root = toy_root(tmp_path)
    warm = spec.cell(root, workload).mix["warmup_steps"]
    update = train.solver_update

    def late(cfg, params, grads, state, **kw):
        if int(state["iter"]) < warm:
            return update(cfg, params, grads, state, **kw)
        if fault == "unchanged":
            return params, {"iter": state["iter"] + 1,
                            "history": state["history"]}
        p2, s2 = update(cfg, params, grads, state, **kw)
        moved = {k: {n: params[k][n] - state["history"][k][n]
                     for n in params[k]} for k in params}
        return moved, {"iter": s2["iter"], "history": state["history"]}
    monkeypatch.setattr(train, "solver_update", late)
    line = run_cell(root, workload, 2**31 + 321, 0.3, False, "cpu")
    checks = line["checks"]
    assert not line["correct"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in
               ("loss_gap", "grad_gap", "update_gap"))
    if fault == "unchanged":
        assert checks["win_update_unit_gap"]["value"] == pytest.approx(1.0)
    assert any(checks["win_" + k]["value"] > checks["win_" + k]["limit"]
               for k in ("loss_gap", "grad_unit_gap", "update_unit_gap"))


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(tmp_path, monkeypatch, workload):
    """The TRAIN loss over the first half of each batch's windows only."""
    from videovector_tpu_torch.graph.net import Net
    apply = Net.apply

    def half(self, params, batch, *args, **kw):
        if self.phase == "TRAIN":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return apply(self, params, batch, *args, **kw)
    monkeypatch.setattr(Net, "apply", half)
    line = _run(tmp_path, workload)
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"][
        "limit"]


@pytest.mark.parametrize("workload", SERVE)
def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch,
                                                workload):
    """The top-k drops the best match and serves ranks 2..k+1."""
    from videovector_tpu_torch.models import retrieval_pipeline as rp

    def shifted(scores, k):
        vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        return vals[..., 1:k + 1], idx[..., 1:k + 1]
    monkeypatch.setattr(rp, "top_k_stable", shifted)
    line = _run(tmp_path, workload)
    assert not line["correct"]
    assert line["checks"]["pick_gap"]["value"] > line["checks"]["pick_gap"][
        "limit"]
