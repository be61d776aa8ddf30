"""The plain references against the port on tiny CPU shapes: the CaffeNet
retrieval path at f32, the retrieval statistics, and the training step's
check through the harness at toy sizes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from vvbench.drivers import serve_query
from vvbench.harness import run_cell
from vvbench.reference import caffenet, embed
from vvbench.tests.toy import REPO, toy_root

CAFFENET = json.loads((REPO / "vvbench/configs/caffenet-retrieval.json")
                      .read_text())


def test_caffenet_reference_against_the_port_at_f32():
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    gen = torch.Generator().manual_seed(3)
    params = serve_query.make_params(gen, CAFFENET, "cpu")
    frames = serve_query.make_clips(gen, 3, CAFFENET["image_hw"], "cpu")
    h = torch.tensor([0, 29, 7])
    w = torch.tensor([5, 0, 29])
    mirror = torch.tensor([False, True, True])
    pipe = RetrievalPipeline(RetrievalPipelineConfig(compute_dtype="float32"),
                             device="cpu")
    got = pipe.embed_frames(params, frames, h, w, mirror)
    want = caffenet.embed(params, frames, h, w, mirror, CAFFENET)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)
    gallery, ids = serve_query.make_gallery(gen, 40, 4096, "cpu")
    served_ids, served = pipe.query(params, frames, h, w, mirror, gallery, ids)
    row_of_id = torch.full((40,), -1, dtype=torch.long)
    row_of_id[ids.long()] = torch.arange(40)
    nums = serve_query.compare(served_ids, served,
                               caffenet.scores(want, gallery), row_of_id, 5)
    assert nums["pick_gap"] < 1e-5


def test_the_compare_reads_an_altered_answer():
    s = torch.tensor([[0.9, 0.5, 0.7, 0.1, 0.3, 0.2]])
    row_of_id = torch.arange(6)
    vals, idx = caffenet.top_k(s, 2)
    assert idx.tolist() == [[0, 2]]
    ok = serve_query.compare(idx, vals, s, row_of_id, 2)
    assert ok == {"pick_gap": 0.0}
    # the second pick is row 1 (0.5) served as the best second (0.7)
    worse = serve_query.compare(torch.tensor([[0, 1]]), vals, s, row_of_id, 2)
    assert worse["pick_gap"] == pytest.approx(0.2 + 0.2)
    off = serve_query.compare(idx, vals + 1e-3, s, row_of_id, 2)
    assert off["pick_gap"] == pytest.approx(1e-3, rel=1e-4)
    twice = serve_query.compare(torch.tensor([[0, 0]]), vals, s, row_of_id, 2)
    assert twice["pick_gap"] == float("inf")


def test_retrieval_stats_against_the_port():
    from videovector_tpu_torch.metrics.retrieval import retrieval_stats
    gen = torch.Generator().manual_seed(5)
    feats = torch.randn((60, 16), generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    vids = torch.randint(0, 7, (60,), generator=gen)
    want = retrieval_stats(feats, vids, vids)
    got = embed.retrieval_stats(feats, vids)
    assert got["test_map"] == pytest.approx(float(want["mean_ap"]), abs=1e-6)
    assert got["test_hit1"] == pytest.approx(float(want["hit_at_1"]),
                                             abs=1e-6)
    assert got["test_hit5"] == pytest.approx(float(want["hit_at_5"]),
                                             abs=1e-6)


def test_iteration_seed_matches_the_port():
    from videovector_tpu_torch.core.seeds import iteration_seed
    for seed, it in ((0, 0), (1234, 7), (2**31 - 1, 199), (77, 2**20)):
        assert embed.iteration_seed(seed, it) == iteration_seed(seed, it)


def test_learning_rate_matches_the_port():
    from videovector_tpu_torch.solver.solvers import (
        SolverConfig, learning_rate,
    )
    solver = json.loads((REPO / "vvbench/configs/videovec-embed-4096.json")
                        .read_text())["solver"]
    cfg = SolverConfig(base_lr=solver["base_lr"], lr_policy="inv",
                       gamma=solver["gamma"], power=solver["power"])
    for it in (0, 1, 2, 50, 1000):
        assert embed.learning_rate(solver, it) == pytest.approx(
            float(learning_rate(cfg, it)), rel=1e-7)


@pytest.mark.parametrize("stretch", ["", "win_"])
def test_training_check_passes_on_the_port(tmp_path, stretch):
    """The run's first steps and the window's, each against the reference."""
    line = run_cell(toy_root(tmp_path), "train-embed-b128-resident",
                    2**31 + 99, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    for name in ("loss_gap", "grad_unit_gap", "update_unit_gap"):
        assert line["checks"][stretch + name]["value"] < 1e-5


def test_fp8_control_is_coarser_than_f32():
    x = torch.linspace(-3, 3, 1001)
    err = (caffenet.fp8(x) - x).abs().max()
    assert 1e-3 < float(err) < 0.2
    assert np.isfinite(float(err))
