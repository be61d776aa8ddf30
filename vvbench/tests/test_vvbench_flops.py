"""The operation and byte counts against values worked out by hand."""

from __future__ import annotations

import json

import pytest

from vvbench import flops
from vvbench.tests.toy import REPO

CAFFENET = json.loads((REPO / "vvbench/configs/caffenet-retrieval.json")
                      .read_text())
EMBED = json.loads((REPO / "vvbench/configs/videovec-embed-4096.json")
                   .read_text())

# multiply-adds of one frame: output positions x filter taps
CONV_MACS = {"conv1": 55 * 55 * 96 * 11 * 11 * 3,
             "conv2": 27 * 27 * 256 * 5 * 5 * 48,
             "conv3": 13 * 13 * 384 * 3 * 3 * 256,
             "conv4": 13 * 13 * 384 * 3 * 3 * 192,
             "conv5": 13 * 13 * 256 * 3 * 3 * 192}


def test_caffenet_convs_by_hand():
    got = {c["name"]: c["ops"] for c in flops.caffenet_convs(1, CAFFENET)}
    assert got == {k: 2.0 * v for k, v in CONV_MACS.items()}
    # conv1's bytes at batch 50: bf16 input and weights, f32 bias, bf16 out
    c1 = flops.caffenet_convs(50, CAFFENET)[0]
    assert c1["bytes"] == (50 * 227 * 227 * 3 * 2 + 11 * 11 * 3 * 96 * 2
                           + 96 * 4 + 50 * 55 * 55 * 96 * 2)


def test_caffenet_frame_is_1_44_gflop():
    fcs = flops.caffenet_fc_shapes(CAFFENET)
    assert fcs == [(9216, 4096), (4096, 4096), (4096, 4096)]
    # 665,784,864 conv multiply-adds, fc6 37,748,736, fc7 16,777,216
    assert flops.caffenet_frame_ops(CAFFENET, tower=False) == 1_440_621_632
    assert flops.caffenet_frame_ops(CAFFENET) == 1_440_621_632 + 33_554_432


def test_serving_bounds():
    # fc6 + fc7 + tower at 50 rows are bytes-bound: 142.6 MB of bf16
    # weights and the small rest
    weights = (9216 * 4096 + 2 * 4096 * 4096) * 2
    assert weights == pytest.approx(142.6e6, rel=1e-3)
    assert flops.k1_query_least_s(50, CAFFENET) == pytest.approx(
        (weights + 3 * 4096 * 4 + 50 * (9216 + 2 * 4096) * 2
         + 3 * 50 * 4096 * 4) / flops.PEAK_BYTES)
    # a query against 1M rows: the f32 scores dominate, 4.1e11 operations
    assert flops.score_ops(50, 1_000_000, 4096) == 4.096e11
    assert flops.query_least_s(50, 1_000_000, CAFFENET) == pytest.approx(
        50 * 1_474_176_064 / 989e12 + 4.096e11 / 67e12)


def test_training_counts():
    rows = 128 * 15
    assert flops.tower_rows(EMBED) == rows
    assert flops.train_step_ops(EMBED) == 4.0 * rows * 4096 * 4096
    assert flops.test_eval_ops(EMBED) == (2.0 * 673 * 4096 * 4096
                                          + 2.0 * 673 * 673 * 4096)
    # the tower forward's least time at the f32 peak: 0.9616 ms a step
    assert flops.k1_train_least_s(EMBED, 1, 0) == pytest.approx(
        2 * rows * 4096 * 4096 / 67e12)
    assert flops.k1_train_least_s(EMBED, 1, 0) * 1e3 == pytest.approx(
        0.9616, abs=1e-4)
