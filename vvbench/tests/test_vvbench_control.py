"""On the card: the control of each configuration (the reference one
precision below the configuration's, in the program's place) and the
half-batch fault come out not correct, while the program comes out
correct, on three seeds at the cells' own sizes with a short window.

    python3 -m pytest vvbench/tests -m cuda -q

This is what `python3 -m vvbench.control` reads at every seed."""

from __future__ import annotations

import pytest

from vvbench.harness import run_cell
from vvbench.tests.toy import REPO

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k]["limit"] for k, v in numbers.items()
               if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,sides", [
    ("serve-query-b50-g20k", ("fp8",)),
    ("train-embed-b128-resident", ("tf32", "half_batch")),
])
def test_control_fails_and_program_holds(card, workload, sides):
    for seed in SEEDS:
        line = run_cell(REPO, workload, seed, 1.0, False, card, control=True)
        assert line["correct"], (seed, line["checks"])
        for side in sides:
            assert _fails(line["control"][side], line["checks"]), (
                seed, side, line["control"][side])
