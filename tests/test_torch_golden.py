"""The golden fixtures (ROADMAP item 8) through the port's Net on the CPU:
tests/golden/ at 1e-5 per blob, as tests/test_golden_parity.py holds JAX,
and tests/golden_fullscale.npz at nrm_err 2e-5 and rel_big 1e-3 per blob,
as tests/test_golden_fullscale.py holds JAX (tests/torch_golden.py runs
both; tests/test_torch_cuda_kernels.py runs them on the card through K2's
f32 core route and K1's f32 route)."""

import numpy as np
import pytest
import test_golden_fullscale as jgold
import torch
import torch_golden as tg

torch.set_num_threads(1)


def test_every_layer_matches_the_golden_dump():
    blobs, golden = tg.mini_golden()
    assert set(golden) <= set(blobs)
    for name, want in golden.items():
        np.testing.assert_allclose(blobs[name], want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_fc7_tight_parity():
    """fc7 at tests/test_golden_parity.py's tighter bound."""
    blobs, golden = tg.mini_golden()
    np.testing.assert_allclose(blobs["fc7"], golden["fc7"], rtol=1e-6,
                               atol=1e-6)


def test_the_copies_are_the_jax_tests_own():
    assert tg.EXTRACTION_NET == jgold.EXTRACTION_NET
    assert (tg.BLOBS, tg.NRM_BOUND, tg.REL_BOUND) == (
        jgold.BLOBS, jgold.NRM_BOUND, jgold.REL_BOUND)


@pytest.fixture(scope="module")
def fullscale():
    return tg.fullscale_errors(tg.fullscale_blobs())


@pytest.mark.parametrize("blob", tg.BLOBS)
def test_fullscale_parity(fullscale, blob):
    nrm, rel = fullscale[blob]
    assert nrm <= tg.NRM_BOUND and rel <= tg.REL_BOUND, (nrm, rel)
