"""The port's rank-stats layers (RETRIEVAL_RANK_STATS in identity and
compute_ap mode, RETRIEVAL_RANK_STATS_FIXED_REF) through its Net against
the JAX package's on the CPU.

The same seeded numpy blobs go through both Nets. The per-item integer
ranks (first relevant position, 1e4 without one) are equal, and the five
scalar tops are within 1e-6. Ties in the distance are decided by index in
both (stable argsorts), and the cases hold exact ties on purpose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu.metrics import retrieval as jr
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.metrics import retrieval as tr

torch.set_num_threads(1)
TOPS = ("mr", "r1", "r5", "r10", "ap")

RANK_NET = """
layers { name: "d" type: MEMORY_DATA top: "ctx" top: "tgt" }
layers { name: "rs" type: RETRIEVAL_RANK_STATS bottom: "ctx" bottom: "tgt"
  top: "mr" top: "r1" top: "r5" top: "r10" top: "ap"
  retrieval_rank_stats_param { %s } }
"""

FIXED_NET = """
layers { name: "d" type: MEMORY_DATA top: "q" top: "qv" top: "g" top: "gv" }
layers { name: "fr" type: RETRIEVAL_RANK_STATS_FIXED_REF bottom: "q"
  bottom: "qv" bottom: "g" bottom: "gv"
  top: "mr" top: "r1" top: "r5" top: "r10" top: "ap" }
"""


def _outputs(txt, batch):
    """The five tops through JAX's Net and the port's."""
    _, jout = JNet(jparse(txt), "TEST").apply(
        {}, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tout = TNet(tparse(txt), "TEST").apply(
        {}, {k: torch.as_tensor(v) for k, v in batch.items()})
    return jout, tout


def _same_tops(jout, tout):
    for k in TOPS:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _rows(rs, n, d=6, exact=False):
    if exact:   # small integers: exact products, so exact ties
        return (rs.randint(-2, 3, size=(n, d)) * 0.5).astype(np.float32)
    return rs.randn(n, d).astype(np.float32)


@pytest.mark.parametrize("b,exact", [(12, False), (11, False), (9, True)])
def test_identity_mode_matches_jax(b, exact):
    rs = np.random.RandomState(b)
    ctx = _rows(rs, b, exact=exact)
    tgt = ctx + (0 if exact else 0.3 * _rows(rs, b))
    jout, tout = _outputs(RANK_NET % "", {"ctx": ctx, "tgt": tgt})
    _same_tops(jout, tout)
    j = jr._rank_stats_peritem(jnp.asarray(ctx), jnp.asarray(tgt), False, 0, 0)
    t = tr._rank_stats_peritem(torch.as_tensor(ctx), torch.as_tensor(tgt),
                               False, 0, 0)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))   # order
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))   # ranks


@pytest.mark.parametrize("num_videos,pos,neg,exact", [
    (8, 1, 10, False), (6, 2, 3, True), (5, 1, 2, False)])
def test_compute_ap_mode_matches_jax(num_videos, pos, neg, exact):
    """The bucket layout of the exhaustive net's layer: item role*B + b is
    in bucket role, the first `positive_size` buckets positives (video 0's
    negatives alias its positives, -0 == 0)."""
    rs = np.random.RandomState(num_videos)
    ctx = _rows(rs, num_videos, exact=exact)
    tgt = _rows(rs, num_videos * (pos + neg), exact=exact)
    tgt[:num_videos] += 0 if exact else ctx      # positives near their query
    kw = f"compute_ap: true positive_size: {pos} negative_size: {neg}"
    jout, tout = _outputs(RANK_NET % kw, {"ctx": ctx, "tgt": tgt})
    _same_tops(jout, tout)
    j = jr._rank_stats_peritem(jnp.asarray(ctx), jnp.asarray(tgt), True,
                               pos, neg)
    t = tr._rank_stats_peritem(torch.as_tensor(ctx), torch.as_tensor(tgt),
                               True, pos, neg)
    for i in (1, 2):
        np.testing.assert_array_equal(t[i].numpy(), np.asarray(j[i]))


@pytest.mark.parametrize("exact", [False, True])
def test_fixed_ref_matches_jax(exact):
    """Gallery ids < 0 are global negatives; a query whose video is not in
    the gallery ranks 1e4; an even query count takes the mean of the two
    middle ranks."""
    rs = np.random.RandomState(3)
    q = _rows(rs, 10, exact=exact)
    g = _rows(rs, 40, exact=exact)
    qv = rs.randint(1, 6, 10).astype(np.float32)
    qv[0] = 99                                     # no match in the gallery
    gv = np.where(rs.rand(40) < 0.3, -1, rs.randint(1, 6, 40)).astype(
        np.float32)
    jout, tout = _outputs(FIXED_NET, {"q": q, "qv": qv, "g": g, "gv": gv})
    _same_tops(jout, tout)
    j = jr._fixed_ref_peritem(jnp.asarray(q), jnp.asarray(qv, jnp.int32),
                              jnp.asarray(g), jnp.asarray(gv, jnp.int32))
    t = tr._fixed_ref_peritem(torch.as_tensor(q),
                              torch.as_tensor(qv).to(torch.int32),
                              torch.as_tensor(g),
                              torch.as_tensor(gv).to(torch.int32))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[2][0].item() == 1e4
