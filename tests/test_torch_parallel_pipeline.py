"""videovector_tpu_torch/parallel/pipeline.py (the 2-stage enc-dec GPipe
schedule over the mesh's "model" axis) against the JAX package's
make_pp_loss_fn and reference_encdec_loss on the CPU.

4 gloo ranks as a (2, 2) mesh, rank r on JAX's device (r // 2, r % 2):
stage r % 2, data shard r // 2. feat 3, hidden 12, T = 6 + 4, B = 16,
M = 2 and 4, inputs from a numpy seed. Values within 1e-5 and gradients
within 1e-4 of their largest magnitude, against JAX's pipeline and its
one-device oracle, so a gradient counted on both stages (or not averaged
over "data") fails; the microbatch divisibility error and the 2-stage
check carry JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_cases as cases
from videovector_tpu.ops.recurrent import init_lstm_params
from videovector_tpu.parallel import make_mesh as jmake_mesh
from videovector_tpu.parallel.pipeline import (
    make_pp_loss_fn as jmake_pp_loss_fn,
    reference_encdec_loss as jreference,
)

MICRO = (2, 4)


def _params(rs, feat=3, hidden=12):
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    p = {"enc": init_lstm_params(ks[0], feat, hidden),
         "dec": init_lstm_params(ks[1], feat, hidden),
         "readout": {"w": rs.randn(hidden, 2).astype(np.float32) * 0.3,
                     "b": np.zeros((2,), np.float32)}}
    return jax.tree.map(np.asarray, p)


def _batch(rs, t_obs=6, t_pred=4, b=16, feat=3):
    cont_obs = np.ones((t_obs, b), np.float32)
    cont_obs[0] = 0
    return {"observed": rs.randn(t_obs, b, feat).astype(np.float32),
            "cont_obs": cont_obs,
            "predicted": rs.randn(t_pred, b, feat).astype(np.float32),
            "cont_pred": np.ones((t_pred, b), np.float32),
            "gt": rs.randn(t_pred, b, 2).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rs = np.random.RandomState(1701)
    params, batch = _params(rs), _batch(rs)
    out = cases.run(4, [("pipeline", dict(params=params, batch=batch,
                                          data_n=2, microbatches=MICRO))],
                    tmp_path_factory.mktemp("parallel_pipeline"),
                    timeout=120)
    return params, batch, [r[0] for r in out]


def _close(got, want, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        w = np.asarray(w)
        np.testing.assert_allclose(flat_g[path], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_matches_jax_and_the_one_device_oracle(ranks, m):
    params, batch, per_rank = ranks
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    pp = jmake_pp_loss_fn(mesh, num_microbatches=m)
    jl, jg = jax.jit(jax.value_and_grad(pp))(jp, jb)
    rl, rg = jax.jit(jax.value_and_grad(jreference))(jp, jb)
    i = MICRO.index(m)
    for out, _ in per_rank:
        loss, grads = out[i]
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        np.testing.assert_allclose(loss, float(rl), rtol=1e-5)
        _close(grads, jg, "vs JAX's pipeline")
        _close(grads, rg, "vs the oracle")


def test_pipeline_errors_carry_jax_messages(ranks):
    params, batch, per_rank = ranks
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as div:
        jmake_pp_loss_fn(mesh, num_microbatches=3)(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError) as stages:
        jmake_pp_loss_fn(jmake_mesh(data=4, model=1,
                                    devices=jax.devices()[:4]),
                         num_microbatches=1)
    for _, (e_div, e_stages) in per_rank:
        assert e_div == str(div.value)
        assert e_stages == str(stages.value)
