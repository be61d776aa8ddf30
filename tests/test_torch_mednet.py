"""The port's MedNet (videovector_tpu_torch/models/mednet.py) and the ops it
runs (pooling geometry, LRN window sum) against the JAX package on the CPU,
in f32, with numpy-seeded weights carried across by params_from_jax.

The full-width test runs CaffeNet's conv geometry at a 227 crop (batch 2,
fc6 = fc7 = 64): it is the one that catches the ceil-mode pool chain
55 -> 27 -> 13 -> 6 and the HWC flatten before fc6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.models.mednet import MedNet as JaxMedNet
from videovector_tpu.models.mednet import MedNetConfig as JaxMedNetConfig
from videovector_tpu.ops.lrn import channel_window_sum as jax_cws
from videovector_tpu.ops.pooling import _pool_geometry as jax_geom
from videovector_tpu.ops.pooling import max_pool as jax_max_pool
from videovector_tpu_torch.convert import params_from_jax
from videovector_tpu_torch.core.fillers import gaussian_fill
from videovector_tpu_torch.models.mednet import (
    CAFFENET_CONVS, MedNet, MedNetConfig,
)
from videovector_tpu_torch.ops.lrn import channel_window_sum
from videovector_tpu_torch.ops.pooling import _pool_geometry, max_pool

torch.set_num_threads(1)


def _numpy_params(rng, convs, fc6, fc7, flat):
    """He-scaled weights so activations stay O(1) through the stack."""
    params, c_in = {}, 3
    for s in convs:
        fan_in = s.kernel * s.kernel * c_in // s.group
        params[s.name] = {
            "w": (rng.randn(s.kernel, s.kernel, c_in // s.group, s.num_output)
                  * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": (rng.randn(s.num_output) * 0.1).astype(np.float32)}
        c_in = s.num_output
    for name, n_in, n_out in (("fc6", flat, fc6), ("fc7", fc6, fc7)):
        params[name] = {
            "w": (rng.randn(n_in, n_out) * np.sqrt(2.0 / n_in)).astype(np.float32),
            "b": (rng.randn(n_out) * 0.1).astype(np.float32)}
    return params


def test_caffenet_geometry_forward_matches_jax(rng):
    cfg_kw = dict(fc6=64, fc7=64, compute_dtype="float32")
    jnet = JaxMedNet(JaxMedNetConfig(**cfg_kw))
    net = MedNet(MedNetConfig(**cfg_kw))
    assert net._spatial_out() == jnet._spatial_out() == 6
    params = _numpy_params(rng, CAFFENET_CONVS, 64, 64, 6 * 6 * 256)
    images = (rng.randn(2, 227, 227, 3) * 50).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_jax(params)
    for upto in ("fc6", "fc7"):
        ref = np.asarray(jnet.forward(jparams, jnp.asarray(images), upto=upto))
        got = net.forward(tparams, torch.as_tensor(images), upto=upto).numpy()
        assert got.shape == ref.shape == (2, 64)
        # f32 on both sides; sums of up to 9216 terms in another order
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
        assert np.abs(ref).max() > 1e-2   # the comparison is not vacuous


def test_init_shapes_match_jax():
    cfg = JaxMedNetConfig(fc6=32, fc7=16)
    jshapes = jax.tree.map(lambda a: a.shape,
                           JaxMedNet(cfg).init(jax.random.PRNGKey(0)))
    params = MedNet(MedNetConfig(fc6=32, fc7=16)).init(
        torch.Generator().manual_seed(0))
    tshapes = {k: {n: tuple(t.shape) for n, t in v.items()}
               for k, v in params.items()}
    assert tshapes == jshapes
    assert abs(params["conv3"]["w"].std().item() - 0.01) < 1e-3
    assert params["fc6"]["w"].is_contiguous()


def test_gaussian_fill_moments():
    g = torch.Generator().manual_seed(0)
    x = gaussian_fill(g, (200, 300), mean=1.0, std=0.5)
    assert x.dtype == torch.float32
    assert abs(x.mean().item() - 1.0) < 0.01 and abs(x.std().item() - 0.5) < 0.01
    again = gaussian_fill(torch.Generator().manual_seed(0), (200, 300),
                          mean=1.0, std=0.5)
    assert torch.equal(x, again)


@pytest.mark.parametrize("size,k,s,p", [(55, 3, 2, 0), (27, 3, 2, 0),
                                        (13, 3, 2, 0), (8, 3, 2, 1),
                                        (10, 2, 3, 1)])
def test_pool_geometry_and_max_pool_match_jax(rng, size, k, s, p):
    assert _pool_geometry(size, size + 1, (k, k), (s, s), (p, p)) == \
        jax_geom(size, size + 1, (k, k), (s, s), (p, p))
    x = rng.randn(2, 3, size, size + 1).astype(np.float32)
    ref = np.asarray(jax_max_pool(jnp.asarray(x), kernel=(k, k),
                                  stride=(s, s), pad=(p, p)))
    got = max_pool(torch.as_tensor(x), kernel=(k, k), stride=(s, s),
                   pad=(p, p))
    np.testing.assert_array_equal(got.numpy(), ref)
    nhwc = max_pool(torch.as_tensor(x.transpose(0, 2, 3, 1)), kernel=(k, k),
                    stride=(s, s), pad=(p, p), layout="NHWC")
    np.testing.assert_array_equal(nhwc.numpy().transpose(0, 3, 1, 2), ref)


@pytest.mark.parametrize("axis,local_size", [(3, 5), (1, 5), (3, 3)])
def test_channel_window_sum_matches_jax(rng, axis, local_size):
    x = rng.rand(2, 7, 4, 9).astype(np.float32)
    ref = np.asarray(jax_cws(jnp.asarray(x), axis, local_size))
    got = channel_window_sum(torch.as_tensor(x), axis, local_size).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
