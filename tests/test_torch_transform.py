"""The port's on-device image transform (videovector_tpu_torch/data/
transformer.py) against the JAX make_batch_transform, on the CPU: both
layouts, the gather branch with mirror and mean, and the static center crop.
Exact arithmetic (uint8 - f32 mean) * scale, so tolerance rtol 1e-6."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.data.transformer import TransformConfig as JaxTransformConfig
from videovector_tpu.data.transformer import make_batch_transform as jax_mbt
from videovector_tpu.data.transformer import (
    sample_transform_params as jax_sample,
)
from videovector_tpu_torch.data.transformer import (
    TransformConfig, make_batch_transform, sample_transform_params,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("with_mean", [False, True])
def test_gather_mirror_mean_matches_jax(rng, layout, with_mean):
    mean = rng.rand(3, 10, 12).astype(np.float32) * 100 if with_mean else None
    kw = dict(crop_size=6, mirror=True, scale=0.5)
    pix = rng.randint(0, 256, size=(7, 3, 10, 12)).astype(np.uint8)
    if layout == "NHWC":
        pix = np.ascontiguousarray(pix.transpose(0, 2, 3, 1))
    h, w, m = sample_transform_params(7, (10, 12), TransformConfig(**kw),
                                      train=True, rng=np.random.RandomState(3))
    assert m.any() and not m.all()
    ref = jax.jit(jax_mbt(JaxTransformConfig(**kw), mean, (10, 12),
                          layout=layout))(jnp.asarray(pix), jnp.asarray(h),
                                          jnp.asarray(w), jnp.asarray(m))
    got = make_batch_transform(TransformConfig(**kw), mean, (10, 12),
                               layout=layout, device="cpu")(torch.as_tensor(pix), h, w, m)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_static_center_crop_matches_jax(rng, layout):
    mean = rng.rand(3, 9, 9).astype(np.float32) * 50
    pix = rng.randint(0, 256, size=(4, 3, 9, 9)).astype(np.uint8)
    if layout == "NHWC":
        pix = np.ascontiguousarray(pix.transpose(0, 2, 3, 1))
    f_jax = jax_mbt(JaxTransformConfig(crop_size=5), mean, (9, 9),
                    layout=layout)
    f = make_batch_transform(TransformConfig(crop_size=5), mean, (9, 9),
                             layout=layout, device="cpu")
    ref = f_jax(jnp.asarray(pix), 2, 1, None)
    got = f(torch.as_tensor(pix), 2, 1, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    # no crop: whole frame minus mean
    f_jax = jax_mbt(JaxTransformConfig(scale=2.0), mean, (9, 9), layout=layout)
    f = make_batch_transform(TransformConfig(scale=2.0), mean, (9, 9),
                             layout=layout, device="cpu")
    np.testing.assert_allclose(
        f(torch.as_tensor(pix), 0, 0, None).numpy(),
        np.asarray(f_jax(jnp.asarray(pix), 0, 0, None)), rtol=1e-6)


def test_sample_params_and_guards_match_jax():
    for train in (False, True):
        ours = sample_transform_params(
            9, (40, 30), TransformConfig(crop_size=20, mirror=True),
            train=train, rng=np.random.RandomState(5))
        ref = jax_sample(9, (40, 30), JaxTransformConfig(crop_size=20,
                                                         mirror=True),
                         train=train, rng=np.random.RandomState(5))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mirror requires crop_size"):
        make_batch_transform(TransformConfig(mirror=True), None, (8, 8),
                             device="cpu")
    f = make_batch_transform(TransformConfig(crop_size=4), None, (8, 8),
                             layout="NHWC", device="cpu")
    with pytest.raises(ValueError, match="pixels_layout"):
        f(torch.zeros(2, 3, 8, 8, dtype=torch.uint8), 0, 0, None)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_transform_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                             device):
    """The default device is the card; without one, building the transform
    for it raises rather than going on on the CPU."""
    sig = inspect.signature(make_batch_transform)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="is_available"):
        make_batch_transform(TransformConfig(crop_size=4), None, (8, 8), **kw)
    f = make_batch_transform(TransformConfig(crop_size=4), None, (8, 8),
                             layout="NHWC", device="cpu")
    assert f(torch.zeros(2, 8, 8, 3, dtype=torch.uint8), 2, 2,
             None).device == torch.device("cpu")
