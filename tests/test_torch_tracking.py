"""The port's tracking sources, social pooling and trajectory model against
the JAX package's on the CPU.

- TrackingWindowsSource / TrackingWindowsSocialSource
  (videovector_tpu_torch.data.tracking) on one VVR store written by the
  port: every batch bit for bit equal to the JAX package's sources' on the
  same store (the numpy arithmetic is a copy), and the same batch_axes.
- social_pooling: values within rtol 1e-5 / atol 1e-6, gradients within
  rtol 1e-4 / atol 1e-5.
- TrajectoryModel.loss (and its ade) within rtol 1e-5 / atol 1e-6 and the
  gradient of every param within rtol 1e-4 / atol 1e-5, with and without
  social pooling and with the conditional decoder, on the same numpy
  params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.data import tracking as jtrack
from videovector_tpu.models import trajectory as jtraj
from videovector_tpu.ops.social import social_pooling as jsocial
from videovector_tpu_torch.convert import params_from_jax, params_to_numpy
from videovector_tpu_torch.data import tracking as ttrack
from videovector_tpu_torch.data.records import RecordWriter
from videovector_tpu_torch.data.wire import Datum, TrackingWindow, TrackPositions
from videovector_tpu_torch.models import trajectory as ttraj
from videovector_tpu_torch.ops.social import social_pooling as tsocial

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-5
T_OBS, T_PRED = 6, 3


def _windows(rng, n=9, scene_feats=0):
    """Scenes of 1 to 5 constant-velocity tracks (one of none), with
    static scene features when asked."""
    out, tid = [], 0
    for s in range(n):
        k = 0 if s == 4 else 1 + (s * 3) % 5
        tracks = []
        for _ in range(k):
            start, vel = rng.rand(2) * 10, rng.randn(2) * 0.5
            ts = np.arange(T_OBS + T_PRED + 1)
            scene = (Datum(channels=scene_feats, height=1, width=1,
                           float_data=list(rng.randn(scene_feats)))
                     if scene_feats else None)
            tracks.append(TrackPositions(
                id=tid, x=list(start[0] + vel[0] * ts + 0.02 * rng.randn(ts.size)),
                y=list(start[1] + vel[1] * ts + 0.02 * rng.randn(ts.size)),
                cl=0, static_scene=scene))
            tid += 1
        out.append(TrackingWindow(observed_time=list(range(T_OBS)),
                                  prediction_time=list(range(T_OBS, T_OBS + T_PRED)),
                                  scene_id=s, track_positions=tracks))
    return out


@pytest.fixture
def store(tmp_path, rng):
    path = str(tmp_path / "tracks.vvr")
    with RecordWriter(path) as w:
        for i, win in enumerate(_windows(rng, scene_feats=2)):
            w.append(f"{i:08d}", win.encode())
    return path


CONFIGS = {
    "default": {},
    "no_encoder_bit": {"encoder_bit": False},
    "static_scene": {"use_static_scene": True, "track_scale": 0.5},
    "cap2": {"max_number_positions": 2},
    "no_labels": {"output_labels": False, "output_scene_ids": False},
}


@pytest.mark.parametrize("social", [False, True])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_sources_give_jax_batches_bit_for_bit(store, social, case):
    kw = dict(batch_size=7, temporal_observed_size=T_OBS,
              temporal_predicted_size=T_PRED, **CONFIGS[case])
    name = "TrackingWindowsSocialSource" if social else "TrackingWindowsSource"
    src = getattr(ttrack, name)(ttrack.TrackingWindowDataset.from_records(store),
                                ttrack.TrackingConfig(**kw))
    ref = getattr(jtrack, name)(jtrack.TrackingWindowDataset.from_records(store),
                                jtrack.TrackingConfig(**kw))
    assert src.batch_axes == ref.batch_axes
    assert src.feature_size == ref.feature_size
    for _ in range(6):
        got, want = src.next_batch(), ref.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # time-major: the batch is on axis 1 of every sequence top
    for k, axis in src.batch_axes.items():
        if k in got:
            assert got[k].shape[axis] == 7, k


def test_rolling_max_number_positions_cap():
    """A ROLLING cap (tracking_windows_data_layer.cpp:393-400): windows of
    3 tracks with cap 2 emit tracks 0, 1 (2 skipped), 10, 11, 20, 21, as
    JAX's source does."""
    windows = [TrackingWindow(
        observed_time=list(range(4)), prediction_time=[4, 5], scene_id=wi,
        track_positions=[TrackPositions(id=wi * 10 + t,
                                        x=[float(wi * 10 + t)] * 6,
                                        y=[0.0] * 6, cl=0) for t in range(3)])
        for wi in range(4)]
    kw = dict(batch_size=6, temporal_observed_size=4,
              temporal_predicted_size=2, max_number_positions=2)
    got = ttrack.TrackingWindowsSource(ttrack.TrackingWindowDataset(windows),
                                       ttrack.TrackingConfig(**kw))
    np.testing.assert_array_equal(got.next_batch()["scene_ids"],
                                  [0, 1, 10, 11, 20, 21])
    np.testing.assert_array_equal(got.next_batch()["scene_ids"],
                                  [30, 31, 0, 1, 10, 11])


def test_empty_windows_and_short_tracks_raise():
    empty = [TrackingWindow(observed_time=[0, 1], prediction_time=[2],
                            scene_id=i, track_positions=[]) for i in range(3)]
    cfg = ttrack.TrackingConfig(batch_size=2, temporal_observed_size=2,
                                temporal_predicted_size=1)
    with pytest.raises(ValueError, match="track_positions"):
        ttrack.TrackingWindowsSource(ttrack.TrackingWindowDataset(empty),
                                     cfg).next_batch()
    with pytest.raises(ValueError, match="empty tracking dataset"):
        ttrack.TrackingWindowDataset([])
    short = [TrackingWindow(scene_id=0, track_positions=[
        TrackPositions(id=0, x=[0.0, 1.0], y=[0.0, 1.0])])]
    cfg = ttrack.TrackingConfig(batch_size=1, temporal_observed_size=2,
                                temporal_predicted_size=1)
    with pytest.raises(ValueError, match="shorter"):
        ttrack.TrackingWindowsSource(ttrack.TrackingWindowDataset(short),
                                     cfg).next_batch()


def test_social_source_oversized_scenes():
    """Scenes larger than the batch are skipped (the batch still fills from
    the one that fits, padded slots marked invalid); a dataset of only
    oversized scenes raises."""
    def scene(wi, k):
        return TrackingWindow(
            observed_time=list(range(4)), prediction_time=[4, 5],
            scene_id=wi, track_positions=[
                TrackPositions(id=wi * 100 + t, x=[float(t)] * 6,
                               y=[0.0] * 6, cl=0) for t in range(k)])
    cfg = ttrack.TrackingConfig(batch_size=4, temporal_observed_size=4,
                                temporal_predicted_size=2)
    ds = ttrack.TrackingWindowDataset([scene(i, 9) for i in range(20)]
                                      + [scene(99, 2)])
    b = ttrack.TrackingWindowsSocialSource(ds, cfg).next_batch()
    assert b["is_valid"].sum() == 4
    np.testing.assert_array_equal(b["relations"], np.kron(
        np.eye(2), np.ones((2, 2))) - np.eye(4))
    big = ttrack.TrackingWindowDataset([scene(i, 9) for i in range(5)])
    with pytest.raises(ValueError, match="fits batch_size"):
        ttrack.TrackingWindowsSocialSource(big, cfg).next_batch()


@pytest.mark.parametrize("with_mean", [False, True])
def test_social_pooling_matches_jax(rng, with_mean):
    b, d, f = 5, 4, 6
    feats = rng.randn(b, d).astype(np.float32)
    rel = (rng.rand(b, b) > 0.4).astype(np.float32)
    np.fill_diagonal(rel, 0)
    w = rng.randn(2, f).astype(np.float32)
    bias = rng.randn(f).astype(np.float32)
    mean = rng.randn(b, 2).astype(np.float32) if with_mean else None
    cot = rng.randn(b, f).astype(np.float32)

    def jloss(x, w, bias):
        out = jsocial(x, jnp.asarray(rel), w, bias,
                      None if mean is None else jnp.asarray(mean))
        return jnp.sum(out * cot), out
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(bias))
    ts = [torch.tensor(a, requires_grad=True) for a in (feats, w, bias)]
    out = tsocial(ts[0], torch.as_tensor(rel), ts[1], ts[2],
                  None if mean is None else torch.as_tensor(mean))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    (out * torch.as_tensor(cot)).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=G_RTOL, atol=G_ATOL)


def _model_batch(rng, social: bool):
    """A batch of the social source (padded slots included) or the plain
    one, from fresh windows."""
    ds = jtrack.TrackingWindowDataset(_windows(rng))
    cfg = jtrack.TrackingConfig(batch_size=8, temporal_observed_size=T_OBS,
                                temporal_predicted_size=T_PRED)
    cls = (jtrack.TrackingWindowsSocialSource if social
           else jtrack.TrackingWindowsSource)
    return cls(ds, cfg).next_batch()


@pytest.mark.parametrize("use_social,conditional", [
    (False, False), (True, False), (True, True), (False, True)])
def test_trajectory_loss_and_grads_match_jax(rng, use_social, conditional):
    cfg = dict(feature_size=3, hidden=8, pool_feat_size=5,
               use_social=use_social, clip_threshold=0.5,
               conditional_decoder=conditional)
    jmodel = jtraj.TrajectoryModel(jtraj.TrajectoryConfig(**cfg))
    tmodel = ttraj.TrajectoryModel(ttraj.TrajectoryConfig(**cfg))
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    tp0 = tmodel.init(torch.Generator().manual_seed(2))
    assert jax.tree.map(np.shape, params_to_numpy(tp0)) == \
        jax.tree.map(np.shape, jp)
    batch = _model_batch(rng, social=use_social)
    if use_social:
        assert batch["is_valid"].min() == 0.0   # padded slots are in it

    (jl, jaux), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = jax.tree.map(lambda t: t.requires_grad_(True), params_from_jax(jp))
    tl, taux = tmodel.loss(tp, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux["ade"].item(), float(jaux["ade"]),
                               rtol=RTOL, atol=ATOL)
    tl.backward()
    # a param the loss does not read (the readout under the conditional
    # decoder): JAX's zeros, torch's None
    tg = jax.tree.map(lambda t: t.grad.numpy() if t.grad is not None
                      else np.zeros(t.shape, np.float32), tp)
    flat_t = jax.tree_util.tree_leaves_with_path(tg)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j)
    for path, g in flat_t:
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=str(path))
