"""The on-device negative sampler in the port (data/device_sampler.py, the
data factory's `device_negatives` branch, SolverDriver's wiring) against
the JAX package's on the CPU.

The apply half takes JAX's own draws (its per-item choice without
replacement, accept mask and slots) and must give JAX's batch and
reservoir bit for bit, duplicate slots included: JAX's CPU scatter lets
the last offer win, and the port resolves duplicates to the last offer
before its scatter. The draws themselves come from a torch.Generator and
are checked as distributions (distinct within an item, the swap rate, no
swap at 0%). The seed buffer equals JAX's factory's bit for bit, the host
batch ships only target+context rows, every refusal of JAX's keeps its
type, one Net step's loss on JAX's draws is within 1e-5 of JAX's, device
negatives learn like host ones, and `vvtpu-torch train` runs the path.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config.textformat import Message as JMessage
from videovector_tpu.config.textformat import parse as jparse
from videovector_tpu.data import device_sampler as jds
from videovector_tpu.graph import Net as JNet
from videovector_tpu.graph.data_factory import make_data_source as jmake
from videovector_tpu.solver.driver import SolverDriver as JDriver
from videovector_tpu_torch import convert
from videovector_tpu_torch.config.textformat import Message, parse
from videovector_tpu_torch.data import device_sampler as tds
from videovector_tpu_torch.data.shots import (
    NegativeReservoir, SampledShotsConfig, ShotDataset, ShotVideo,
    VideoSampledShotsSource,
)
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.graph.data_factory import make_data_source
from videovector_tpu_torch.models.embedding import (
    VideoEmbeddingConfig, VideoEmbeddingModel,
)
from videovector_tpu_torch.solver import SolverConfig
from videovector_tpu_torch.solver.driver import SolverDriver
from videovector_tpu_torch.solver.solvers import init_solver_state, solver_update

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "projects", "videovec_embedding"))
from generate_net import emit  # noqa: E402

FEAT = 16


def _jax_draws(rng, max_size, batch, n, offered, swap):
    """JAX's draws inside train_batch_with_device_negatives, as tensors."""
    k_sample, k_update = jax.random.split(rng)
    keys = jax.random.split(k_sample, batch)
    ids = jax.vmap(lambda k: jax.random.choice(
        k, max_size, shape=(n,), replace=False))(keys)
    k1, k2 = jax.random.split(k_update)
    accept = jax.random.uniform(k1, (offered,)) < swap / 100.0
    slots = jax.random.randint(k2, (offered,), 0, max_size)
    return tds.StepDraws(*(torch.as_tensor(np.array(a)).to(dt) for a, dt in (
        (ids, torch.long), (accept, torch.bool), (slots, torch.long))))


@pytest.mark.parametrize("seed", range(4))
def test_apply_half_bit_equal_to_jax_with_duplicate_slots(seed):
    rs = np.random.RandomState(seed)
    max_size, b, c, n, d, swap = 7, 4, 3, 3, 5, 90.0
    buf = rs.randn(max_size, d).astype(np.float32)
    host = rs.randn(b, c, d).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    draws = _jax_draws(rng, max_size, b, n, b * c, swap)
    # 12 offers at 90% into 7 slots: several accepted offers share a slot
    acc = draws.slots[draws.accept]
    assert len(acc) > len(torch.unique(acc))
    jbatch, jres = jds.train_batch_with_device_negatives(
        jds.init_device_reservoir(buf, max_size, swap), rng,
        jnp.asarray(host), n)
    tbatch, tres = tds.apply_step(
        tds.init_device_reservoir(buf, max_size, swap, device="cpu"),
        torch.as_tensor(host), draws)
    np.testing.assert_array_equal(tbatch.numpy(), np.asarray(jbatch))
    np.testing.assert_array_equal(tres.buffer.numpy(), np.asarray(jres.buffer))


def test_duplicate_slots_take_the_last_offer():
    res = tds.DeviceReservoir(torch.zeros(4, 1), 50.0)
    feats = torch.arange(1.0, 7.0)[:, None]
    accept = torch.tensor([True, True, False, True, True, True])
    slots = torch.tensor([2, 2, 2, 0, 3, 0])
    out = tds.apply_update(res, feats, accept, slots).buffer[:, 0]
    assert out.tolist() == [6.0, 0.0, 2.0, 5.0]
    assert res.buffer.abs().sum() == 0     # the input stays as it was


def test_sample_negatives_distinct_within_item():
    buf = torch.arange(20.0).repeat_interleave(4).reshape(20, 4)
    res = tds.init_device_reservoir(buf, 20, 50, device="cpu")
    g = torch.Generator().manual_seed(0)
    negs = tds.sample_negatives(res, g, batch=6, n=10)
    assert negs.shape == (6, 10, 4)
    for row in negs[..., 0]:
        assert len(set(row.tolist())) == 10
    assert len(torch.unique(negs[..., 0])) > 10
    # uniform over the slots, as the host's Fisher-Yates top-n
    ids = tds.draw_negative_ids(g, 16, 600, 4).reshape(-1)
    freq = torch.bincount(ids, minlength=16).double() / ids.numel()
    assert (freq - 1 / 16).abs().max() < 0.02


def test_update_reservoir_swap_rate_and_zero_swap():
    g = torch.Generator().manual_seed(1)
    res = tds.init_device_reservoir(np.zeros((1000, 2), np.float32), 1000, 50,
                                    device="cpu")
    changed = int((tds.update_reservoir(res, g, torch.ones(400, 2))
                   .buffer[:, 0] != 0).sum())
    assert 120 < changed < 260   # ~400 * 0.5 = 200 swaps, minus collisions
    res0 = tds.init_device_reservoir(np.zeros((50, 2), np.float32), 50, 0,
                                     device="cpu")
    assert tds.update_reservoir(res0, g, torch.ones(50, 2)).buffer.abs() \
        .sum() == 0


# -- the product path: factory and driver --------------------------------------

def _records(tmp_path):
    path = str(tmp_path / "train.vvr")
    if not os.path.exists(path):
        rng = np.random.RandomState(0)
        videos = []
        for v in range(10):
            center = rng.randn(FEAT).astype(np.float32)
            feats = np.abs(center + 0.3 * rng.randn(8, FEAT).astype(np.float32))
            videos.append(ShotVideo(v + 1, np.arange(8, dtype=np.int32), feats))
        ShotDataset(videos).to_records(path)
    return path


def _solver(tmp_path, msg_cls=Message, **emit_kw):
    src = _records(tmp_path)
    net_path = str(tmp_path / "net.prototxt")
    with open(net_path, "w") as f:
        f.write(emit(src, src, batch=4, test_batch=2, negatives=4, embed=8,
                     buffer_size=16, device_negatives=True, **emit_kw))
    solver = msg_cls()
    for k, v in (("net", net_path), ("base_lr", 0.02), ("momentum", 0.9),
                 ("max_iter", 3), ("display", 1), ("random_seed", 7)):
        solver.add(k, v)
    return solver


def test_seed_buffer_and_host_batch_equal_jaxs(tmp_path):
    """The seed buffer is the reference's initial fill, bit for bit JAX's
    factory's; the host batch carries (B, C, D), while the Net was
    initialized at (B, C+N, D)."""
    td = SolverDriver(_solver(tmp_path), device="cpu").build()
    jd = JDriver(_solver(tmp_path, JMessage)).build()
    np.testing.assert_array_equal(td.device_negatives["buffer"],
                                  jd.device_negatives["buffer"])
    ds = ShotDataset.from_records(_records(tmp_path))
    want = NegativeReservoir(16, FEAT, 50, np.random.RandomState(7))
    want.fill(ds)
    np.testing.assert_array_equal(td.device_negatives["buffer"], want.buffer)
    assert {k: v for k, v in td.device_negatives.items() if k != "buffer"} \
        == {k: v for k, v in jd.device_negatives.items() if k != "buffer"}
    tb, jb = td.train_source.next_batch(), jd.train_source.next_batch()
    assert tb["data"].shape == (4, 5, FEAT)
    np.testing.assert_array_equal(tb["data"], jb["data"])
    assert tb["data"].nbytes == 4 * 9 * FEAT * 4 * 5 // 9
    assert {ln: {pn: tuple(t.shape) for pn, t in lp.items()}
            for ln, lp in td.params.items()} == \
        {ln: {pn: tuple(t.shape) for pn, t in lp.items()}
         for ln, lp in jd.params.items()}


def test_trains_and_threads_the_reservoir(tmp_path):
    td = SolverDriver(_solver(tmp_path), device="cpu").build()
    buf0 = td.device_negatives["buffer"].copy()
    res = td.train()
    losses = [m["loss"] for _, m in res.metrics_history]
    assert len(losses) == 3 and np.isfinite(losses).all()
    final = res.final_carry
    assert isinstance(final, torch.Tensor) and final.shape == buf0.shape
    assert not np.array_equal(final.numpy(), buf0)
    # each iteration's draws depend on (seed, iteration) alone: a second
    # build trains alike
    again = SolverDriver(_solver(tmp_path), device="cpu").build().train()
    assert [m["loss"] for _, m in again.metrics_history] == losses
    assert torch.equal(again.final_carry, final)


def _layer(src, **extra):
    fields = " ".join(f"{k}: {v}" for k, v in extra.items())
    return f"""
layers {{ name: "d" type: VIDEO_SAMPLED_SHOTS_DATA top: "data"
  video_sampled_shots_data_param {{
    source: "{src}" batch_size: 4 num_negative_samples: 4
    context_type: WINDOW context_size: 5 device_negatives: true {fields} }} }}
"""


@pytest.mark.parametrize("extra,match", [
    (dict(max_buffer_size=16, negative_swap_percentage=50,
          max_same_video_negs=2), "same-video"),
    ({}, "max_buffer_size")])
def test_factory_refusals_match_jax(tmp_path, extra, match):
    text = _layer(_records(tmp_path), **extra)
    for mk, prs in ((make_data_source, parse), (jmake, jparse)):
        with pytest.raises(ValueError, match=match):
            mk(prs(text).get_list("layers")[0], phase="TRAIN")


def _refusal(tmp_path, case, msg_cls):
    if case == "test_net":
        net = (parse if msg_cls is Message else jparse)(
            _layer(_records(tmp_path), max_buffer_size=16,
                   negative_swap_percentage=50)
            + 'layers { name: "sil" type: SILENCE bottom: "data" }')
        solver = msg_cls()
        for k, v in (("net_param", net), ("base_lr", 0.01), ("max_iter", 1),
                     ("test_iter", 1), ("test_interval", 1)):
            solver.add(k, v)
        return solver
    solver = _solver(tmp_path, msg_cls)
    if case == "role_major_data":
        solver.add("role_major_data", True)
    elif case == "snapshot_vis":
        solver.add("snapshot_vis", 2)
    elif case == "debug_info":
        solver.add("debug_info", True)
    return solver


@pytest.mark.parametrize("case,match", [
    ("role_major_data", "role_major_data"), ("test_net", "TRAIN-net feature"),
    ("snapshot_vis", "snapshot_vis"), ("debug_info", "debug_info")])
def test_driver_refusals_match_jax(tmp_path, case, match):
    with pytest.raises(ValueError, match=match):
        JDriver(_refusal(tmp_path, case, JMessage)).build()
    with pytest.raises(ValueError, match=match):
        SolverDriver(_refusal(tmp_path, case, Message), device="cpu").build()


def test_stateful_net_and_mesh_refusals(tmp_path):
    """A stateful net with device_negatives is refused, as in JAX; a mesh
    trains since item 11 (tests/test_torch_parallel_driver.py): only
    shard_gallery without one is refused."""
    td = SolverDriver(_solver(tmp_path), device="cpu").build()
    with pytest.raises(ValueError, match="requires mesh"):
        td.train(shard_gallery=True)
    td.train_net.layers.append(parse(
        'layers { name: "rnn" type: LSTM }').get_list("layers")[0])
    with pytest.raises(ValueError, match="stateful"):
        td.train()


def test_one_net_step_on_jaxs_draws_matches_jax(tmp_path):
    """The TRAIN Net's loss on the batch the apply half assembles from JAX's
    draws, against JAX's Net on JAX's own assembled batch (dropout off),
    within 1e-5; the updated reservoirs bit-equal."""
    src = _records(tmp_path)
    text = emit(src, src, batch=4, test_batch=2, negatives=4, embed=8,
                buffer_size=16, device_negatives=True, dropout=0.0)
    host = np.abs(np.random.RandomState(2).randn(4, 5, FEAT)).astype(np.float32)
    buf = np.abs(np.random.RandomState(3).randn(16, FEAT)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jfull, jres = jds.train_batch_with_device_negatives(
        jds.init_device_reservoir(buf, 16, 50), rng, jnp.asarray(host), 4)
    tfull, tres = tds.apply_step(
        tds.init_device_reservoir(buf, 16, 50, device="cpu"),
        torch.as_tensor(host), _jax_draws(rng, 16, 4, 4, 20, 50))
    np.testing.assert_array_equal(tres.buffer.numpy(), np.asarray(jres.buffer))
    vids = np.arange(4, dtype=np.float32)
    jnet = JNet(jparse(text), "TRAIN")
    jp, _ = jnet.init(jax.random.PRNGKey(0), {
        "data": jax.ShapeDtypeStruct((4, 9, FEAT), jnp.float32),
        "video_id": jax.ShapeDtypeStruct((4,), jnp.float32)})
    jloss = float(jnet.apply(jp, {"data": jfull, "video_id": jnp.asarray(vids)},
                             rng=jax.random.PRNGKey(1))[0])
    tnet = TNet(parse(text), "TRAIN")
    tnet.init(torch.Generator(), {"data": np.zeros((4, 9, FEAT), np.float32),
                                  "video_id": vids})
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tloss = float(tnet.apply(tp, {"data": tfull,
                                  "video_id": torch.as_tensor(vids)},
                             generator=torch.Generator())[0])
    assert abs(tloss - jloss) <= 1e-5 * max(1.0, abs(jloss))


def test_device_negatives_learn_like_host_negatives():
    """As tests/test_device_sampler_training.py: the two negative samplers
    land in the same loss region on the same data (the distributions are
    the same, the streams are not)."""
    rng = np.random.RandomState(0)
    dim, negs, iters = 24, 5, 120
    videos = []
    for v in range(15):
        center = rng.randn(dim).astype(np.float32)
        feats = np.abs(center + 0.4 * rng.randn(10, dim).astype(np.float32))
        videos.append(ShotVideo(v + 1, np.arange(10, dtype=np.int32), feats))
    ds = ShotDataset(videos)
    model = VideoEmbeddingModel(VideoEmbeddingConfig(
        feature_dim=dim, embed_dim=16, num_context=4, num_negatives=negs,
        margin=1.0, dropout_rate=0.0, compute_dtype="float32"))
    scfg = SolverConfig(base_lr=0.02, momentum=0.9)

    def run(device_side: bool):
        src = VideoSampledShotsSource(ds, SampledShotsConfig(
            batch_size=16, num_negative_samples=0 if device_side else negs,
            max_buffer_size=0 if device_side else 40,
            negative_swap_percentage=50, max_same_video_negs=0,
            context_type="WINDOW", context_size=5))
        res = tds.init_device_reservoir(
            np.concatenate([v.features for v in ds.videos]), 40, 50,
            device="cpu")
        g = torch.Generator().manual_seed(0)
        params = model.init(torch.Generator().manual_seed(0))
        state = init_solver_state(scfg, params)
        losses = []
        for _ in range(iters):
            data = torch.as_tensor(src.next_batch()["data"])
            if device_side:
                data, res = tds.train_batch_with_device_negatives(
                    res, g, data, negs)
            p = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
                 for k, v in params.items()}
            loss = model.loss(p, {"data": data}, train=False)[0]
            grads = torch.autograd.grad(
                loss, [t for v in p.values() for t in v.values()])
            it = iter(grads)
            g_tree = {k: {n: next(it) for n in v} for k, v in p.items()}
            params, state = solver_update(scfg, params, g_tree, state)
            losses.append(float(loss.detach()))
        return losses

    host, device = run(False), run(True)
    h_final, d_final = np.mean(host[-20:]), np.mean(device[-20:])
    assert np.isfinite(h_final) and np.isfinite(d_final)
    assert abs(h_final - d_final) < 0.15 * max(h_final, d_final)
    h_slope = h_final - np.mean(host[10:30])
    d_slope = d_final - np.mean(device[10:30])
    assert abs(h_slope - d_slope) < 0.1


def test_reachable_from_vvtpu_torch_train(tmp_path):
    from videovector_tpu_torch.tools.cli import main as cli_main
    spath = str(tmp_path / "solver.prototxt")
    with open(spath, "w") as f:
        f.write(_solver(tmp_path).dumps())
    assert cli_main(["train", "--solver", spath, "--cpu"]) == 0
