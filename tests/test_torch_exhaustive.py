"""The paper's exhaustive-shots training and fixed-gallery eval through the
port, against the JAX package on the CPU: the VIDEO_SHOTS_DATA and
FIXED_VIDEO_SHOT_TEST_DATA sources of the data factory, batch for batch
against JAX's `make_data_source` on the same store and seed (as
tests/test_data_factory.py::test_video_shots_exhaustive_factory and
tests/test_fixed_ref_net.py drive them), and the exhaustive net's TRAIN
step through the port's Net against JAX's Net.

The exhaustive net is generate_net.py's emit at D = E = 64, B = 8, its
TRAIN data layer swapped for VIDEO_SHOTS_DATA (WINDOW, context 4, 10
negatives: [target, 4 context, 10 negatives], the flagship's 15 roles)
and a RETRIEVAL_RANK_STATS over the context mean and the target and
negative embeddings added. Tolerances: batches bit for bit; the loss and
fc7's gradients within 1e-5 of JAX's unfused Net (1e-4 of its fused
one), the rank tops within 1e-6.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.config import parse as jparse
from videovector_tpu.graph import Net as JNet
from videovector_tpu.graph import data_factory as jfac
from videovector_tpu_torch import convert
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import records as trec
from videovector_tpu_torch.data import shots as tshots
from videovector_tpu_torch.data import wire as twire
from videovector_tpu_torch.graph import Net as TNet
from videovector_tpu_torch.graph import data_factory as tfac

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
D, E, B, NEG = 64, 64, 8, 10


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """30 videos of 3..9 shots (one of 1 shot, which WINDOW skips), D dims,
    written by the port."""
    tmp = tmp_path_factory.mktemp("exhaustive")
    rs = np.random.RandomState(11)
    videos = []
    for v in range(30):
        n = 1 if v == 4 else rs.randint(3, 10)
        center = rs.randn(D).astype(np.float32)
        feats = np.abs(center + 0.4 * rs.randn(n, D)).astype(np.float32)
        videos.append(tshots.ShotVideo(v + 1, np.arange(n, dtype=np.int32),
                                       feats))
    path = str(tmp / "shots.vvr")
    tshots.ShotDataset(videos).to_records(path)
    return path


def _layer(txt, parse):
    return parse(txt).get_list("layers")[0]


SHOTS = """
layers {{ name: "v" type: VIDEO_SHOTS_DATA top: "data" {vid_top}
  video_shots_data_param {{ source: "{src}" batch_size: {b}
    context_type: {ctype} context_size: {c} num_negative_samples: {neg}
    max_buffer_size: 40 negative_swap_percentage: 50
    max_same_video_negs: {same} }} }}
"""


@pytest.mark.parametrize("ctype,c,neg,same,vid_top", [
    ("WINDOW", 4, NEG, 6, ""), ("WINDOW", 2, 3, 0, 'top: "vid"'),
    ("PAIRWISE", 1, 0, 0, 'top: "vid"'), ("PAST", 3, 2, 1, 'top: "vid"')])
def test_video_shots_source_matches_jax(store, ctype, c, neg, same, vid_top):
    """Batch for batch over more than a pass of the store: the cursors
    (video, target, context) persist across batches as JAX's do, the
    WINDOW borders are zero-padded with the flag in the last feature."""
    txt = SHOTS.format(src=store, b=B, ctype=ctype, c=c, neg=neg, same=same,
                       vid_top=vid_top)
    jsrc = jfac.make_data_source(_layer(txt, jparse), seed=5)
    tsrc = tfac.make_data_source(_layer(txt, tparse), seed=5)
    assert isinstance(tsrc.source, tshots.VideoShotsSource)
    for _ in range(40):
        jb, tb = jsrc.next_batch(), tsrc.next_batch()
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    channels = 1 + (1 if ctype == "PAIRWISE" else c) + neg
    assert tb["data"].shape == (B, channels, D)


def test_window_needs_an_even_context(store):
    txt = SHOTS.format(src=store, b=B, ctype="WINDOW", c=3, neg=0, same=0,
                       vid_top="")
    with pytest.raises(ValueError, match="even"):
        tfac.make_data_source(_layer(txt, tparse))


def _gallery(path, rs, windows=3, pos=2, neg=1, d=8):
    with trec.RecordWriter(path) as w:
        for i in range(windows):
            def mk():
                return twire.Datum(float_data=rs.randn(d).astype(np.float32))
            w.append(str(i), twire.TestVideoShotWindows(
                video_id=i + 1, positive_shot_words=[mk() for _ in range(pos)],
                negative_shot_words=[mk() for _ in range(neg)]).encode())


FIXED = """
layers {{ name: "q" type: MEMORY_DATA top: "feats" top: "vids" }}
layers {{ name: "gallery" type: FIXED_VIDEO_SHOT_TEST_DATA
  top: "ref_feats" top: "ref_vids"
  fixed_video_shot_test_data_param {{ source: "{src}" }} }}
layers {{ name: "stats" type: RETRIEVAL_RANK_STATS_FIXED_REF
  bottom: "feats" bottom: "vids" bottom: "ref_feats" bottom: "ref_vids"
  top: "median_rank" top: "r1" top: "r5" top: "r10" top: "map" }}
"""


def test_fixed_gallery_net_matches_jax(tmp_path, rng):
    """tests/test_fixed_ref_net.py's net: the gallery source yields the
    same constant batch as JAX's (negatives labelled -1), and the rank
    tops through both Nets agree."""
    src = str(tmp_path / "gal.vvr")
    _gallery(src, rng)
    txt = FIXED.format(src=src)
    jn, tn = JNet(jparse(txt), "TEST"), TNet(tparse(txt), "TEST")
    layer = next(l for l in tn.layers
                 if l.get("type") == "FIXED_VIDEO_SHOT_TEST_DATA")
    tsrc = tfac.make_data_source(layer, phase="TEST")
    jgal = jfac.make_data_source(next(
        l for l in jn.layers if l.get("type") == "FIXED_VIDEO_SHOT_TEST_DATA"),
        phase="TEST").next_batch()
    gal = tsrc.next_batch()
    assert gal["ref_feats"].shape == (9, 8)
    np.testing.assert_array_equal(gal["ref_vids"],
                                  [1, 1, -1, 2, 2, -1, 3, 3, -1])
    for k in jgal:
        np.testing.assert_array_equal(gal[k], jgal[k])
        assert tsrc.next_batch()[k] is gal[k]        # a constant
    batch = {"feats": rng.randn(4, 8).astype(np.float32),
             "vids": np.array([1, 2, 3, 1], np.float32), **gal}
    _, jout = jn.apply({}, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tout = tn.apply({}, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("median_rank", "r1", "r5", "r10", "map"):
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-6)
    assert 0.0 <= tout["map"].item() <= 1.0
    assert tout["median_rank"].item() >= 1.0


# -- the exhaustive TRAIN net -------------------------------------------------

RANK_LAYERS = """
layers { name: "cand_concat" type: CONCAT bottom: "etn" %s top: "cands"
  concat_param { concat_dim: 0 } include: { phase: TRAIN } }
layers { name: "train_rank" type: RETRIEVAL_RANK_STATS bottom: "ctxn"
  bottom: "cands" top: "train_median_rank" top: "train_r1" top: "train_r5"
  top: "train_r10" top: "train_map"
  retrieval_rank_stats_param { compute_ap: true positive_size: 1
    negative_size: %d } include: { phase: TRAIN } }
"""


def exhaustive_net(train_src, test_src, **emit_kw):
    """generate_net.py's emit with its TRAIN data layer swapped for
    VIDEO_SHOTS_DATA (WINDOW, context 4 without the target) and the
    train-side RETRIEVAL_RANK_STATS added."""
    spec = importlib.util.spec_from_file_location(
        "generate_net", ROOT / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kw = dict(batch=B, embed=E, negatives=NEG, weight_std=0.1, dropout=0.0,
              buffer_size=40)
    kw.update(emit_kw)
    txt = mod.emit(train_src, test_src, **kw)
    swapped = re.sub(
        r"type: VIDEO_SAMPLED_SHOTS_DATA\n  top: \"data\"\n"
        r"  video_sampled_shots_data_param \{.*?\n  \}",
        'type: VIDEO_SHOTS_DATA\n  top: "data"\n'
        f'  video_shots_data_param {{ source: "{train_src}"\n'
        f'    batch_size: {kw["batch"]} context_type: WINDOW context_size: 4\n'
        f'    num_negative_samples: {kw["negatives"]} max_buffer_size: '
        f'{kw["buffer_size"]}\n'
        '    negative_swap_percentage: 50 max_same_video_negs: 6 }',
        txt, count=1, flags=re.S)
    assert swapped != txt
    negs = " ".join(f'bottom: "en{i}x"' for i in range(1, kw["negatives"] + 1))
    return swapped + RANK_LAYERS % (negs, kw["negatives"])


def test_exhaustive_train_step_matches_jax(store):
    """One TRAIN step of the exhaustive net on the factory's first batch:
    the loss, the outputs (the rank tops among them) and fc7's gradients
    through the port's Net (fused scoring, its default) against JAX's."""
    txt = exhaustive_net(store, "unused_test.vvr")
    layer = next(l for l in tparse(txt).get_list("layers")
                 if l.get("type") == "VIDEO_SHOTS_DATA")
    batch = tfac.make_data_source(layer, seed=3).next_batch()
    jbatch = jfac.make_data_source(next(
        l for l in jparse(txt).get_list("layers")
        if l.get("type") == "VIDEO_SHOTS_DATA"), seed=3).next_batch()
    np.testing.assert_array_equal(batch["data"], jbatch["data"])
    assert batch["data"].shape == (B, 1 + 4 + NEG, D)

    jn = JNet(jparse(txt), "TRAIN", fuse_scoring=False)
    tn = TNet(tparse(txt), "TRAIN")
    jp, _ = jn.init(jax.random.PRNGKey(0), {
        "data": jax.ShapeDtypeStruct(batch["data"].shape, jnp.float32)})
    tn.init(torch.Generator().manual_seed(0), batch)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))

    def jloss(p, net=jn):
        return net.apply(p, {"data": jnp.asarray(batch["data"])})
    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    p = convert.map_params(lambda t: t.clone().requires_grad_(), tp)
    tl, tout = tn.apply(p, {"data": torch.as_tensor(batch["data"])})
    tl.backward()
    assert tn._last_absorbed > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("w", "b"):
        g = np.asarray(jg["fc7"][k])
        np.testing.assert_allclose(p["fc7"][k].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())
    assert sorted(tout) == sorted(jout)
    for k in tout:
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ("train_median_rank", "train_r1", "train_map"):
        assert tout[k].item() == pytest.approx(float(jout[k]), abs=1e-6)
    assert 1.0 <= tout["train_median_rank"].item() <= 11 * B
    # JAX's default Net fuses the scoring head: the same math summed in
    # another order
    (jfl, _), jfg = jax.value_and_grad(
        lambda p: jloss(p, JNet(jparse(txt), "TRAIN")), has_aux=True)(jp)
    np.testing.assert_allclose(tl.item(), float(jfl), rtol=1e-4)
    g = np.asarray(jfg["fc7"]["w"])
    np.testing.assert_allclose(p["fc7"]["w"].grad.numpy(), g, rtol=1e-4,
                               atol=1e-4 * np.abs(g).max())


def test_new_losses_enter_the_displayed_outputs_as_jaxs_do(tmp_path):
    """A TRAIN net with EUCLIDEAN_LOSS (loss_weight 0.5), CONTRASTIVE_LOSS
    (its default weight 1) and ACCURACY (weight 0) beside the max-margin
    loss: the port's SolverDriver displays the same "Train net output"
    lines as JAX's, the weighted ones with " (* w = x loss)", and the same
    loss."""
    from test_torch_driver import Lines, _pair, write_mini_project
    mini = write_mini_project(tmp_path)
    Path(mini["net"]).write_text(Path(mini["net"]).read_text() + """
layers { name: "reg" type: EUCLIDEAN_LOSS bottom: "ctxn" bottom: "etn"
  top: "reg_loss" loss_weight: 0.5 include: { phase: TRAIN } }
layers { name: "pair" type: CONTRASTIVE_LOSS bottom: "ctxn" bottom: "en1n"
  bottom: "ns1" top: "pair_loss" include: { phase: TRAIN } }
layers { name: "acc" type: ACCURACY bottom: "negs" bottom: "ns1"
  top: "tp_acc" include: { phase: TRAIN } }
""")
    jd, td = _pair(mini, max_iter=2, display=1, test_interval=0,
                   test_iter=None)
    pat = re.compile(r"    Train net output #(\d+): (\S+) = (\S+)(.*)")
    lines = []
    for name, d in (("videovector_tpu", jd), ("videovector_tpu_torch", td)):
        with Lines(name) as out:
            res = d.train()
        lines.append([pat.match(l).groups() for l in out.lines
                      if pat.match(l)])
        assert res.metrics_history
    (jl, tl) = lines
    assert [(i, k) for i, k, _, _ in tl] == [(i, k) for i, k, _, _ in jl]
    for (_, k, jv, js), (_, _, tv, ts) in zip(jl, tl):
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5, err_msg=k)
        assert ts.startswith(js.split("=")[0]) and bool(ts) == bool(js), k
    weighted = {k: s for _, k, _, s in tl if s}
    assert weighted["reg_loss"].startswith(" (* 0.5 = ")
    assert weighted["pair_loss"].startswith(" (* 1 = ")
    assert "tp_acc" not in weighted
