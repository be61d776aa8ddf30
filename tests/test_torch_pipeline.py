"""The port's RetrievalPipeline (videovector_tpu_torch/models/
retrieval_pipeline.py) and VideoEmbeddingModel against the JAX package on
the CPU, at the small configuration of tests/test_retrieval_pipeline.py
(f32; params carried across with params_from_jax). Ids must be equal,
scores within atol 1e-5. Also: the port imports with JAX blocked, and the
pipeline runs on the card unless asked for the CPU."""

import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.data.transformer import TransformConfig as JaxTC
from videovector_tpu.data.transformer import sample_transform_params
from videovector_tpu.models import embedding as jemb
from videovector_tpu.models import mednet as jmed
from videovector_tpu.models import retrieval_pipeline as jrp
from videovector_tpu_torch.convert import params_from_jax
from videovector_tpu_torch.models import embedding as temb
from videovector_tpu_torch.models import mednet as tmed
from videovector_tpu_torch.models import retrieval_pipeline as trp

torch.set_num_threads(1)


def _tiny(pkg_rp, pkg_med, pkg_emb, layout):
    """The _tiny_pipeline configuration, built from either package (two
    convs here, the second grouped, so groups and LRN are on the path; the
    port's on the CPU)."""
    on_cpu = {"device": "cpu"} if pkg_rp is trp else {}
    p = pkg_rp.RetrievalPipeline(pkg_rp.RetrievalPipelineConfig(
        image_hw=(36, 36), crop=32, embed_dim=16, top_k=3,
        compute_dtype="float32", pixels_layout=layout), **on_cpu)
    p.mednet = pkg_med.MedNet(pkg_med.MedNetConfig(
        convs=(pkg_med.ConvSpec("conv1", 8, 5, stride=2, pool=True, lrn=True),
               pkg_med.ConvSpec("conv2", 8, 3, pad=1, group=2)),
        fc6=32, fc7=64, input_hw=(32, 32), compute_dtype="float32"))
    p.embedder = pkg_emb.VideoEmbeddingModel(pkg_emb.VideoEmbeddingConfig(
        feature_dim=64, embed_dim=16, dropout_rate=0.0,
        compute_dtype="float32"))
    return p


def _pair(layout):
    return (_tiny(jrp, jmed, jemb, layout), _tiny(trp, tmed, temb, layout))


def _frames(rng, n, layout):
    pix = rng.randint(0, 256, (n, 3, 36, 36)).astype(np.uint8)
    return pix if layout == "NCHW" else np.ascontiguousarray(
        pix.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_embed_gallery_query_match_jax(rng, layout):
    jp, tp = _pair(layout)
    jparams = jp.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    pix = _frames(rng, 6, layout)
    h, w, m = sample_transform_params(6, (36, 36), JaxTC(crop_size=32),
                                      train=True, rng=np.random.RandomState(0))
    jargs = (jnp.asarray(pix), jnp.asarray(h), jnp.asarray(w), jnp.asarray(m))

    ref = np.asarray(jp.embed_frames(jparams, *jargs))
    got = tp.embed_frames(tparams, torch.as_tensor(pix), h, w, m).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)

    vids = [np.array([1, 1, 2, 2, 3, 3])]
    jgal, jids = jp.build_gallery(jparams, [jargs], vids)
    tgal, tids = tp.build_gallery(tparams, [(torch.as_tensor(pix), h, w, m)],
                                  vids)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tgal.numpy(), np.asarray(jgal), atol=1e-5)

    jtop, jscores = jax.jit(jp.query)(jparams, *jargs, jgal, jids)
    ttop, tscores = tp.query(tparams, torch.as_tensor(pix), h, w, m, tgal, tids)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), atol=1e-5)


def test_query_ties_lower_index_first(rng):
    """Duplicate gallery rows score exactly equal: top-k takes the lower
    gallery index first, as lax.top_k does."""
    jp, tp = _pair("NCHW")
    jparams = jp.init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    pix = _frames(rng, 4, "NCHW")
    h, w, m = sample_transform_params(4, (36, 36), JaxTC(crop_size=32),
                                      train=False, rng=np.random.RandomState(0))
    base = rng.randn(3, 16).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    gallery = base[[0, 1, 0, 2, 1, 0]]                   # rows 0, 2, 5 equal
    ids = np.array([10, 11, 12, 13, 14, 15], np.int32)
    jtop, jscores = jp.query(jparams, jnp.asarray(pix), jnp.asarray(h),
                             jnp.asarray(w), jnp.asarray(m),
                             jnp.asarray(gallery), jnp.asarray(ids))
    ttop, tscores = tp.query(tparams, torch.as_tensor(pix), h, w, m,
                             torch.as_tensor(gallery), torch.as_tensor(ids))
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), atol=1e-5)
    for row in ttop.numpy():             # every row lists ties in id order
        for a, b in ((10, 12), (12, 15), (11, 14)):
            if a in row and b in row:
                assert list(row).index(a) < list(row).index(b)
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    vals, idx = trp.top_k_stable(scores, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]


def test_embedding_extract_matches_jax(rng):
    cfg = dict(feature_dim=24, embed_dim=12, compute_dtype="float32")
    jm = jemb.VideoEmbeddingModel(jemb.VideoEmbeddingConfig(**cfg))
    tm = temb.VideoEmbeddingModel(temb.VideoEmbeddingConfig(**cfg))
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    feats = rng.randn(5, 4, 24).astype(np.float32)
    feats[0] = -np.abs(feats[0])      # all-negative frames -> a zero row
    ref = np.asarray(jm.extract(jparams, jnp.asarray(feats)))
    got = tm.extract(tparams, torch.as_tensor(feats)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(
        tm.embed(tparams, torch.as_tensor(feats)).numpy(),
        np.asarray(jm.embed(jparams, jnp.asarray(feats))), atol=1e-5)
    # at train time the default dropout (0.9) needs a generator, as JAX's
    # embed needs an rng
    with pytest.raises(ValueError, match="generator"):
        tm.embed(tparams, torch.as_tensor(feats), train=True)


def test_init_shapes_match_jax():
    jp = jrp.RetrievalPipeline(jrp.RetrievalPipelineConfig(embed_dim=32))
    tp = trp.RetrievalPipeline(trp.RetrievalPipelineConfig(embed_dim=32),
                               device="cpu")
    jshapes = jax.eval_shape(jp.init, jax.random.PRNGKey(0))
    tparams = tp.init(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_pipeline_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                            device):
    """The default device is the card; without one, asking for it (by
    default or by name) raises, and nothing goes on on the CPU."""
    sig = inspect.signature(trp.RetrievalPipeline)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trp.RetrievalPipelineConfig(embed_dim=16)
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="is_available"):
        trp.RetrievalPipeline(cfg, **kw)
    assert trp.RetrievalPipeline(cfg, device="cpu").device == torch.device("cpu")


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["videovector_tpu"] = None
        import videovector_tpu_torch
        import videovector_tpu_torch._build
        import videovector_tpu_torch.config
        import videovector_tpu_torch.config.binproto
        import videovector_tpu_torch.config.proto_schema
        import videovector_tpu_torch.config.textformat
        import videovector_tpu_torch.config.upgrade
        import videovector_tpu_torch.convert
        import videovector_tpu_torch.core.fillers
        import videovector_tpu_torch.core.seeds
        import videovector_tpu_torch.data.generic
        import videovector_tpu_torch.data.device_sampler
        import videovector_tpu_torch.data.hdf5
        import videovector_tpu_torch.data.leveldbio
        import videovector_tpu_torch.data.lmdbio
        import videovector_tpu_torch.data.native
        import videovector_tpu_torch.data.netproto
        import videovector_tpu_torch.data.prefetch
        import videovector_tpu_torch.data.records
        import videovector_tpu_torch.data.shots
        import videovector_tpu_torch.data.tracking
        import videovector_tpu_torch.data.transformer
        import videovector_tpu_torch.data.weights
        import videovector_tpu_torch.data.wire
        import videovector_tpu_torch.models.embedding
        import videovector_tpu_torch.models.googlenet
        import videovector_tpu_torch.models.mednet
        import videovector_tpu_torch.models.retrieval_pipeline
        import videovector_tpu_torch.models.timesformer
        import videovector_tpu_torch.models.trajectory
        import videovector_tpu_torch.device
        import videovector_tpu_torch.graph
        import videovector_tpu_torch.graph.data_factory
        import videovector_tpu_torch.graph.fuse
        import videovector_tpu_torch.graph.layers
        import videovector_tpu_torch.graph.net
        import videovector_tpu_torch.metrics
        import videovector_tpu_torch.metrics.classification
        import videovector_tpu_torch.metrics.retrieval
        import videovector_tpu_torch.ops.activations
        import videovector_tpu_torch.ops.attention
        import videovector_tpu_torch.ops.collectives
        import videovector_tpu_torch.ops.sharding
        import videovector_tpu_torch.ops.conv
        import videovector_tpu_torch.ops.embedding
        import videovector_tpu_torch.ops.hopper.conv_gemm
        import videovector_tpu_torch.ops.hopper.matmul
        import videovector_tpu_torch.ops.linear
        import videovector_tpu_torch.ops.losses
        import videovector_tpu_torch.ops.lrn
        import videovector_tpu_torch.ops.normalization
        import videovector_tpu_torch.ops.pooling
        import videovector_tpu_torch.ops.quant
        import videovector_tpu_torch.ops.recurrent
        import videovector_tpu_torch.ops.reductions
        import videovector_tpu_torch.ops.social
        import videovector_tpu_torch.ops.topk
        import videovector_tpu_torch.parallel
        import videovector_tpu_torch.parallel.mesh
        import videovector_tpu_torch.parallel.multihost
        import videovector_tpu_torch.parallel.multihost_worker
        import videovector_tpu_torch.parallel.pipeline
        import videovector_tpu_torch.parallel.shard_map_dp
        import videovector_tpu_torch.parallel.shard_map_tp
        import videovector_tpu_torch.parallel.train
        import videovector_tpu_torch.solver
        import videovector_tpu_torch.solver.checkpoint
        import videovector_tpu_torch.solver.driver
        import videovector_tpu_torch.solver.solvers
        import videovector_tpu_torch.solver.train
        import videovector_tpu_torch.tools
        import videovector_tpu_torch.tools.cli
        import videovector_tpu_torch.tools.converters
        import videovector_tpu_torch.tools.dump
        import videovector_tpu_torch.tools.export_model
        import videovector_tpu_torch.tools.extract_features
        import videovector_tpu_torch.tools.make_tracking_data
        import videovector_tpu_torch.tools.parity
        import videovector_tpu_torch.tools.plot_training_stats
        import videovector_tpu_torch.tools.quantize
        import videovector_tpu_torch.tools.serving
        import videovector_tpu_torch.tools.upgrade_net_proto
        import videovector_tpu_torch.tools.vis_snapshot
        import videovector_tpu_torch.utils.logging
        import videovector_tpu_torch.utils.timer
        bad = [m for m in sys.modules
               if m in ("jax", "videovector_tpu") and sys.modules[m]
               or m.startswith(("jax.", "videovector_tpu.", "jaxlib"))]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _key_args(rng, n=4, offsets=torch.int64):
    """(params, pixels, h, w, mirror, gallery, ids) of the tiny port
    pipeline on the CPU."""
    tp = _tiny(trp, tmed, temb, "NHWC")
    params = tp.init(torch.Generator().manual_seed(0))
    pix = torch.as_tensor(_frames(rng, n, "NHWC"))
    h, w = (torch.as_tensor(rng.randint(0, 5, n), dtype=offsets)
            for _ in range(2))
    mirror = torch.as_tensor(rng.randint(0, 2, n) > 0)
    gallery = torch.nn.functional.normalize(torch.randn(20, 16), dim=1)
    return tp, [params, pix, h, w, mirror, gallery,
                torch.arange(20, dtype=torch.int32)]


def test_query_on_the_cpu_never_captures(rng):
    """On the CPU every query runs eagerly: no graph is kept, none is
    replayed, and a repeated query answers as a fresh pipeline's first."""
    from videovector_tpu_torch.utils import timer
    tp, args = _key_args(rng)
    first = trp.RetrievalPipeline(tp.cfg, device="cpu")
    first.mednet, first.embedder = tp.mednet, tp.embedder
    ref = first.query(*args)
    with timer.tally() as counts:
        outs = [tp.query(*args) for _ in range(3)]
    assert tp._graph is None
    assert "vvtpu.query.graph_replays" not in counts
    for ids, scores in outs:
        assert torch.equal(ids, ref[0]) and torch.equal(scores, ref[1])


def test_features_hold_the_last_queries_fc7(rng):
    """After a query `features` holds the backbone's features of its
    frames: CaffeNet's fc7, as MedNet's forward gives them on the
    transformed frames."""
    tp, args = _key_args(rng)
    assert tp.features is None
    tp.query(*args)
    params, pix, h, w, mirror = args[:5]
    want = tp.mednet.forward(params["mednet"], tp.transform(pix, h, w, mirror))
    assert torch.equal(tp.features, want)


@pytest.mark.parametrize("change, same", [
    ("nothing", True),
    ("another params dict of the same tensors", True),
    ("a weight updated in place", True),
    ("a new pixels tensor of the same shape", True),
    ("another gallery tensor", False),
    ("another params tensor", False),
    ("another frames shape", False),
    ("another offsets dtype", False),
])
def test_query_graph_key(rng, change, same):
    """The key a captured query is valid for: the same resident tensors
    (by address, wherever their dicts) and the same input layouts give
    the same key; another gallery or weight tensor, frames shape or
    offsets dtype another."""
    _, args = _key_args(rng)
    key = trp.query_graph_key(*args)
    params, pix, h, w, mirror, gallery, ids = args
    if change == "another params dict of the same tensors":
        params = {"mednet": dict(params["mednet"]),
                  "tower": dict(params["tower"])}
    elif change == "a weight updated in place":
        params["tower"]["w"].mul_(2.0)
    elif change == "a new pixels tensor of the same shape":
        pix = pix.clone()
    elif change == "another gallery tensor":
        gallery = gallery.clone()
    elif change == "another params tensor":
        params = {"mednet": params["mednet"],
                  "tower": {"w": params["tower"]["w"].clone(),
                            "b": params["tower"]["b"]}}
    elif change == "another frames shape":
        pix = torch.cat([pix, pix[:1]])
    elif change == "another offsets dtype":
        h, w = h.int(), w.int()
    got = trp.query_graph_key(params, pix, h, w, mirror, gallery, ids)
    assert (got == key) is same


@pytest.mark.parametrize("shape, k, want", [
    ((50, 1000), 5, (50, 5)), ((1, 20000), 5, (1, 5)), ((3, 4), 5, (3, 4)),
    ((2, 3, 40), 32, (2, 3, 32)), ((7,), 1, (1,))])
def test_top_k_rows_fake_gives_shapes_and_dtypes(shape, k, want):
    """The custom op's fake, which a capture and `torch.export` see: f32
    values and int64 indices of min(k, G) a row, on meta tensors and fake
    ones; a k above 32 or scores other than f32 raise there already."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from videovector_tpu_torch.ops import topk
    vals, idx = torch.ops.vvtpu.top_k_rows(torch.empty(shape, device="meta"),
                                           k)
    assert (vals.shape, vals.dtype, idx.shape, idx.dtype) == (
        want, torch.float32, want, torch.int64)
    with FakeTensorMode():
        vals, idx = topk.top_k_rows(torch.empty(shape), k)
        assert (vals.shape, vals.dtype, idx.dtype) == (want, torch.float32,
                                                       torch.int64)
    with pytest.raises(ValueError, match="0 to 32"):
        torch.ops.vvtpu.top_k_rows(torch.empty(shape, device="meta"), 33)
    with pytest.raises(TypeError, match="f32"):
        torch.ops.vvtpu.top_k_rows(
            torch.empty(shape, device="meta", dtype=torch.bfloat16), k)


def _tied_scores(rng, rows, cols):
    """Scores rounded to a few values, so that most of a row ties."""
    return torch.as_tensor(np.round(rng.randn(rows, cols) * 2) / 4,
                           dtype=torch.float32)


@pytest.mark.parametrize("k", [1, 5, 32])
def test_top_k_stable_on_the_cpu_is_lax_top_k_at_ties(rng, k):
    """On the CPU `top_k_stable` is `top_k_stable_plain`, bit for bit, and
    both give lax.top_k's values and indices on heavily tied rows with
    +-inf and NaN; at signed zeros they tie -0.0 with +0.0 and take the
    lower index first (XLA ranks +0.0 first)."""
    scores = _tied_scores(rng, 6, 300)
    scores[1] = 0.25                                       # a constant row
    scores[2, [3, 90, 200]] = torch.tensor([np.inf, -np.inf, np.nan])
    scores[3, 7] = np.nan
    vals, idx = trp.top_k_stable(scores, k)
    pvals, pidx = trp.top_k_stable_plain(scores, k)
    assert torch.equal(idx, pidx) and vals.numpy().tobytes() == (
        pvals.numpy().tobytes())
    jvals, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    zeros = torch.tensor([[-1.0, -0.0, 0.0, -0.0, 0.0, -2.0]])
    vals, idx = trp.top_k_stable(zeros, 5)
    assert idx.tolist() == [[1, 2, 3, 4, 0]]
    assert torch.signbit(vals).tolist() == [[True, False, True, False, True]]
    short = trp.top_k_stable(scores[:, :3], k)
    assert short[1].shape == (6, min(k, 3))


def test_a_cpu_query_counts_its_top_k_call(rng):
    """A query on the CPU counts one `vvtpu.topk.calls` and launches
    nothing."""
    from videovector_tpu_torch.utils import timer
    tp, args = _key_args(rng)
    with timer.tally() as counts:
        tp.query(*args)
    assert counts["vvtpu.topk.calls"] == 1
    assert "vvtpu.topk.launches" not in counts
