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
        import videovector_tpu_torch
        import videovector_tpu_torch._build
        import videovector_tpu_torch.config
        import videovector_tpu_torch.config.textformat
        import videovector_tpu_torch.config.upgrade
        import videovector_tpu_torch.convert
        import videovector_tpu_torch.core.fillers
        import videovector_tpu_torch.data.records
        import videovector_tpu_torch.data.shots
        import videovector_tpu_torch.data.transformer
        import videovector_tpu_torch.data.wire
        import videovector_tpu_torch.models.embedding
        import videovector_tpu_torch.models.mednet
        import videovector_tpu_torch.models.retrieval_pipeline
        import videovector_tpu_torch.device
        import videovector_tpu_torch.metrics
        import videovector_tpu_torch.metrics.classification
        import videovector_tpu_torch.metrics.retrieval
        import videovector_tpu_torch.ops.activations
        import videovector_tpu_torch.ops.conv
        import videovector_tpu_torch.ops.hopper.conv_gemm
        import videovector_tpu_torch.ops.hopper.matmul
        import videovector_tpu_torch.ops.linear
        import videovector_tpu_torch.ops.losses
        import videovector_tpu_torch.ops.lrn
        import videovector_tpu_torch.ops.normalization
        import videovector_tpu_torch.ops.pooling
        import videovector_tpu_torch.solver
        import videovector_tpu_torch.solver.checkpoint
        import videovector_tpu_torch.solver.solvers
        import videovector_tpu_torch.solver.train
        import videovector_tpu_torch.utils.logging
        bad = [m for m in sys.modules if m == "jax" and sys.modules[m]
               or m.startswith(("jax.", "videovector_tpu.", "jaxlib"))
               or m == "videovector_tpu"]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
