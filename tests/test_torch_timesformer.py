"""TimeSformer with divided space-time attention, the serving path's first
transformer backbone (models/timesformer.py), and what it forced below it,
on the CPU: the attention op's plain version (ops/attention.py) against a
naive softmax(Q K^T) V for both kinds of head, with and without the shared
class row; K1's GELU epilogue's plain version against F.gelu; the port's
forward and each half of a block against the benchmark's plain reference
(vvbench/reference/timesformer.py: vit.py's rearranges, the class row
repeated once a frame, its outputs averaged after proj) on seeded random
weights at D 64, 2 heads, 2 blocks, 4 frames of 32 x 32 (4 patches), MLP
256; `RetrievalPipeline(backbone="timesformer")` at the published widths
on a short clip against the reference's top-5; the spans and counters; the
residual stream over 12 blocks; and vvbench/flops_timesformer.py at the
published sizes.

Tolerances. f32 paths differ from the reference by summation order alone
(the port's (h w t) rows and one class row against vit.py's rearranges
and T class copies, the class mean before proj against after it): 1e-5 of
the largest magnitude. bf16 paths round every GEMM operand and output and
attention's output to bf16 through 2 blocks (12 in the pipeline's case):
they read a relative L2 gap of a few 1e-3 in the features, so 3e-2 holds
them, and fp8 operands read about 1e-1."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from videovector_tpu_torch.models import retrieval_pipeline as trp
from videovector_tpu_torch.models import timesformer as tt
from videovector_tpu_torch.ops import attention as ta
from videovector_tpu_torch.ops.hopper import matmul as k1
from videovector_tpu_torch.utils import timer
from vvbench import flops_timesformer as flops
from vvbench.drivers import serve_query, serve_timesformer
from vvbench.reference import fp8
from vvbench.reference import timesformer as ref

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1]
                     / "vvbench/configs/timesformer-l-retrieval.json")
                    .read_text())
SMALL_CFG = tt.TimeSformerConfig(dim=64, depth=2, heads=2, mlp_dim=256,
                                 crop=32, frames=4, kept_tokens=8)
# the reference's keys for the small model
SMALL = {**CONFIG, "dim": 64, "depth": 2, "heads": 2, "mlp_dim": 256,
         "crop": 32, "clip_frames": 4, "kept_tokens": 8, "image_hw": [40, 40],
         "feature_dim": 64, "embed_dim": 64}
# the published widths over a short clip: 2 frames of 32 x 32, 4 patches
SHORT = {**CONFIG, "image_hw": [40, 40], "crop": 32, "clip_frames": 2}


def _rel(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def _small(seed, dtype="float32"):
    net = tt.TimeSformer(tt.TimeSformerConfig(
        **{**SMALL_CFG.__dict__, "compute_dtype": dtype}))
    drawn = net.draw(torch.Generator().manual_seed(seed))
    return net, drawn, net.cast_weights(drawn)


def _clip(seed, n=1, t=4, size=32):
    return torch.randn((n, t, size, size, 3),
                       generator=torch.Generator().manual_seed(seed))


def _ncthw(x):
    return x.permute(0, 4, 1, 2, 3)


# -- the attention op's plain version ---------------------------------------

def _naive(q, k, v, scale):
    """softmax(q k^T * scale) v of one head of one sequence, in f64."""
    s = (q.double() @ k.double().T) * scale
    return torch.softmax(s, dim=-1) @ v.double()


@pytest.mark.parametrize("kind,extra", [("temporal", False),
                                        ("spatial", True),
                                        ("spatial", False)])
def test_attention_plain_against_naive_softmax(kind, extra):
    """Each head of each sequence, gathered by hand from the rows the
    geometry names, against softmax(Q K^T) V in f64: the temporal heads'
    contiguous T rows a patch, the spatial heads' rows a stride of T apart
    with (or without) the clip's class row in front of every frame's keys
    and queries. f32 qkv: within 1e-5 (summation order)."""
    clips, patches, frames, heads, hd = 2, 3, 4, 2, 8
    seqs = getattr(ta.Sequences, kind)(clips, patches, frames)
    if not extra:
        seqs = ta.Sequences(**{**seqs.__dict__, "extra_base": -1})
    rows = clips * (patches * frames + (kind == "spatial"))
    qkv = torch.randn((rows, 3 * heads * hd),
                      generator=torch.Generator().manual_seed(3))
    scale = hd ** -0.5
    out, cls = ta.attention(qkv, heads, seqs)
    assert out.shape == (rows, heads * hd) and out.dtype == torch.float32
    assert cls.shape == ((seqs.sequences if extra else 0), heads * hd)
    q, k, v = qkv.view(rows, 3, heads, hd).unbind(1)
    for s, toks in enumerate(seqs.token_rows()):
        toks = toks.tolist()
        if extra:
            toks = [seqs.extra_rows()[s].item()] + toks
        for h in range(heads):
            want = _naive(q[toks, h], k[toks, h], v[toks, h], scale)
            got = out[toks[int(extra):], h * hd:(h + 1) * hd]
            assert torch.allclose(got.double(), want[int(extra):], atol=1e-5)
            if extra:
                assert torch.allclose(cls[s, h * hd:(h + 1) * hd].double(),
                                      want[0], atol=1e-5)
    if kind == "temporal":
        # the temporal sequences are contiguous rows: each a patch of a clip
        assert seqs.token_rows()[1].tolist() == [4, 5, 6, 7]
    else:
        # frame 1 of clip 1: rows 1 + 13 + 1, then a stride of 4
        assert seqs.token_rows()[5].tolist() == [15, 19, 23]


def test_attention_bf16_rounds_its_output_once():
    """bf16 qkv: the plain version's outputs are its f32 outputs from the
    same bf16 operands, rounded once; the class outputs stay f32."""
    seqs = ta.Sequences.spatial(1, 4, 3)
    qkv = torch.randn((13, 3 * 64), generator=torch.Generator().manual_seed(4)
                      ).to(torch.bfloat16)
    out, cls = ta.attention(qkv, 1, seqs)
    want, want_cls = ta.attention(qkv.float(), 1, seqs)
    assert out.dtype == torch.bfloat16 and cls.dtype == torch.float32
    assert torch.equal(out[1:], want[1:].to(torch.bfloat16))
    assert torch.allclose(cls, want_cls, atol=1e-6)


def test_attention_refuses_rows_beyond_qkv_and_records_one_op():
    """A geometry that reads past qkv's rows raises; under torch.export the
    call is one `vvtpu::attention` node."""
    seqs = ta.Sequences.temporal(1, 2, 4)
    with pytest.raises(ValueError, match="reads rows"):
        ta.attention(torch.zeros((7, 6)), 1, seqs)

    class M(torch.nn.Module):
        def forward(self, qkv):
            return ta.attention(qkv, 1, seqs)[0]
    prog = torch.export.export(M(), (torch.randn(8, 6),))
    names = [str(n.target) for n in prog.graph.nodes]
    assert any("vvtpu.attention" in n for n in names), names


# -- K1's GELU epilogue -------------------------------------------------------

@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_gelu_epilogue_plain_against_f_gelu(out_dtype):
    """act = GELU with the exact erf, applied to the f32 sum plus bias
    before the one rounding: equal to F.gelu(approximate="none") in f32,
    rounded once; ReLU and GELU together raise."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((37, 48), generator=gen).to(torch.bfloat16)
    w = torch.randn((48, 29), generator=gen).to(torch.bfloat16)
    b = torch.randn(29, generator=gen)
    got = k1.matmul(x, w, b, fuse_gelu=True, out_dtype=out_dtype)
    acc = x.float() @ w.float() + b
    want = F.gelu(acc, approximate="none")
    assert torch.equal(got, want.to(out_dtype))
    assert not torch.equal(F.gelu(acc, approximate="tanh").to(out_dtype), got)
    assert torch.equal(k1.epilogue_plain(acc - b, b, False, out_dtype, True),
                       got)
    with pytest.raises(ValueError, match="ReLU or GELU"):
        k1.matmul(x, w, b, fuse_relu=True, fuse_gelu=True)


# -- the model against the reference ----------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_against_the_reference(dtype, tol):
    """The whole forward, two clips of 4 frames, against vit.py's on the
    same draws: the features (the final norm's class row) and the kept
    patch rows."""
    net, drawn, params = _small(6, dtype)
    x = _clip(7, n=2)
    kept, got = net.served_features(params, x)
    with torch.no_grad():
        stream = ref.forward_features(drawn, _ncthw(x), SMALL)
    rows = ref.kept_rows(4, 4, 8)
    want = torch.cat([stream[:, :1], stream[:, rows]], dim=1)
    assert got.shape == (2, 64) and kept.shape == (2, 9, 64)
    assert torch.equal(got, kept[:, 0])
    assert _rel(got, want[:, 0]) < tol and _rel(kept, want) < tol
    if dtype == "float32":
        assert (kept - want).abs().max() <= 1e-5 * want.abs().max()


def _stream_pair(seed):
    """A random stream (2 clips, 1 + 4 x 4 rows of 64) for the port and the
    reference, in the port's (h w t) order, which is vit.py's."""
    return torch.randn((2, 17, 64), generator=torch.Generator()
                       .manual_seed(seed))


def test_temporal_half_against_vit():
    """x[1:] + temporal_fc(proj(attention over each patch's 4 frames)),
    the port's in place on contiguous rows, vit.py's through its
    (b h w) t m rearranges: equal within f32 summation order."""
    net, drawn, params = _small(8)
    x = _stream_pair(9)
    got = x.clone()
    net._temporal_half(params["blocks"]["0"], got, 2, 4, 4)
    want = ref.temporal_half(x, drawn["blocks"]["0"], 2, 4, 2, SMALL)
    assert torch.equal(got[:, 0], x[:, 0])
    assert (got[:, 1:] - want).abs().max() <= 1e-5 * want.abs().max()


def test_spatial_half_against_vit():
    """[cls; xt] + [class outputs' mean; patch outputs]: the port's one
    class row through norm1 and qkv, its outputs averaged before proj,
    against vit.py's class row repeated once a frame and its outputs
    averaged after proj; equal within f32 summation order, and the class
    row differs from frame 0's output alone."""
    net, drawn, params = _small(10)
    x = _stream_pair(11)
    got = x.clone()
    net._spatial_half(params["blocks"]["1"], got, 2, 4, 4)
    want = ref.spatial_half(x, x[:, 1:], drawn["blocks"]["1"], 2, 4, 2,
                            SMALL)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    frame0 = x.clone()
    net._class_mean = lambda cls, n, t: cls.view(n, t, -1)[:, 0]
    net._spatial_half(params["blocks"]["1"], frame0, 2, 4, 4)
    assert (frame0[:, 0] - want[:, 0]).abs().max() > 1e-3


def test_mlp_half_against_vit():
    net, drawn, params = _small(12)
    x = _stream_pair(13)
    got = x.clone()
    net._mlp_half(params["blocks"]["0"], got)
    want = ref.mlp_half(x, drawn["blocks"]["0"], SMALL)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_a_reversed_clip_changes_the_features():
    """Time is modelled: the clip's frames last to first give other
    features (time_embed and the temporal heads), where a net blind to
    order would give the same up to f32 rounding (1e-6). The class row
    averages its spatial outputs over the frames, so it moves less than
    the patch rows."""
    net, _, params = _small(14)
    x = _clip(15)
    a, b = (net.served_features(params, c)[0] for c in (x, x.flip(1)))
    assert _rel(b[:, 0], a[:, 0]) > 1e-3
    assert _rel(b[:, 1:], a[:, 1:]) > 0.05


def test_fp8_operands_fail_the_bf16_tolerance():
    """The reference with fp8 operands (the benchmark's control) lies well
    outside the tolerance the bf16 port keeps."""
    _, drawn, _ = _small(16)
    x = _ncthw(_clip(17))
    want = ref.features(drawn, x, SMALL)
    got = ref.features(drawn, x, SMALL, q=fp8)
    assert _rel(got, want) > 3e-2


def test_defaults_are_the_configurations_widths_and_checks_the_clip():
    cfg = tt.TimeSformerConfig()
    assert (cfg.dim, cfg.depth, cfg.heads, cfg.mlp_dim, cfg.patch, cfg.crop,
            cfg.frames, cfg.ln_eps, cfg.qkv_bias, cfg.kept_tokens) == (
        CONFIG["dim"], CONFIG["depth"], CONFIG["heads"], CONFIG["mlp_dim"],
        CONFIG["patch"], CONFIG["crop"], CONFIG["clip_frames"],
        CONFIG["ln_eps"], CONFIG["qkv_bias"], CONFIG["kept_tokens"])
    assert cfg.dim // cfg.heads == CONFIG["head_dim"] == ta.HEAD_DIM
    assert tt.TimeSformer.pixel_mean == CONFIG["pixel_mean"]
    assert tt.TimeSformer.pixel_scale == pytest.approx(CONFIG["pixel_scale"])
    assert tt.INIT == {k: CONFIG["weights"][k] for k in tt.INIT}
    net, _, params = _small(18)
    with pytest.raises(ValueError, match="no interpolation"):
        net.forward(params, _clip(19, t=3))
    with pytest.raises(ValueError, match="32 x 32"):
        net.forward(params, _clip(19, size=48))


def test_kept_tokens_spread_over_every_frame():
    rows = tt.kept_tokens(196, 96, 64)
    assert torch.equal(1 + rows, ref.kept_rows(196, 96, 64))
    frames, patches = rows % 96, rows // 96
    assert len(set(rows.tolist())) == 64 and frames.max() >= 94
    assert len(set(patches.tolist())) == 64
    assert sorted(set(frames.tolist())) == sorted(
        {i * 96 // 64 for i in range(64)})


def test_init_casts_what_draw_draws():
    """`init` gives `draw`'s params with the linear weights in bf16 and
    everything else f32, bit for bit."""
    net = tt.TimeSformer(tt.TimeSformerConfig(
        **{**SMALL_CFG.__dict__, "compute_dtype": "bfloat16"}))
    got = net.init(torch.Generator().manual_seed(20))
    want = net.draw(torch.Generator().manual_seed(20))
    from videovector_tpu_torch.convert import leaves_with_paths
    pairs = dict(leaves_with_paths(want))
    for path, leaf in leaves_with_paths(got):
        src = pairs.pop(path)
        cast = path[-1] == "w"
        assert leaf.dtype == (torch.bfloat16 if cast else torch.float32)
        assert torch.equal(leaf, src.to(leaf.dtype))
    assert not pairs
    assert got["blocks"]["1"]["mlp"]["fc1"]["w"].shape == (64, 256)
    assert got["pos_embed"].shape == (5, 64)
    assert got["time_embed"].shape == (4, 64)


def test_the_residual_stream_stays_bounded_over_twelve_blocks():
    """The configuration's draws at the published widths and depth, on a
    2-frame clip of 32 x 32: each block's stream rows' RMS stays within a
    few times the embedding's, and the attention logits of both kinds in
    the first block spread by about 1 or more (softmax far from
    uniform)."""
    gen = torch.Generator().manual_seed(21)
    params = serve_timesformer.make_params(gen, SHORT, "cpu")["timesformer"]
    net = tt.TimeSformer(tt.TimeSformerConfig(crop=32,
                                              compute_dtype="float32"))
    x = torch.rand((1, 2, 32, 32, 3), generator=gen) * 4 - 2
    stream = net._embed(params, x, 1, 2, 2)
    rms = [float(stream.pow(2).mean().sqrt())]
    logits = {}
    real = ta.attention

    def spy(qkv, heads, seqs, scale=None):
        if seqs.kind not in logits:
            q, k = qkv.view(qkv.shape[0], 3, heads, 64)[:, :2].unbind(1)
            logits[seqs.kind] = float((torch.einsum(
                "qhd,khd->hqk", q, k) / 8).std())
        return real(qkv, heads, seqs, scale)
    tt.attention = spy
    try:
        for i in range(12):
            net._block(params["blocks"][str(i)], stream, 1, 4, 2)
            rms.append(float(stream.pow(2).mean().sqrt()))
    finally:
        tt.attention = real
    assert all(torch.isfinite(torch.tensor(rms)))
    assert max(rms) < 8 * rms[0], rms
    assert min(logits.values()) > 0.8, logits


# -- the pipeline ------------------------------------------------------------

def _pipe(dtype):
    return trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        image_hw=(40, 40), crop=32, embed_dim=768, compute_dtype=dtype,
        backbone="timesformer"), device="cpu")


def _params(seed, pipe):
    drawn = serve_timesformer.make_params(
        torch.Generator().manual_seed(seed), SHORT, "cpu")
    return drawn, {"timesformer": pipe.timesformer.cast_weights(
        drawn["timesformer"]), "tower": drawn["tower"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_query_with_the_timesformer_backbone(dtype):
    """Two clips of 2 frames in one query at the published widths, each
    with its own crop and mirror: one embedding and one top-5 row a clip,
    against the reference's scores; in f32 the embeddings within 1e-5 and
    the picks exact up to summation order, in bf16 the kept rows within the
    bf16 tolerance and the picks within 3e-3 in cosine."""
    pipe = _pipe(dtype)
    drawn, params = _params(22, pipe)
    frames = (serve_query.make_clips(torch.Generator().manual_seed(23), 4,
                                     (40, 40), "cpu"),
              torch.tensor([0, 8]), torch.tensor([5, 0]),
              torch.tensor([False, True]))
    rows = 40
    gallery, ids = serve_query.make_gallery(torch.Generator().manual_seed(24),
                                            rows, 768, "cpu")
    row_of_id = torch.full((rows,), -1, dtype=torch.long)
    row_of_id[ids.long()] = torch.arange(rows)
    assert pipe.backbone is pipe.timesformer
    assert pipe.embedder.cfg.feature_dim == 768
    feats: list = []
    want = ref.embed(drawn, *frames, SHORT, feats_out=feats)
    served = pipe.query(params, *frames, gallery, ids)
    assert served[0].shape == (2, 5) and pipe.features.shape == (2, 65, 768)
    nums = serve_query.compare(*served, ref.scores(want, gallery), row_of_id,
                               5)
    gap = serve_timesformer.feature_gap(pipe.features, feats[0])
    if dtype == "float32":
        got = pipe.embed_frames(params, *frames)
        assert torch.allclose(got, want, atol=1e-5, rtol=0)
        assert nums["pick_gap"] < 1e-5 and gap < 1e-4
    else:
        assert gap < 3e-2
        assert nums["pick_gap"] < 3e-3


def test_the_pipeline_names_the_backbone_and_its_input():
    pipe = _pipe("bfloat16")
    net = pipe.backbone
    assert pipe.backbone_key == "timesformer" and net.clip_input
    assert (net.pixel_mean, net.pixel_scale) == (114.75, 1 / 57.375)
    assert net.cfg.crop == 32 and net.cfg.dim == 768
    with pytest.raises(ValueError, match="'timesformer'"):
        trp.RetrievalPipeline(trp.RetrievalPipelineConfig(backbone="vit"),
                              device="cpu")


def test_blocks_and_attention_are_spans_and_layout_copies_counted():
    """Under the profiler the query's backbone span is
    `vvtpu.query.timesformer`, holding twelve `vvtpu.timesformer.block`
    spans with request ids 0..11, each with one `vvtpu.attn.temporal` and
    one `vvtpu.attn.spatial` span; 24 attention calls and no launch on the
    CPU, where `vvtpu.attn.layout_bytes` counts the plain version's copies:
    each kind's gather of its sequences' q, k and v (the class row once a
    frame) and scatter of their outputs, in bf16, over 12 blocks."""
    from torch.profiler import ProfilerActivity, profile
    pipe = _pipe("bfloat16")
    _, params = _params(25, pipe)
    frames = (serve_query.make_clips(torch.Generator().manual_seed(26), 2,
                                     (40, 40), "cpu"),
              torch.tensor([1]), torch.tensor([2]), torch.tensor([False]))
    gallery, ids = serve_query.make_gallery(torch.Generator().manual_seed(1),
                                            16, 768, "cpu")
    with timer.span("vvtpu.between"):
        pass
    with timer.tally() as counts, profile(activities=[ProfilerActivity.CPU]):
        pipe.query(params, *frames, gallery, ids)
    rec = timer.recorded()
    names = [s.name for s in rec.spans]
    (top,) = [i for i, n in enumerate(names) if n == "vvtpu.query.timesformer"]
    blocks = [i for i, s in enumerate(rec.spans)
              if s.name == "vvtpu.timesformer.block"]
    assert [rec.spans[i].req for i in blocks] == list(range(12))
    assert all(rec.spans[i].parent == top for i in blocks)
    for kind in ("temporal", "spatial"):
        spans = [s for s in rec.spans if s.name == "vvtpu.attn." + kind]
        assert len(spans) == 12
        assert sorted(s.parent for s in spans) == blocks
    p, t, d = 4, 2, 768
    temporal = p * t * 3 + p * t
    spatial = t * (p + 1) * 3 + t * p
    assert rec.counters["vvtpu.attn.layout_bytes"] == (
        12 * (temporal + spatial) * d * 2)
    assert counts["vvtpu.attn.layout_bytes"] == (
        rec.counters["vvtpu.attn.layout_bytes"])
    assert counts["vvtpu.attn.calls"] == 24
    assert not any(k.endswith("launches") for k in counts)


# -- vvbench/flops_timesformer.py -------------------------------------------

def test_flops_at_the_published_sizes():
    """121.3 M parameters; 4.760 TFLOP a 96-frame clip (2.38 T
    multiply-adds; 7.14 T over the paper's 3 test views); per block 377.8
    GFLOP of GEMMs, 5.55 of temporal and 11.45 of spatial attention; 86
    GEMMs; the GEMMs' tensor-core bound 4.61 ms, the attention's 0.83 ms of
    bytes (115.6 MB a kind a block)."""
    assert flops.parameters(CONFIG) == 121_326_336
    g = flops.gemms(1, CONFIG)
    assert len(g) == 86
    block = [x for x in g if x["name"].startswith("blocks/0/")]
    assert len(block) == 7
    assert sum(x["ops"] for x in block) / 1e9 == pytest.approx(377.8,
                                                               abs=0.1)
    a = flops.attentions(1, CONFIG)
    assert len(a) == 24
    assert a[0]["kind"] == "temporal" and a[0]["sequences"] == 196
    assert a[0]["ops"] / 1e9 == pytest.approx(5.55, abs=0.01)
    assert a[1]["kind"] == "spatial" and a[1]["tokens"] == 197
    assert a[1]["ops"] / 1e9 == pytest.approx(11.45, abs=0.01)
    assert a[0]["bytes"] / 1e6 == pytest.approx(115.6, abs=0.1)
    assert a[1]["bytes"] / 1e6 == pytest.approx(115.6, abs=0.5)
    ops = flops.clip_ops(CONFIG)
    assert ops / 1e12 == pytest.approx(4.760, abs=5e-4)
    assert 3 * ops / 2 / 1e12 == pytest.approx(7.14, abs=0.01)
    assert flops.attn_least_s(1, CONFIG) * 1e3 == pytest.approx(0.83,
                                                                abs=0.01)
    gemm_ops = sum(x["ops"] for x in g)
    assert gemm_ops / 989e12 * 1e3 == pytest.approx(4.61, abs=0.01)
    assert flops.k1_least_s(1, CONFIG) * 1e3 == pytest.approx(4.61,
                                                              abs=0.02)
    assert flops.query_least_s(1, 20_000, CONFIG) > ops / 989e12
