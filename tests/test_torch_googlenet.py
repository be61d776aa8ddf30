"""GoogLeNet, the serving path's second backbone (models/googlenet.py), on
the CPU against the benchmark's plain reference
(vvbench/reference/googlenet.py: plain torch, f32, TF32 off) on seeded
random weights: a reduced-width net through `GoogLeNet.forward`, one
224 frame at BVLC's widths, `RetrievalPipeline(backbone="googlenet")`'s
query in f32 and bf16, K2's padded space-to-depth repack against a direct
conv, the graph engine's TEST forward of the same net through
`GoogLeNet.params_from_graph_engine`, the spans and the concatenation
counter, and vvbench/flops_googlenet.py against counts worked by hand.

Tolerances. f32 paths differ from the reference by summation order alone
(im2col GEMMs against F.conv2d): 1e-5 of the largest magnitude, or
relative L2. bf16 paths round every conv's output and the LRNs to bf16
(8 bits of mantissa) through 11 convs in depth: the reduced net reads a
relative L2 gap of about 3e-3 in its pool5 features and the full one
about 4e-3, so 2e-2 holds them with room and is well below what fp8
operands give (about 5e-2, vvbench's control)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from videovector_tpu_torch.models import googlenet as tg
from videovector_tpu_torch.models import retrieval_pipeline as trp
from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from videovector_tpu_torch.utils import timer
from vvbench import flops_googlenet
from vvbench.drivers import serve_googlenet
from vvbench.drivers import serve_query
from vvbench.reference import googlenet as ref

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1]
                     / "vvbench/configs/googlenet-retrieval.json").read_text())


def _reduced_table() -> dict:
    """The stem and the first two modules at BVLC's widths over 8, 3b
    ending its stage with the 3x3/2 pool: at 64 x 64 the map is 32 after
    conv1, 16 after pool1, 8 after pool2 and 4 after pool3, so pool5 is a
    4 x 4 average."""
    table = {"stem": {k: v // 8 for k, v in CONFIG["stem"].items()},
             "inceptions": [{k: (v // 8 if isinstance(v, int)
                                 and not isinstance(v, bool) else v)
                             for k, v in m.items()}
                            for m in CONFIG["inceptions"][:2]],
             "pool5_kernel": 4}
    assert table["inceptions"][1]["pool"]
    return table


REDUCED = _reduced_table()


def _config(table, dtype="float32") -> tg.GoogLeNetConfig:
    """The port's config of a table of widths as the benchmark writes it."""
    stem = table["stem"]
    mods = tuple(tg.InceptionSpec(m["name"], m["1x1"], m["3x3_reduce"],
                                  m["3x3"], m["5x5_reduce"], m["5x5"],
                                  m["pool_proj"], pool=m["pool"])
                 for m in table["inceptions"])
    return tg.GoogLeNetConfig(stem["conv1"], stem["conv2_reduce"],
                              stem["conv2"], mods, compute_dtype=dtype)


def test_the_port_defaults_to_the_configurations_widths():
    assert _config(CONFIG, "bfloat16") == tg.GoogLeNetConfig()


def _rel(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def _params(table, seed):
    """The benchmark's weights for `table` (xavier convs, biases 0.2 plus
    a gaussian, a gaussian tower) on the CPU."""
    cfg = {**CONFIG, **table}
    cfg["feature_dim"] = cfg["embed_dim"] = _config(table).feature_dim
    return serve_googlenet.make_params(torch.Generator().manual_seed(seed),
                                       cfg, "cpu"), cfg


def _net(table, dtype):
    return tg.GoogLeNet(_config(table, dtype))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_reduced_width_net_against_the_reference(dtype, tol):
    params, _ = _params(REDUCED, 1)
    x = torch.rand((3, 64, 64, 3), generator=torch.Generator().manual_seed(2)
                   ) * 255
    got = _net(REDUCED, dtype).forward(params["googlenet"], x)
    want = ref.features(params["googlenet"], x.permute(0, 3, 1, 2), REDUCED)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 60)
    assert _rel(got, want) < tol


def test_one_published_width_frame_against_the_reference():
    """All nine modules at BVLC's widths: the features are 1,024 wide and
    within summation order of the reference in f32."""
    params, _ = _params(CONFIG, 3)
    x = torch.rand((1, 224, 224, 3), generator=torch.Generator().manual_seed(4)
                   ) * 255
    net = _net(CONFIG, "float32")
    assert len(net.cfg.convs()) == 57 and net.cfg.feature_dim == 1024
    got = net.forward(params["googlenet"], x)
    want = ref.features(params["googlenet"], x.permute(0, 3, 1, 2), CONFIG)
    assert got.shape == (1, 1024)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _query_inputs(seed, n=3, rows=40):
    gen = torch.Generator().manual_seed(seed)
    frames = serve_query.make_clips(gen, n, CONFIG["image_hw"], "cpu")
    h = torch.tensor([0, 32, 7][:n])
    w = torch.tensor([5, 0, 32][:n])
    mirror = torch.tensor([False, True, True][:n])
    gallery, ids = serve_query.make_gallery(gen, rows, 1024, "cpu")
    row_of_id = torch.full((rows,), -1, dtype=torch.long)
    row_of_id[ids.long()] = torch.arange(rows)
    return (frames, h, w, mirror), gallery, ids, row_of_id


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_query_with_the_googlenet_backbone(dtype):
    """The pipeline's query against the reference's scores: in f32 the
    embeddings within 1e-5 and the picks exact up to summation order; in
    bf16 the pool5 features within the bf16 tolerance and the picks
    within 2e-3 in cosine (a relative gap of 4e-3 in a unit embedding
    moves a score against unit gallery rows in 1,024 dimensions by about
    4e-3 / 32 each)."""
    params, cfg = _params(CONFIG, 5)
    frames, gallery, ids, row_of_id = _query_inputs(6)
    pipe = trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        backbone="googlenet", crop=224, embed_dim=1024,
        compute_dtype=dtype), device="cpu")
    assert pipe.backbone is pipe.googlenet
    assert pipe.embedder.cfg.feature_dim == 1024
    feats: list = []
    want = ref.embed(params, *frames, cfg, feats_out=feats)
    served = pipe.query(params, *frames, gallery, ids)
    nums = serve_query.compare(*served, ref.scores(want, gallery), row_of_id,
                               5)
    # the served call's features, as the forward computes them
    got_feats = pipe.features
    assert torch.equal(got_feats, pipe.googlenet.forward(
        params["googlenet"], pipe.transform(*frames)))
    if dtype == "float32":
        got = pipe.embed_frames(params, *frames)
        assert torch.allclose(got, want, atol=1e-5, rtol=0)
        assert nums["pick_gap"] < 1e-5
    else:
        assert serve_googlenet.feature_gap(got_feats, feats[0]) < 2e-2
        assert nums["pick_gap"] < 2e-3


def test_pipeline_params_and_other_backbones():
    pipe = trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        backbone="googlenet", crop=224, embed_dim=1024), device="cpu")
    params = pipe.init(torch.Generator().manual_seed(0))
    assert set(params) == {"googlenet", "tower"}
    assert len(params["googlenet"]) == 57
    assert params["tower"]["w"].shape == (1024, 1024)
    caffe = trp.RetrievalPipeline(device="cpu")
    assert caffe.backbone is caffe.mednet and caffe.backbone_key == "mednet"
    assert pipe.features is None and caffe.features is None
    with pytest.raises(ValueError, match="backbone"):
        trp.RetrievalPipeline(trp.RetrievalPipelineConfig(backbone="vgg16"),
                              device="cpu")


@pytest.mark.parametrize("shape,k,stride,pad", [
    ((2, 224, 224, 3), 7, 2, 3),        # GoogLeNet's conv1: (224+6-7) % 2 = 1
    ((3, 31, 23, 3), 7, 2, 3),          # ragged, not square
    ((1, 20, 17, 3), 5, 3, 2),          # another stride and pad
    ((2, 227, 227, 3), 11, 4, 0),       # CaffeNet's conv1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_space_to_depth_against_a_direct_conv(shape, k, stride, pad,
                                                     dtype):
    """The repack, then the plain stride-1 unpadded conv, against the plain
    padded strided conv on the original operands (both sum in f32; 1e-5 of
    the largest magnitude: summation order). The repacked channels are
    rounded up to a 16-byte chunk of the dtype, the spare ones zero."""
    gen = torch.Generator().manual_seed(k + pad)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn((k, k, 3, 16), generator=gen) * 0.1).to(dtype)
    xs, ws = k2.space_to_depth(x, w, stride, pad)
    kb = -(-k // stride)
    oh = (shape[1] + 2 * pad - k) // stride + 1
    ow = (shape[2] + 2 * pad - k) // stride + 1
    chunk = 16 // x.element_size()
    e = -(-stride * stride * 3 // chunk) * chunk
    assert xs.shape == (shape[0], oh + kb - 1, ow + kb - 1, e)
    assert ws.shape == (kb, kb, e, 16)
    assert not xs[..., stride * stride * 3:].any()
    got = k2.conv2d_gemm_nhwc_plain(xs.float(), ws.float())
    want = k2.conv2d_gemm_nhwc_plain(x.float(), w.float(),
                                     stride=(stride, stride), pad=(pad, pad))
    assert got.shape == want.shape == (shape[0], oh, ow, 16)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _prototxt(table, batch, hw) -> str:
    """BVLC's deploy net, data to pool5/7x7_s1, at `table`'s widths, in
    the V1 layer format, with BVLC's layer and blob names and fillers."""
    out = [f'name: "GoogleNet"\ninput: "data"\ninput_dim: {batch}\n'
           f"input_dim: 3\ninput_dim: {hw}\ninput_dim: {hw}\n"]

    def layer(name, kind, bottoms, top, body=""):
        bs = "".join(f'bottom: "{b}" ' for b in bottoms)
        out.append(f'layers {{ name: "{name}" type: {kind} {bs}'
                   f'top: "{top}" {body}}}\n')

    def conv(name, bottom, num, k, stride=1, pad=0):
        layer(name, "CONVOLUTION", [bottom], name,
              f"convolution_param {{ num_output: {num} kernel_size: {k} "
              f"stride: {stride} pad: {pad} weight_filler {{ type: "
              f'"xavier" }} bias_filler {{ type: "gaussian" std: 0.1 }} }} ')
        layer(name.replace("/", "/relu_", 1) if "/" in name else
              "relu_" + name, "RELU", [name], name)
        return name

    def pool(name, bottom, kind, k, stride, pad=0):
        layer(name, "POOLING", [bottom], name,
              f"pooling_param {{ pool: {kind} kernel_size: {k} "
              f"stride: {stride} pad: {pad} }} ")
        return name

    def norm(name, bottom):
        layer(name, "LRN", [bottom], name,
              "lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } ")
        return name

    s = table["stem"]
    x = conv("conv1/7x7_s2", "data", s["conv1"], 7, 2, 3)
    x = norm("pool1/norm1", pool("pool1/3x3_s2", x, "MAX", 3, 2))
    x = conv("conv2/3x3_reduce", x, s["conv2_reduce"], 1)
    x = conv("conv2/3x3", x, s["conv2"], 3, 1, 1)
    x = pool("pool2/3x3_s2", norm("conv2/norm2", x), "MAX", 3, 2)
    stage = 3
    for m in table["inceptions"]:
        p = f"inception_{m['name']}/"
        tops = [conv(p + "1x1", x, m["1x1"], 1),
                conv(p + "3x3", conv(p + "3x3_reduce", x, m["3x3_reduce"], 1),
                     m["3x3"], 3, 1, 1),
                conv(p + "5x5", conv(p + "5x5_reduce", x, m["5x5_reduce"], 1),
                     m["5x5"], 5, 1, 2),
                conv(p + "pool_proj", pool(p + "pool", x, "MAX", 3, 1, 1),
                     m["pool_proj"], 1)]
        layer(p + "output", "CONCAT", tops, p + "output")
        x = p + "output"
        if m["pool"]:
            x = pool(f"pool{stage}/3x3_s2", x, "MAX", 3, 2)
            stage += 1
    k = table["pool5_kernel"]
    pool("pool5/7x7_s1", x, "AVE", k, 1)
    return "".join(out)


def test_graph_engine_params_map_onto_the_backbone():
    """The graph engine's f32 TEST forward of the reduced net's prototxt
    (CONVOLUTION, POOLING MAX and AVE, LRN, CONCAT) against
    `GoogLeNet.forward` on the engine's own params through
    `params_from_graph_engine`: within summation order (1e-5)."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    net = Net(parse(_prototxt(REDUCED, 2, 64)), "TEST")
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(8)
                   ) * 255
    net_params, _ = net.init(torch.Generator().manual_seed(9),
                             {"data": torch.empty(x.shape, device="meta")})
    blobs = net.apply(net_params, {"data": x}, return_blobs=True)[1]
    want = blobs["pool5/7x7_s1"].reshape(2, -1)
    params = tg.GoogLeNet.params_from_graph_engine(net_params)
    assert sorted(params) == sorted(n for n, *_ in _config(REDUCED).convs())
    got = _net(REDUCED, "float32").forward(
        params, x.permute(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 60)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_modules_are_spans_and_concatenations_are_counted():
    """Under the profiler the query's backbone span is
    `vvtpu.query.googlenet`, holding nine `vvtpu.inception` spans with
    request ids 0..8; `vvtpu.concat_bytes` is the modules' bf16 outputs,
    1,235,584 elements a frame (123.56 MB at 50 frames)."""
    from torch.profiler import ProfilerActivity, profile
    params, _ = _params(CONFIG, 10)
    frames, gallery, ids, _ = _query_inputs(11, n=1)
    pipe = trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        backbone="googlenet", crop=224, embed_dim=1024), device="cpu")
    with timer.span("vvtpu.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.query(params, *frames, gallery, ids)
    rec = timer.recorded()
    names = [s.name for s in rec.spans]
    assert "vvtpu.query.mednet" not in names
    (top,) = [i for i, n in enumerate(names) if n == "vvtpu.query.googlenet"]
    mods = [s for s in rec.spans if s.name == "vvtpu.inception"]
    assert [s.req for s in mods] == list(range(9))
    assert all(rec.spans[s.parent].name == "vvtpu.query.googlenet"
               for s in mods)
    assert rec.spans[top].req == pipe.queries
    assert rec.counters["vvtpu.concat_bytes"] == 2 * 1_235_584
    assert 50 * 2 * 1_235_584 == 123_558_400


# multiply-adds of one frame, worked by hand: output positions x output
# channels x taps x input channels
STEM_MACS = (112 * 112 * 64 * 49 * 3          # conv1/7x7_s2
             + 56 * 56 * 64 * 64              # conv2/3x3_reduce
             + 56 * 56 * 192 * 9 * 64)        # conv2/3x3


def _module_macs(hw, c, m):
    n1, r3, n3, r5, n5, pp = m
    return hw * hw * (c * n1 + c * r3 + 9 * r3 * n3 + c * r5 + 25 * r5 * n5
                      + c * pp)


def test_flops_by_hand():
    convs = flops_googlenet.googlenet_convs(50, CONFIG)
    assert len(convs) == 57 and convs[0]["name"] == "conv1/7x7_s2"
    # conv1 at 50 frames: 11.8 GFLOP
    assert convs[0]["ops"] == 2.0 * 50 * 112 * 112 * 64 * 147 == 11_801_395_200
    assert convs[0]["bytes"] == (50 * 224 * 224 * 3 * 2 + 147 * 64 * 2
                                 + 64 * 4 + 50 * 112 * 112 * 64 * 2)
    macs = STEM_MACS
    macs += _module_macs(28, 192, (64, 96, 128, 16, 32, 32))
    macs += _module_macs(28, 256, (128, 128, 192, 32, 96, 64))
    macs += _module_macs(14, 480, (192, 96, 208, 16, 48, 64))
    macs += _module_macs(14, 512, (160, 112, 224, 24, 64, 64))
    macs += _module_macs(14, 512, (128, 128, 256, 24, 64, 64))
    macs += _module_macs(14, 512, (112, 144, 288, 32, 64, 64))
    macs += _module_macs(14, 528, (256, 160, 320, 32, 128, 128))
    macs += _module_macs(7, 832, (256, 160, 320, 32, 128, 128))
    macs += _module_macs(7, 832, (384, 192, 384, 48, 128, 128))
    assert macs == 1_581_647_872
    assert flops_googlenet.frame_ops(CONFIG, tower=False) == 2.0 * macs
    assert flops_googlenet.frame_ops(CONFIG) == 2.0 * (macs + 1024 * 1024)
    # 158.2 GFLOP a query; its least time at the bf16 peak and the f32
    # scores against 20,000 rows at the f32 peak: 0.19 ms
    assert sum(c["ops"] for c in convs) == pytest.approx(158.16e9, rel=1e-4)
    assert flops_googlenet.query_least_s(50, 20_000, CONFIG) == pytest.approx(
        50 * 2.0 * (macs + 1024 * 1024) / 989e12
        + 2.0 * 50 * 20_000 * 1024 / 67e12)
    assert flops_googlenet.k2_least_s(50, CONFIG) * 1e3 == pytest.approx(
        0.2905, abs=1e-3)
