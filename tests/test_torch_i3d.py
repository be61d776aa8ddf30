"""I3D, the serving path's first clip backbone (models/i3d.py), and what it
forced below it, on the CPU: TF's SAME pads (`same_pads`), K2's depth
route's plain version (`conv3d_gemm_ndhwc`) against F.conv3d, the 3D
space-to-depth repack against a direct conv, the NDHWC max pool's plain
version against a window-by-window maximum, `I3D.forward` at published
widths against the benchmark's plain reference (vvbench/reference/i3d.py:
plain torch, f32, BatchNorm unfolded) on seeded random weights,
`RetrievalPipeline(backbone="i3d")`'s query against the reference's
top-5, the spans and counters, and vvbench/flops_i3d.py against counts
worked by hand.

Tolerances. f32 paths differ from the reference by summation order alone
(im2col GEMMs against F.conv3d, the fold against BatchNorm applied after
the conv): 1e-5 of the largest magnitude, or relative L2. bf16 paths
round every conv's output to bf16 through 21 convs in depth: 16 frames
at 64 x 64 read a relative L2 gap of about 7e-3 in the features, so 2e-2
holds them and lies below what fp8 operands give (about 8e-2)."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from videovector_tpu_torch.models import i3d as ti
from videovector_tpu_torch.models import retrieval_pipeline as trp
from videovector_tpu_torch.ops import pooling
from videovector_tpu_torch.ops.conv import same_pads
from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from videovector_tpu_torch.utils import timer
from vvbench import flops_i3d
from vvbench.drivers import serve_i3d, serve_query
from vvbench.reference import i3d as ref

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1]
                     / "vvbench/configs/i3d-retrieval.json").read_text())
# the published widths over a small clip: 16 frames of 64 x 64 end as a
# 2 x 2 x 2 map, whose head window is the whole map
SMALL = {**CONFIG, "image_hw": [72, 72], "crop": 64, "clip_frames": 16,
         "head_pool": [2, 2, 2]}


@pytest.mark.parametrize("n,k,s,want", [
    (250, 7, 2, (2, 3)),      # Conv3d_1a over the clip: 125 frames
    (224, 7, 2, (2, 3)),      # and over the crop: 112
    (112, 3, 2, (0, 1)),      # MaxPool3d_2a: 56
    (125, 1, 1, (0, 0)),      # its frames
    (125, 3, 1, (1, 1)),      # a module's 3x3x3 conv or pool
    (125, 3, 2, (1, 1)),      # MaxPool3d_4a over time: 63
    (28, 3, 2, (0, 1)),       # and over space: 14
    (63, 2, 2, (0, 1)),       # MaxPool3d_5a over time: 32
    (14, 2, 2, (0, 0)),       # and over space: 7
])
def test_same_pads(n, k, s, want):
    assert same_pads(n, k, s) == want == ref.same_pads(n, k, s)
    assert (n + sum(want) - k) // s + 1 == -(-n // s)


def _rel(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def _conv_case(seed, shape, kernel, c_out, dtype):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn((*kernel, shape[-1], c_out), generator=gen) * 0.2
         ).to(dtype)
    b = torch.randn(c_out, generator=gen)
    return x, w, b


def _conv3d_direct(x, w, b, stride, pad):
    """F.conv3d in f32 over x padded by pad ((before, after) per axis)."""
    (pt, pt1), (ph, ph1), (pw, pw1) = pad
    xp = F.pad(x.float().permute(0, 4, 1, 2, 3), (pw, pw1, ph, ph1, pt, pt1))
    y = F.conv3d(xp, w.float().permute(4, 3, 0, 1, 2), b, stride=stride)
    return y.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("kernel,stride,pad", [
    ((1, 1, 1), (1, 1, 1), ((0, 0),) * 3),
    ((2, 2, 2), (2, 2, 2), ((0, 1), (0, 1), (0, 0))),
    ((3, 3, 3), (1, 1, 1), ((1, 1),) * 3),
    ((3, 3, 3), (2, 2, 2), ((1, 1), (0, 1), (1, 0))),
    ((7, 7, 7), (2, 2, 2), ((2, 3),) * 3),
    ((3, 1, 1), (1, 2, 1), ((2, 0), (0, 0), (0, 0))),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_plain_against_f_conv3d(kernel, stride, pad, dtype):
    """K2's depth route's plain version (im2col in (d, i, j, c) order and
    one f32 matmul) against F.conv3d over an explicit pad: the f32 sums
    within summation order (1e-5 of the largest), and with the epilogue
    (bias, ReLU, a bf16 output) within one bf16 step of rounding the
    direct sum so."""
    x, w, b = _conv_case(sum(kernel) + stride[0], (2, 9, 11, 10, 8), kernel,
                         16, dtype)
    got = k2.conv3d_gemm_ndhwc_plain(x, w, stride=stride, pad=pad)
    want = _conv3d_direct(x, w, None, stride, pad)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    got = k2.conv3d_gemm_ndhwc(x, w, b, stride=stride, pad=pad,
                               fuse_relu=True, out_dtype=torch.bfloat16)
    want = k2.conv_epilogue_plain(_conv3d_direct(x, w, None, stride, pad), b,
                                  True, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert (got.float() - want.float()).abs().max() <= (
        2 ** -7 * want.float().abs().max())


def test_a_kernel_one_frame_deep_folds_the_frames_into_the_batch():
    """A 1x3x3 conv with no frame pads is the 2D conv of the frames as a
    batch, and the 1x1x1 convs of I3D likewise (the 2D route)."""
    x, w, b = _conv_case(3, (2, 5, 8, 8, 8), (1, 3, 3), 16, torch.float32)
    got = k2.conv3d_gemm_ndhwc(x, w, b, pad=((0, 0), (1, 1), (1, 1)),
                               fuse_relu=True)
    want = k2.conv2d_gemm_nhwc_plain(x.reshape(10, 8, 8, 8), w[0], b,
                                     pad=(1, 1), fuse_relu=True)
    assert torch.equal(got, want.reshape(2, 5, 8, 8, 16))


@pytest.mark.parametrize("shape,k,stride,pad", [
    ((1, 16, 64, 64, 3), 7, 2, ((2, 3),) * 3),          # I3D's conv1, small
    ((2, 9, 13, 11, 3), 7, 2, ((2, 3), (2, 3), (2, 3))),  # ragged
    ((1, 7, 10, 9, 3), 5, 3, ((1, 2), (2, 2), (0, 1))),   # another stride
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_space_to_depth_3d_against_a_direct_conv(shape, k, stride, pad,
                                                 dtype):
    """The 3D repack, then the plain stride-1 unpadded conv, against the
    plain padded strided conv on the original operands (both sum in f32;
    1e-5 of the largest magnitude). The repacked channels are rounded up to
    a 16-byte chunk of the dtype, the spare ones zero."""
    gen = torch.Generator().manual_seed(k + stride)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn((k, k, k, 3, 16), generator=gen) * 0.1).to(dtype)
    xs, ws = k2.space_to_depth_3d(x, w, stride, pad)
    kb = -(-k // stride)
    out = [(n + b + a - k) // stride + 1
           for n, (b, a) in zip(shape[1:4], pad)]
    chunk = 16 // x.element_size()
    e = -(-stride ** 3 * 3 // chunk) * chunk
    assert xs.shape == (shape[0], *(o + kb - 1 for o in out), e)
    assert ws.shape == (kb, kb, kb, e, 16)
    assert not xs[..., stride ** 3 * 3:].any()
    got = k2.conv3d_gemm_ndhwc_plain(xs.float(), ws.float())
    want = k2.conv3d_gemm_ndhwc_plain(x.float(), w.float(),
                                      stride=(stride,) * 3, pad=pad)
    assert got.shape == want.shape == (shape[0], *out, 16)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _window_max(x, kernel, stride, pad):
    """The max over each window of x (N, T, H, W, C) clipped to the clip,
    by unfolding a -inf padded copy (one window at a time)."""
    (pt, pt1), (ph, ph1), (pw, pw1) = pad
    xp = F.pad(x.float(), (0, 0, pw, pw1, ph, ph1, pt, pt1),
               value=-math.inf)
    for axis, (k, s) in enumerate(zip(kernel, stride), start=1):
        xp = xp.unfold(axis, k, s)
    return xp.amax(dim=(-3, -2, -1)).to(x.dtype)


# I3D's pools at a small clip's sizes: name, (T, H, W, C), window, stride
I3D_POOLS = [
    ("MaxPool3d_2a", (8, 32, 32, 8), (1, 3, 3), (1, 2, 2)),
    ("Mixed module", (8, 8, 8, 16), (3, 3, 3), (1, 1, 1)),
    ("MaxPool3d_4a", (9, 8, 7, 16), (3, 3, 3), (2, 2, 2)),
    ("MaxPool3d_5a", (5, 4, 4, 16), (2, 2, 2), (2, 2, 2)),
    ("ragged", (7, 5, 6, 12), (3, 2, 3), (2, 1, 2)),
]


@pytest.mark.parametrize("name,shape,window,stride", I3D_POOLS,
                         ids=[p[0] for p in I3D_POOLS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ndhwc_pool_plain_against_window_maxima(name, shape, window, stride,
                                                dtype):
    """The NDHWC pool's plain version (a -inf F.pad and F.max_pool3d) and
    `max_pool(layout="NDHWC")` on the CPU (the custom op, or the NHWC
    pool over the frames for a window one frame deep) against each
    window's maximum, bit for bit, at TF's SAME pads; one call counted."""
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn((2, *shape), generator=gen).to(dtype)
    pad = tuple(same_pads(n, k, s) for n, k, s in zip(shape, window, stride))
    want = _window_max(x, window, stride, pad)
    assert want.shape[1:4] == tuple(-(-n // s) for n, s in zip(shape,
                                                                stride))
    plain = pooling.max_pool_ndhwc_plain(x, window, stride, pad)
    with timer.tally() as counts:
        got = pooling.max_pool(x, kernel=window, stride=stride, pad=pad,
                               layout="NDHWC")
    assert torch.equal(plain, want) and torch.equal(got, want)
    assert got.is_contiguous()
    assert counts.get("vvtpu.max_pool.calls") == 1
    assert "vvtpu.max_pool.launches" not in counts


def _params(cfg, seed):
    """The benchmark's draws for `cfg` on the CPU: the reference's params
    (BatchNorm's statistics as drawn) and the program's (folded)."""
    drawn = serve_i3d.make_params(torch.Generator().manual_seed(seed), cfg,
                                  "cpu")
    net = ti.I3D(ti.I3DConfig(compute_dtype="float32"))
    return drawn, {"i3d": net.fold_batch_norm(drawn["i3d"]),
                   "tower": drawn["tower"]}


def test_the_port_defaults_to_the_configurations_widths():
    cfg = ti.I3DConfig()
    convs = cfg.convs()
    layers, pools = flops_i3d.layers(CONFIG)
    assert [(n, k, s, ci, co) for n, k, s, ci, co, *_ in layers] == convs
    assert len(convs) == 57 and cfg.feature_dim == 1024
    assert sum(k == 3 for _, k, *_ in convs) == 19
    assert sum(p[1][0] > 1 for p in pools) == 11 and len(pools) == 13
    assert [ti.module_name(m) for m in cfg.inceptions] == [
        m["name"] for m in CONFIG["modules"]]
    assert cfg.bn_eps == CONFIG["batch_norm"]["eps"]


def test_batch_norm_folds_into_the_conv():
    """The folded conv (bias b', weights w') equals the conv followed by
    BatchNorm with the moving statistics, within f32 rounding."""
    drawn, params = _params(SMALL, 1)
    name = "Mixed_4c/Branch_1/Conv3d_0b_3x3"
    p, q = drawn["i3d"][name], params["i3d"][name]
    x = torch.rand((1, 4, 5, 5, p["w"].shape[3]),
                   generator=torch.Generator().manual_seed(2))
    pad = ((1, 1),) * 3
    got = k2.conv3d_gemm_ndhwc_plain(x, q["w"], q["b"], pad=pad)
    raw = k2.conv3d_gemm_ndhwc_plain(x, p["w"], pad=pad)
    want = (raw - p["moving_mean"]) * torch.rsqrt(
        p["moving_variance"] + 1e-3) + p["beta"]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _clips(seed, n, cfg):
    gen = torch.Generator().manual_seed(seed)
    return serve_query.make_clips(gen, n * cfg["clip_frames"],
                                  cfg["image_hw"], "cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_published_widths_against_the_reference(dtype, tol):
    """All 57 convs at the published widths, 16 frames of 64 x 64: the
    port's forward on the folded params against the reference on the
    drawn ones (BatchNorm after each conv)."""
    drawn, params = _params(SMALL, 3)
    x = torch.rand((1, 16, 64, 64, 3),
                   generator=torch.Generator().manual_seed(4)) * 2 - 1
    net = ti.I3D(ti.I3DConfig(compute_dtype=dtype))
    got = net.forward(params["i3d"], x)
    with torch.no_grad():
        want = ref.features(drawn["i3d"], x.permute(0, 4, 1, 2, 3), SMALL)
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 1024)
    assert _rel(got, want) < tol
    if dtype == "float32":
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _pipe(dtype="float32"):
    return trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        image_hw=(72, 72), crop=64, embed_dim=1024, compute_dtype=dtype,
        backbone="i3d"), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_query_with_the_i3d_backbone(dtype):
    """Two clips in one query, each with its own crop and mirror: one
    embedding and one top-5 row a clip, against the reference's scores;
    in f32 the embeddings within 1e-5 and the picks exact up to summation
    order, in bf16 the features within the bf16 tolerance and the picks
    within 2e-3 in cosine."""
    drawn, params = _params(SMALL, 5)
    frames = (_clips(6, 2, SMALL), torch.tensor([0, 8]), torch.tensor([5, 0]),
              torch.tensor([False, True]))
    rows = 40
    gallery, ids = serve_query.make_gallery(torch.Generator().manual_seed(7),
                                            rows, 1024, "cpu")
    row_of_id = torch.full((rows,), -1, dtype=torch.long)
    row_of_id[ids.long()] = torch.arange(rows)
    pipe = _pipe(dtype)
    assert pipe.backbone is pipe.i3d and pipe.embedder.cfg.feature_dim == 1024
    feats: list = []
    want = ref.embed(drawn, *frames, SMALL, feats_out=feats)
    served = pipe.query(params, *frames, gallery, ids)
    # one window a clip at 16 frames: the last map is 2 frames deep
    assert served[0].shape == (2, 5) and pipe.features.shape == (2, 1, 1024)
    nums = serve_query.compare(*served, ref.scores(want, gallery), row_of_id,
                               5)
    if dtype == "float32":
        got = pipe.embed_frames(params, *frames)
        assert torch.allclose(got, want, atol=1e-5, rtol=0)
        assert nums["pick_gap"] < 1e-5
    else:
        assert serve_i3d.feature_gap(pipe.features, feats[0]) < 2e-2
        assert nums["pick_gap"] < 2e-3


def test_the_features_are_the_mean_of_the_heads_windows():
    """`head_windows` is the AvgPool3d's output, a row a 2-frame window of
    the last map (3 windows at 32 frames), against the reference's; the
    forward's features are their mean over time."""
    drawn, params = _params(SMALL, 12)
    x = torch.rand((1, 32, 64, 64, 3),
                   generator=torch.Generator().manual_seed(13)) * 2 - 1
    net = ti.I3D(ti.I3DConfig(compute_dtype="float32"))
    got = net.head_windows(params["i3d"], x)
    with torch.no_grad():
        want = ref.windows(drawn["i3d"], x.permute(0, 4, 1, 2, 3), SMALL)
    assert got.shape == want.shape == (1, 3, 1024)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(net.forward(params["i3d"], x), got.mean(dim=1))


def test_every_frame_of_a_clip_takes_the_clips_crop():
    """The transform of a clip crops every frame at the clip's offsets and
    mirrors all or none: the clip's features equal those of its frames
    cropped and flipped by hand."""
    pipe = _pipe()
    _, params = _params(SMALL, 8)
    pix = _clips(9, 1, SMALL)
    got = pipe.embed_frames(params, pix, torch.tensor([3]), torch.tensor([6]),
                            torch.tensor([True]))
    x = (pix[:, 3:67, 6:70].float().flip(2) - 127.5) / 127.5
    want = pipe.embedder.embed({"tower": params["tower"]},
                               pipe.i3d.forward(params["i3d"], x[None]))
    assert torch.allclose(got, torch.nn.functional.normalize(want, dim=1),
                          atol=1e-6, rtol=0)


def test_init_folds_what_draw_draws():
    """`I3D.init` gives the params `forward` reads: `draw`'s, BatchNorm
    folded, bit for bit."""
    net = ti.I3D()
    got = net.init(torch.Generator().manual_seed(5))
    want = net.fold_batch_norm(net.draw(torch.Generator().manual_seed(5)))
    assert got.keys() == want.keys()
    for name, p in want.items():
        assert got[name].keys() == {"w", "b"}
        assert all(torch.equal(got[name][k], p[k]) for k in p)


@pytest.mark.parametrize("backbone,clips,mean,scale", [
    ("caffenet", False, None, 1.0), ("googlenet", False, None, 1.0),
    ("i3d", True, 127.5, 1 / 127.5)])
def test_each_backbone_declares_its_input(backbone, clips, mean, scale):
    """The pipeline asks the backbone, not its name: frames or clips, the
    transform's mean and scale; a frame backbone keeps the features its
    tower reads."""
    crop = 227 if backbone == "caffenet" else 224
    pipe = trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        backbone=backbone, crop=crop), device="cpu")
    net = pipe.backbone
    assert (net.clip_input, net.pixel_mean, net.pixel_scale) == (
        clips, mean, scale)
    if not clips:
        marker = torch.zeros(2, 3)
        net.forward = lambda params, x: marker
        kept, feats = net.served_features({}, None)
        assert kept is marker and feats is marker


def test_pipeline_params_and_clip_shapes():
    pipe = _pipe()
    params = pipe.init(torch.Generator().manual_seed(0))
    assert set(params) == {"i3d", "tower"} and len(params["i3d"]) == 57
    assert set(params["i3d"]["Conv3d_1a_7x7"]) == {"w", "b"}
    assert params["i3d"]["Conv3d_1a_7x7"]["w"].shape == (7, 7, 7, 3, 64)
    assert params["tower"]["w"].shape == (1024, 1024)
    pix = _clips(1, 1, SMALL)
    with pytest.raises(ValueError, match="whole clips"):
        pipe.embed_frames(params, pix[:15], torch.tensor([0, 1]),
                          torch.tensor([0, 1]), torch.tensor([False, True]))
    with pytest.raises(ValueError, match="whole clips"):
        pipe.embed_frames(params, pix, torch.tensor([0, 1]),
                          torch.tensor([0]), torch.tensor([False, True]))
    # 16 frames as two clips of 8: too short for the head's window
    with pytest.raises(ValueError, match="fewer than the head's window"):
        pipe.embed_frames(params, pix, torch.tensor([0, 1]),
                          torch.tensor([0, 1]), torch.tensor([False, True]))


def test_modules_are_spans_and_pools_and_concatenations_are_counted():
    """Under the profiler the query's backbone span is `vvtpu.query.i3d`,
    holding nine `vvtpu.inception` spans with request ids 0..8;
    `vvtpu.concat_bytes` is the modules' f32 outputs at 16 x 64 x 64;
    13 NDHWC or NHWC pool calls, no launch on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    _, params = _params(SMALL, 10)
    pipe = _pipe()
    frames = (_clips(11, 1, SMALL), torch.tensor([1]), torch.tensor([2]),
              torch.tensor([False]))
    gallery, ids = serve_query.make_gallery(torch.Generator().manual_seed(1),
                                            16, 1024, "cpu")
    with timer.span("vvtpu.between"):
        pass
    with timer.tally() as counts, profile(activities=[ProfilerActivity.CPU]):
        pipe.query(params, *frames, gallery, ids)
    rec = timer.recorded()
    names = [s.name for s in rec.spans]
    (top,) = [i for i, n in enumerate(names) if n == "vvtpu.query.i3d"]
    mods = [s for s in rec.spans if s.name == "vvtpu.inception"]
    assert [s.req for s in mods] == list(range(9))
    assert all(rec.spans[s.parent].name == "vvtpu.query.i3d" for s in mods)
    # frames and side of each module's map, and its output's channels
    sizes = [(8, 8)] * 2 + [(4, 4)] * 5 + [(2, 2)] * 2
    widths = [256, 480, 512, 512, 512, 528, 832, 832, 1024]
    want = sum(t * s * s * c for (t, s), c in zip(sizes, widths)) * 4
    assert rec.counters["vvtpu.concat_bytes"] == want
    assert counts["vvtpu.max_pool.calls"] == 13
    assert not any(k.endswith("launches") for k in counts)


# multiply-adds of one 64-frame clip at 224, worked from the module table:
# output voxels x output channels x taps x input channels
STEM_MACS = (32 * 112 * 112 * 64 * 343 * 3        # Conv3d_1a_7x7
             + 32 * 56 * 56 * 64 * 64              # Conv3d_2b_1x1
             + 32 * 56 * 56 * 192 * 27 * 64)       # Conv3d_2c_3x3


def _module_macs(thw, c, m):
    n1, r3, n3, r5, n5, pp = m
    return thw * (c * n1 + c * r3 + 27 * r3 * n3 + c * r5 + 27 * r5 * n5
                  + c * pp)


def test_flops_by_hand():
    """111.2 G multiply-adds a 64-frame clip (the published count is about
    108 G); at the cell's 250 frames 869.9 GFLOP and 1.59 GB, a tensor-core
    bound of 0.880 ms a query and 0.476 ms of bytes, and the 13 pools'
    0.26 ms."""
    macs = STEM_MACS
    macs += _module_macs(32 * 28 * 28, 192, (64, 96, 128, 16, 32, 32))
    macs += _module_macs(32 * 28 * 28, 256, (128, 128, 192, 32, 96, 64))
    macs += _module_macs(16 * 14 * 14, 480, (192, 96, 208, 16, 48, 64))
    macs += _module_macs(16 * 14 * 14, 512, (160, 112, 224, 24, 64, 64))
    macs += _module_macs(16 * 14 * 14, 512, (128, 128, 256, 24, 64, 64))
    macs += _module_macs(16 * 14 * 14, 512, (112, 144, 288, 32, 64, 64))
    macs += _module_macs(16 * 14 * 14, 528, (256, 160, 320, 32, 128, 128))
    macs += _module_macs(8 * 7 * 7, 832, (256, 160, 320, 32, 128, 128))
    macs += _module_macs(8 * 7 * 7, 832, (384, 192, 384, 48, 128, 128))
    convs64 = flops_i3d.i3d_convs(1, CONFIG, frames=64)
    assert len(convs64) == 57
    assert sum(c["ops"] for c in convs64) == 2.0 * macs
    assert macs / 1e9 == pytest.approx(111.15, abs=0.01)
    convs = flops_i3d.i3d_convs(1, CONFIG)
    assert convs[0]["ops"] == 2.0 * 125 * 112 * 112 * 64 * 343 * 3
    assert convs[0]["bytes"] == (250 * 224 * 224 * 3 * 2 + 343 * 3 * 64 * 2
                                 + 64 * 4 + 125 * 112 * 112 * 64 * 2)
    assert sum(c["ops"] for c in convs) / 1e9 == pytest.approx(869.9,
                                                               abs=0.05)
    assert sum(c["bytes"] for c in convs) / 1e9 == pytest.approx(1.594,
                                                                 abs=1e-3)
    assert flops_i3d.query_least_s(1, 20_000, CONFIG) * 1e3 == pytest.approx(
        0.8802, abs=1e-4)
    assert flops_i3d.pool_least_s(1, CONFIG) * 1e3 == pytest.approx(
        0.2626, abs=1e-4)
    pools = flops_i3d.i3d_pools(1, CONFIG)
    # MaxPool3d_2a reads conv1's 125 x 112 x 112 x 64 and writes a quarter
    assert pools[0]["bytes"] == 125 * (112 * 112 + 56 * 56) * 64 * 2
    assert flops_i3d.k2_least_s(1, CONFIG) > flops_i3d.query_least_s(
        1, 20_000, CONFIG) - 2.0 * 20_000 * 1024 / 67e12
