"""The port's Hopper kernels (K1's and K2's two routes each) against their
plain versions on a CUDA card: ragged shapes, strided operands, groups, both
dtypes, split-K, tile shapes, and the launch preconditions. Skipped without
a card.

On the card (where JAX is absent, so the repo's conftest cannot load):
    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from videovector_tpu_torch.ops.hopper import matmul as k1

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# relative to max|plain|: f32 outputs differ by summation order only, bf16
# outputs by at most one rounding step
REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _t(rng, *shape, dev, dtype=torch.float32):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                           device=dev).to(dtype)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL[ref.dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(1, 1, 1), (100, 300, 70), (50, 1000, 513),
                                 (300, 64, 260)])
def test_k1_matches_plain(dev, dtype, out_dtype, mkn):
    rng = np.random.RandomState(0)
    m, k, n = mkn
    x, w, b = _t(rng, m, k, dev=dev, dtype=dtype), \
        _t(rng, k, n, dev=dev, dtype=dtype), _t(rng, n, dev=dev)
    before = k1.matmul.launches
    got = k1.matmul(x, w, b, fuse_relu=True, out_dtype=out_dtype)
    assert k1.matmul.launches == before + 1
    _close(got, k1.matmul_plain(x, w, b, fuse_relu=True, out_dtype=out_dtype))


def test_k1_strided_operands(dev):
    rng = np.random.RandomState(1)
    x = _t(rng, 90, 70, dev=dev)[::2, 3:67]     # (45, 64), row stride 140
    w = _t(rng, 33, 64, dev=dev).T              # (64, 33), transposed
    _close(k1.matmul(x, w), k1.matmul_plain(x, w))


def test_k1_rejects(dev):
    x = torch.ones(4, 8, device=dev)
    with pytest.raises(TypeError):
        k1.matmul(x, torch.ones(8, 4, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        k1.matmul(x, torch.ones(7, 4, device=dev))
    with pytest.raises(NotImplementedError, match="forward only"):
        k1.matmul(x.requires_grad_(), torch.ones(8, 4, device=dev))
    xb = torch.ones(64, 64, device=dev, dtype=torch.bfloat16)
    assert k1.k1_route(xb, xb, torch.float32) == "sm90"
    with pytest.raises(NotImplementedError, match="forward only"):
        k1.matmul(xb.requires_grad_(), xb)


def _randn(gen, *shape, dev):
    return torch.randn(shape, generator=gen, device=dev).bfloat16()


@pytest.mark.parametrize("n", [8, 520, 4096])
@pytest.mark.parametrize("k", [64, 4096, 9216, 1000])
@pytest.mark.parametrize("m", [1, 50, 63, 64, 65, 256, 1920])
def test_k1_sm90_matches_plain_and_core(dev, m, k, n):
    """The sm90 route against the plain version and the core route (w read
    through a transposed view of a transposed copy), both output types,
    with and without bias and ReLU."""
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k * 3 + n)
    x, w = _randn(gen, m, k, dev=dev), _randn(gen, k, n, dev=dev)
    b = torch.randn(n, generator=gen, device=dev)
    w_core = w.T.contiguous().T
    assert k1.k1_route(x, w, torch.float32) == "sm90"
    assert k1.k1_route(x, w_core, torch.float32) == "core"
    for out_dtype in (torch.float32, torch.bfloat16):
        for bias, relu in ((None, False), (b, True)):
            before = (k1.matmul.launches, k1.matmul.launches_sm90)
            got = k1.matmul(x, w, bias, fuse_relu=relu, out_dtype=out_dtype)
            assert (k1.matmul.launches, k1.matmul.launches_sm90) == \
                (before[0] + 1, before[1] + 1)
            _close(got, k1.matmul_plain(x, w, bias, fuse_relu=relu,
                                        out_dtype=out_dtype))
            _close(got, k1.matmul(x, w_core, bias, fuse_relu=relu,
                                  out_dtype=out_dtype))
            assert k1.matmul.launches_sm90 == before[1] + 1


@pytest.mark.parametrize("mkn", [(50, 9216, 4096), (256, 1000, 520)])
def test_k1_sm90_split_counts_agree_and_repeat_bitwise(dev, mkn, monkeypatch):
    """One split against the plan's and against one split per BK tile; each
    run twice gives the same bits (no atomics in the split-K reduction)."""
    m, k, n = mkn
    gen = torch.Generator(device=dev).manual_seed(5)
    x, w = _randn(gen, m, k, dev=dev), _randn(gen, k, n, dev=dev)
    b = torch.randn(n, generator=gen, device=dev)
    plan = k1.k1_split_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block_m, planned = plan(m, n, k, sms)
    assert planned > 1
    ref = k1.matmul_plain(x, w, b, fuse_relu=True, out_dtype=torch.bfloat16)
    for splits in (1, planned, -(-k // k1.SM90_BK)):
        monkeypatch.setattr(k1, "k1_split_plan",
                            lambda *_, s=splits: (block_m, s))
        runs = [k1.matmul(x, w, b, fuse_relu=True, out_dtype=torch.bfloat16)
                for _ in range(2)]
        _close(runs[0], ref)
        assert torch.equal(runs[0], runs[1]), splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_nchw_matches_plain(dev, dtype):
    rng = np.random.RandomState(2)
    x, w, b = _t(rng, 2, 3, 9, 9, dev=dev), _t(rng, 8, 3, 3, 3, dev=dev), \
        _t(rng, 8, dev=dev)
    got = k2.conv2d_im2col_gemm(x.to(dtype), w.to(dtype), b, stride=(2, 2),
                                pad=(1, 1))
    _close(got, k2.conv2d_im2col_gemm_plain(x.to(dtype), w.to(dtype), b,
                                            stride=(2, 2), pad=(1, 1)))
    with pytest.raises(ValueError, match="groups"):
        k2.conv2d_im2col_gemm(x, w[:, :1], b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [
    # hw, c, o, k, stride, pad, groups
    (23, 3, 12, 11, 4, 0, 1),
    (9, 8, 6, 5, 1, 2, 2),
    (7, 12, 18, 3, 1, 1, 3),
    (6, 130, 40, 3, 2, 1, 2),
])
def test_k2_nhwc_groups_match_plain(dev, dtype, geom):
    rng = np.random.RandomState(3)
    hw, c, o, k, s, p, g = geom
    x = _t(rng, 3, hw, hw, c, dev=dev, dtype=dtype)
    w = _t(rng, k, k, c // g, o, dev=dev, dtype=dtype)
    b = _t(rng, o, dev=dev)
    kw = dict(stride=(s, s), pad=(p, p), groups=g, fuse_relu=True,
              out_dtype=dtype)
    before = k2.conv2d_im2col_gemm.launches
    got = k2.conv2d_gemm_nhwc(x, w, b, **kw)
    assert k2.conv2d_im2col_gemm.launches == before + g
    _close(got, k2.conv2d_gemm_nhwc_plain(x, w, b, **kw))


# (x NHWC, w HWIO, stride, pad): CaffeNet's five convs at batch 2, then
# ragged ones: M not a tile multiple, Cg = 48, groups 1/2/3, stride 1/2/4,
# pad 0/1/2, Og masked in one or two tiles, a 1x1 conv, space-to-depth
K2_SM90_GEOMS = {
    "conv1": ((2, 227, 227, 3), (11, 11, 3, 96), 4, 0),
    "conv2": ((2, 27, 27, 96), (5, 5, 48, 256), 1, 2),
    "conv3": ((2, 13, 13, 256), (3, 3, 256, 384), 1, 1),
    "conv4": ((2, 13, 13, 384), (3, 3, 192, 384), 1, 1),
    "conv5": ((2, 13, 13, 384), (3, 3, 192, 256), 1, 1),
    "g2_cg8_m243": ((3, 9, 9, 16), (3, 3, 8, 16), 1, 1),
    "cg48_og40_p2": ((3, 11, 7, 48), (5, 5, 48, 40), 1, 2),
    "g3_s2": ((2, 13, 13, 72), (3, 3, 24, 48), 2, 1),
    "s4_p2_direct": ((2, 35, 35, 16), (7, 7, 16, 32), 4, 2),
    "1x1_og200": ((2, 31, 31, 64), (1, 1, 64, 200), 1, 0),
    "s2d_small": ((3, 23, 23, 3), (11, 11, 3, 16), 4, 0),
}


def _k2_operands(gen, geom, dev):
    xs, ws, s, p = geom
    fan_in = ws[0] * ws[1] * ws[2]
    x = _randn(gen, *xs, dev=dev)
    w = (torch.randn(ws, generator=gen, device=dev) * fan_in ** -0.5).bfloat16()
    b = torch.randn(ws[3], generator=gen, device=dev) * 0.1
    return x, w, b, dict(stride=(s, s), pad=(p, p),
                         groups=xs[3] // ws[2])


def _core_view(w):
    """The same HWIO weights as a strided view, which the route sends to the
    core."""
    return w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


@pytest.mark.parametrize("name", list(K2_SM90_GEOMS))
def test_k2_sm90_matches_plain_and_core(dev, name):
    """One launch per conv on the sm90 route, against the plain version and
    the core route on the same bf16 operands, both output types, with and
    without bias and ReLU; a second run gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(len(name))
    x, w, b, geo = _k2_operands(gen, K2_SM90_GEOMS[name], dev)
    w_core = _core_view(w)
    route_kw = dict(stride=geo["stride"], pad=geo["pad"])
    assert k2.k2_route(x, w, torch.bfloat16, **route_kw) == "sm90"
    assert k2.k2_route(x, w_core, torch.bfloat16, **route_kw) == "core"
    for out_dtype in (torch.float32, torch.bfloat16):
        for bias, relu in ((None, False), (b, True)):
            kw = dict(geo, fuse_relu=relu, out_dtype=out_dtype)
            before = (k2.conv2d_im2col_gemm.launches,
                      k2.conv2d_im2col_gemm.launches_sm90)
            got = k2.conv2d_gemm_nhwc(x, w, bias, **kw)
            assert (k2.conv2d_im2col_gemm.launches,
                    k2.conv2d_im2col_gemm.launches_sm90) == \
                (before[0] + 1, before[1] + 1)
            _close(got, k2.conv2d_gemm_nhwc_plain(x, w, bias, **kw))
            _close(got, k2.conv2d_gemm_nhwc(x, w_core, bias, **kw))
            assert k2.conv2d_im2col_gemm.launches_sm90 == before[1] + 1
            assert torch.equal(got, k2.conv2d_gemm_nhwc(x, w, bias, **kw))


@pytest.mark.parametrize("name", ["conv1", "conv2", "conv4", "g3_s2",
                                  "cg48_og40_p2"])
def test_k2_sm90_bit_for_bit_on_integers(dev, name):
    """Integer operands in [-2, 2] keep every f32 sum exact, so the kernel's
    output equals conv_epilogue_plain's on the plain f32 sum bit for bit;
    a bias of odd eighths makes the bf16 epilogue round."""
    xs, ws, s, p = K2_SM90_GEOMS[name]
    rs = np.random.RandomState(7)
    x = torch.as_tensor(rs.randint(-2, 3, xs).astype(np.float32), device=dev)
    w = torch.as_tensor(rs.randint(-2, 3, ws).astype(np.float32), device=dev)
    b = torch.as_tensor((2 * rs.randint(-64, 64, ws[3]) + 1) / 8,
                        dtype=torch.float32, device=dev)
    kw = dict(stride=(s, s), pad=(p, p), groups=xs[3] // ws[2], fuse_relu=True)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = k2.conv2d_im2col_gemm.launches_sm90
        got = k2.conv2d_gemm_nhwc(x.bfloat16(), w.bfloat16(), b,
                                  out_dtype=out_dtype, **kw)
        assert k2.conv2d_im2col_gemm.launches_sm90 == before + 1
        ref = k2.conv2d_gemm_nhwc_plain(x, w, b, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("block_m,block_n", k2.SM90_TILES)
def test_k2_sm90_every_tile_shape(dev, block_m, block_n, monkeypatch):
    """Each of the kernel's tile shapes on a grouped conv whose group width
    (96) some of them divide and others mask."""
    gen = torch.Generator(device=dev).manual_seed(block_m + block_n)
    x, w, b, geo = _k2_operands(gen, ((3, 10, 10, 32), (3, 3, 16, 192), 1, 1),
                                dev)
    plan = k2.k2_sm90_plan
    monkeypatch.setattr(k2, "k2_sm90_plan", lambda *a: (block_m, block_n,
                                                        plan(*a)[2]))
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(geo, fuse_relu=True, out_dtype=out_dtype)
        before = k2.conv2d_im2col_gemm.launches_sm90
        got = k2.conv2d_gemm_nhwc(x, w, b, **kw)
        assert k2.conv2d_im2col_gemm.launches_sm90 == before + 1
        _close(got, k2.conv2d_gemm_nhwc_plain(x, w, b, **kw))


@pytest.mark.parametrize("shape,k,stride", [((2, 227, 227, 3), 11, 4),
                                            ((3, 23, 19, 3), 11, 4),
                                            ((2, 9, 9, 2), 3, 2)])
def test_space_to_depth_kernel_equals_plain(dev, shape, k, stride):
    """The repack kernel moves bits: equal to the plain version's."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _randn(gen, *shape, dev=dev)
    w = _randn(gen, k, k, shape[3], 16, dev=dev)
    before = k2.space_to_depth.launches
    xs, ws = k2.space_to_depth(x, w, stride)
    assert k2.space_to_depth.launches == before + 1
    ref_x, ref_w = k2.space_to_depth_plain(x, w, stride)
    torch.cuda.synchronize()
    assert torch.equal(xs, ref_x) and torch.equal(ws, ref_w)
    with pytest.raises(ValueError, match="contiguous bf16"):
        k2.space_to_depth(x.float(), w.float(), stride)


def _mm_calls(fn) -> int:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::mm")


@pytest.mark.parametrize("kn", [64, 4096])
@pytest.mark.parametrize("m", [60, 1920])
def test_tower_function_on_k1(dev, m, kn):
    """The training tower (ops.linear.tower_matmul, bf16 operands, f32 out,
    bias epilogue, no fused ReLU) on K1's sm90 route: the forward against
    matmul_plain; dW (rounded to bf16) and db against the plain Function's
    backward on the same dY, and against their formulas; the ReLU tie of an
    all-zero row against a zero bias; and no dX product unless x asks for a
    gradient. (dY is fed to the Function itself: through relu, a kernel
    output a rounding away from 0 on the other side of it than the plain
    one would change dY there.)"""
    from videovector_tpu_torch.ops.activations import relu
    from videovector_tpu_torch.ops.linear import tower_matmul
    gen = torch.Generator(device=dev).manual_seed(m + kn)
    x = torch.randn(m, kn, generator=gen, device=dev)
    x[0] = 0.0
    w0 = torch.randn(kn, kn, generator=gen, device=dev) * kn ** -0.5
    b0 = torch.randn(kn, generator=gen, device=dev)
    b0[:8] = 0.0
    g = torch.randn(m, kn, generator=gen, device=dev)
    out = {}
    for plain in (False, True):
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        before = (k1.matmul.launches, k1.matmul.launches_sm90)
        h = tower_matmul(x, w, b, compute_dtype=torch.bfloat16, plain=plain)
        assert (k1.matmul.launches, k1.matmul.launches_sm90) == (
            (before[0] + 1, before[1] + 1) if not plain else before)
        n_mm = _mm_calls(lambda: h.backward(g))
        assert n_mm == 1            # dW only: x does not ask for a gradient
        out[plain] = (h.detach(), w.grad, b.grad)
    (h, dw, db), (h_ref, dw_ref, db_ref) = out[False], out[True]
    _close(h, k1.matmul_plain(x.bfloat16(), w0.bfloat16(), b0))
    _close(h, h_ref)
    assert torch.equal(dw, dw_ref) and torch.equal(db, db_ref)
    assert torch.equal(dw, dw.bfloat16().float())       # rounded to bf16
    _close(dw, (x.bfloat16().float().T @ g).bfloat16().float())
    _close(db, g.sum(0))
    # the tie through relu: h[0, :8] == 0 exactly, and its gradient is 0.5
    assert (h[0, :8] == 0).all()
    w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
    hk = tower_matmul(x, w, b, compute_dtype=torch.bfloat16)
    relu(hk).backward(g)
    dy = g * torch.where(h > 0, 1.0, torch.where(h == 0, 0.5, 0.0))
    _close(b.grad, dy.sum(0))
    xg = x.clone().requires_grad_()
    w = w0.clone().requires_grad_()
    h2 = tower_matmul(xg, w, b0, compute_dtype=torch.bfloat16)
    assert _mm_calls(lambda: h2.backward(g)) == 2
    _close(xg.grad, (g @ w0.bfloat16().float().T).bfloat16().float())


def test_test_eval_tower_on_k1_at_673_rows(dev):
    """The flagship test eval's tower: VideoEmbeddingModel.extract on one
    (673, 4, 4096) test batch, without gradients, is one K1 launch on the
    sm90 route (bias + ReLU epilogue, f32 out), against matmul_plain and
    the plain model."""
    from videovector_tpu_torch.models.embedding import (
        VideoEmbeddingConfig, VideoEmbeddingModel,
    )
    cfg = VideoEmbeddingConfig()
    gen = torch.Generator(device=dev).manual_seed(6)
    params = VideoEmbeddingModel(cfg).init(gen)
    params["tower"]["b"] = torch.randn(4096, generator=gen, device=dev) * 0.01
    feats = torch.randn((673, 4, 4096), generator=gen, device=dev)
    x = torch.mean(feats, dim=1).bfloat16()
    w, b = params["tower"]["w"].bfloat16(), params["tower"]["b"]
    assert k1.k1_route(x, w, torch.float32) == "sm90"
    with torch.no_grad():
        before = (k1.matmul.launches, k1.matmul.launches_sm90)
        emb = VideoEmbeddingModel(cfg).extract(params, feats)
        assert (k1.matmul.launches, k1.matmul.launches_sm90) == \
            (before[0] + 1, before[1] + 1)
        ref = VideoEmbeddingModel(cfg, plain=True).extract(params, feats)
        _close(emb, ref)
        _close(k1.matmul(x, w, b, fuse_relu=True),
               k1.matmul_plain(x, w, b, fuse_relu=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_count_engine_equals_sort_on_the_card(dev, dtype):
    """retrieval_stats_chunked's two engines on the card give the same
    results on a 2,000-row gallery of overlapping classes, f32 and bf16."""
    from videovector_tpu_torch.metrics import retrieval as tr
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d, c = 2000, 256, 20
    cls = torch.randint(0, c, (n,), generator=gen, device=dev)
    vids = torch.randint(0, n // 10, (n,), generator=gen, device=dev)
    centers = torch.randn((c, d), generator=gen, device=dev)
    feats = centers[cls] * 0.3 + torch.randn((n, d), generator=gen, device=dev)
    feats = feats / feats.norm(dim=1, keepdim=True)
    outs = [tr.retrieval_stats_chunked(feats, vids, cls, method=m,
                                       gallery_dtype=dtype, query_chunk=128,
                                       exclude_same_video_shots=ex)
            for ex in (False, True) for m in ("count", "sort")]
    for a, b in (outs[:2], outs[2:]):
        assert all(float(a[k]) == float(b[k]) for k in a), (a, b)
        assert 0.05 < float(a["mean_ap"]) < 0.99


def test_bf16_gallery_stays_bf16_on_the_card(dev):
    """A bf16 gallery is never copied to f32 on the card: the distance
    product is bf16 x bf16 with an f32 output. The peak memory of a sort
    pass over a (20,000 x 4096) bf16 gallery stays below what an f32 copy
    of it alone would take."""
    from videovector_tpu_torch.metrics import retrieval as tr
    gen = torch.Generator(device=dev).manual_seed(8)
    n, d = 20_000, 4096
    feats = torch.randn((n, d), generator=gen, device=dev).bfloat16()
    feats = feats / feats.float().norm(dim=1, keepdim=True).bfloat16()
    vids = torch.randint(0, 500, (n,), generator=gen, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = tr.retrieval_stats_chunked(feats, vids, vids % 7, method="sort",
                                     gallery_dtype="bfloat16", query_chunk=64)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < n * d * 4
    assert 0.0 <= float(out["mean_ap"]) <= 1.0


def test_training_step_ignores_the_process_tf32_setting(dev):
    """One train step at the flagship's layout, dropout 0.9, with torch's
    global TF32 flag on equals one with it off, bit for bit: the tower's
    backward products and the scores product run in full f32 (TF32 off)
    whatever the process sets, and the flag is back as it was after."""
    from videovector_tpu_torch.models.embedding import (
        VideoEmbeddingConfig, VideoEmbeddingModel,
    )
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train
    cfg = VideoEmbeddingConfig(feature_dim=512, embed_dim=512)
    model = VideoEmbeddingModel(cfg)
    gen = torch.Generator(device=dev).manual_seed(9)
    params = model.init(gen)
    batch = {"data": torch.randn((cfg.num_roles, 64, 512), generator=gen,
                                 device=dev)}
    x = torch.randn((256, 512), generator=gen, device=dev)
    runs = []
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = flag
        try:
            # the flag does reach an unscoped f32 product
            runs.append([x @ x.T])
            res = train(lambda p, b, g: model.loss(p, b, generator=g,
                                                   train=True, role_major=True),
                        params, iter([batch]), SolverConfig(
                            base_lr=0.05, momentum=0.9, max_iter=1,
                            random_seed=3), device="cuda",
                        batch_axes={"data": 1})
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        runs[-1] += [res.params["tower"]["w"], res.params["tower"]["b"]]
    torch.cuda.synchronize()
    assert not torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
