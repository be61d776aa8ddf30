"""The port's Hopper kernels (K1's three routes, K2's three) against their
plain versions on a CUDA card: ragged shapes, strided operands, groups, both
dtypes, split-K, tile shapes, and the launch preconditions. Skipped without
a card.

On the card (where JAX is absent, so the repo's conftest cannot load):
    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from torch_pool_cases import GEOMETRIES, IDS, pool_args, same_bits
from videovector_tpu_torch.device import plain_versions
from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from videovector_tpu_torch.ops.hopper import matmul as k1
from videovector_tpu_torch.utils import timer

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


def _close(got, ref, rel=None):
    """got within `rel` (by default the dtype's tolerance) x max|ref|."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    rel = REL_TOL[ref.dtype] if rel is None else rel
    assert err <= rel * ref.float().abs().max().item(), err


def _counted(fn):
    """fn()'s result and what `count` added while it ran (`timer.tally`:
    the kernels' launch counters, `vvtpu.query.graph_replays`,
    `vvtpu.cast_bytes`, ...), profiled or not."""
    with timer.tally() as counts:
        out = fn()
    torch.cuda.synchronize()
    return out, counts


def _got(counts, *names):
    """The counters `vvtpu.<name>` of a tally, 0 where absent."""
    return tuple(counts.get("vvtpu." + n, 0) for n in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(1, 1, 1), (100, 300, 70), (50, 1000, 513),
                                 (300, 64, 260)])
def test_k1_matches_plain(dev, dtype, out_dtype, mkn):
    rng = np.random.RandomState(0)
    m, k, n = mkn
    x, w, b = _t(rng, m, k, dev=dev, dtype=dtype), \
        _t(rng, k, n, dev=dev, dtype=dtype), _t(rng, n, dev=dev)
    got, counts = _counted(
        lambda: k1.matmul(x, w, b, fuse_relu=True, out_dtype=out_dtype))
    assert _got(counts, "k1.launches") == (1,)
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


def test_each_precondition_runs_once_an_eager_call(dev, monkeypatch):
    """K1's and K2's checks (shapes and dtypes, one device, no autograd
    graph to extend) run once in an eager call of `matmul` and of
    `conv2d_gemm_nhwc`, on the sm90 and core routes and with conv1's
    repack; `conv2d_nchw`'s forward, an autograd Function's, needs no
    autograd check and runs the other two once."""
    calls = collections.Counter()

    def counted(kernel, mod, name):
        real = getattr(mod, name)

        def wrapper(*args, **kwargs):
            calls[kernel, name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapper)
    for kernel, mod in (("k1", k1), ("k2", k2)):
        for name in ("_check", "same_device", "forward_only"):
            counted(kernel, mod, name)
    gen = torch.Generator(device=dev).manual_seed(3)
    x, w = _randn(gen, 50, 256, dev=dev), _randn(gen, 256, 128, dev=dev)
    b = torch.randn(128, generator=gen, device=dev)
    conv1 = _randn(gen, 4, 227, 227, 3, dev=dev), \
        _randn(gen, 11, 11, 3, 96, dev=dev), dict(stride=(4, 4))
    grouped = _randn(gen, 4, 27, 27, 96, dev=dev), \
        _randn(gen, 5, 5, 48, 256, dev=dev), dict(pad=(2, 2), groups=2)
    every = {(m, n): 1 for m in ("k1", "k2")
             for n in ("_check", "same_device", "forward_only")}
    cases = [("k1", lambda: k1.matmul(x, w, b, fuse_relu=True)),
             ("k1", lambda: k1.matmul(x, w.T.contiguous().T, b))]
    cases += [("k2", lambda a=a, kw=kw: k2.conv2d_gemm_nhwc(
        a[0], a[1], None, fuse_relu=True, out_dtype=torch.bfloat16, **kw))
        for a, kw in ((conv1[:2], conv1[2]), (grouped[:2], grouped[2]),
                      ((grouped[0], _core_view(grouped[1])), grouped[2]))]
    for kernel, call in cases:
        calls.clear()
        call()
        assert calls == {k: v for k, v in every.items() if k[0] == kernel}
    calls.clear()
    k2.conv2d_nchw(grouped[0].permute(0, 3, 1, 2).float(),
                   grouped[1].permute(3, 2, 0, 1).float(), None,
                   pad=(2, 2), groups=2)
    assert calls == {("k2", "_check"): 1, ("k2", "same_device"): 1}
    torch.cuda.synchronize()


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
            got, counts = _counted(lambda: k1.matmul(
                x, w, bias, fuse_relu=relu, out_dtype=out_dtype))
            assert _got(counts, "k1.launches", "k1.sm90_launches") == (1, 1)
            _close(got, k1.matmul_plain(x, w, bias, fuse_relu=relu,
                                        out_dtype=out_dtype))
            core, counts = _counted(lambda: k1.matmul(
                x, w_core, bias, fuse_relu=relu, out_dtype=out_dtype))
            _close(got, core)
            assert _got(counts, "k1.launches", "k1.sm90_launches") == (1, 0)


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


def _k1_core_copy(x):
    """A contiguous copy of x whose data starts 4 bytes past 16: the same
    strides, on K1's core route."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    return buf[1:1 + x.numel()].view(x.shape).copy_(x)


def _f32_splits(monkeypatch, m, k, n, dev, split):
    """Pins the f32 route's splits: the plan's ("planned") or one ("one")."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile, planned = k1.k1_f32_plan(m, n, k, sms)
    splits = planned if split == "planned" else 1
    monkeypatch.setattr(k1, "k1_f32_plan", lambda *_: (tile, splits))
    return splits


@pytest.mark.parametrize("split", ["planned", "one"])
@pytest.mark.parametrize("mkn", [(1920, 4096, 4096), (673, 4096, 4096),
                                 (1, 4, 8), (673, 1000, 4100), (129, 36, 260)])
def test_k1_f32_matches_plain_and_core(dev, mkn, split, monkeypatch):
    """The f32 route against the plain version and the core route on the
    same operands, both output types, with and without bias and ReLU, with
    the plan's splits and with one; two runs give the same bits, and with
    one split the sum is the core's term by term (ascending k, fmaf), so
    the output is the core's bit for bit."""
    m, k, n = mkn
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k * 3 + n)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    b = torch.randn(n, generator=gen, device=dev)
    x_core = _k1_core_copy(x)
    assert k1.k1_route(x, w, torch.float32) == "f32"
    assert k1.k1_route(x_core, w, torch.float32) == "core"
    splits = _f32_splits(monkeypatch, m, k, n, dev, split)
    for out_dtype in (torch.float32, torch.bfloat16):
        for bias, relu in ((None, False), (b, True)):
            kw = dict(fuse_relu=relu, out_dtype=out_dtype)
            runs, counts = _counted(
                lambda: [k1.matmul(x, w, bias, **kw) for _ in range(2)])
            assert _got(counts, "k1.launches", "k1.f32_launches",
                        "k1.sm90_launches") == (2, 2, 0)
            _close(runs[0], k1.matmul_plain(x, w, bias, **kw))
            core = k1.matmul(x_core, w, bias, **kw)
            _close(runs[0], core)
            assert torch.equal(runs[0], runs[1])
            if splits == 1:
                assert torch.equal(runs[0], core)


@pytest.mark.parametrize("split", ["planned", "one"])
@pytest.mark.parametrize("mkn", [(673, 4096, 4096), (129, 36, 260)])
def test_k1_f32_bit_for_bit_on_integers(dev, mkn, split, monkeypatch):
    """Integer operands in [-2, 2] keep every f32 sum exact, whatever the
    order and the splits, so the f32 route's output equals the plain
    version's bit for bit; a bias of odd eighths makes the bf16 output
    round."""
    m, k, n = mkn
    rs = np.random.RandomState(8)
    x = torch.as_tensor(rs.randint(-2, 3, (m, k)).astype(np.float32), device=dev)
    w = torch.as_tensor(rs.randint(-2, 3, (k, n)).astype(np.float32), device=dev)
    b = torch.as_tensor((2 * rs.randint(-64, 64, n) + 1) / 8,
                        dtype=torch.float32, device=dev)
    _f32_splits(monkeypatch, m, k, n, dev, split)
    for out_dtype in (torch.float32, torch.bfloat16):
        got, counts = _counted(
            lambda: k1.matmul(x, w, b, fuse_relu=True, out_dtype=out_dtype))
        assert _got(counts, "k1.f32_launches") == (1,)
        ref = k1.matmul_plain(x, w, b, fuse_relu=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


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
    got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(x, w, b, **kw))
    assert _got(counts, "k2.launches") == (g,)
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
            got, counts = _counted(
                lambda: k2.conv2d_gemm_nhwc(x, w, bias, **kw))
            assert _got(counts, "k2.launches", "k2.sm90_launches") == (1, 1)
            _close(got, k2.conv2d_gemm_nhwc_plain(x, w, bias, **kw))
            core, counts = _counted(
                lambda: k2.conv2d_gemm_nhwc(x, w_core, bias, **kw))
            _close(got, core)
            assert _got(counts, "k2.sm90_launches") == (0,)
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
        got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(
            x.bfloat16(), w.bfloat16(), b, out_dtype=out_dtype, **kw))
        assert _got(counts, "k2.sm90_launches") == (1,)
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
        got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(x, w, b, **kw))
        assert _got(counts, "k2.sm90_launches") == (1,)
        _close(got, k2.conv2d_gemm_nhwc_plain(x, w, b, **kw))


@pytest.mark.parametrize("shape,k,stride", [((2, 227, 227, 3), 11, 4),
                                            ((3, 23, 19, 3), 11, 4),
                                            ((2, 9, 9, 2), 3, 2)])
def test_space_to_depth_kernel_equals_plain(dev, shape, k, stride):
    """The repack kernel moves bits: equal to the plain version's."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _randn(gen, *shape, dev=dev)
    w = _randn(gen, k, k, shape[3], 16, dev=dev)
    (xs, ws), counts = _counted(lambda: k2.space_to_depth(x, w, stride))
    assert _got(counts, "s2d.launches") == (1,)
    ref_x, ref_w = k2.space_to_depth_plain(x, w, stride)
    torch.cuda.synchronize()
    assert torch.equal(xs, ref_x) and torch.equal(ws, ref_w)
    # f32 operands are the f32 route's; a strided x is neither route's
    with pytest.raises(ValueError, match="contiguous"):
        k2.space_to_depth(x.transpose(1, 2), w, stride)
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        k2.space_to_depth(x.float(), w, stride)


@pytest.mark.parametrize("shape,k,stride", [((2, 227, 227, 3), 11, 4),
                                            ((3, 23, 19, 3), 11, 4),
                                            ((2, 9, 9, 4), 3, 2)])
def test_space_to_depth_f32_kernel_equals_plain(dev, shape, k, stride):
    """The repack kernel at f32 (the f32 route's conv1) moves bits too."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(shape, generator=gen, device=dev)
    w = torch.randn((k, k, shape[3], 16), generator=gen, device=dev)
    (xs, ws), counts = _counted(lambda: k2.space_to_depth(x, w, stride))
    assert _got(counts, "s2d.launches") == (1,)
    ref_x, ref_w = k2.space_to_depth_plain(x, w, stride)
    torch.cuda.synchronize()
    assert xs.dtype == torch.float32
    assert torch.equal(xs, ref_x) and torch.equal(ws, ref_w)


# -- K2's f32 route (csrc/conv_gemm_f32_sm90.cu) --------------------------------

# (x NHWC, w HWIO, stride, pad): CaffeNet's five convs, then ragged ones: M
# not a tile multiple, Cg = 4 and 12 (taps change inside a 32-k stage),
# groups 1/2/3, stride 1/2/4, pad 0/1/2, Og masked in a tile, a 1x1 conv,
# a space-to-depth repack at f32
K2_F32_GEOMS = {
    **{name: ((2, *xs[1:]), ws, s, p)
       for name, (xs, ws, s, p) in K2_SM90_GEOMS.items()
       if name.startswith("conv")},
    "g2_cg4_m243": ((3, 9, 9, 8), (3, 3, 4, 8), 1, 1),
    "cg12_og20_p2": ((3, 11, 7, 12), (5, 5, 12, 20), 1, 2),
    "g3_s2": ((2, 13, 13, 72), (3, 3, 24, 48), 2, 1),
    "s4_p2_direct": ((2, 35, 35, 16), (7, 7, 16, 32), 4, 2),
    "1x1_og200": ((2, 31, 31, 64), (1, 1, 64, 200), 1, 0),
    "s2d_small": ((3, 23, 23, 3), (11, 11, 3, 16), 4, 0),
}


def _k2_f32_operands(gen, geom, dev, batch=None):
    xs, ws, s, p = geom
    if batch is not None:
        xs = (batch, *xs[1:])
    x = torch.randn(xs, generator=gen, device=dev)
    w = torch.randn(ws, generator=gen, device=dev) * (ws[0] * ws[1] * ws[2]) ** -0.5
    b = torch.randn(ws[3], generator=gen, device=dev) * 0.1
    return x, w, b, dict(stride=(s, s), pad=(p, p), groups=xs[3] // ws[2])


def _f32_launches(counts):
    return _got(counts, "k2.launches", "k2.f32_launches", "s2d.launches")


@pytest.mark.parametrize("name", list(K2_F32_GEOMS))
def test_k2_f32_matches_plain_and_core(dev, name):
    """One launch per conv on the f32 route (plus conv1's repack), against
    the plain version and the core route on the same f32 operands, with and
    without bias and ReLU; a second run gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(len(name))
    x, w, b, geo = _k2_f32_operands(gen, K2_F32_GEOMS[name], dev)
    w_core = _core_view(w)
    route_kw = dict(stride=geo["stride"], pad=geo["pad"])
    assert k2.k2_route(x, w, torch.float32, **route_kw) == "f32"
    assert k2.k2_route(x, w_core, torch.float32, **route_kw) == "core"
    repack = int(w.shape[2] % 4 != 0)
    for bias, relu in ((None, False), (b, True)):
        kw = dict(geo, fuse_relu=relu)
        got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(x, w, bias, **kw))
        assert _f32_launches(counts) == (1, 1, repack)
        _close(got, k2.conv2d_gemm_nhwc_plain(x, w, bias, **kw))
        _close(got, k2.conv2d_gemm_nhwc(x, w_core, bias, **kw))
        assert torch.equal(got, k2.conv2d_gemm_nhwc(x, w, bias, **kw))


@pytest.mark.parametrize("batch", [2, 50])
@pytest.mark.parametrize("name", ["conv1", "conv2", "conv3", "conv4", "conv5"])
def test_k2_f32_caffenet_convs_match_plain_and_core(dev, name, batch):
    """CaffeNet's convs at batch 2 and 50 under the plan's tiles and splits:
    against the plain version and the core, within 1e-3 max|ref|, with and
    without bias and ReLU, one launch each; two runs give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(batch + len(name))
    x, w, b, geo = _k2_f32_operands(gen, K2_F32_GEOMS[name], dev, batch)
    for bias, relu in ((None, False), (b, True)):
        kw = dict(geo, fuse_relu=relu)
        got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(x, w, bias, **kw))
        assert _f32_launches(counts)[1] == 1
        _close(got, k2.conv2d_gemm_nhwc_plain(x, w, bias, **kw))
        _close(got, k2.conv2d_gemm_nhwc(x, _core_view(w), bias, **kw))
        assert torch.equal(got, k2.conv2d_gemm_nhwc(x, w, bias, **kw))


@pytest.mark.parametrize("tile", list(k2.F32_TILES))
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_k2_f32_every_tile_and_split(dev, tile, splits, monkeypatch):
    """Each tile shape at 1 to 5 splits on a grouped conv whose group width
    (96) every tile masks in its last column tile: within the tolerance of
    the plain version, and two runs give the same bits under split-K."""
    gen = torch.Generator(device=dev).manual_seed(sum(tile) + splits)
    x, w, b, geo = _k2_f32_operands(
        gen, ((3, 10, 10, 32), (3, 3, 16, 192), 1, 1), dev)
    monkeypatch.setattr(k2, "k2_f32_plan", lambda *a: (*tile, splits))
    kw = dict(geo, fuse_relu=True)
    got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(x, w, b, **kw))
    assert _f32_launches(counts)[1] == 1
    _close(got, k2.conv2d_gemm_nhwc_plain(x, w, b, **kw))
    assert torch.equal(got, k2.conv2d_gemm_nhwc(x, w, b, **kw))


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("name", ["conv1", "conv2", "conv4", "g3_s2",
                                  "cg12_og20_p2"])
def test_k2_f32_bit_for_bit_on_integers(dev, name, splits, monkeypatch):
    """Integer operands in [-2, 2] keep every f32 sum exact in any order, so
    the route's output equals the plain version's bit for bit, split or
    not; a bias of odd eighths and ReLU on top."""
    xs, ws, s, p = K2_F32_GEOMS[name]
    rs = np.random.RandomState(7)
    x = torch.as_tensor(rs.randint(-2, 3, xs).astype(np.float32), device=dev)
    w = torch.as_tensor(rs.randint(-2, 3, ws).astype(np.float32), device=dev)
    b = torch.as_tensor((2 * rs.randint(-64, 64, ws[3]) + 1) / 8,
                        dtype=torch.float32, device=dev)
    plan = k2.k2_f32_plan
    monkeypatch.setattr(k2, "k2_f32_plan",
                        lambda *a: (*plan(*a)[:2], min(splits, -(-a[3] // 32))))
    kw = dict(stride=(s, s), pad=(p, p), groups=xs[3] // ws[2], fuse_relu=True)
    got, counts = _counted(lambda: k2.conv2d_gemm_nhwc(x, w, b, **kw))
    assert _f32_launches(counts)[1] == 1
    ref = k2.conv2d_gemm_nhwc_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_k2_f32_misaligned_view_takes_the_core(dev):
    """x one element (4 bytes) past an aligned address: the core, one launch
    per group, and the f32 route's count stays."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x, w, b, geo = _k2_f32_operands(gen, K2_F32_GEOMS["conv4"], dev)
    x_off = torch.empty(x.numel() + 4, device=dev)[1:1 + x.numel()] \
        .view(x.shape).copy_(x)
    assert k2.k2_route(x_off, w, torch.float32, stride=geo["stride"],
                       pad=geo["pad"]) == "core"
    got, counts = _counted(
        lambda: k2.conv2d_gemm_nhwc(x_off, w, b, fuse_relu=True, **geo))
    assert _f32_launches(counts)[:2] == (geo["groups"], 0)
    _close(got, k2.conv2d_gemm_nhwc_plain(x, w, b, fuse_relu=True, **geo))


@pytest.mark.parametrize("name", ["conv1", "conv3", "conv4"])
def test_conv2d_nchw_f32_ignores_the_process_tf32_setting(dev, name):
    """The Net's f32 CONVOLUTION on the f32 route gives the same bits with
    TF32 allowed in the process and without: the route's products are
    exact f32 FFMAs."""
    c, hw, o, k, s, p, g = CAFFENET_NCHW[name]
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((2, c, hw, hw), generator=gen, device=dev)
    w = torch.randn((o, c // g, k, k), generator=gen, device=dev) * 0.05
    b = torch.randn(o, generator=gen, device=dev) * 0.1
    kw = dict(stride=(s, s), pad=(p, p), groups=g)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ys = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            y, counts = _counted(lambda: k2.conv2d_nchw(x, w, b, **kw))
            ys.append(y)
            assert _f32_launches(counts)[1] == 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])


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
        with plain_versions() if plain else contextlib.nullcontext():
            h, counts = _counted(lambda: tower_matmul(
                x, w, b, compute_dtype=torch.bfloat16))
        assert _got(counts, "k1.launches", "k1.sm90_launches") == (
            (0, 0) if plain else (1, 1))
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
        emb, counts = _counted(
            lambda: VideoEmbeddingModel(cfg).extract(params, feats))
        assert _got(counts, "k1.launches", "k1.sm90_launches") == (1, 1)
        with plain_versions():
            ref = VideoEmbeddingModel(cfg).extract(params, feats)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_net_on_k1_matches_the_net_on_plain(dev, dtype):
    """generate_net.py's TRAIN and TEST nets at small widths (D = 256, E =
    128, B = 16) through the port's Net with K1 and with its plain version
    (inside `plain_versions()`), on the same params and batch: one K1 launch per
    forward, on the f32 route for f32 operands and the sm90 route for
    bf16; loss within 1e-4 relative, fc7's gradients and the TEST net's
    normalized embeddings within 1e-3 of their largest magnitude."""
    import importlib.util
    from pathlib import Path

    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    spec = importlib.util.spec_from_file_location(
        "generate_net", Path(__file__).resolve().parent.parent
        / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    msg = parse(mod.emit("train.vvr", "test.vvr", batch=16, test_batch=40,
                         embed=128, weight_std=0.05))
    cd = None if dtype == "float32" else dtype
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {"data": torch.randn((16, 15, 256), generator=gen, device=dev)}
    test = {"data": torch.randn((40, 4, 256), generator=gen, device=dev),
            "video_ids": torch.randint(0, 8, (40,), generator=gen,
                                       device=dev).float()}
    outs = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            net = Net(msg, "TRAIN", compute_dtype=cd)
            params, _ = net.init(torch.Generator(device=dev).manual_seed(0),
                                 batch)
            p = {k: {n: v.requires_grad_() for n, v in d.items()}
                 for k, d in params.items()}
            with timer.tally() as counts:
                loss = net.loss_fn(
                    p, batch, torch.Generator(device=dev).manual_seed(1))
                loss.backward()
                test_net = Net(msg, "TEST", compute_dtype=cd)
                test_net.init(torch.Generator(device=dev).manual_seed(0), test)
                with torch.no_grad():
                    _, tout = test_net.apply(p, test, return_blobs=True)
            torch.cuda.synchronize()
        launched = _got(counts, "k1.launches", "k1.sm90_launches",
                        "k1.f32_launches")
        assert launched == ((0, 0, 0) if plain else
                            (2, 2, 0) if dtype == "bfloat16" else (2, 0, 2))
        outs.append((loss.item(), p["fc7"]["w"].grad, p["fc7"]["b"].grad,
                     tout))
    (lk, wk, bk, tk), (lp, wp, bp, tp) = outs
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for got, ref in ((wk, wp), (bk, bp)):
        assert (got - ref).abs().max().item() <= \
            1e-3 * ref.abs().max().item()
    assert 0.0 <= tk["test_map"].item() <= 1.0
    assert (tk["ctxn"] - tp["ctxn"]).abs().max().item() <= 1e-3


def test_fused_net_matches_unfused_on_the_card(dev):
    """The scoring fusion on the card at the flagship's 15 roles: the loss
    within 1e-5 relative, fc7's gradients within 1e-4 of their largest
    magnitude (the same K1 launches both ways; only the scoring head's
    reduction order differs), and fewer device operations."""
    import importlib.util
    from pathlib import Path

    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    spec = importlib.util.spec_from_file_location(
        "generate_net", Path(__file__).resolve().parent.parent
        / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    msg = parse(mod.emit("train.vvr", "test.vvr", batch=32, embed=256,
                         weight_std=0.05))
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"data": torch.randn((32, 15, 512), generator=gen, device=dev)}
    res = []
    for fuse in (False, True):
        net = Net(msg, "TRAIN", fuse_scoring=fuse)
        params, _ = net.init(torch.Generator(device=dev).manual_seed(0), batch)
        p = {k: {n: v.requires_grad_() for n, v in d.items()}
             for k, d in params.items()}
        with timer.tally() as counts:
            loss = net.loss_fn(p, batch,
                               torch.Generator(device=dev).manual_seed(1))
            loss.backward()
        torch.cuda.synchronize()
        assert _got(counts, "k1.launches") == (1,)
        res.append((loss.item(), p["fc7"]["w"].grad, p["fc7"]["b"].grad,
                    net._last_absorbed))
    (l0, w0, b0, a0), (l1, w1, b1, a1) = res
    assert a0 == 0 and a1 == 37
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for got, ref in ((w1, w0), (b1, b0)):
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_prefetcher_pinned_copies_equal_the_source(dev):
    """The prefetcher's path on the card (pinned staging buffers reused in
    a ring, the copy on a side stream, the consumer's stream waiting on its
    event, record_stream): 40 batches, each consumed by a kernel queued
    behind a slow one on the consumer's stream, equal the source's bytes."""
    from videovector_tpu_torch.data.prefetch import DevicePrefetcher
    rng = np.random.RandomState(3)
    host = [{"data": rng.randn(64, 15, 1024).astype(np.float32),
             "video_id": rng.randint(0, 1000, 64).astype(np.float32)}
            for _ in range(40)]
    pf = DevicePrefetcher(iter(host), depth=2, device="cuda")
    slow = torch.randn((2048, 2048), device=dev)
    sums = []
    for b in pf:
        assert b["data"].device.type == "cuda"
        for _ in range(4):          # keep the consumer's stream busy
            slow = torch.tanh(slow @ slow * 1e-3)
        sums.append((b["data"].double().sum(), b["video_id"].clone()))
    torch.cuda.synchronize()
    assert len(sums) == 40
    for (s, vid), h in zip(sums, host):
        assert s.item() == pytest.approx(h["data"].astype(np.float64).sum(),
                                         rel=1e-12, abs=1e-6)
        assert np.array_equal(vid.cpu().numpy(), h["video_id"])
    pf.close()


# -- the graph engine's CONVOLUTION on K2 (conv2d_nchw) ------------------------

# CaffeNet's convs as NCHW at batch 2: name -> (C, hw, O, k, stride, pad, groups)
CAFFENET_NCHW = {
    "conv1": (3, 227, 96, 11, 4, 0, 1),
    "conv2": (96, 27, 256, 5, 1, 2, 2),
    "conv3": (256, 13, 384, 3, 1, 1, 1),
    "conv4": (384, 13, 384, 3, 1, 1, 2),
    "conv5": (384, 13, 256, 3, 1, 1, 2),
}


def _k2_counts(counts):
    return _got(counts, "k2.launches", "k2.sm90_launches", "s2d.launches",
                "k2.f32_launches")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CAFFENET_NCHW))
def test_k2_net_entry_matches_plain(dev, name, dtype):
    """conv2d_nchw at CaffeNet's convs: f32 on the f32 route, bf16 on the
    sm90 route (one launch each, conv1 repacked), its output channels_last;
    forward and the plain backward against the plain version on the same
    operands."""
    c, hw, o, k, s, p, g = CAFFENET_NCHW[name]
    gen = torch.Generator(device=dev).manual_seed(len(name))
    x0 = torch.randn((2, c, hw, hw), generator=gen, device=dev)
    w0 = torch.randn((o, c // g, k, k), generator=gen, device=dev) \
        * (k * k * c // g) ** -0.5
    b0 = torch.randn(o, generator=gen, device=dev) * 0.1
    kw = dict(stride=(s, s), pad=(p, p), groups=g, compute_dtype=dtype)
    cot = torch.randn((2, o, (hw + 2 * p - k) // s + 1,
                       (hw + 2 * p - k) // s + 1), generator=gen,
                      device=dev).to(dtype)
    out = {}
    for plain in (False, True):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        with plain_versions() if plain else contextlib.nullcontext():
            y, counts = _counted(lambda: k2.conv2d_nchw(x, w, b, **kw))
            y.backward(cot)
        if plain:
            assert _k2_counts(counts) == (0, 0, 0, 0)
        else:
            f32 = dtype == torch.float32
            assert _k2_counts(counts) == (1, not f32, name == "conv1", f32)
            assert y.is_contiguous(memory_format=torch.channels_last)
        out[plain] = (y.detach(), x.grad, w.grad, b.grad)
    (y, dx, dw, db), (y_ref, dx_ref, dw_ref, db_ref) = out[False], out[True]
    assert y.dtype == dtype
    _close(y, y_ref)
    # dx and dw are rounded to the compute dtype: cuDNN's sums, in an order
    # that may change from run to run, can round a bf16 step apart
    for got, ref in ((dx, dx_ref), (dw, dw_ref)):
        assert got.dtype == torch.float32
        _close(got, ref, REL_TOL[dtype])
    _close(db, db_ref)


def _card_extraction(dev, compute_dtype, plain, params, batch):
    from torch_extraction_net import extraction_net
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    net = Net(parse(extraction_net(widths=WIDE8)), "TEST",
              compute_dtype=compute_dtype)
    with plain_versions() if plain else contextlib.nullcontext(), \
            torch.inference_mode():
        (_, blobs), counts = _counted(
            lambda: net.apply(params, batch, return_blobs=True))
    k1_delta = _got(counts, "k1.launches", "k1.sm90_launches",
                    "k1.f32_launches")
    return blobs, k1_delta, _k2_counts(counts)


# the narrowed extraction net at widths the sm90 route takes (every channel
# count per group a multiple of 8)
WIDE8 = {"96": "16", "256": "32", "384": "48", "4096": "64"}


def _extraction_params(dev, seed=3):
    from torch_extraction_net import BATCH, CROP, extraction_net
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"data": torch.randn((BATCH, 3, CROP, CROP), generator=gen,
                                 device=dev) * 40,
             "label": torch.zeros(BATCH, device=dev)}
    net = Net(parse(extraction_net(widths=WIDE8)), "TEST")
    params, _ = net.init(gen, batch)
    for lp in params.values():
        for name, t in lp.items():
            # conv OIHW: fan-in C*kh*kw; fc (K, N): K
            fan_in = t.shape[0] if t.dim() == 2 else t[0].numel()
            t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                    * (fan_in ** -0.5 if name == "w" else 0.1))
    return params, batch


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_extraction_net_on_the_kernels_matches_plain(dev, compute_dtype):
    """The narrowed extraction Net (CaffeNet's layers and geometry) on K1
    and K2 against its plain versions on the card. f32: 5 K2 launches on the
    f32 route + conv1's repack, fc6, fc7 on K1's f32 route; bf16: 5 sm90
    K2 launches + conv1's repack, fc6, fc7 on sm90."""
    params, batch = _extraction_params(dev)
    blobs, k1d, k2d = _card_extraction(dev, compute_dtype, False, params,
                                       batch)
    ref, k1p, k2p = _card_extraction(dev, compute_dtype, True, params, batch)
    assert k1p == (0, 0, 0) and k2p == (0, 0, 0, 0)
    if compute_dtype is None:
        assert k2d == (5, 0, 1, 5) and k1d == (2, 0, 2)
    else:
        assert k2d == (5, 5, 1, 0) and k1d == (2, 2, 0)
    # a bf16 chain: a rounding step flipped early moves the later blobs
    rel = REL_TOL[torch.bfloat16] if compute_dtype else None
    for name in ("conv1", "norm2", "pool5", "ip1_nonorm", "ip2"):
        _close(blobs[name], ref[name], rel)


def test_caffemodel_fc_weights_take_k1s_f32_route(dev, tmp_path):
    """fc6 and fc7 loaded from a .caffemodel (Caffe's (N, K) blobs,
    transposed and made contiguous on load) take K1's f32 route."""
    from videovector_tpu_torch.data.weights import (
        NetWeights, load_into_params, params_to_weights,
    )
    params, batch = _extraction_params(dev, seed=4)
    path = str(tmp_path / "w.caffemodel")
    params_to_weights(params).save(path)
    loaded = load_into_params(NetWeights.load(path), {
        ln: {k: torch.zeros_like(v) for k, v in lp.items()}
        for ln, lp in params.items()})
    for ln in ("fc6", "fc7"):
        assert loaded[ln]["w"].device == params[ln]["w"].device
        assert torch.equal(loaded[ln]["w"], params[ln]["w"])
        assert k1.k1_route(torch.zeros((2, loaded[ln]["w"].shape[0]),
                                       device=dev), loaded[ln]["w"],
                           torch.float32) == "f32"
    blobs, k1d, _ = _card_extraction(dev, None, False, loaded, batch)
    assert k1d == (2, 0, 2)
    ref, _, _ = _card_extraction(dev, None, True, params, batch)
    _close(blobs["ip2"], ref["ip2"])


def _with_tf32(flag: bool, fn):
    """fn() with torch's global TF32 flag for matmuls set to `flag`; the
    flag must come back as fn found it, and is reset to off after."""
    torch.backends.cuda.matmul.allow_tf32 = flag
    try:
        out = fn()
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _tf32_reaches(dev, x):
    """The flag does change an unscoped f32 product of these operands."""
    a, b = (_with_tf32(f, lambda: x @ x.T) for f in (True, False))
    torch.cuda.synchronize()
    assert not torch.equal(a, b)


def test_regularized_inner_product_ignores_the_process_tf32_setting(dev):
    """The Net's INNER_PRODUCT with regularization > 0 (ops.linear's
    _Dot): the forward and both gradients with TF32 on in the
    process equal the run with it off, bit for bit."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    net = Net(parse("""
    layers { name: "d" type: MEMORY_DATA top: "x" }
    layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "y"
      inner_product_param { num_output: 384 regularization: 0.5
        weight_filler { type: "gaussian" std: 0.1 } } }
    """), "TRAIN")
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((256, 512), generator=gen, device=dev)
    params, _ = net.init(gen, {"x": x})
    _tf32_reaches(dev, x)

    def run():
        p = {"ip": {k: v.clone().requires_grad_() for k, v in
                    params["ip"].items()}}
        xi = x.clone().requires_grad_()
        y = net.apply(p, {"x": xi})[1]["y"]
        y.backward(torch.ones_like(y))
        return [y.detach(), xi.grad, p["ip"]["w"].grad, p["ip"]["b"].grad]
    on, off = (_with_tf32(f, run) for f in (True, False))
    torch.cuda.synchronize()
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_pipeline_query_ignores_the_process_tf32_setting(dev):
    """RetrievalPipeline.query's scores against the gallery, and so its
    top-k ids, are the same with TF32 on in the process as with it off."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    pipe = RetrievalPipeline(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = pipe.init(gen)
    pix = torch.randint(0, 256, (4, 256, 256, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    zeros = torch.zeros(4, dtype=torch.int32, device=dev)
    gallery = torch.nn.functional.normalize(
        torch.randn((2048, 4096), generator=gen, device=dev), dim=1)
    ids = torch.arange(2048, dtype=torch.int32, device=dev)
    _tf32_reaches(dev, gallery[:256])
    on, off = (_with_tf32(f, lambda: pipe.query(
        params, pix, zeros + 14, zeros + 14, zeros.bool(), gallery, ids))
        for f in (True, False))
    torch.cuda.synchronize()
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


def test_query_spans_hold_the_kernels_launches_and_no_device_work(dev):
    """One profiled query of the full-width pipeline: K2's five convs, K1's
    three products and conv1's repack are spans (`vvtpu.k2`, `vvtpu.k1`,
    `vvtpu.s2d` inside conv1's `vvtpu.k2`), each with its ctypes call as
    the child `.launch`, and the counter `vvtpu.cast_bytes` reads 2 bytes
    a weight. A span's range on the device's timeline is a user annotation,
    never a device operation."""
    from torch.profiler import ProfilerActivity, profile

    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    pipe = RetrievalPipeline(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = pipe.init(gen)
    pix = torch.randint(0, 256, (4, 256, 256, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    zeros = torch.zeros(4, dtype=torch.int32, device=dev)
    gallery = torch.nn.functional.normalize(
        torch.randn((2048, 4096), generator=gen, device=dev), dim=1)
    ids = torch.arange(2048, dtype=torch.int32, device=dev)

    def query():
        out = pipe.query(params, pix, zeros + 14, zeros + 14, zeros.bool(),
                         gallery, ids)
        torch.cuda.synchronize()
        return out
    query()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        query()
    rec = timer.recorded()
    spans = rec.spans
    names = [s.name for s in spans]
    assert names.count("vvtpu.k2") == 5 and names.count("vvtpu.k1") == 3
    assert names.count("vvtpu.s2d") == 1
    for kernel, launches in (("vvtpu.k2", 5), ("vvtpu.k1", 3),
                             ("vvtpu.s2d", 1)):
        found = [s for s in spans if s.name == kernel + ".launch"]
        assert len(found) == launches
        assert all(spans[s.parent].name == kernel for s in found)
    (s2d,) = [s for s in spans if s.name == "vvtpu.s2d"]
    assert spans[s2d.parent].name == "vvtpu.k2"
    weights = sum(v["w"].numel() for v in params["mednet"].values()) + \
        params["tower"]["w"].numel()
    assert rec.counters["vvtpu.cast_bytes"] == 2 * weights
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name.startswith("vvtpu.")]
    assert all(getattr(e, "is_user_annotation", False) for e in device), \
        sorted({e.name for e in device})


def _serving(dev, seed=7, rows=4096):
    """A full-width pipeline on the card, its params, a gallery of `rows`
    unit rows with permuted ids, and the generator that drew them."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    pipe = RetrievalPipeline(device=dev)
    params = pipe.init(gen)
    gallery = torch.nn.functional.normalize(
        torch.randn((rows, 4096), generator=gen, device=dev), dim=1)
    ids = torch.randperm(rows, generator=gen, device=dev).to(torch.int32)
    return pipe, params, gallery, ids, gen


def _clip(gen, n, dev):
    """One query's n frames with their own crop offsets and mirrors."""
    pix = torch.randint(0, 256, (n, 256, 256, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    h, w = (torch.randint(0, 30, (n,), generator=gen, device=dev)
            for _ in range(2))
    return pix, h, w, torch.randint(0, 2, (n,), generator=gen,
                                     device=dev) > 0


def _eager_query(dev, params, frames, gallery, ids):
    """A fresh pipeline's first query, which runs eagerly."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    pipe = RetrievalPipeline(device=dev)
    out = pipe.query(params, *frames, gallery, ids)
    assert pipe._graph is None
    return out


def _equal(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_replayed_queries_equal_the_eager_query_bit_for_bit(dev):
    """Eight queries at one shape, each with its own clip, offsets and
    mirrors: the first runs eagerly, the second is captured and replayed,
    the rest replayed; every answer is bit-equal to a fresh pipeline's
    eager one, and stays as it was after the later calls. After updates
    in place to the gallery and a weight, the replay sees them."""
    pipe, params, gallery, ids, gen = _serving(dev)
    clips = [_clip(gen, 50, dev) for _ in range(8)]
    held, copies, replays = [], [], []
    for frames in clips:
        out, counts = _counted(
            lambda: pipe.query(params, *frames, gallery, ids))
        held.append(out)
        copies.append(tuple(t.clone() for t in out))
        replays.append(counts.get("vvtpu.query.graph_replays", 0))
    assert replays == [0] + [1] * 7
    for frames, out, copy in zip(clips, held, copies):
        assert out[0].shape == (50, 5) and out[1].shape == (50, 5)
        assert _equal(out, copy)
        assert _equal(out, _eager_query(dev, params, frames, gallery, ids))
    gallery.mul_(-1.0)
    params["mednet"]["conv1"]["w"].mul_(2.0)
    out, counts = _counted(
        lambda: pipe.query(params, *clips[0], gallery, ids))
    assert counts["vvtpu.query.graph_replays"] == 1
    assert _equal(out, _eager_query(dev, params, clips[0], gallery, ids))
    assert not _equal(out, held[0])


@pytest.mark.parametrize("change", ["gallery", "params", "batch"])
def test_another_gallery_params_or_batch_runs_eagerly(dev, change):
    """After a capture, a query with another gallery tensor, another
    params dict or another batch size is not replayed and answers as the
    eager query does; its second call captures it in the first one's
    place, bit-equal again."""
    pipe, params, gallery, ids, gen = _serving(dev)
    frames = _clip(gen, 50, dev)
    for _ in range(2):
        pipe.query(params, *frames, gallery, ids)
    first = pipe._graph.key
    if change == "gallery":
        gallery = torch.nn.functional.normalize(
            torch.randn(gallery.shape, generator=gen, device=dev), dim=1)
    elif change == "params":
        params = pipe.init(gen)
    else:
        frames = _clip(gen, 20, dev)
    want = _eager_query(dev, params, frames, gallery, ids)
    for replayed in (0, 1):
        out, counts = _counted(
            lambda: pipe.query(params, *frames, gallery, ids))
        assert counts.get("vvtpu.query.graph_replays", 0) == replayed
        assert _equal(out, want)
    assert pipe._graph.key != first


def test_plain_host_offsets_and_first_calls_never_capture(dev):
    """`plain_versions()`, Python-int offsets and a pipeline's first call
    run eagerly every time: no graph is kept and none replayed; a graph
    captured outside `plain_versions()` is not replayed inside it."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    pipe, params, gallery, ids, gen = _serving(dev)
    pix, h, w, mirror = _clip(gen, 8, dev)
    plain = RetrievalPipeline(device=dev)

    def plain_query():
        with plain_versions():
            return plain.query(params, pix, h, w, mirror, gallery, ids)
    calls = [plain_query,
             lambda: pipe.query(params, pix, 14, 14, False, gallery, ids)]
    for call in calls:
        for _ in range(3):
            _, counts = _counted(call)
            assert "vvtpu.query.graph_replays" not in counts
            if call is plain_query:
                assert not [k for k in counts if k.endswith("launches")]
    assert plain._graph is None and pipe._graph is None
    _, counts = _counted(lambda: pipe.query(params, pix, h, w, mirror,
                                            gallery, ids))
    assert "vvtpu.query.graph_replays" not in counts
    assert pipe._graph is None
    for _ in range(2):
        pipe.query(params, pix, h, w, mirror, gallery, ids)
    assert pipe._graph is not None
    with plain_versions():
        _, counts = _counted(lambda: pipe.query(params, pix, h, w, mirror,
                                                gallery, ids))
    assert "vvtpu.query.graph_replays" not in counts
    assert not [k for k in counts if k.endswith("launches")]


@pytest.mark.parametrize("shape,k,stride,pad", [
    ((50, 224, 224, 3), 7, 2, 3),       # GoogLeNet's conv1
    ((3, 31, 23, 3), 7, 2, 3),          # ragged, not square
    ((1, 20, 17, 3), 5, 3, 2),
    ((2, 228, 228, 3), 11, 4, 0),       # a step past the image, no pad
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_padded_space_to_depth_kernel_equals_plain(dev, shape, k, stride,
                                                   pad, dtype):
    """The repack with padding, and channels rounded up to a 16-byte chunk,
    moves bits: equal to the plain version's."""
    gen = torch.Generator(device=dev).manual_seed(k + pad)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = torch.randn((k, k, 3, 64), generator=gen, device=dev).to(dtype)
    (xs, ws), counts = _counted(
        lambda: k2.space_to_depth(x, w, stride, pad))
    assert _got(counts, "s2d.launches") == (1,)
    ref_x, ref_w = k2.space_to_depth_plain(x, w, stride, pad)
    torch.cuda.synchronize()
    assert xs.shape == ref_x.shape and ws.shape == ref_w.shape
    assert torch.equal(xs, ref_x) and torch.equal(ws, ref_w)


def test_caffenet_conv1_repack_is_unchanged(dev):
    """CaffeNet's conv1 (11x11/4, no pad, 227 at batch 50): the repack
    writes what it wrote before it took padding, the reshape of the image
    and of the kernel padded at their ends, 48 channels; the conv over it
    stays on the sm90 route, bit-equal from one call to the next."""
    gen = torch.Generator(device=dev).manual_seed(21)
    x = _randn(gen, 50, 227, 227, 3, dev=dev)
    w = _randn(gen, 11, 11, 3, 96, dev=dev)
    xs, ws = k2.space_to_depth(x, w, 4)
    old_x = torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 1)).reshape(
        50, 57, 4, 57, 4, 3).permute(0, 1, 3, 2, 4, 5).reshape(50, 57, 57, 48)
    old_w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, 1, 0, 1)).reshape(
        3, 4, 3, 4, 3, 96).permute(0, 2, 1, 3, 4, 5).reshape(3, 3, 48, 96)
    torch.cuda.synchronize()
    assert torch.equal(xs, old_x) and torch.equal(ws, old_w)
    b = torch.randn(96, generator=gen, device=dev)
    kw = dict(stride=(4, 4), fuse_relu=True, out_dtype=torch.bfloat16)
    (got, again), counts = _counted(
        lambda: [k2.conv2d_gemm_nhwc(x, w, b, **kw) for _ in range(2)])
    assert _got(counts, "k2.sm90_launches", "s2d.launches") == (2, 2)
    _close(got, k2.conv2d_gemm_nhwc_plain(x, w, b, **kw))
    assert torch.equal(got, again)


def _googlenet_serving(dev, seed=17, rows=4096):
    """A full-width GoogLeNet pipeline on the card, its params, a gallery
    of `rows` unit rows of 1,024 with permuted ids, and the generator."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = RetrievalPipelineConfig(backbone="googlenet", crop=224,
                                  embed_dim=1024)
    pipe = RetrievalPipeline(cfg, device=dev)
    params = pipe.init(gen)
    gallery = torch.nn.functional.normalize(
        torch.randn((rows, 1024), generator=gen, device=dev), dim=1)
    ids = torch.randperm(rows, generator=gen, device=dev).to(torch.int32)
    return pipe, params, gallery, ids, gen


def test_googlenet_convs_all_take_the_sm90_route(dev):
    """One GoogLeNet forward at 50 frames: 57 K2 launches, all on the sm90
    route, conv1 after one repack, none on the core; the pool5 features
    within 2e-2 (relative L2) of the plain forward's (each conv rounds to
    bf16 on both sides, summed in another order)."""
    from videovector_tpu_torch.models.googlenet import GoogLeNet
    pipe, params, _, _, gen = _googlenet_serving(dev)
    frames = _clip(gen, 50, dev)
    x = pipe.transform(*frames)
    got, counts = _counted(
        lambda: pipe.googlenet.forward(params["googlenet"], x))
    assert _got(counts, "k2.launches", "k2.sm90_launches",
                "s2d.launches") == (57, 57, 1)
    with plain_versions():
        plain = GoogLeNet(pipe.googlenet.cfg).forward(params["googlenet"], x)
    torch.cuda.synchronize()
    assert got.shape == (50, 1024)
    assert float((got - plain).norm() / plain.norm()) < 2e-2


def test_googlenet_replays_equal_the_eager_query_bit_for_bit(dev):
    """GoogLeNet's query through the same graph capture as CaffeNet's:
    the first call eager, the second captured and replayed, the rest
    replayed; each answer, and the pool5 features `features` holds after
    it (a replay's the graph's own buffer), bit-equal to a fresh
    pipeline's eager ones; each replay adds the capture's
    `vvtpu.concat_bytes` (123.56 MB at 50 frames)."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    pipe, params, gallery, ids, gen = _googlenet_serving(dev)
    clips = [_clip(gen, 50, dev) for _ in range(4)]
    replays, concat = [], []
    for frames in clips:
        out, counts = _counted(
            lambda: pipe.query(params, *frames, gallery, ids))
        replays.append(counts.get("vvtpu.query.graph_replays", 0))
        concat.append(counts.get("vvtpu.concat_bytes", 0))
        fresh = RetrievalPipeline(pipe.cfg, device=dev)
        want = fresh.query(params, *frames, gallery, ids)
        assert fresh._graph is None
        assert out[0].shape == (50, 5) and _equal(out, want)
        assert pipe.features.shape == (50, 1024)
        assert torch.equal(pipe.features, fresh.features)
        if replays[-1]:
            assert pipe.features is pipe._graph.features
    assert replays == [0, 1, 1, 1]
    assert concat == [123_558_400] * 4


def test_a_replayed_query_under_the_profiler_shows_its_kernels(dev):
    """A profiled query that is a replay: K2 (conv_wgmma and conv1's
    space_to_depth), K1 (gemm_tma_wgmma) and cuBLAS's score GEMM are in the
    device trace by name, inside the span `vvtpu.query.replay` with no
    wrapper's span; `vvtpu.query.graph_replays` reads 1 and
    `vvtpu.cast_bytes` what the eager query casts. A profiled second call
    is not captured."""
    from torch.profiler import ProfilerActivity, profile

    pipe, params, gallery, ids, gen = _serving(dev)
    frames = _clip(gen, 50, dev)

    def query():
        out = pipe.query(params, *frames, gallery, ids)
        torch.cuda.synchronize()
        return out
    query()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        query()
    eager = timer.recorded()
    assert pipe._graph is None and "vvtpu.k2" in {s.name for s in eager.spans}
    query()                                       # captured
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = query()
    rec = timer.recorded()
    assert rec.counters["vvtpu.query.graph_replays"] == 1
    assert rec.counters["vvtpu.cast_bytes"] == \
        eager.counters["vvtpu.cast_bytes"]
    names = [s.name for s in rec.spans]
    assert names == ["vvtpu.query", "vvtpu.query.replay"]
    device = {e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    for kernel in ("vv::conv90::conv_wgmma", "vv::conv90::space_to_depth",
                   "vv::sm90::gemm_tma_wgmma"):
        assert any(kernel in n for n in device), (kernel, sorted(device))
    assert any("gemm" in n and "vv::" not in n for n in device), \
        sorted(device)
    assert _equal(out, _eager_query(dev, params, frames, gallery, ids))


def test_rank_stats_dist_ignores_the_process_tf32_setting(dev):
    """retrieval_rank_stats_fixed_ref's -2 x.y^T, and so its order and
    ranks, are the same with TF32 on in the process as with it off."""
    from videovector_tpu_torch.metrics import retrieval as tr
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((673, 1024), generator=gen, device=dev)
    g = torch.randn((4096, 1024), generator=gen, device=dev)
    qv = torch.randint(0, 50, (673,), generator=gen, device=dev)
    gv = torch.randint(-1, 50, (4096,), generator=gen, device=dev)
    _tf32_reaches(dev, q)
    on, off = (_with_tf32(f, lambda: tr._fixed_ref_peritem(q, qv, g, gv))
               for f in (True, False))
    torch.cuda.synchronize()
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_golden_fixtures_through_the_f32_routes(dev):
    """tests/golden/ (1e-5 per blob) and the full-width extraction tower of
    tests/golden_fullscale.npz (nrm_err 2e-5, rel_big 1e-3 per blob) on the
    card: every CONVOLUTION on K2 (the f32 route where it addresses the
    operands, else the core) and every INNER_PRODUCT on K1's f32 route, as
    the CPU test holds the plain versions."""
    import torch_golden as tg
    with timer.tally() as counts:
        blobs, golden = tg.mini_golden(dev)
        for name, want in golden.items():
            np.testing.assert_allclose(blobs[name], want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        tg.assert_fullscale_within_bounds(tg.fullscale_errors(
            tg.fullscale_blobs(dev)))
    # two nets: 2 fc each on K1's f32 route; the mini net's conv1 (3
    # channels, 5x5/2 with pad 2) on the f32 route after its padded
    # repack, its conv2 on K2's core (6 outputs a group), one launch per
    # group; the full tower's 5 on the f32 route, one launch each, conv1
    # after its repack
    assert _got(counts, "k1.f32_launches", "k2.launches", "k2.f32_launches",
                "s2d.launches") == (4, 1 + 2 + 5, 1 + 5, 2)


# -- item 9: the LSTM family, social pooling, the trajectory project ----------

def _trajectory_net(tmp_path, rng, **kw):
    """projects/trajectory_forecast's prototxt (generate_net.emit, loaded by
    path) over stores the port writes."""
    import importlib.util
    from pathlib import Path

    from videovector_tpu_torch.tools.make_tracking_data import write_windows
    proj = Path(__file__).resolve().parent.parent / "projects/trajectory_forecast"
    spec = importlib.util.spec_from_file_location(
        "trajproj_generate_net", proj / "generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    train = write_windows(str(tmp_path / "train.vvr"), rng, 12)
    test = write_windows(str(tmp_path / "test.vvr"), rng, 4)
    return mod.emit(train, test, **kw)


def test_trajectory_net_on_the_card_matches_the_cpu(dev, tmp_path):
    """The project's TRAIN Net (LSTM_ENC_DEC, the readout on K1) on the card
    against the CPU on the same params and batch: the loss within 1e-4
    relative, every gradient within 1e-3 of its largest magnitude; the
    readout is one K1 launch."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.graph.data_factory import make_data_source
    rng = np.random.RandomState(11)
    msg = parse(_trajectory_net(tmp_path, rng))
    net = Net(msg, "TRAIN")
    layer = next(l for l in net.layers if l.get("type") == "TRACKING_WINDOWS_DATA")
    batch = make_data_source(layer).next_batch()
    params, _ = net.init(torch.Generator().manual_seed(0),
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    out = {}
    for d in ("cpu", dev):
        p = {ln: {pn: t.detach().to(d).requires_grad_()
                  for pn, t in lp.items()} for ln, lp in params.items()}
        loss, counts = _counted(lambda: net.loss_fn(
            p, {k: torch.as_tensor(v, device=d) for k, v in batch.items()}))
        if d == dev:
            assert _got(counts, "k1.launches") == (1,)
        loss.backward()
        out[str(d)] = (loss.item(), {f"{ln}/{pn}": t.grad.cpu() for ln, lp
                                     in p.items() for pn, t in lp.items()})
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k


def test_lstm_carry_is_detached_and_memory_stays_flat(dev):
    """train over a stateful Net on the card: the carry enters each step
    detached (truncated BPTT), so the memory in use is the same at the top
    of every step after the first two (an attached carry would keep each
    earlier step's graph alive)."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train
    net = Net(parse("""
    layers { name: "d" type: MEMORY_DATA top: "x" top: "cont" top: "y" }
    layers { name: "rnn" type: LSTM bottom: "x" bottom: "cont" top: "h"
      inner_product_param { num_output: 256
        weight_filler { type: "gaussian" std: 0.05 } } }
    layers { name: "fb" type: FLATTEN_BATCH bottom: "h" top: "hf" }
    layers { name: "yf" type: FLATTEN_BATCH bottom: "y" top: "yf" }
    layers { name: "loss" type: EUCLIDEAN_LOSS bottom: "hf" bottom: "yf"
      top: "l" }
    """), "TRAIN")
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [{"x": torch.randn((10, 64, 128), generator=gen, device=dev),
                "cont": torch.ones((10, 64), device=dev),
                "y": torch.randn((10, 64, 256), generator=gen, device=dev)}
               for _ in range(7)]
    params, _ = net.init(gen, batches[0])

    def loss_fn(p, batch, generator):
        feed = {k: v for k, v in batch.items() if k != "__carry__"}
        loss, _, carry = net.apply(p, feed, state=batch.get("__carry__"),
                                   return_state=True)
        return loss, {"__carry__": carry}
    used = []

    def hook(p, it):
        torch.cuda.synchronize()
        used.append(torch.cuda.memory_allocated(dev))
    res = train(loss_fn, params, iter(batches), SolverConfig(
        base_lr=0.01, momentum=0.9, max_iter=6), device=dev,
        hooks=[(1, hook)], fused_accum=False)
    assert len(used) == 6
    assert used[2:] == [used[2]] * 4, used
    assert not res.final_carry["rnn"].h.requires_grad


def test_lstm_products_ignore_the_process_tf32_setting(dev):
    """The LSTM's input projection and recurrent products, the conditional
    decoder's h2o/o2h products and the social projection (ops.linear.dot),
    forward and backward: with TF32 on in the process, bit for bit the run
    with it off."""
    from videovector_tpu_torch.models.trajectory import (
        TrajectoryConfig, TrajectoryModel,
    )
    from videovector_tpu_torch.ops import recurrent
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((12, 256, 512), generator=gen, device=dev)
    _tf32_reaches(dev, x[0])
    cont = torch.ones((12, 256), device=dev)
    params = recurrent.init_lstm_params(gen, 512, 512, conditional=True,
                                        output_dim=16)
    first = torch.randn((256, 16), generator=gen, device=dev)
    b = 64
    social = {"observed": torch.randn((8, b, 3), generator=gen, device=dev),
              "cont_observed": torch.ones((8, b), device=dev),
              "predicted": torch.randn((4, b, 3), generator=gen, device=dev),
              "cont_predicted": torch.ones((4, b), device=dev),
              "mean_pos": torch.randn((b, 2), generator=gen, device=dev),
              "relations": 1 - torch.eye(b, device=dev),
              "is_valid": torch.ones((b,), device=dev),
              "labels": torch.randn((4, b, 2), generator=gen, device=dev)}
    model = TrajectoryModel(TrajectoryConfig(hidden=512, pool_feat_size=256))
    mparams = model.init(gen)

    def grads_of(fn, tree):
        leaves = {k: v.clone().requires_grad_() for k, v in tree.items()}
        outs = fn(leaves)
        sum(o.float().sum() for o in outs).backward()
        return [o.detach() for o in outs] + [v.grad for v in leaves.values()]

    def lstm(p):
        h, fin = recurrent.lstm(p, x, cont, clip_threshold=1.0)
        return [h, fin.c]
    base = {k: params[k] for k in ("w_i", "w_h", "b")}

    def run():
        return (grads_of(lstm, base)
                + grads_of(lambda p: [recurrent.lstm_conditional(
                    p, x, first, cont)[0]], params)
                + grads_of(lambda sp: [model.loss(
                    {**mparams, "social_proj": sp}, social)[0]],
                    mparams["social_proj"]))
    on, off = (_with_tf32(f, run) for f in (True, False))
    torch.cuda.synchronize()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _python_sampler(path: str, seed: int = 5):
    """VIDEO_SAMPLED_SHOTS_DATA over `path` from the port's factory with the
    native sampler off (it reads VVR only), as an LMDB store feeds it."""
    import os
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.shots import VideoSampledShotsSource
    from videovector_tpu_torch.graph.data_factory import make_data_source
    layer = parse(
        'layers { name: "d" type: VIDEO_SAMPLED_SHOTS_DATA top: "data" '
        f'video_sampled_shots_data_param {{ source: "{path}" batch_size: 16 '
        "num_negative_samples: 10 max_buffer_size: 60 "
        "negative_swap_percentage: 50 max_same_video_negs: 2 "
        "context_type: WINDOW context_size: 5 } }").get_list("layers")[0]
    old = os.environ.get("VVTPU_NATIVE_DATA")
    os.environ["VVTPU_NATIVE_DATA"] = "0"
    try:
        src = make_data_source(layer, seed=seed)
    finally:
        if old is None:
            os.environ.pop("VVTPU_NATIVE_DATA")
        else:
            os.environ["VVTPU_NATIVE_DATA"] = old
    assert isinstance(src.source, VideoSampledShotsSource)
    return src


def test_lmdb_fed_net_step_equals_the_vvr_fed_one(dev, tmp_path):
    """generate_net.py's TRAIN Net (D = 256, E = 128, B = 16) on the card,
    one step from an LMDB copy of a shot store and one from the VVR store:
    the same batch, then the same loss and fc7 gradients, bit for bit, one
    K1 launch on the f32 route each."""
    import importlib.util
    from pathlib import Path

    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.records import open_store, open_store_writer
    from videovector_tpu_torch.data.shots import ShotDataset, ShotVideo
    from videovector_tpu_torch.graph import Net
    rs = np.random.RandomState(2)
    vvr = str(tmp_path / "shots.vvr")
    ShotDataset([ShotVideo(v + 1, np.arange(9, dtype=np.int32),
                           np.abs(rs.randn(9, 256)).astype(np.float32))
                 for v in range(12)]).to_records(vvr)
    lmdb = str(tmp_path / "shots_lmdb")
    with open_store_writer(lmdb, "lmdb") as w:
        for key, value in open_store(vvr):
            w.put(key, bytes(value))
    spec = importlib.util.spec_from_file_location(
        "generate_net", Path(__file__).resolve().parent.parent
        / "projects/videovec_embedding/generate_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    msg = parse(mod.emit(vvr, "test.vvr", batch=16, test_batch=40, embed=128,
                         weight_std=0.05))
    runs = []
    for path in (vvr, lmdb):
        batch = {"data": torch.as_tensor(
            _python_sampler(path).next_batch()["data"], device=dev)}
        net = Net(msg, "TRAIN")
        params, _ = net.init(torch.Generator(device=dev).manual_seed(0), batch)
        p = {k: {n: v.requires_grad_() for n, v in d.items()}
             for k, d in params.items()}
        with timer.tally() as counts:
            loss = net.loss_fn(p, batch,
                               torch.Generator(device=dev).manual_seed(1))
            loss.backward()
        torch.cuda.synchronize()
        assert _got(counts, "k1.launches", "k1.f32_launches") == (1, 1)
        runs.append((batch["data"], loss.detach(), p["fc7"]["w"].grad,
                     p["fc7"]["b"].grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_extraction_into_lmdb_and_leveldb_equals_vvr_on_the_card(dev,
                                                                  tmp_path):
    """extract on the card over an LMDB frame store with the narrowed
    extraction net (widths the f32 routes take): --backend=vvr, lmdb and
    leveldb each launch 5 K2 f32-route convs + conv1's repack and 2 K1
    f32-route products a batch, and the features in the LMDB and LevelDB
    stores are the vvr store's bit for bit."""
    from torch_extraction_net import BATCH, data_layer_net
    from videovector_tpu_torch.data.records import open_store, open_store_writer
    from videovector_tpu_torch.data.wire import BlobProto, Datum
    from videovector_tpu_torch.tools import extract_features
    rs = np.random.RandomState(6)
    store = str(tmp_path / "frames_lmdb")
    with open_store_writer(store, "lmdb") as w:
        for i in range(6):
            pix = rs.randint(0, 256, (3, 112, 112)).astype(np.uint8)
            w.put(f"{i:08d}", Datum(channels=3, height=112, width=112,
                                    data=pix.tobytes(), label=i).encode())
    mean = tmp_path / "mean.blob"
    mean.write_bytes(BlobProto.from_array(
        np.full((1, 3, 112, 112), 120.0, np.float32)).encode())
    net = tmp_path / "net.prototxt"
    net.write_text(data_layer_net(store, str(mean), widths=WIDE8))
    batches, n = 3, 3 * BATCH
    feats = {}
    for backend in ("vvr", "lmdb", "leveldb"):
        counts, launched = _counted(lambda: extract_features.extract(
            str(net), [], ["ip2"], str(tmp_path / "out"), batches,
            backend=backend, device="cuda"))
        assert counts == {"ip2": n}
        assert _got(launched, "k1.launches", "k1.sm90_launches",
                    "k1.f32_launches") == (2 * batches, 0, 2 * batches)
        assert _k2_counts(launched) == (5 * batches, 0, batches, 5 * batches)
        path = str(tmp_path / {"vvr": "out_ip2.vvr", "lmdb": "out_ip2_lmdb",
                               "leveldb": "out_ip2_leveldb"}[backend])
        r = open_store(path)
        rows = {int(r.key(i)): Datum.decode(bytes(r.value(i))).float_data
                for i in range(len(r))}
        r.close()
        feats[backend] = np.stack([rows[i] for i in range(n)])
    assert feats["lmdb"].tobytes() == feats["vvr"].tobytes()
    assert feats["leveldb"].tobytes() == feats["vvr"].tobytes()


def test_crc32c_takes_the_native_twin_on_the_card_machine(dev, monkeypatch):
    """The card's machine builds the port's native library, and LevelDB's
    CRC32C and snappy run there in C, never in the Python twins."""
    from videovector_tpu_torch.data import leveldbio, native
    assert native.available()
    data = bytes(range(256)) * 40
    comp = leveldbio.snappy_compress(data * 2)
    want = leveldbio._crc32c_py(data, 7)

    def forbidden(*a, **kw):
        raise AssertionError("the Python twin ran")
    monkeypatch.setattr(leveldbio, "_crc32c_py", forbidden)
    monkeypatch.setattr(leveldbio, "_snappy_decompress_py", forbidden)
    assert leveldbio.crc32c(data, 7) == want
    assert leveldbio.crc32c(b"123456789" * 40) == native.crc32c(
        b"123456789" * 40)
    assert leveldbio.snappy_decompress(comp) == data * 2


# -- item 10: the custom ops, the int8 product, the device sampler -------------

def test_k1_and_k2_export_as_custom_ops_equal_to_eager(dev, tmp_path):
    """K1 and K2 through torch.export as vvtpu:: custom ops: the program
    holds both nodes, reloads, launches each once a call (counted) and
    gives the eager launches' bits."""
    from videovector_tpu_torch.tools.export_model import (
        load_exported, save_exported,
    )
    g = torch.Generator(device=dev).manual_seed(0)
    w1 = torch.randn(3, 3, 16, 64, generator=g, device=dev) * 0.1
    b1 = torch.randn(64, generator=g, device=dev)
    w2 = torch.randn(64 * 12 * 12, 96, generator=g, device=dev) * 0.01

    def fn(x):
        y = k2.conv2d_gemm_nhwc(x, w1, b1, pad=(1, 1), fuse_relu=True)
        return k1.matmul(y.reshape(y.shape[0], -1), w2)

    x = torch.randn(20, 12, 12, 16, generator=g, device=dev)
    with torch.no_grad():
        eager = fn(x)
        path = str(tmp_path / "ops.pt2")
        save_exported(path, fn, x)
        ep = load_exported(path)
        targets = {str(n.target) for n in ep.graph.nodes}
        assert any("vvtpu.k1_matmul" in t for t in targets), targets
        assert any("vvtpu.k2_conv2d_nhwc" in t for t in targets), targets
        got, counts = _counted(lambda: ep.module()(x))
    assert _got(counts, "k1.f32_launches", "k2.f32_launches") == (1, 1)
    assert torch.equal(got, eager)


@pytest.mark.parametrize("m", [1, 16, 50])
def test_int8_product_padding_is_exact(dev, m):
    """torch._int_mm wants more than 16 rows and K, N multiples of 8 on the
    card: the zero padding leaves the int32 product equal to int64's."""
    from videovector_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(m)
    a = torch.randint(-127, 128, (m, 9215), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (9215, 1001), generator=g, device=dev,
                      dtype=torch.int8)
    got = quant.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, 1001)
    assert torch.equal(got.cpu().long(), a.cpu().long() @ b.cpu().long())


def test_duplicate_slot_scatter_is_deterministic(dev):
    """Accepted offers sharing a slot: the last offer wins on the card, the
    same on every one of 20 repeats and as on the CPU."""
    from videovector_tpu_torch.data import device_sampler as ds
    g = torch.Generator(device=dev).manual_seed(0)
    res = ds.DeviceReservoir(torch.randn(64, 256, generator=g, device=dev),
                             90.0)
    feats = torch.randn(4096, 256, generator=g, device=dev)
    accept = torch.rand(4096, generator=g, device=dev) < 0.9
    slots = torch.randint(0, 64, (4096,), generator=g, device=dev)
    first = ds.apply_update(res, feats, accept, slots).buffer
    for _ in range(20):
        assert torch.equal(ds.apply_update(res, feats, accept, slots).buffer,
                           first)
    cpu = ds.apply_update(ds.DeviceReservoir(res.buffer.cpu(), 90.0),
                          feats.cpu(), accept.cpu(), slots.cpu()).buffer
    assert torch.equal(first.cpu(), cpu)
    last = {int(s): i for i, s in enumerate(slots.tolist()) if accept[i]}
    for s, i in last.items():
        assert torch.equal(first[s], feats[i])


def test_one_rank_nccl_dp_step_is_bit_equal_to_the_unsharded_step(dev):
    """parallel.make_train_step on a one-rank NCCL mesh (its group started
    by make_mesh): the all_reduce of one rank is the identity, so three
    flagship steps (K1's sm90 route, dropout 0.9) equal solver/train.py's
    unsharded steps bit for bit."""
    import torch.distributed as dist

    from videovector_tpu_torch.models.embedding import (
        VideoEmbeddingConfig, VideoEmbeddingModel,
    )
    from videovector_tpu_torch.parallel import make_mesh, make_train_step
    from videovector_tpu_torch.parallel.train import shard_batch, shard_params
    from videovector_tpu_torch.solver.solvers import (
        SolverConfig, init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import value_and_grad
    cfg = VideoEmbeddingConfig(feature_dim=256, embed_dim=256)
    m = VideoEmbeddingModel(cfg)
    s = SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=5e-4)
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(0)
    batches = [_t(rng, 15, 32, 256, dev=dev) for _ in range(3)]

    def loss_fn(p, b, g):
        return m.loss(p, b, generator=g, train=True, role_major=True)

    gen = torch.Generator(device=dev)
    p, st = params, init_solver_state(s, params)
    vg = value_and_grad(loss_fn)
    ref = []
    for i, b in enumerate(batches):
        gen.manual_seed(i)
        (loss, _), g = vg(p, {"data": b}, gen)
        p, st = solver_update(s, p, g, st)
        ref.append(loss)
    mesh = make_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        q = shard_params(params, mesh)
        qs = init_solver_state(s, q)
        step = make_train_step(loss_fn, s, mesh)
        with timer.tally() as counts:
            for i, b in enumerate(batches):
                gen.manual_seed(i)
                q, qs, met = step(q, qs, shard_batch({"data": b}, mesh,
                                                     {"data": 1}), gen)
                assert torch.equal(met["loss"], ref[i])
        assert _got(counts, "k1.sm90_launches") == (3,)
        for k in ("w", "b"):
            assert torch.equal(q["tower"][k], p["tower"][k])
    finally:
        dist.destroy_process_group()


SERVE_NET = """
name: "serve"
input: "x"
input_dim: 6 input_dim: 16 input_dim: 12 input_dim: 12
layers { name: "c1" type: CONVOLUTION bottom: "x" top: "h"
  convolution_param { num_output: 32 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "r1" type: RELU bottom: "h" top: "h" }
layers { name: "fc" type: INNER_PRODUCT bottom: "h" top: "f"
  inner_product_param { num_output: 64 weight_filler { type: "xavier" }
    bias_filler { type: "constant" value: 0.05 } } }
layers { name: "r2" type: RELU bottom: "f" top: "f" }
layers { name: "fc2" type: INNER_PRODUCT bottom: "f" top: "out"
  inner_product_param { num_output: 16
    weight_filler { type: "xavier" } } }
"""


def _serve_net(tmp_path, dev):
    """SERVE_NET's prototxt, a .caffemodel of its seeded init, its
    one-device artifact, and a batch on `dev`."""
    from videovector_tpu_torch.config import parse as tparse
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.solver.checkpoint import snapshot
    from videovector_tpu_torch.tools import serving
    net_path = tmp_path / "serve.prototxt"
    net_path.write_text(SERVE_NET)
    params, _ = Net(tparse(SERVE_NET), "TEST").init(
        torch.Generator().manual_seed(3),
        {"x": np.zeros((6, 16, 12, 12), np.float32)})
    weights, _ = snapshot(str(tmp_path / "w"), 1, params)
    one = str(tmp_path / "one.vvtserve")
    assert serving.main(["export", str(net_path), one, "--weights", weights,
                         "--blobs", "out"]) == 0
    batch = {"x": torch.randn(6, 16, 12, 12, device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(1))}
    return str(net_path), weights, one, batch


def test_one_rank_nccl_mesh_artifact_equals_the_one_device_one(dev,
                                                               tmp_path):
    """`vvtpu-torch-serve export --mesh 1x1` on a one-rank NCCL mesh (its
    group started by make_mesh) of a conv + fc net: the artifact's outputs
    are the one-device artifact's bits, and a call launches K2 once and K1
    twice (counted)."""
    import torch.distributed as dist

    from videovector_tpu_torch.tools import serving
    net, weights, one_path, batch = _serve_net(tmp_path, dev)
    mesh_path = str(tmp_path / "mesh.vvtserve")
    try:
        assert serving.main(["export", net, mesh_path, "--weights", weights,
                             "--blobs", "out", "--mesh", "1x1"]) == 0
        assert dist.get_backend() == "nccl"
    finally:
        dist.destroy_process_group()
    one, _ = serving.load_serving(one_path)
    call, meta = serving.load_serving(mesh_path)
    assert (meta["mesh"], meta["nr_devices"]) == ({"data": 1, "model": 1}, 1)
    want = one(batch)["out"]
    got, counts = _counted(
        lambda: serving.mesh_serving(call, meta)(batch)["out"])
    assert _got(counts, "k1.launches", "k2.launches") == (2, 1)
    assert torch.equal(got, want)


def test_two_card_mesh_artifact_over_nccl_and_gloo(dev, tmp_path):
    """A 1 x 2 artifact of the conv + fc net on two cards, one rank a card
    under python -m torch.distributed.run (tests/torch_card_ranks.py),
    exported over NCCL and over gloo (CUDA tensors): each rank's program
    names its own card; either artifact served over either backend gives
    the one-device artifact's outputs within 1e-5 of their largest
    magnitude, every serving the same bits, and each rank's call launches
    K2 once and K1 twice (fc's and fc2's column shards); ranks put on each
    other's cards refuse their programs."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    from videovector_tpu_torch.tools import serving
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (one rank a card)")
    net, weights, one_path, batch = _serve_net(tmp_path, dev)
    np.savez(tmp_path / "batch.npz", x=batch["x"].cpu().numpy())
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    arts = {b: str(tmp_path / f"{b}.vvtserve") for b in ("nccl", "gloo")}

    def ranks(*args):
        out = str(tmp_path / f"res{len(list(tmp_path.glob('res*')))}")
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", str(root / "tests" / "torch_card_ranks.py"),
             args[0], args[1], out, *args[2:]],
            env=env, cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        res = []
        for r in range(2):
            with open(f"{out}.{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
        return res

    for b in arts:
        for r, res in enumerate(ranks("export", b, arts[b], net, weights,
                                      "out", "1x2")):
            assert (res["backend"], res["device"]) == (b, f"cuda:{r}")
            assert res["meta"]["devices"] == ["cuda:0", "cuda:1"]
    one, _ = serving.load_serving(one_path)
    want = one(batch)["out"].cpu().numpy()
    served = {b: ranks("serve", b, str(tmp_path / "batch.npz"), *arts.values())
              for b in ("nccl", "gloo")}
    first = served["nccl"][0][arts["nccl"]]["outs"]["out"]
    for b, res in served.items():
        for r, rank in enumerate(res):
            assert (rank["backend"], rank["device"]) == (b, f"cuda:{r}")
            for art in arts.values():
                got = rank[art]
                assert got["launches"] == (2, 1)
                assert got["outs"]["out"].shape == want.shape
                np.testing.assert_allclose(got["outs"]["out"], want, rtol=0,
                                           atol=1e-5 * np.abs(want).max())
                np.testing.assert_array_equal(got["outs"]["out"], first)
    for r, rank in enumerate(ranks("serve", "nccl",
                                   str(tmp_path / "batch.npz"),
                                   arts["nccl"], "--swap")):
        assert rank["device"] == f"cuda:{1 - r}"
        assert rank[arts["nccl"]]["error"] == (
            f"rank {r}'s program was exported on cuda:{r}, which its buffers "
            f"and constants name; this rank serves on cuda:{1 - r}: serve "
            "one rank a device in the exporting ranks' order")


# -- the NHWC max pool (csrc/max_pool_nhwc.cu, vvtpu::max_pool_nhwc) ----------

POOL_DTYPES = [torch.bfloat16, torch.float32, torch.float16]


def _pool_values(shape, dtype, dev, seed):
    """Small integers and halves of both signs, zeros as +0.0 or -0.0: the
    windows hold ties and signed zeros, which only a scan in aten's order
    returns bit for bit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-3, 4, shape, generator=g, device=dev).float() / 2
    neg = torch.rand(shape, generator=g, device=dev) < 0.5
    return torch.where((x == 0) & neg, -0.0, x).to(dtype)


def _pooled(x, kernel, stride, pad):
    """The kernel's output and the counters and launches it added."""
    from videovector_tpu_torch.ops import pooling
    out, counts = _counted(lambda: pooling.max_pool(
        x, kernel=kernel, stride=stride, pad=pad, layout="NHWC"))
    return out, counts, counts.get("vvtpu.max_pool.launches", 0)


@pytest.mark.parametrize("dtype", POOL_DTYPES)
@pytest.mark.parametrize("case", GEOMETRIES, ids=IDS)
def test_max_pool_kernel_equals_plain(dev, case, dtype):
    """Each serving pool at 50 frames: one launch, counted in both counters,
    bit-equal to the plain version (F.pad + aten's max_pool2d on the card)
    and from one call to the next."""
    from videovector_tpu_torch.ops import pooling
    hwc, kernel, stride, pad = pool_args(case)
    x = _pool_values((50, *hwc), dtype, dev, seed=sum(hwc) + stride[0])
    got, counts, launches = _pooled(x, kernel, stride, pad)
    assert launches == 1 and got.is_contiguous()
    assert counts == {"vvtpu.max_pool.calls": 1,
                      "vvtpu.max_pool.launches": 1}
    want = pooling.max_pool_nhwc_plain(x, kernel, stride, pad)
    again = pooling.max_pool_nhwc(x, kernel, stride, pad)
    torch.cuda.synchronize()
    assert same_bits(got, want) and same_bits(again, got)


@pytest.mark.parametrize("dtype", POOL_DTYPES)
@pytest.mark.parametrize("kind", ["odd_channels", "nan", "misaligned",
                                  "channel_slice", "all_neg_inf",
                                  "five_by_five", "subnormals"])
def test_max_pool_kernel_edges_equal_plain(dev, kind, dtype):
    """The scalar instantiation (13 channels, a base one element past an
    aligned address, a channel slice whose pixel stride is not a 16-byte
    multiple), planted NaNs, whole windows of -inf, a 5x5/3 window (the
    kernel's generic loop) and subnormals of both signs (which a compare
    that flushed them to zero would take for ties), each bit-equal to the
    plain version."""
    from videovector_tpu_torch.ops import pooling
    kernel, stride, pad = (3, 3), (2, 2), (1, 1)
    x = _pool_values((4, 29, 29, 64), dtype, dev, seed=len(kind))
    if kind == "odd_channels":
        x = x[..., :13].contiguous()
    elif kind == "nan":
        x[0, 3, 4, 5] = x[1, 0, 0, 7] = x[3, 28, 28, 63] = float("nan")
        stride = (1, 1)
    elif kind == "misaligned":
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        x = flat[1:].view(x.shape).copy_(x)
    elif kind == "channel_slice":
        x = x[..., 3:58]
    elif kind == "all_neg_inf":
        x[:, :6, :6] = -float("inf")
    elif kind == "subnormals":
        g = torch.Generator(device=dev).manual_seed(9)
        bits = torch.randint(1, 128, x.shape, generator=g, device=dev)
        sign = torch.randint(0, 2, x.shape, generator=g, device=dev)
        ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
        x = (bits | sign << (8 * x.element_size() - 1)).to(ints).view(dtype)
    else:
        kernel, stride, pad = (5, 5), (3, 3), (2, 2)
    got, _, launches = _pooled(x, kernel, stride, pad)
    want = pooling.max_pool_nhwc_plain(x, kernel, stride, pad)
    torch.cuda.synchronize()
    assert launches == 1 and same_bits(got, want)
    if kind == "nan":
        assert want.isnan().sum() >= 3


@pytest.mark.parametrize("dtype", POOL_DTYPES)
def test_max_pool_cut_strips_equal_plain(dev, dtype):
    """The 3x3 route (4-row strips at stride 1, single rows at stride 2)
    over maps whose output rows 4 does not divide, so the last strip is
    cut, with planted NaNs and a block of -inf: bit-equal to the plain
    version."""
    from videovector_tpu_torch.ops import pooling
    for hw, stride, pad in ((13, 1, 1), (15, 2, 0), (14, 2, 0), (7, 1, 1)):
        x = _pool_values((3, hw, hw + 2, 40), dtype, dev, seed=hw)
        x[0, 2, 3, 4] = x[2, hw - 1, 0, 39] = float("nan")
        x[1, :3, :4] = -float("inf")
        args = ((3, 3), (stride, stride), (pad, pad))
        got, _, launches = _pooled(x, *args)
        want = pooling.max_pool_nhwc_plain(x, *args)
        torch.cuda.synchronize()
        assert launches == 1 and same_bits(got, want), (hw, stride)


def _device_kernels(fn):
    """fn()'s device kernels by name, one entry a launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("backbone", ["googlenet", "caffenet"])
def test_a_forward_pools_on_the_kernel_alone(dev, backbone, monkeypatch):
    """A profiled backbone forward at 50 frames: 13 (GoogLeNet) or 3
    (CaffeNet) launches of vv::pool::max_pool_nhwc, no aten max pool, and
    no fill (neither a pool's -inf pad nor, since their kernel, the LRNs'
    zero pads); its features equal, bit for bit, those of the same forward
    with the plain version in each pool's place."""
    import importlib

    from videovector_tpu_torch.ops import pooling
    if backbone == "googlenet":
        pipe, params, _, _, gen = _googlenet_serving(dev)
        net, pools = pipe.googlenet, 13
    else:
        pipe, params, _, _, gen = _serving(dev)
        net, pools = pipe.mednet, 3
    x = pipe.transform(*_clip(gen, 50, dev))
    p = params[pipe.backbone_key]
    names = _device_kernels(lambda: net.forward(p, x))
    assert sum("vv::pool::max_pool_nhwc" in n for n in names) == pools, names
    assert not any("max_pool" in n and "vv::" not in n for n in names)
    fills = [n for n in names if "FillFunctor" in n]
    assert not fills, fills
    got = net.forward(p, x)
    monkeypatch.setattr(
        importlib.import_module(type(net).__module__), "max_pool",
        lambda x, *, kernel, stride, pad=(0, 0), layout: (
            pooling.max_pool_nhwc_plain(x, kernel, stride, pad)))
    want = net.forward(p, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("backbone", ["googlenet", "caffenet"])
def test_replays_count_the_pools_and_equal_the_eager_query(dev, backbone):
    """Three queries of one pipeline (eager, captured and replayed,
    replayed): each adds its pools to `vvtpu.max_pool.calls` and
    `vvtpu.max_pool.launches`, and its two LRNs to `vvtpu.lrn.calls` and
    `vvtpu.lrn.launches` (a replay its capture's counts), and answers
    as a fresh pipeline's eager query, bit for bit."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    if backbone == "googlenet":
        pipe, params, gallery, ids, gen = _googlenet_serving(dev)
        pools = 13
    else:
        pipe, params, gallery, ids, gen = _serving(dev)
        pools = 3
    for replayed in (0, 1, 1):
        frames = _clip(gen, 50, dev)
        out, counts = _counted(
            lambda: pipe.query(params, *frames, gallery, ids))
        assert counts.get("vvtpu.query.graph_replays", 0) == replayed
        assert counts["vvtpu.max_pool.calls"] == pools
        assert counts["vvtpu.max_pool.launches"] == pools
        assert counts["vvtpu.lrn.calls"] == counts["vvtpu.lrn.launches"] == 2
        fresh = RetrievalPipeline(pipe.cfg, device=dev)
        assert _equal(out, fresh.query(params, *frames, gallery, ids))


def test_an_exported_mednet_launches_the_pool_kernel(dev, tmp_path):
    """A MedNet forward exported on the card holds three
    vvtpu.max_pool_nhwc nodes and two vvtpu.lrn_nhwc nodes; the reloaded
    program launches the pool kernel three times a call and the LRN kernel
    twice, and gives the eager forward's bits."""
    from videovector_tpu_torch.models.mednet import MedNet
    from videovector_tpu_torch.tools.export_model import (
        load_exported, save_exported,
    )
    pipe, params, _, _, gen = _serving(dev)
    x = pipe.transform(*_clip(gen, 50, dev))
    net = MedNet(pipe.mednet.cfg)
    with torch.no_grad():
        eager = net.forward(params["mednet"], x)
        path = str(tmp_path / "mednet.pt2")
        save_exported(path, lambda im: net.forward(params["mednet"], im), x)
        ep = load_exported(path)
        targets = [str(n.target) for n in ep.graph.nodes]
        assert sum("vvtpu.max_pool_nhwc" in t for t in targets) == 3
        assert sum("vvtpu.lrn_nhwc" in t for t in targets) == 2
        got, counts = _counted(lambda: ep.module()(x))
    assert _got(counts, "max_pool.launches", "lrn.launches") == (3, 2)
    assert torch.equal(got, eager)


# -- the NHWC LRN (csrc/lrn_nhwc.cu, vvtpu::lrn_nhwc) -------------------------

LRN_DTYPES = [torch.bfloat16, torch.float32, torch.float16]
# the serving path's LRNs at 50 frames: GoogLeNet's norm1 and norm2 (224
# crop), CaffeNet's (227 crop)
LRN_SHAPES = {"googlenet-norm1": (50, 56, 56, 64),
              "googlenet-norm2": (50, 56, 56, 192),
              "caffenet-norm1": (50, 27, 27, 96),
              "caffenet-norm2": (50, 13, 13, 256)}


def _lrn_values(shape, dtype, dev, seed):
    """Activations of both signs at a conv's scale (tens), so that the
    window's sum moves the scale well away from 1, a tenth of them zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 40
    return torch.where(torch.rand(shape, generator=g, device=dev) < 0.1,
                       0.0, x).to(dtype)


def _steps(a, b):
    """The largest distance between two bf16 or f16 tensors in steps of
    their type (signed zeros equal)."""
    def key(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs().max().item()


def _lrn(x, **kw):
    """`lrn_nhwc`'s output and the counts it added."""
    from videovector_tpu_torch.ops import lrn
    return _counted(lambda: lrn.lrn_nhwc(x, **kw))


def _matches_f32_version(got, x, local_size=5, alpha=1e-4, beta=0.75):
    """got against the plain version run in f32 and rounded once: within one
    step of bf16 or f16, within 1e-6 relative in f32."""
    from videovector_tpu_torch.ops import lrn
    once = lrn.lrn_nhwc_plain(x.float(), local_size, alpha, beta)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype
    assert got.is_contiguous()
    if x.dtype == torch.float32:
        assert ((got - once).abs() <= 1e-6 * once.abs()).all()
    else:
        assert _steps(got, once.to(x.dtype)) <= 1


@pytest.mark.parametrize("dtype", LRN_DTYPES)
@pytest.mark.parametrize("name", list(LRN_SHAPES))
def test_lrn_kernel_matches_the_f32_version(dev, name, dtype):
    """Each serving LRN at 50 frames: one launch, counted in both counters,
    within one step of the f32 version (within bf16's tolerance of the bf16
    chain it replaced) and the same bits from one call to the next."""
    from videovector_tpu_torch.ops import lrn
    x = _lrn_values(LRN_SHAPES[name], dtype, dev, seed=len(name))
    got, counts = _lrn(x)
    assert counts == {"vvtpu.lrn.calls": 1, "vvtpu.lrn.launches": 1}
    _matches_f32_version(got, x)
    assert torch.equal(lrn.lrn_nhwc(x), got)
    if dtype == torch.bfloat16:
        _close(got, lrn.lrn_nhwc_plain(x))


@pytest.mark.parametrize("dtype", LRN_DTYPES)
@pytest.mark.parametrize("kind", ["odd_channels", "fewer_channels_than_window",
                                  "one_chunk_wide_window", "misaligned",
                                  "channel_slice", "nchw_view",
                                  "strided_pixels"])
def test_lrn_kernel_edges_match_the_f32_version(dev, kind, dtype):
    """The scalar kernel (13 channels; 3 channels under a window of 5; a base
    one element past an aligned address; a channel slice; the NHWC view of
    an NCHW tensor), and the chunk kernel on 8 channels under a window of 9,
    which reaches past the pixel's channels on both sides, and on every
    other column (a pixel stride of two pixels): one launch each, within
    one step of the f32 version."""
    x = _lrn_values((4, 9, 11, 96), dtype, dev, seed=len(kind))
    kw = {}
    if kind == "odd_channels":
        x = x[..., :13].contiguous()
    elif kind == "fewer_channels_than_window":
        x = x[..., :3].contiguous()
    elif kind == "one_chunk_wide_window":
        x, kw = x[..., :8].contiguous(), {"local_size": 9}
    elif kind == "misaligned":
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        x = flat[1:].view(x.shape).copy_(x)
    elif kind == "channel_slice":
        x = x[..., 3:67]
    elif kind == "nchw_view":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    else:
        x = x[:, :, ::2]
    got, counts = _lrn(x, **kw)
    assert counts["vvtpu.lrn.launches"] == 1
    _matches_f32_version(got, x, **kw)


@pytest.mark.parametrize("dtype", LRN_DTYPES)
@pytest.mark.parametrize("local_size,alpha,beta", [
    (1, 1e-3, 0.5), (3, 2e-4, 0.5), (5, 1e-3, 1.0), (7, 5e-5, 0.75),
    (9, 3e-4, 0.6), (11, 1e-4, 0.75), (17, 2e-5, 0.9), (19, 1e-4, 0.75)])
def test_lrn_kernel_window_sizes_match_the_f32_version(dev, local_size, alpha,
                                                       beta, dtype):
    """Other windows, alphas and betas over 64 channels: every size the
    chunk kernel instantiates (up to 17 in bf16 and f16, 9 in f32) and
    larger ones, which take the scalar kernel."""
    x = _lrn_values((3, 7, 9, 64), dtype, dev, seed=local_size)
    kw = {"local_size": local_size, "alpha": alpha, "beta": beta}
    got, counts = _lrn(x, **kw)
    assert counts["vvtpu.lrn.launches"] == 1
    _matches_f32_version(got, x, **kw)


def test_lrn_plain_versions_launch_nothing_and_grad_raises(dev):
    """Inside `plain_versions()` a call counts and launches nothing, giving
    the plain version's bits; a call that autograd records raises, as K1's
    and K2's entry points do."""
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.ops import lrn
    x = _lrn_values((2, 5, 6, 64), torch.bfloat16, dev, seed=1)
    with plain_versions():
        got, counts = _lrn(x)
    assert counts == {"vvtpu.lrn.calls": 1}
    assert torch.equal(got, lrn.lrn_nhwc_plain(x))
    with pytest.raises(NotImplementedError, match="forward only"):
        lrn.lrn_nhwc(x.float().requires_grad_())
    with torch.no_grad():
        _, counts = _lrn(x.float().requires_grad_())
    assert counts["vvtpu.lrn.launches"] == 1


@pytest.mark.parametrize("backbone", ["googlenet", "caffenet"])
def test_a_forward_normalizes_on_the_lrn_kernel(dev, backbone):
    """A profiled backbone forward at 50 frames: two LRN calls and two
    launches of vv::lrn::lrn_nhwc_chunks; inside `plain_versions()` two
    calls and no launch."""
    from videovector_tpu_torch.device import plain_versions
    if backbone == "googlenet":
        pipe, params, _, _, gen = _googlenet_serving(dev)
        net = pipe.googlenet
    else:
        pipe, params, _, _, gen = _serving(dev)
        net = pipe.mednet
    x = pipe.transform(*_clip(gen, 50, dev))
    p = params[pipe.backbone_key]
    _, counts = _counted(lambda: net.forward(p, x))
    assert _got(counts, "lrn.calls", "lrn.launches") == (2, 2)
    names = _device_kernels(lambda: net.forward(p, x))
    assert sum("vv::lrn::lrn_nhwc_chunks" in n for n in names) == 2, names
    with plain_versions():
        _, counts = _counted(lambda: net.forward(p, x))
    assert _got(counts, "lrn.calls", "lrn.launches") == (2, 0)


# -- I3D: K2's depth route (csrc/conv3d_gemm_sm90.cu), the 3D repack and the
# -- NDHWC max pool (csrc/max_pool_nhwc.cu, vvtpu::max_pool_ndhwc) -----------

# (N, T, H, W, C), kernel, stride, pad (before, after) per axis, O
CONV3D_CASES = [
    ((1, 9, 14, 14, 64), (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, 192),
    ((2, 7, 9, 11, 16), (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, 32),
    ((1, 8, 10, 12, 24), (4, 4, 4), (1, 1, 1), ((0, 0),) * 3, 64),
    ((1, 9, 13, 11, 32), (3, 3, 3), (2, 2, 2), ((1, 1), (0, 1), (1, 0)), 64),
    ((1, 6, 7, 7, 96), (2, 3, 3), (1, 1, 1), ((0, 1), (1, 1), (1, 1)), 136),
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV3D_CASES,
                         ids=[f"k{c[1][0]}s{c[2][0]}c{c[0][4]}"
                              for c in CONV3D_CASES])
def test_k2_depth_route_matches_plain(dev, case, out_dtype):
    """One launch of the depth route a conv (counted on the sm90 route and
    as a depth launch), within one bf16 step of the plain version (both sum
    in f32, in other orders), and the same bits from one call to the
    next."""
    shape, kernel, stride, pad, o = case
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((*kernel, shape[4], o), generator=gen, device=dev)
         * 0.1).to(torch.bfloat16)
    b = torch.randn(o, generator=gen, device=dev)

    def conv():
        return k2.conv3d_gemm_ndhwc(x, w, b, stride=stride, pad=pad,
                                    fuse_relu=True, out_dtype=out_dtype)
    got, counts = _counted(conv)
    assert _got(counts, "k2.launches", "k2.sm90_launches",
                "k2.depth_launches", "s2d.launches") == (1, 1, 1, 0)
    want = k2.conv3d_gemm_ndhwc_plain(x, w, b, stride=stride, pad=pad,
                                      fuse_relu=True, out_dtype=out_dtype)
    _close(got, want)
    assert torch.equal(got, conv())


def test_i3d_conv1_repacks_onto_the_depth_route(dev):
    """Conv3d_1a_7x7 (stride 2, TF's SAME pads 2 before and 3 after) over a
    small clip: the 3D repack kernel bit-equal to its plain version, then
    one repack and one depth launch, within one bf16 step of the plain
    strided conv."""
    from videovector_tpu_torch.ops.conv import same_pads
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn((1, 20, 40, 36, 3), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = (torch.randn((7, 7, 7, 3, 64), generator=gen, device=dev)
         * 0.05).to(torch.bfloat16)
    b = torch.randn(64, generator=gen, device=dev)
    pad = tuple(same_pads(n, 7, 2) for n in x.shape[1:4])
    (xs, ws), counts = _counted(lambda: k2.space_to_depth_3d(x, w, 2, pad))
    assert _got(counts, "s2d.launches") == (1,)
    pxs, pws = k2.space_to_depth_3d_plain(x, w, 2, pad)
    assert torch.equal(xs, pxs) and torch.equal(ws, pws)
    assert xs.shape == (1, 13, 23, 21, 24) and ws.shape == (4, 4, 4, 24, 64)
    got, counts = _counted(lambda: k2.conv3d_gemm_ndhwc(
        x, w, b, stride=(2, 2, 2), pad=pad, fuse_relu=True,
        out_dtype=torch.bfloat16))
    assert _got(counts, "k2.launches", "k2.sm90_launches",
                "k2.depth_launches", "s2d.launches") == (1, 1, 1, 1)
    assert got.shape == (1, 10, 20, 18, 64)
    _close(got, k2.conv3d_gemm_ndhwc_plain(
        x, w, b, stride=(2, 2, 2), pad=pad, fuse_relu=True,
        out_dtype=torch.bfloat16))


# name, (T, H, W, C), window, stride
NDHWC_POOLS = [
    ("module", (9, 14, 14, 64), (3, 3, 3), (1, 1, 1)),
    ("module-ragged", (6, 5, 7, 24), (3, 3, 3), (1, 1, 1)),
    ("4a", (25, 28, 28, 48), (3, 3, 3), (2, 2, 2)),
    ("5a", (13, 14, 14, 32), (2, 2, 2), (2, 2, 2)),
    ("other", (7, 5, 6, 16), (3, 2, 3), (2, 1, 2)),
    ("odd-channels", (5, 6, 6, 6), (3, 3, 3), (1, 1, 1)),
]


@pytest.mark.parametrize("dtype", POOL_DTYPES)
@pytest.mark.parametrize("case", NDHWC_POOLS, ids=[c[0] for c in NDHWC_POOLS])
def test_ndhwc_pool_kernel_equals_plain(dev, case, dtype):
    """One launch of the NDHWC kernel (counted as a deep one) at TF's SAME
    pads, bit-equal to the plain version (a -inf F.pad and F.max_pool3d) on
    values with ties, signed zeros and a few NaNs."""
    from videovector_tpu_torch.ops import pooling
    from videovector_tpu_torch.ops.conv import same_pads
    _, shape, window, stride = case
    x = _pool_values((2, *shape), dtype, dev, sum(shape))
    x.view(-1)[::97] = float("nan")
    pad = tuple(same_pads(n, k, s) for n, k, s in zip(shape, window, stride))
    got, counts = _counted(lambda: pooling.max_pool(
        x, kernel=window, stride=stride, pad=pad, layout="NDHWC"))
    assert _got(counts, "max_pool.calls", "max_pool.launches",
                "max_pool.depth_launches") == (1, 1, 1)
    assert same_bits(got, pooling.max_pool_ndhwc_plain(x, window, stride,
                                                       pad))


def test_a_pool_one_frame_deep_runs_the_nhwc_kernel(dev):
    """MaxPool3d_2a (1x3x3 at 1,2,2, SAME) over the frames: one launch of
    the NHWC kernel, none of the NDHWC one, bit-equal to the plain 3D
    pool."""
    from videovector_tpu_torch.ops import pooling
    x = _pool_values((1, 6, 112, 112, 64), torch.bfloat16, dev, 5)
    pad = ((0, 0), (0, 1), (0, 1))
    got, counts = _counted(lambda: pooling.max_pool(
        x, kernel=(1, 3, 3), stride=(1, 2, 2), pad=pad, layout="NDHWC"))
    assert _got(counts, "max_pool.launches",
                "max_pool.depth_launches") == (1, 0)
    assert same_bits(got, pooling.max_pool_ndhwc_plain(
        x, (1, 3, 3), (1, 2, 2), pad))


def _i3d_serving(dev, seed=23, rows=4096):
    """A full-width I3D pipeline on the card, its params (BatchNorm
    folded), a gallery of `rows` unit rows of 1,024 with permuted ids, and
    the generator."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = RetrievalPipelineConfig(backbone="i3d", crop=224, embed_dim=1024)
    pipe = RetrievalPipeline(cfg, device=dev)
    params = pipe.init(gen)
    gallery = torch.nn.functional.normalize(
        torch.randn((rows, 1024), generator=gen, device=dev), dim=1)
    ids = torch.randperm(rows, generator=gen, device=dev).to(torch.int32)
    return pipe, params, gallery, ids, gen


def _i3d_clip(gen, frames, dev):
    """One clip's frames with one crop offset pair and mirror flag."""
    pix = torch.randint(0, 256, (frames, 256, 256, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    h, w = (torch.randint(0, 33, (1,), generator=gen, device=dev)
            for _ in range(2))
    return pix, h, w, torch.randint(0, 2, (1,), generator=gen,
                                     device=dev) > 0


def test_i3d_convs_and_pools_all_take_the_kernels(dev):
    """One I3D forward over a 64-frame clip: 57 K2 launches, all on the sm90
    route, 20 of them deep (the 19 3x3x3 convs and conv1 after one repack),
    none on the core; 13 pools, all launched, 11 of them on the NDHWC
    kernel; the features within 2e-2 (relative L2) of the plain forward's."""
    pipe, params, _, _, gen = _i3d_serving(dev)
    pix, h, w, m = _i3d_clip(gen, 64, dev)
    x = pipe.transform(pix, h.expand(64), w.expand(64), m.expand(64))
    x = x.reshape(1, 64, 224, 224, 3)
    got, counts = _counted(lambda: pipe.i3d.forward(params["i3d"], x))
    assert _got(counts, "k2.launches", "k2.sm90_launches",
                "k2.depth_launches", "s2d.launches") == (57, 57, 20, 1)
    assert _got(counts, "max_pool.calls", "max_pool.launches",
                "max_pool.depth_launches") == (13, 13, 11)
    with plain_versions():
        plain = pipe.i3d.forward(params["i3d"], x)
    torch.cuda.synchronize()
    assert got.shape == (1, 1024)
    assert float((got - plain).norm() / plain.norm()) < 2e-2


def test_i3d_replays_equal_the_eager_query_bit_for_bit(dev):
    """I3D's query of one clip through the graph capture: the first call
    eager, the second captured and replayed, the third replayed; each
    answer and the features `features` holds after it bit-equal to a fresh
    pipeline's eager ones; a replay adds its capture's counts."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    pipe, params, gallery, ids, gen = _i3d_serving(dev)
    replays = []
    for _ in range(3):
        clip = _i3d_clip(gen, 64, dev)
        out, counts = _counted(lambda: pipe.query(params, *clip, gallery,
                                                  ids))
        replays.append(counts.get("vvtpu.query.graph_replays", 0))
        assert _got(counts, "k2.depth_launches",
                    "max_pool.depth_launches") == (20, 11)
        fresh = RetrievalPipeline(pipe.cfg, device=dev)
        want = fresh.query(params, *clip, gallery, ids)
        assert fresh._graph is None
        assert out[0].shape == (1, 5) and _equal(out, want)
        # the head's 7 windows at 64 frames: the last map is 8 frames deep
        assert pipe.features.shape == (1, 7, 1024)
        assert torch.equal(pipe.features, fresh.features)
    assert replays == [0, 1, 1]


# -- the per-row top-k selection (csrc/top_k_rows.cu, vvtpu::top_k_rows) ------

def _topk_scores(case, dev):
    """Scores of one case on the card (a view where the case says so)."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    if case == "misaligned view":
        # rows of 20,011 scores start at every 4-byte offset mod 16, and
        # the view drops the first column besides
        return torch.randn((5, 20_011), generator=gen, device=dev)[:, 1:]
    rows, cols = TOPK_SHAPES[case]
    x = torch.randn((rows, cols), generator=gen, device=dev)
    if case == "ties":
        x = torch.round(x * 2) / 4
        x[1] = 0.25                                       # a constant row
    elif case == "specials":
        x = torch.round(x * 2) / 4
        x[0, ::7] = 0.0
        x[0, 3::7] = -0.0
        x[1, ::11] = float("inf")
        x[1, 5::11] = float("-inf")
        x[2, 4000] = float("nan")
        x[2, 17] = float("nan")
        x[3] = torch.where(x[3] > 0, -0.0, 0.0)            # only zeros
    return x


TOPK_SHAPES = {"1x20000": (1, 20_000), "50x20000": (50, 20_000),
               "50x1000000": (50, 1_000_000), "3x4099": (3, 4_099),
               "3x40099": (3, 40_099), "ties": (4, 50_000),
               "specials": (4, 9_001), "short rows": (4, 3)}
TOPK_CASES = [*TOPK_SHAPES, "misaligned view"]


def _bits_equal(got, want):
    """Values bit for bit (NaN and signed zeros included) and indices."""
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape and got[1].dtype == torch.int64
    assert torch.equal(got[1], want[1]), (got[1] != want[1]).sum().item()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_top_k_kernel_equals_the_stable_sort(dev, case, k):
    """The selection kernel against `top_k_stable_plain` (torch's stable
    sort) on the same scores: values and indices bit-equal, at the
    serving shapes, ragged tails, a view whose rows start off 16-byte
    alignment, rows shorter than k, heavy ties, a constant row, signed
    zeros, +-inf and NaN; one launch a call."""
    from videovector_tpu_torch.models import retrieval_pipeline as rp
    scores = _topk_scores(case, dev)
    got, counts = _counted(lambda: rp.top_k_stable(scores, k))
    assert _got(counts, "topk.calls", "topk.launches") == (1, 1)
    assert got[0].shape == (scores.shape[0], min(k, scores.shape[1]))
    _bits_equal(got, rp.top_k_stable_plain(scores, k))
    if case == "specials":
        _bits_equal(got, tuple(t.to(dev) for t in rp.top_k_stable_plain(
            scores.cpu(), k)))


def test_top_k_kernel_replays_in_a_graph_and_refuses_what_it_cannot(dev):
    """Captured in a CUDA graph, the kernel pair answers as the eager call
    for new scores copied into the captured input; inside
    `plain_versions()` a call counts and launches nothing; a call that
    autograd records, a k above 32 and scores other than f32 raise."""
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.models import retrieval_pipeline as rp
    gen = torch.Generator(device=dev).manual_seed(5)
    scores = torch.randn((50, 20_000), generator=gen, device=dev)
    rp.top_k_stable(scores, 5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rp.top_k_stable(scores, 5)
    for _ in range(2):
        scores.copy_(torch.randn((50, 20_000), generator=gen, device=dev))
        graph.replay()
        _bits_equal(out, rp.top_k_stable_plain(scores, 5))
    with plain_versions():
        got, counts = _counted(lambda: rp.top_k_stable(scores, 5))
    assert counts == {"vvtpu.topk.calls": 1}
    _bits_equal(got, rp.top_k_stable_plain(scores, 5))
    with pytest.raises(NotImplementedError, match="forward only"):
        rp.top_k_stable(scores.clone().requires_grad_(), 5)
    with pytest.raises(ValueError, match="0 to 32"):
        rp.top_k_stable(scores, 33)
    with pytest.raises(TypeError, match="f32"):
        rp.top_k_stable(scores.to(torch.bfloat16), 5)


def test_a_served_query_selects_on_the_kernel_eager_and_replayed(
        dev, monkeypatch):
    """Three queries against a 20,000-row gallery (eager, captured and
    replayed, replayed): each counts one top-k call and one launch (a
    replay its capture's) and answers, bit for bit, as a fresh pipeline's
    eager query and as one whose top-k is the stable sort."""
    from videovector_tpu_torch.models import retrieval_pipeline as rp
    pipe, params, gallery, ids, gen = _serving(dev, rows=20_000)
    for replayed in (0, 1, 1):
        frames = _clip(gen, 50, dev)
        out, counts = _counted(
            lambda: pipe.query(params, *frames, gallery, ids))
        assert counts.get("vvtpu.query.graph_replays", 0) == replayed
        assert _got(counts, "topk.calls", "topk.launches") == (1, 1)
        assert _equal(out, _eager_query(dev, params, frames, gallery, ids))
        with monkeypatch.context() as m:
            m.setattr(rp, "top_k_stable", rp.top_k_stable_plain)
            sorted_ = _eager_query(dev, params, frames, gallery, ids)
        assert _equal(out, sorted_)


# -- the attention kernel (csrc/attention_sm90.cu, vvtpu::attention) and K1's
# -- GELU epilogue (matmul_sm90.cu's twins), for TimeSformer --------------------

# (kind, clips, patches, frames, class row): TimeSformer-L's published
# shapes (196 x 12 sequences of 96, 96 x 12 of 196 plus the class row),
# two clips, and small and ragged ones
ATTN_CASES = {"temporal 196x96": ("temporal", 1, 196, 96, False),
              "spatial 96x197": ("spatial", 1, 196, 96, True),
              "temporal 2 clips": ("temporal", 2, 196, 8, False),
              "spatial 2 clips": ("spatial", 2, 49, 8, True),
              "spatial no class row": ("spatial", 2, 49, 8, False),
              "one token": ("temporal", 1, 3, 1, False),
              "255 and the class row": ("spatial", 1, 255, 2, True)}


def _attn_case(case, dev):
    from videovector_tpu_torch.ops import attention as ta
    kind, clips, patches, frames, extra = ATTN_CASES[case]
    seqs = getattr(ta.Sequences, kind)(clips, patches, frames)
    if kind == "spatial" and not extra:
        seqs = ta.Sequences(**{**seqs.__dict__, "extra_base": -1})
    rows = clips * (patches * frames + (kind == "spatial"))
    gen = torch.Generator(device=dev).manual_seed(len(case))
    # unit-variance q and k: logits of std 1 at scale 1/8
    qkv = torch.randn((rows, 3 * 768), generator=gen, device=dev).to(
        torch.bfloat16)
    return seqs, qkv


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_kernel_matches_plain(dev, case):
    """The kernel against its plain version (f32 scores, softmax and sums
    from the same bf16 operands) over every row a sequence holds: outputs
    within one bf16 step of max|plain| (the kernel rounds P to bf16 for
    its second product), the class row's f32 outputs within 1e-2 of
    max|plain|; one launch, counted by kind."""
    from videovector_tpu_torch.ops import attention as ta
    seqs, qkv = _attn_case(case, dev)
    (out, cls), counts = _counted(lambda: ta.attention(qkv, 12, seqs))
    assert _got(counts, "attn.calls", "attn.launches",
                f"attn.{seqs.kind}_launches") == (1, 1, 1)
    with plain_versions():
        want, want_cls = ta.attention(qkv, 12, seqs)
    held = seqs.token_rows(dev).reshape(-1)
    _close(out[held], want[held])
    assert torch.isfinite(out[held].float()).all()
    assert cls.shape == want_cls.shape
    if seqs.extra:
        _close(cls, want_cls, rel=1e-2)


def test_attention_kernel_replays_in_a_graph_and_refuses_what_it_cannot(dev):
    """Captured in a CUDA graph, the kernel answers as the eager call for
    new qkv copied into the captured input; two launches give the same
    bits; inside `plain_versions()` a call launches nothing and counts
    itself and the plain version's gather of its sequences' q, k and v and
    scatter of their outputs; a call that autograd records, f32 qkv, heads
    of 32 and sequences of 256 tokens with the class row raise."""
    from videovector_tpu_torch.ops import attention as ta
    seqs, qkv = _attn_case("spatial 2 clips", dev)
    first = ta.attention(qkv, 12, seqs)
    again = ta.attention(qkv, 12, seqs)
    torch.cuda.synchronize()
    held = seqs.token_rows(dev).reshape(-1)
    assert torch.equal(first[0][held], again[0][held])
    assert torch.equal(first[1], again[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ta.attention(qkv, 12, seqs)
    for seed in (1, 2):
        qkv.copy_(torch.randn(qkv.shape, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev))
        graph.replay()
        want = ta.attention(qkv, 12, seqs)
        torch.cuda.synchronize()
        assert torch.equal(out[0][held], want[0][held])
        assert torch.equal(out[1], want[1])
    with plain_versions():
        _, counts = _counted(lambda: ta.attention(qkv, 12, seqs))
    gathered = seqs.sequences * (seqs.length + seqs.extra) * 3
    scattered = seqs.sequences * seqs.length
    assert counts == {"vvtpu.attn.calls": 1, "vvtpu.attn.layout_bytes":
                      (gathered + scattered) * 768 * 2}
    with pytest.raises(NotImplementedError, match="forward only"):
        ta.attention(qkv.clone().float().requires_grad_(), 12, seqs)
    with pytest.raises(ValueError, match="bf16"):
        ta.attention(qkv.float(), 12, seqs)
    with pytest.raises(ValueError, match="heads of 64"):
        ta.attention(qkv, 24, seqs)
    long = ta.Sequences.spatial(1, 255, 1)
    too_long = ta.Sequences(**{**long.__dict__, "length": 256,
                               "token_stride": 1})
    with pytest.raises(ValueError, match="256 tokens"):
        ta.attention(torch.zeros((257, 2304), dtype=torch.bfloat16,
                                 device=dev), 12, too_long)


def _steps_apart(got, want):
    """The largest distance in bf16 steps between two bf16 tensors."""
    a = got.view(torch.int16).int()
    b = want.view(torch.int16).int()
    sign = (a < 0) != (b < 0)
    return int(torch.where(sign, a.abs() + b.abs(), (a - b).abs()).max())


@pytest.mark.parametrize("mkn", [(18_816, 768, 3072), (18_817, 768, 3072),
                                 (50, 4096, 4096), (37, 200, 136)])
def test_k1_gelu_matches_its_f32_sum_through_gelu(dev, mkn):
    """K1 with the GELU epilogue (TimeSformer's fc1 at 18,816 x 768 x
    3,072, one split; a 50-row product on the split-K reduce's twin; a
    ragged one) against K1's own f32 sum of the same operands through
    F.gelu (exact erf) and one rounding: within one bf16 step, almost all
    equal; one sm90 launch counted as GELU's."""
    rng = np.random.RandomState(1)
    m, k, n = mkn
    x, w = (_t(rng, m, k, dev=dev, dtype=torch.bfloat16),
            _t(rng, k, n, dev=dev, dtype=torch.bfloat16) * k ** -0.5)
    b = _t(rng, n, dev=dev)
    got, counts = _counted(lambda: k1.matmul(x, w, b, fuse_gelu=True,
                                             out_dtype=torch.bfloat16))
    assert _got(counts, "k1.launches", "k1.sm90_launches",
                "k1.gelu_launches") == (1, 1, 1)
    acc = k1.matmul(x, w, b, out_dtype=torch.float32)
    want = torch.nn.functional.gelu(acc).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert _steps_apart(got, want) <= 1
    assert float((got != want).float().mean()) < 1e-3
    with plain_versions():
        plain = k1.matmul(x, w, b, fuse_gelu=True, out_dtype=torch.bfloat16)
    _close(got, plain)
    with pytest.raises(ValueError, match="sm90 route alone"):
        k1.matmul(x.float(), w.float(), b, fuse_gelu=True)


@pytest.mark.parametrize("mkn", [(50, 9216, 4096), (50, 4096, 4096),
                                 (1, 768, 768), (18_817, 768, 2304)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_relu_and_bias_launches_keep_their_bits(dev, mkn, out_dtype):
    """CaffeNet's fc6 and fc7 and the tower (50 rows), TimeSformer's tower
    and qkv: the ReLU launch is the no-activation launch's ReLU bit for
    bit, and two launches of each give the same bits, beside the GELU
    twins in the same library."""
    rng = np.random.RandomState(2)
    m, k, n = mkn
    x, w = (_t(rng, m, k, dev=dev, dtype=torch.bfloat16),
            _t(rng, k, n, dev=dev, dtype=torch.bfloat16) * k ** -0.5)
    b = _t(rng, n, dev=dev)
    runs = [(k1.matmul(x, w, b, fuse_relu=True, out_dtype=out_dtype),
             k1.matmul(x, w, b, out_dtype=out_dtype)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], torch.relu(runs[0][1]))


def _timesformer_serving(dev, seed=29, rows=20_000):
    """A full-width TimeSformer-L pipeline on the card with the benchmark's
    draws (f32, for the reference) and the params it serves (linear
    weights in bf16), a gallery of `rows` unit rows of 768 with permuted
    ids, the configuration and the generator."""
    import json
    from pathlib import Path

    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    from vvbench.drivers import serve_timesformer
    cfg = json.loads((Path(__file__).resolve().parents[1] / "vvbench"
                      / "configs" / "timesformer-l-retrieval.json")
                     .read_text())
    gen = torch.Generator(device=dev).manual_seed(seed)
    pipe = RetrievalPipeline(RetrievalPipelineConfig(
        backbone="timesformer", crop=224, embed_dim=768), device=dev)
    drawn = serve_timesformer.make_params(gen, cfg, dev)
    params = {"timesformer": pipe.timesformer.cast_weights(
        drawn["timesformer"]), "tower": drawn["tower"]}
    gallery = torch.nn.functional.normalize(
        torch.randn((rows, 768), generator=gen, device=dev), dim=1)
    ids = torch.randperm(rows, generator=gen, device=dev).to(torch.int32)
    return pipe, drawn, params, gallery, ids, cfg, gen


def test_timesformer_query_eager_and_replayed_against_the_reference(dev):
    """TimeSformer-L's query of one 96-frame clip: the first call eager,
    the second captured and replayed, the third replayed; each answer and
    the features after it bit-equal to a fresh pipeline's eager ones; 86
    K1 launches on the sm90 route (12 with GELU), 24 attention launches (12
    a kind), no token re-ordered, a replay counting its capture's; the
    features and picks within the cell's limits of the f32 reference."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    from vvbench.drivers import serve_query, serve_timesformer
    from vvbench.reference import timesformer as ref
    pipe, drawn, params, gallery, ids, cfg, gen = _timesformer_serving(dev)
    row_of_id = torch.full((gallery.shape[0],), -1, dtype=torch.long,
                           device=dev)
    row_of_id[ids.long()] = torch.arange(gallery.shape[0], device=dev)
    replays = []
    for _ in range(3):
        clip = _i3d_clip(gen, 96, dev)
        out, counts = _counted(lambda: pipe.query(params, *clip, gallery,
                                                  ids))
        replays.append(counts.get("vvtpu.query.graph_replays", 0))
        assert _got(counts, "k1.launches", "k1.sm90_launches",
                    "k1.gelu_launches", "attn.launches",
                    "attn.temporal_launches", "attn.spatial_launches",
                    "attn.layout_bytes") == (86, 86, 12, 24, 12, 12, 0)
        fresh = RetrievalPipeline(pipe.cfg, device=dev)
        want = fresh.query(params, *clip, gallery, ids)
        assert fresh._graph is None
        assert out[0].shape == (1, 5) and _equal(out, want)
        assert pipe.features.shape == (1, 65, 768)
        assert torch.equal(pipe.features, fresh.features)
        feats: list = []
        s = ref.scores(ref.embed(drawn, *clip, cfg, feats_out=feats),
                       gallery)
        gap = serve_timesformer.feature_gap(pipe.features, feats[0])
        pick = serve_query.compare(*out, s, row_of_id, 5)["pick_gap"]
        assert gap < cfg["limits"]["feature_gap"], gap
        assert pick < cfg["limits"]["pick_gap"], pick
    assert replays == [0, 1, 1]
