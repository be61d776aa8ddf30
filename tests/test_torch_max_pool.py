"""The NHWC max pool (ops/pooling.py: `max_pool(layout="NHWC")`, the
custom op `vvtpu::max_pool_nhwc`) on the CPU, at the 16 pool geometries of
the serving path (tests/torch_pool_cases.py).

On CPU tensors the op runs its plain version: both entry points give the
bits of the old chain (a -inf F.pad, then F.max_pool2d) and of plain
models of the kernel's two scans (a clipped window row-major; row maxima,
then the rows, as its strips fold them), NaN, signed zeros, all-(-inf)
windows and odd channel counts included. The op's fake implementation
gives the output's shape on "meta" tensors and under FakeTensorMode. The
counter `vvtpu.max_pool.calls` adds each NHWC call (a GoogLeNet forward
13, CaffeNet's 3, a plain model's and NCHW's none) and
`vvtpu.max_pool.launches` no launch on the CPU. The card's tests are in
tests/test_torch_cuda_kernels.py.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from torch_pool_cases import (
    CAFFENET, GEOMETRIES, GOOGLENET, IDS, clipped_window_max, pool_args,
    same_bits, strip_window_max,
)
from videovector_tpu_torch.ops import pooling
from videovector_tpu_torch.ops.pooling import _pool_geometry, max_pool
from videovector_tpu_torch.utils import timer

DTYPES = [torch.bfloat16, torch.float32]


def _old_chain(x, kernel, stride, pad):
    """The NHWC pool as ops/pooling.py computed it before the kernel."""
    nchw = x.permute(0, 3, 1, 2)
    _, _, ph, pw = _pool_geometry(x.shape[1], x.shape[2], kernel, stride, pad)
    out = F.max_pool2d(F.pad(nchw, (pw[0], pw[1], ph[0], ph[1]),
                             value=-math.inf),
                       kernel_size=kernel, stride=stride)
    return out.permute(0, 2, 3, 1)


def _values(shape, dtype, seed):
    """Small integers and halves of both signs, zeros as +0.0 or -0.0, so
    windows hold ties and signed zeros."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-3, 4, shape, generator=g).float() / 2
    neg = torch.rand(shape, generator=g) < 0.5
    x = torch.where((x == 0) & neg, torch.tensor(-0.0), x)
    return x.to(dtype)


def _both_entries(x, kernel, stride, pad):
    with timer.tally() as counts:
        via_pool = max_pool(x, kernel=kernel, stride=stride, pad=pad,
                            layout="NHWC")
    via_op = torch.ops.vvtpu.max_pool_nhwc(x, list(kernel), list(stride),
                                           list(pad))
    assert counts == {"vvtpu.max_pool.calls": 1}
    assert via_pool.is_contiguous() and via_op.is_contiguous()
    return via_pool, via_op


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", GEOMETRIES, ids=IDS)
def test_nhwc_pool_equals_the_old_chain_and_the_kernels_scan(case, dtype):
    hwc, kernel, stride, pad = pool_args(case)
    x = _values((2, *hwc), dtype, seed=sum(hwc) + stride[0])
    want = _old_chain(x, kernel, stride, pad)
    launches = pooling.max_pool_nhwc.launches
    for got in _both_entries(x, kernel, stride, pad):
        assert same_bits(got, want)
    for scan in (clipped_window_max, strip_window_max):
        assert same_bits(scan(x, kernel, stride, pad), want)
    assert pooling.max_pool_nhwc.launches == launches


@pytest.mark.parametrize("case", GEOMETRIES, ids=IDS)
def test_the_fake_shape_matches(case):
    hwc, kernel, stride, pad = pool_args(case)
    want = _old_chain(torch.zeros((3, *hwc)), kernel, stride, pad).shape
    meta = torch.ops.vvtpu.max_pool_nhwc(
        torch.empty((3, *hwc), device="meta", dtype=torch.bfloat16),
        list(kernel), list(stride), list(pad))
    assert meta.shape == want and meta.dtype == torch.bfloat16
    with FakeTensorMode() as mode:
        fake = torch.ops.vvtpu.max_pool_nhwc(
            mode.from_tensor(torch.empty((3, *hwc))), list(kernel),
            list(stride), list(pad))
    assert fake.shape == want and fake.is_contiguous()


def _planted(kind, dtype):
    """(x, kernel, stride, pad) with one kind of edge value."""
    if kind == "nan":
        x = _values((2, 14, 14, 24), dtype, seed=1)
        x[0, 3, 4, 5] = x[1, 0, 0, 7] = x[1, 13, 13, 0] = float("nan")
        return x, (3, 3), (1, 1), (1, 1)
    if kind == "all_neg_inf":
        x = _values((1, 9, 9, 16), dtype, seed=2)
        x[0, :4, :4] = -float("inf")      # whole windows, padding beside them
        return x, (3, 3), (2, 2), (1, 1)
    if kind == "odd_channels":
        return _values((2, 15, 15, 13), dtype, seed=3), (3, 3), (2, 2), (0, 0)
    # a window that reaches past the image on the ceil side, and a 2x2/2 pool
    return _values((2, 10, 11, 8), dtype, seed=4), (2, 2), (2, 2), (0, 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["nan", "all_neg_inf", "odd_channels",
                                  "two_by_two"])
def test_edge_values(kind, dtype):
    x, kernel, stride, pad = _planted(kind, dtype)
    want = _old_chain(x, kernel, stride, pad)
    for got in _both_entries(x, kernel, stride, pad):
        assert same_bits(got, want)
    for scan in (clipped_window_max, strip_window_max):
        assert same_bits(scan(x, kernel, stride, pad), want)
    if kind == "nan":
        assert want.isnan().sum() >= 3
    if kind == "all_neg_inf":
        assert (want == -float("inf")).any()


def _recorded_pools(monkeypatch):
    """The (H, W, C), kernel, stride and pad of each `max_pool_nhwc` call."""
    seen, real = [], pooling.max_pool_nhwc

    def record(x, kernel, stride, pad=(0, 0)):
        seen.append((tuple(x.shape[1:]), kernel[0], stride[0], pad[0]))
        return real(x, kernel, stride, pad)
    monkeypatch.setattr(pooling, "max_pool_nhwc", record)
    return seen


def _geometries(cases):
    return [c[1:] for c in cases]


def test_googlenet_runs_its_13_pools_through_the_op(monkeypatch):
    from videovector_tpu_torch.models.googlenet import GoogLeNet
    net = GoogLeNet()
    params = net.init(torch.Generator().manual_seed(0))
    images = torch.randn((1, 224, 224, 3), generator=torch.Generator()
                         .manual_seed(1))
    seen = _recorded_pools(monkeypatch)
    with timer.tally() as counts:
        net.forward(params, images)
    assert seen == _geometries(GOOGLENET)
    assert counts.get("vvtpu.max_pool.calls") == 13
    assert "vvtpu.max_pool.launches" not in counts
    with timer.tally() as counts:
        GoogLeNet(plain=True).forward(params, images[:, :64, :64])
    assert "vvtpu.max_pool.calls" not in counts


def test_caffenet_runs_its_3_pools_through_the_op(monkeypatch):
    from videovector_tpu_torch.models.mednet import MedNet, MedNetConfig
    cfg = MedNetConfig(fc6=8, fc7=8)
    params = MedNet(cfg).init(torch.Generator().manual_seed(0))
    images = torch.randn((1, 227, 227, 3), generator=torch.Generator()
                         .manual_seed(1))
    seen = _recorded_pools(monkeypatch)
    with timer.tally() as counts:
        fc7 = MedNet(cfg).forward(params, images)
    assert seen == _geometries(CAFFENET)
    assert counts.get("vvtpu.max_pool.calls") == 3
    with timer.tally() as counts:
        plain = MedNet(cfg, plain=True).forward(params, images)
    assert "vvtpu.max_pool.calls" not in counts
    assert torch.equal(fc7, plain)


def test_nchw_pooling_keeps_its_path():
    x = _values((2, 8, 13, 13), torch.float32, seed=5)
    with timer.tally() as counts:
        got = max_pool(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    assert counts == {}
    want = _old_chain(x.permute(0, 2, 3, 1), (3, 3), (2, 2),
                      (1, 1)).permute(0, 3, 1, 2)
    assert same_bits(got, want)
