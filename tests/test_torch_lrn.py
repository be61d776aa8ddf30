"""The NHWC LRN (ops/lrn.py: `lrn_nhwc`, the custom op `vvtpu::lrn_nhwc`) on
the CPU.

On CPU tensors the op runs its plain version (`lrn_cross_channel` on the
last axis, in x's dtype), so `lrn_nhwc` gives the bits it gave before its
kernel, through one `vvtpu::lrn_nhwc` call that `torch.export` records as
one node an LRN. The op's fake implementation gives the output's shape and
dtype on "meta" tensors and under FakeTensorMode. A call that autograd
records takes the plain version directly (the op has no backward). The
counter `vvtpu.lrn.calls` adds each call, on any device and inside
`device.plain_versions()`; `vvtpu.lrn.launches` no launch on the CPU. The
card's tests are in tests/test_torch_cuda_kernels.py.
"""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from videovector_tpu_torch.device import plain_versions
from videovector_tpu_torch.ops import lrn
from videovector_tpu_torch.utils import timer

DTYPES = [torch.bfloat16, torch.float32, torch.float16]


class _Ops(TorchDispatchMode):
    """The names of the ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _x(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 40).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kw", [
    ((2, 5, 6, 64), {}),
    ((1, 3, 4, 13), {"local_size": 3, "alpha": 2e-4, "beta": 0.5}),
    ((2, 2, 3, 3), {"local_size": 7, "alpha": 1e-3, "beta": 1.0}),
])
def test_the_cpu_takes_the_plain_version_through_the_op(shape, kw, dtype):
    x = _x(shape, dtype, seed=sum(shape))
    with timer.tally() as counts, _Ops() as ops:
        got = lrn.lrn_nhwc(x, **kw)
    assert counts == {"vvtpu.lrn.calls": 1}
    assert ops.names.count("vvtpu.lrn_nhwc.default") == 1
    want = lrn.lrn_cross_channel(
        x, axis=3, **{"local_size": 5, "alpha": 1e-4, "beta": 0.75, **kw})
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(lrn.lrn_nhwc_plain(x, **kw), want)


def test_a_non_contiguous_x_gives_a_contiguous_output():
    x = _x((2, 4, 4, 16)).permute(0, 2, 1, 3)
    got = lrn.lrn_nhwc(x)
    assert got.is_contiguous()
    assert torch.equal(got, lrn.lrn_nhwc_plain(x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_fake_gives_shape_and_dtype(dtype):
    meta = torch.ops.vvtpu.lrn_nhwc(
        torch.empty((3, 7, 5, 24), device="meta", dtype=dtype), 5, 1e-4,
        0.75)
    assert meta.shape == (3, 7, 5, 24) and meta.dtype == dtype
    with FakeTensorMode() as mode:
        fake = torch.ops.vvtpu.lrn_nhwc(
            mode.from_tensor(torch.empty((2, 3, 4, 8), dtype=dtype)), 3,
            1e-4, 0.75)
    assert fake.shape == (2, 3, 4, 8) and fake.dtype == dtype
    assert fake.is_contiguous()


@pytest.mark.parametrize("bad,error", [
    (torch.empty((3, 4, 8)), ValueError),
    (torch.empty((1, 3, 4, 8), dtype=torch.float64), TypeError),
])
def test_the_op_refuses_other_ranks_and_dtypes(bad, error):
    with pytest.raises(error):
        torch.ops.vvtpu.lrn_nhwc(bad, 5, 1e-4, 0.75)
    with pytest.raises(error):
        torch.ops.vvtpu.lrn_nhwc(bad.to("meta"), 5, 1e-4, 0.75)


@pytest.mark.parametrize("call", ["entry", "op", "fake"])
def test_an_even_local_size_raises(call):
    x = _x((1, 2, 2, 8))
    with pytest.raises(ValueError, match="must be odd"):
        if call == "entry":
            lrn.lrn_nhwc(x, local_size=4)
        elif call == "op":
            torch.ops.vvtpu.lrn_nhwc(x, 4, 1e-4, 0.75)
        else:
            torch.ops.vvtpu.lrn_nhwc(x.to("meta"), 6, 1e-4, 0.75)


def test_a_call_that_autograd_records_takes_the_plain_version():
    """With grad on and x requiring it, the plain version runs (no op) and
    its gradient is the plain chain's; under no_grad the op runs."""
    x = _x((2, 3, 3, 16)).requires_grad_()
    with timer.tally() as counts, _Ops() as ops:
        y = lrn.lrn_nhwc(x)
    assert counts == {"vvtpu.lrn.calls": 1}
    assert "vvtpu.lrn_nhwc.default" not in ops.names
    (got,) = torch.autograd.grad(y.square().sum(), x)
    x2 = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(
        lrn.lrn_cross_channel(x2, alpha=1e-4, axis=3).square().sum(), x2)
    assert torch.equal(got, want)
    with torch.no_grad(), _Ops() as ops:
        out = lrn.lrn_nhwc(x)
    assert ops.names.count("vvtpu.lrn_nhwc.default") == 1
    assert not out.requires_grad and torch.equal(out, y.detach())


def _small_mednet():
    from videovector_tpu_torch.models.mednet import (
        CAFFENET_CONVS, MedNet, MedNetConfig,
    )
    convs = tuple(dataclasses.replace(c, num_output=16)
                  for c in CAFFENET_CONVS)
    cfg = MedNetConfig(convs=convs, fc6=24, fc7=12, input_hw=(67, 67),
                       compute_dtype="float32")
    net = MedNet(cfg)
    return net, net.init(torch.Generator().manual_seed(0))


def test_an_exported_mednet_holds_one_lrn_node_an_lrn():
    """CaffeNet's norm1 and norm2 export as two vvtpu.lrn_nhwc nodes and no
    aten pad or pow; the program gives the eager forward's bits."""
    from videovector_tpu_torch.tools.export_model import export
    net, params = _small_mednet()
    x = torch.randn((2, 67, 67, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ep = export(lambda im: net.forward(params, im), (x,))
        targets = [str(n.target) for n in ep.graph.nodes]
        assert sum("vvtpu.lrn_nhwc" in t for t in targets) == 2, targets
        assert not any("pad" in t or "pow" in t for t in targets), targets
        assert torch.equal(ep.module()(x), net.forward(params, x))


@pytest.mark.parametrize("backbone", ["googlenet", "caffenet"])
def test_a_forward_counts_its_two_lrns(backbone):
    """A GoogLeNet forward and a CaffeNet forward each count two LRN calls
    and no launch on the CPU, inside `plain_versions()` as well."""
    if backbone == "googlenet":
        from videovector_tpu_torch.models.googlenet import GoogLeNet
        net = GoogLeNet()
        params = net.init(torch.Generator().manual_seed(0))
        x = torch.randn((1, 64, 64, 3),
                        generator=torch.Generator().manual_seed(1))
    else:
        net, params = _small_mednet()
        x = torch.randn((1, 67, 67, 3),
                        generator=torch.Generator().manual_seed(1))
    with timer.tally() as counts:
        want = net.forward(params, x)
    assert counts.get("vvtpu.lrn.calls") == 2
    assert "vvtpu.lrn.launches" not in counts
    with timer.tally() as counts, plain_versions():
        got = net.forward(params, x)
    assert counts.get("vvtpu.lrn.calls") == 2
    assert "vvtpu.lrn.launches" not in counts
    assert torch.equal(got, want)
