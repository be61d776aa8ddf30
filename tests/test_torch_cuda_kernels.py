"""The port's Hopper kernels (K1's two routes, K2) against their plain
versions on a CUDA card: ragged shapes, strided operands, groups, both
dtypes, split-K, and the launch preconditions. Skipped without a card.

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
    with pytest.raises(NotImplementedError, match="training slice"):
        k1.matmul(x.requires_grad_(), torch.ones(8, 4, device=dev))
    xb = torch.ones(64, 64, device=dev, dtype=torch.bfloat16)
    assert k1.k1_route(xb, xb, torch.float32) == "sm90"
    with pytest.raises(NotImplementedError, match="training slice"):
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
