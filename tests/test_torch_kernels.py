"""The port's kernel modules (K1 ops/hopper/matmul.py, K2
ops/hopper/conv_gemm.py) and the plain ops around them, against the JAX
package on the CPU. On CPU tensors each wrapper runs its plain version; the
same numpy-seeded inputs go through the Pallas kernels in interpret mode.
All f32; tolerance atol 1e-3 as in tests/test_pallas.py unless stated.
The bf16-output tests use integer operands, whose f32 sums are exact, and
compare bit for bit: there the only difference left is where each side
rounds."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st
from jax import lax

from videovector_tpu.models.mednet import MedNet as JaxMedNet
from videovector_tpu.ops.conv import conv2d as jax_conv2d
from videovector_tpu.ops.conv import im2col as jax_im2col
from videovector_tpu.ops.normalization import l2_normalize_rows as jax_l2n
from videovector_tpu.ops.pallas.conv_gemm import (
    conv2d_im2col_gemm as jax_conv_gemm,
)
from videovector_tpu.ops.pallas.matmul import matmul as jax_matmul
from videovector_tpu.ops.pallas.matmul import matmul_padded as jax_matmul_padded
from videovector_tpu_torch import _build
from videovector_tpu_torch.ops import conv as tconv
from videovector_tpu_torch.ops.activations import relu
from videovector_tpu_torch.ops.hopper import conv_gemm as k2
from videovector_tpu_torch.ops.hopper import matmul as k1
from videovector_tpu_torch.ops.normalization import l2_normalize_rows

torch.set_num_threads(1)


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", ["256x512x256", "bias_relu_128x256x128",
                                  "padded_100x300x70"])
def test_k1_matches_pallas_matmul(rng, case):
    if case == "256x512x256":
        x, w, b = _np(rng, 256, 512), _np(rng, 512, 256), None
        ref = jax_matmul(jnp.asarray(x), jnp.asarray(w), block_m=128,
                         block_n=128, block_k=256, interpret=True)
        got = k1.matmul(torch.as_tensor(x), torch.as_tensor(w))
    elif case == "bias_relu_128x256x128":
        x, w, b = _np(rng, 128, 256), _np(rng, 256, 128), _np(rng, 128)
        ref = jax_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         block_m=128, block_n=128, block_k=128,
                         fuse_relu=True, interpret=True)
        got = k1.matmul(torch.as_tensor(x), torch.as_tensor(w),
                        torch.as_tensor(b), fuse_relu=True)
    else:
        x, w = _np(rng, 100, 300), _np(rng, 300, 70)
        ref = jax_matmul_padded(jnp.asarray(x), jnp.asarray(w), interpret=True)
        got = k1.matmul_padded(torch.as_tensor(x), torch.as_tensor(w))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("mkn,relu", [((64, 256, 128), True),
                                      ((128, 128, 256), False)])
def test_k1_bf16_out_matches_pallas_bit_for_bit(mkn, relu):
    """K1 rounds once, after bias and ReLU in f32, as the Pallas kernel does:
    integer operands in [-4, 4] with K <= 256 make both f32 sums exact, and a
    bias of odd eighths makes the sums need rounding in bf16."""
    m, k, n = mkn
    rs = np.random.RandomState(0)
    x = rs.randint(-4, 5, (m, k)).astype(np.float32)
    w = rs.randint(-4, 5, (k, n)).astype(np.float32)
    b = (2 * rs.randint(-64, 64, n) + 1).astype(np.float32) / 8
    ref = jax_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                     jnp.asarray(b), block_m=64, block_n=128, block_k=128,
                     fuse_relu=relu, out_dtype=jnp.bfloat16, interpret=True)
    got = k1.matmul(torch.as_tensor(x).bfloat16(), torch.as_tensor(w).bfloat16(),
                    torch.as_tensor(b), fuse_relu=relu, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_k1_bf16_out_rounds_once_after_bias():
    """K2's bf16 output follows MedNet's conv epilogue (models/mednet.py): the
    conv emits bf16, the bias is rounded to bf16 and added in bf16, then
    ReLU. Integer operands keep the conv sums exact in bf16, so the port and
    JAX agree bit for bit; the f32 bias has bits beyond bf16, so K1's single
    rounding would differ."""
    rs = np.random.RandomState(0)
    x = rs.randint(-2, 3, (2, 7, 7, 4)).astype(np.float32)        # NHWC
    w = rs.randint(-2, 3, (3, 3, 2, 6)).astype(np.float32)        # HWIO, 2 groups
    b = rs.randn(6).astype(np.float32) * 8
    bf = jnp.bfloat16
    conv = lax.conv_general_dilated(
        jnp.asarray(x, bf), jnp.asarray(w, bf), window_strides=(1, 1),
        padding=[(1, 1)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=2, preferred_element_type=bf)
    ref = np.asarray(jnp.maximum(conv + jnp.asarray(b).astype(bf), 0.0)
                     .astype(jnp.float32))
    got = k2.conv2d_gemm_nhwc(torch.as_tensor(x).bfloat16(),
                              torch.as_tensor(w).bfloat16(), torch.as_tensor(b),
                              pad=(1, 1), groups=2, fuse_relu=True,
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    once = torch.relu(torch.as_tensor(np.asarray(conv.astype(jnp.float32)) + b))
    assert (once.bfloat16().float().numpy() != ref).any()


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _misaligned(x):
    """A contiguous copy of x whose data starts 2 bytes past 16."""
    buf = torch.zeros(x.numel() + 8, dtype=x.dtype)
    return buf[1:1 + x.numel()].view(x.shape).copy_(x)


@pytest.mark.parametrize("case,route", [
    ("contiguous_bf16", "sm90"),
    ("bf16_out", "sm90"),
    ("f32", "f32"),
    ("transposed_w", "core"),
    ("odd_row_stride", "core"),
    ("misaligned_offset", "core"),
    ("broadcast_rows", "core"),
    ("empty_k", "core"),
    ("f32_bf16_out", "f32"),
    ("f32_row_stride_of_4", "f32"),
    ("f32_transposed_w", "core"),
    ("f32_odd_row_stride", "core"),
    ("f32_misaligned_offset", "core"),
    ("f32_broadcast_rows", "core"),
    ("f32_empty_k", "core"),
])
def test_k1_route(case, route):
    x, w, out = _bf16(50, 256), _bf16(256, 520), torch.float32
    if case == "bf16_out":
        out = torch.bfloat16
    elif case == "f32":
        x, w = x.float(), w.float()
    elif case == "transposed_w":
        w = _bf16(520, 256).T
    elif case == "odd_row_stride":
        x = _bf16(50, 260)[:, :256]                 # row stride 260: 520 bytes
    elif case == "misaligned_offset":
        x = _bf16(50, 264)[:, 1:257]                # data 2 bytes past 16
    elif case == "broadcast_rows":
        x = _bf16(1, 256).expand(50, 256)          # row stride 0
    elif case == "empty_k":
        x, w = _bf16(50, 0), _bf16(0, 520)
    elif case.startswith("f32_"):
        x, w = x.float(), w.float()
        if case == "f32_bf16_out":
            out = torch.bfloat16
        elif case == "f32_row_stride_of_4":
            x = torch.zeros(50, 260)[:, :256]       # 1040 bytes
        elif case == "f32_transposed_w":
            w = torch.zeros(520, 256).T
        elif case == "f32_odd_row_stride":
            x = torch.zeros(50, 258)[:, :256]       # 1032 bytes
        elif case == "f32_misaligned_offset":
            x = torch.zeros(50, 264)[:, 1:257]      # data 4 bytes past 16
        elif case == "f32_broadcast_rows":
            x = torch.zeros(1, 256).expand(50, 256)
        elif case == "f32_empty_k":
            x, w = torch.zeros(50, 0), torch.zeros(0, 520)
    assert k1.k1_route(x, w, out) == route


def _split_k_ranges(k, splits, bk=k1.SM90_BK):
    """The [k0, k1) range of each split as csrc/matmul_sm90.cu and
    csrc/matmul_f32_sm90.cu compute it: split s takes BK tiles
    [s * T // splits, (s + 1) * T // splits) of the T = ceil(k / BK) tiles."""
    k_tiles = -(-k // bk)
    return [(s * k_tiles // splits * bk,
             min(k, (s + 1) * k_tiles // splits * bk))
            for s in range(splits)]


@pytest.mark.parametrize("m,n,k", [(1, 8, 64), (50, 4096, 9216),
                                   (50, 4096, 4096), (50, 520, 1000),
                                   (63, 8, 64), (65, 4096, 4096),
                                   (256, 4096, 9216), (1920, 4096, 4096),
                                   (50, 4096, 100)])
def test_k1_split_plan(m, n, k):
    """Splits are >= 1 and at most the BK tiles of K, so every split's K
    range is non-empty and, but for the last, a multiple of BK."""
    sms = 132
    block_m, splits = k1.k1_split_plan(m, n, k, sms)
    assert block_m == (64 if m <= 64 else 128)
    k_tiles = -(-k // k1.SM90_BK)
    tiles = -(-m // block_m) * -(-n // k1.SM90_BN)
    assert 1 <= splits <= k_tiles
    ranges = _split_k_ranges(k, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and (a1 - a0) % k1.SM90_BK == 0
    assert all(k1_ > k0 for k0, k1_ in ranges)
    # one wave of at most one block per SM, which fills the card to within
    # one split's worth of tiles where K allows
    assert tiles * splits <= max(tiles, sms)
    if tiles * k_tiles >= sms:
        assert tiles * splits > sms - tiles
    if tiles >= sms:
        assert splits == 1


def test_k1_split_plan_serving_and_training_shapes():
    assert k1.k1_split_plan(50, 4096, 9216, 132) == (64, 4)
    assert k1.k1_split_plan(50, 4096, 4096, 132) == (64, 4)
    assert k1.k1_split_plan(256, 4096, 9216, 132) == (128, 2)
    assert k1.k1_split_plan(256, 4096, 4096, 132) == (128, 2)
    assert k1.k1_split_plan(1920, 4096, 4096, 132) == (128, 1)


def _f32_fill(tiles, splits, sms):
    """The share of its waves of one block per SM that tiles x splits
    blocks fill."""
    blocks = tiles * splits
    return blocks / (-(-blocks // sms) * sms)


@pytest.mark.parametrize("m,n,k", [(1, 8, 4), (129, 260, 36), (673, 4100, 1000),
                                   (673, 4096, 4096), (1920, 4096, 4096),
                                   (50, 4096, 9216), (300, 260, 64),
                                   (4096, 4096, 4096), (200, 128, 100000)])
def test_k1_f32_plan(m, n, k):
    """The f32 route's tiles cover the output; splits are between 1 and
    the BK tiles of K and their K ranges partition K; splits is the fewest
    whose blocks fill their waves of one block per SM to F32_FILL, or one
    per BK tile when no count does."""
    sms = 132
    (block_m, block_n), splits = k1.k1_f32_plan(m, n, k, sms)
    assert (block_m, block_n) == (k1.F32_BM, k1.F32_BN)
    tiles_m, tiles_n = -(-m // block_m), -(-n // block_n)
    assert (tiles_m - 1) * block_m < m <= tiles_m * block_m
    assert (tiles_n - 1) * block_n < n <= tiles_n * block_n
    k_tiles = -(-k // k1.F32_BK)
    assert 1 <= splits <= k_tiles
    ranges = _split_k_ranges(k, splits, k1.F32_BK)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and (a1 - a0) % k1.F32_BK == 0
    assert all(k1_ > k0 for k0, k1_ in ranges)
    tiles = tiles_m * tiles_n
    fills = [_f32_fill(tiles, s, sms) for s in range(1, splits + 1)]
    if fills[-1] >= k1.F32_FILL:
        assert all(f < k1.F32_FILL for f in fills[:-1])
    else:
        assert splits == k_tiles and all(f < k1.F32_FILL for f in fills)


def test_k1_f32_plan_net_shapes():
    """The f32 Net's INNER_PRODUCT on an H100 (132 SMs): TRAIN's 1920 rows
    give 480 tiles, 91% of 4 waves, so 3 splits fill 11 waves to 99%;
    TEST's 673 rows give 192 tiles, 73% of 2 waves, so 2 splits fill 3
    waves to 97%."""
    assert k1.k1_f32_plan(1920, 4096, 4096, 132) == ((128, 128), 3)
    assert k1.k1_f32_plan(673, 4096, 4096, 132) == ((128, 128), 2)
    assert _f32_fill(480, 1, 132) < k1.F32_FILL <= _f32_fill(480, 3, 132)
    assert round(_f32_fill(480, 3, 132), 2) == 0.99
    assert round(_f32_fill(192, 2, 132), 2) == 0.97


def test_k1_validates_before_dispatch():
    x = torch.ones(4, 8)
    with pytest.raises(TypeError):
        k1.matmul(x, torch.ones(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        k1.matmul(x, torch.ones(7, 4))
    with pytest.raises(TypeError):
        k1.matmul(x.double(), torch.ones(8, 4, dtype=torch.float64))
    # "meta" tensors take the plain versions: shapes, no data
    assert k1.matmul(x.to("meta"), torch.ones(8, 4, device="meta")).shape \
        == (4, 4)
    assert k2.conv2d_im2col_gemm(torch.ones(1, 1, 3, 3, device="meta"),
                                 torch.ones(1, 1, 1, 1, device="meta")) \
        .shape == (1, 1, 3, 3)
    # a tensor on any other device neither launches nor falls back
    with FakeTensorMode():
        with pytest.raises(ValueError, match="CUDA"):
            k1.matmul(torch.ones(4, 8, device="mps"),
                      torch.ones(8, 4, device="mps"))
        with pytest.raises(ValueError, match="CUDA"):
            k2.conv2d_im2col_gemm(torch.ones(1, 1, 3, 3, device="mps"),
                                  torch.ones(1, 1, 1, 1, device="mps"))


def test_k2_matches_pallas_conv_gemm(rng):
    x, w, b = _np(rng, 2, 3, 9, 9), _np(rng, 8, 3, 3, 3), _np(rng, 8)
    ref = jax_conv_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=(2, 2), pad=(1, 1), interpret=True)
    got = k2.conv2d_im2col_gemm(torch.as_tensor(x), torch.as_tensor(w),
                                torch.as_tensor(b), stride=(2, 2), pad=(1, 1))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    with pytest.raises(ValueError, match="groups"):
        k2.conv2d_im2col_gemm(torch.as_tensor(x), torch.as_tensor(w[:, :1]))


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_k2_grouped_nhwc_matches_jax_conv(rng, fuse_relu):
    """A grouped MedNet conv (conv2's geometry, narrow): K2's NHWC/HWIO entry
    against JAX ops.conv.conv2d(groups=2) on NCHW/OIHW."""
    x, w, b = _np(rng, 2, 8, 13, 13), _np(rng, 6, 4, 5, 5), _np(rng, 6)
    ref = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                pad=(2, 2), groups=2))
    if fuse_relu:
        ref = np.maximum(ref, 0)
    got = k2.conv2d_gemm_nhwc(
        torch.as_tensor(x.transpose(0, 2, 3, 1)),
        torch.as_tensor(w.transpose(2, 3, 1, 0)), torch.as_tensor(b),
        pad=(2, 2), groups=2, fuse_relu=fuse_relu)
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), ref,
                               atol=1e-3)


# CaffeNet's convs as (x NHWC, w HWIO, stride, pad), at batch 2
CAFFENET_K2 = {
    "conv1": ((2, 227, 227, 3), (11, 11, 3, 96), 4, 0),
    "conv2": ((2, 27, 27, 96), (5, 5, 48, 256), 1, 2),
    "conv3": ((2, 13, 13, 256), (3, 3, 256, 384), 1, 1),
    "conv4": ((2, 13, 13, 384), (3, 3, 192, 384), 1, 1),
    "conv5": ((2, 13, 13, 384), (3, 3, 192, 256), 1, 1),
}


@pytest.mark.parametrize("case,route", [
    *((name, "sm90") for name in CAFFENET_K2),
    ("conv3_f32_out", "sm90"),
    ("f32", "core"),
    ("f32_out_f32_in", "f32"),
    *((f"f32_{name}", "f32") for name in CAFFENET_K2),
    ("f32_odd_channel_stride", "core"),
    ("f32_misaligned_data", "core"),
    ("f32_cg3_padded", "f32"),
    ("f32_og_not_multiple_of_4", "core"),
    ("f32_w_not_contiguous", "core"),
    ("odd_channel_stride", "core"),
    ("misaligned_data", "core"),
    ("cg_12_stride_1", "core"),
    ("conv1_padded", "sm90"),
    ("conv1_ragged_step", "sm90"),
    ("googlenet_conv1", "sm90"),
    ("cg3_stride_1", "core"),
    ("og_not_multiple_of_8", "core"),
    ("w_not_contiguous", "core"),
    ("conv1_w_not_contiguous", "core"),
    ("conv1_misaligned_data", "core"),
])
def test_k2_route(case, route):
    name = case if case in CAFFENET_K2 else case[4:] if case[4:] in \
        CAFFENET_K2 else "conv3"
    xs, ws, s, p = CAFFENET_K2[name]
    x, w, out = _bf16(*xs), _bf16(*ws), torch.bfloat16
    if case.startswith("f32_"):
        # f32 operands and output: the f32 route, unless the gathers cannot
        # address them
        x, w, out = x.float(), w.float(), torch.float32
    if case == "f32_odd_channel_stride":
        x = torch.zeros(2, 13, 13, 512)[..., ::2]     # channel stride 2
    elif case == "f32_misaligned_data":
        x = torch.zeros(2, 13, 13, 260)[..., 1:257]   # data 4 bytes past 16
    elif case == "f32_cg3_padded":
        x, w = torch.zeros(2, 227, 227, 3), torch.zeros(11, 11, 3, 96)
        s, p = 4, 2                                   # repacked, pad and all
    elif case == "f32_og_not_multiple_of_4":
        w = torch.zeros(3, 3, 256, 6)                 # 6 outputs
    elif case == "f32_w_not_contiguous":
        w = torch.zeros(384, 3, 3, 256).permute(1, 2, 3, 0)
    elif case == "conv3_f32_out":
        out = torch.float32
    elif case == "f32":
        x, w = x.float(), w.float()
    elif case == "f32_out_f32_in":
        x, w, out = x.float(), w.float(), torch.float32
    elif case == "odd_channel_stride":
        x = _bf16(2, 13, 13, 512)[..., ::2]          # channel stride 2
    elif case == "misaligned_data":
        x = _bf16(2, 13, 13, 264)[..., 1:257]        # data 2 bytes past 16
    elif case == "cg_12_stride_1":
        x, w = _bf16(2, 9, 9, 24), _bf16(3, 3, 12, 32)   # 24-byte chunks
    elif case == "conv1_padded":
        x, w = _bf16(2, 227, 227, 3), _bf16(11, 11, 3, 96)
        s, p = 4, 1
    elif case == "conv1_ragged_step":
        x, w = _bf16(2, 228, 228, 3), _bf16(11, 11, 3, 96)   # (228-11) % 4
        s = 4
    elif case == "googlenet_conv1":
        x, w = _bf16(2, 224, 224, 3), _bf16(7, 7, 3, 64)     # 12 channels
        s, p = 2, 3                                   # repacked: 16, padded
    elif case == "cg3_stride_1":
        x, w = _bf16(2, 28, 28, 3), _bf16(3, 3, 3, 64)  # nothing to repack
        s, p = 1, 1
    elif case == "og_not_multiple_of_8":
        w = _bf16(3, 3, 128, 12)                      # 2 groups of 6 outputs
    elif case == "w_not_contiguous":
        w = _bf16(384, 3, 3, 256).permute(1, 2, 3, 0)
    elif case == "conv1_w_not_contiguous":
        xs, ws, s, p = CAFFENET_K2["conv1"]
        x, w = _bf16(*xs), _bf16(96, 11, 11, 3).permute(1, 2, 3, 0)
    elif case == "conv1_misaligned_data":
        xs, ws, s, p = CAFFENET_K2["conv1"]
        x, w = _misaligned(_bf16(*xs)), _bf16(*ws)
    assert k2.k2_route(x, w, out, stride=(s, s), pad=(p, p)) == route


@pytest.mark.parametrize("m,og,groups", [
    (151_250, 96, 1), (36_450, 128, 2), (8_450, 384, 1), (8_450, 192, 2),
    (8_450, 128, 2), (774_400, 96, 1), (43_264, 192, 2), (1, 8, 1),
    (100, 40, 3), (300, 520, 2), (65, 200, 1)])
def test_k2_sm90_plan_covers_every_tile_and_no_tile_crosses_a_group(
        m, og, groups):
    sms = 132
    block_m, block_n, grid = k2.k2_sm90_plan(m, og, groups, sms)
    assert block_m in k2.SM90_BLOCK_M and block_n in k2.SM90_BLOCK_N
    assert grid[2] == groups
    assert (grid[0] - 1) * block_m < m <= grid[0] * block_m
    for g in range(groups):
        cols = []
        for j in range(grid[1]):
            lo = g * og + j * block_n
            hi = g * og + min((j + 1) * block_n, og)
            assert g * og <= lo < hi <= (g + 1) * og      # inside group g
            cols.extend(range(lo, hi))
        assert cols == list(range(g * og, (g + 1) * og))  # each column once
    assert block_m == (128 if -(-m // 128) * grid[1] * groups >= 2 * sms
                       else 64)


def test_k2_sm90_plan_caffenet():
    """Tiles that divide each conv's group width (conv1's after the
    space-to-depth repack); 128 rows per block where that still gives two
    blocks per SM (conv1, conv2), else 64."""
    plans = {(m, og, g): k2.k2_sm90_plan(m, og, g, 132)[:2]
             for m, og, g in ((151_250, 96, 1), (36_450, 128, 2),
                              (8_450, 384, 1), (8_450, 192, 2),
                              (8_450, 128, 2))}
    assert list(plans.values()) == [(128, 96), (128, 128), (64, 192),
                                    (64, 192), (64, 128)]
    # batch 256: every conv has enough 128-row blocks
    assert k2.k2_sm90_plan(43_264, 384, 1, 132)[:2] == (128, 192)
    assert k2.k2_sm90_plan(43_264, 128, 2, 132)[:2] == (128, 128)


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 200_000), og=st.integers(1, 130).map(lambda v: 4 * v),
       groups=st.integers(1, 4), k=st.integers(1, 1200).map(lambda v: 4 * v),
       sms=st.sampled_from([132, 114, 1]))
def test_k2_f32_plan_covers_every_tile_once_and_no_tile_crosses_a_group(
        m, og, groups, k, sms):
    """The f32 route's grid, as the kernel reads its block indices: every
    (row, group column, K tile) once, no tile reaching into another group,
    every split a non-empty run of K tiles."""
    block_m, block_n, splits = k2.k2_f32_plan(m, og, groups, k, sms)
    assert (block_m, block_n) in k2.F32_TILES
    k_tiles = -(-k // k2.F32_BK)
    assert 1 <= splits <= min(k_tiles, k2.F32_MAX_SPLITS)
    grid = (-(-m // block_m), -(-og // block_n), groups * splits)
    assert (grid[0] - 1) * block_m < m <= grid[0] * block_m
    ranges = [range(s * k_tiles // splits, (s + 1) * k_tiles // splits)
              for s in range(splits)]
    assert all(ranges) and [t for r in ranges for t in r] == list(range(k_tiles))
    for z in range(grid[2]):
        g, split = divmod(z, splits)
        assert g < groups and split < splits
    for g in range(groups):
        cols = []
        for j in range(grid[1]):
            lo = g * og + j * block_n
            hi = g * og + min((j + 1) * block_n, og)
            assert g * og <= lo < hi <= (g + 1) * og      # inside group g
            cols.extend(range(lo, hi))
        assert cols == list(range(g * og, (g + 1) * og))  # each column once


def test_k2_f32_plan_caffenet():
    """The f32 route's plans at CaffeNet's convs, batch 50 (conv1 after the
    space-to-depth repack: 3x3 over 48 channels): 64 x 128 tiles, two blocks
    an SM, but for conv4, whose 192 columns a group take three 64-wide
    tiles with no waste, and K split where the tiles leave much of a wave
    empty (conv3: 399 blocks on 264 places, conv4: 402, conv5: 266); at
    batch 256 every conv fills its waves unsplit but conv5. On the H100 the
    picks summed within 2.3% of the fastest tile and split of each conv in
    scripts/torch_k2_f32_tiles.py at either batch (PERF.md)."""
    convs = {"conv1": (151_250, 96, 1, 432), "conv2": (36_450, 128, 2, 1200),
             "conv3": (8_450, 384, 1, 2304), "conv4": (8_450, 192, 2, 1728),
             "conv5": (8_450, 128, 2, 1728)}
    plans = {name: k2.k2_f32_plan(*geo, 132) for name, geo in convs.items()}
    assert plans == {"conv1": (64, 128, 1), "conv2": (64, 128, 1),
                     "conv3": (64, 128, 3), "conv4": (128, 64, 3),
                     "conv5": (64, 128, 6)}
    b256 = {name: k2.k2_f32_plan(m * 256 // 50, og, g, k, 132)
            for name, (m, og, g, k) in convs.items()}
    assert b256 == {"conv1": (64, 128, 1), "conv2": (64, 128, 1),
                    "conv3": (64, 128, 1), "conv4": (128, 64, 1),
                    "conv5": (64, 128, 3)}


@pytest.mark.parametrize("shape", [(2, 227, 227, 3), (2, 31, 23, 3)])
def test_f32_space_to_depth_conv_matches_jax_conv2d(shape):
    """The f32 route's conv1: `space_to_depth_plain` at f32, then the plain
    stride-1 conv over the repacked operands, against JAX's ops.conv.conv2d
    (the Net's CONVOLUTION) on the original 11x11/4 conv, within 1e-5 of
    the largest magnitude: conv1's geometry narrowed to batch 2 and 16
    outputs, and a ragged edge (the repack pads one row and column past
    the image, which meet only the kernel's zero taps)."""
    rs = np.random.RandomState(6)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(11, 11, 3, 16) * 0.1).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    xs, ws = k2.space_to_depth_plain(torch.as_tensor(x), torch.as_tensor(w), 4)
    assert xs.dtype == ws.dtype == torch.float32
    assert xs.shape == (2, (shape[1] + 1) // 4, (shape[2] + 1) // 4, 48)
    got = k2.conv2d_gemm_nhwc_plain(xs, ws, torch.as_tensor(b)).numpy()
    ref = np.asarray(jax_conv2d(jnp.asarray(x.transpose(0, 3, 1, 2)),
                                jnp.asarray(w.transpose(3, 2, 0, 1)),
                                jnp.asarray(b), stride=(4, 4)))
    ref = ref.transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(2, 23, 23, 3), (1, 227, 227, 3),
                                   (2, 19, 27, 3)])
def test_space_to_depth_matches_jax_and_the_plain_conv(shape):
    """The port's repack, then the plain stride-1 conv, against JAX's
    MedNet._conv_space_to_depth (square images only, as JAX's) and against
    the plain 11x11/4 conv on the original operands (f32)."""
    rs = np.random.RandomState(4)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(11, 11, 3, 8) * 0.1).astype(np.float32)
    xs, ws = k2.space_to_depth(torch.as_tensor(x), torch.as_tensor(w), 4)
    h, wd = shape[1:3]
    assert xs.shape == (shape[0], (h + 1) // 4, (wd + 1) // 4, 48)
    assert ws.shape == (3, 3, 48, 8)
    got = k2.conv2d_gemm_nhwc_plain(xs, ws).numpy()
    if h == wd:
        ref = np.asarray(JaxMedNet._conv_space_to_depth(
            jnp.asarray(x), jnp.asarray(w), 4, jnp.float32))
        np.testing.assert_allclose(got, ref, atol=1e-4)
    direct = k2.conv2d_gemm_nhwc_plain(torch.as_tensor(x), torch.as_tensor(w),
                                       stride=(4, 4)).numpy()
    np.testing.assert_allclose(got, direct, atol=1e-4)


def _sm90_gathered_a(x, w_shape, stride, pad, groups, block_m):
    """The implicit A matrix as csrc/conv_gemm_sm90.cu's producer warpgroup
    writes it, stage by stage, for every M tile and group: the same row and
    chunk decomposition, 128-byte swizzle and zero fill, read back through
    the swizzle. Returns (groups, M, k_tiles * 64)."""
    n, h, wd, c = x.shape
    kh, kw, cg, _ = w_shape
    oh, ow = k2._out_hw(h, wd, kh, kw, stride, pad)
    m_total, k_total = n * oh * ow, kh * kw * cg
    k_tiles = -(-k_total // 64)
    flat = x.reshape(-1)
    sxn, sxh, sxw = h * wd * c, wd * c, c
    a = np.zeros((groups, -(-m_total // block_m) * block_m, k_tiles * 64),
                 np.float32)
    for grp in range(groups):
        for m0 in range(0, m_total, block_m):
            for t in range(k_tiles):
                smem = np.full(block_m * 64, np.nan, np.float32)
                for p in range(128):
                    q = p % 8
                    k = t * 64 + q * 8
                    tap, ch = divmod(k, cg)
                    i, j = divmod(tap, kw)
                    for r in range(block_m * 8 // 128):
                        row = p // 8 + 16 * r
                        m = m0 + row
                        ox, rest = m % ow, m // ow
                        oy, nn = rest % oh, rest // oh
                        y0 = oy * stride[0] - pad[0] if m < m_total else -2**30
                        x0 = ox * stride[1] - pad[1]
                        off = nn * sxn + y0 * sxh + x0 * sxw + grp * cg
                        ok = (k < k_total and 0 <= y0 + i < h
                              and 0 <= x0 + j < wd)
                        dst = row * 64 + (q ^ (row & 7)) * 8
                        src = off + i * sxh + j * sxw + ch
                        smem[dst:dst + 8] = flat[src:src + 8] if ok else 0
                tile = smem.reshape(block_m, 8, 8)
                unswizzled = np.stack([tile[r, [q ^ (r & 7) for q in range(8)]]
                                       for r in range(block_m)])
                a[grp, m0:m0 + block_m, t * 64:(t + 1) * 64] = \
                    unswizzled.reshape(block_m, 64)
    return a[:, :m_total]


@pytest.mark.parametrize("geom", [
    # (n, h, w, c), (kh, kw, cg, o), stride, pad, groups
    ((2, 9, 9, 16), (3, 3, 8, 16), (1, 1), (1, 1), 2),
    ((1, 11, 7, 48), (5, 5, 48, 8), (1, 1), (2, 2), 1),
    ((1, 13, 13, 24), (3, 3, 8, 24), (2, 2), (1, 1), 3),
    ((1, 11, 11, 48), (3, 3, 48, 96), (1, 1), (0, 0), 1),   # conv1 after s2d
])
def test_sm90_gather_index_math_is_im2col(geom):
    """The sm90 route's A tiles, written and read as the kernel does, are the
    plain im2col patches in (i, j, c) order, zeros past K and in the padding,
    for both tile heights."""
    xs, ws, stride, pad, groups = geom
    x = np.random.RandomState(5).randn(*xs).astype(np.float32)
    kh, kw, cg, _ = ws
    cols = tconv.im2col(torch.as_tensor(x).permute(0, 3, 1, 2), kernel=(kh, kw),
                        stride=stride, pad=pad)          # (n, c kh kw, oh, ow)
    n, _, oh, ow = cols.shape
    # im2col orders (c, i, j); the kernel and HWIO weights order (i, j, c)
    patches = cols.reshape(n, groups, cg, kh, kw, oh, ow) \
        .permute(1, 0, 5, 6, 3, 4, 2).reshape(groups, n * oh * ow, kh * kw * cg)
    for block_m in k2.SM90_BLOCK_M:
        a = _sm90_gathered_a(x, ws, stride, pad, groups, block_m)
        k_total = kh * kw * cg
        np.testing.assert_array_equal(a[:, :, :k_total], patches.numpy())
        assert not a[:, :, k_total:].any()


def _f32_gathered_a(x, w_shape, stride, pad, groups, block_m, splits,
                    producers):
    """The implicit A matrix as csrc/conv_gemm_f32_sm90.cu's `producers`
    threads write it, stage by stage, for every M tile, group and split:
    thread p copies chunk p % 8 of rows p // 8 + (producers // 8) r, the row
    origins computed once, its tap set from its first K tile by one
    division and then stepped forward 32 k a stage, the 128-byte swizzle
    and the zero fill, read back through the swizzle. Returns (groups, M,
    k_tiles * 32)."""
    n, h, wd, c = x.shape
    kh, kw, cg, _ = w_shape
    oh, ow = k2._out_hw(h, wd, kh, kw, stride, pad)
    m_total, k_total = n * oh * ow, kh * kw * cg
    k_tiles = -(-k_total // 32)
    flat = x.reshape(-1)
    sxn, sxh, sxw = h * wd * c, wd * c, c
    a = np.zeros((groups, -(-m_total // block_m) * block_m, k_tiles * 32),
                 np.float32)
    for grp in range(groups):
        for m0 in range(0, m_total, block_m):
            rows = []
            for r in range(block_m):
                m = m0 + r
                ox, rest = m % ow, m // ow
                oy, nn = rest % oh, rest // oh
                y0, x0 = oy * stride[0] - pad[0], ox * stride[1] - pad[1]
                rows.append((nn * sxn + y0 * sxh + x0 * sxw + grp * cg,
                             y0 if m < m_total else -2**30, x0))
            for split in range(splits):
                t_begin = split * k_tiles // splits
                nt = (split + 1) * k_tiles // splits - t_begin
                state = {}
                for p in range(producers):
                    k = t_begin * 32 + 4 * (p % 8)
                    tap, ch = divmod(k, cg)
                    state[p] = [k, *divmod(tap, kw), ch]
                for t in range(nt):
                    smem = np.full(block_m * 32, np.nan, np.float32)
                    for p in range(producers):
                        q = p % 8
                        k, i, j, ch = state[p]
                        for r in range(block_m * 8 // producers):
                            row = p // 8 + producers // 8 * r
                            off, y0, x0 = rows[row]
                            ok = (k < k_total and 0 <= y0 + i < h
                                  and 0 <= x0 + j < wd)
                            dst = row * 32 + (q ^ (row & 7)) * 4
                            src = off + i * sxh + j * sxw + ch
                            smem[dst:dst + 4] = flat[src:src + 4] if ok else 0
                        k, ch = k + 32, ch + 32
                        while ch >= cg:
                            ch -= cg
                            j += 1
                            if j == kw:
                                j, i = 0, i + 1
                        state[p] = [k, i, j, ch]
                    tile = smem.reshape(block_m, 8, 4)
                    unswizzled = np.stack([tile[r, [q ^ (r & 7) for q in range(8)]]
                                           for r in range(block_m)])
                    kt = t_begin + t
                    a[grp, m0:m0 + block_m, kt * 32:(kt + 1) * 32] = \
                        unswizzled.reshape(block_m, 32)
    return a[:, :m_total]


@pytest.mark.parametrize("geom", [
    # (n, h, w, c), (kh, kw, cg, o), stride, pad, groups
    ((2, 9, 9, 8), (3, 3, 4, 8), (1, 1), (1, 1), 2),       # Cg 4: 8 taps a stage
    ((1, 11, 7, 12), (5, 5, 12, 8), (1, 1), (2, 2), 1),    # taps mid-chunk row
    ((1, 13, 13, 48), (3, 3, 16, 24), (2, 2), (1, 1), 3),
    ((1, 11, 11, 48), (3, 3, 48, 96), (1, 1), (0, 0), 1),  # conv1 after s2d
])
@pytest.mark.parametrize("splits", [1, 3])
def test_f32_gather_index_math_is_im2col(geom, splits):
    """The f32 route's A tiles, written and read as the kernel does, are the
    plain im2col patches in (i, j, c) order, zeros past K and in the
    padding, for both tile heights and producer counts (two and four
    warps), split or not."""
    xs, ws, stride, pad, groups = geom
    x = np.random.RandomState(5).randn(*xs).astype(np.float32)
    kh, kw, cg, _ = ws
    cols = tconv.im2col(torch.as_tensor(x).permute(0, 3, 1, 2), kernel=(kh, kw),
                        stride=stride, pad=pad)          # (n, c kh kw, oh, ow)
    n, _, oh, ow = cols.shape
    patches = cols.reshape(n, groups, cg, kh, kw, oh, ow) \
        .permute(1, 0, 5, 6, 3, 4, 2).reshape(groups, n * oh * ow, kh * kw * cg)
    for block_m in sorted({bm for bm, _ in k2.F32_TILES}):
        for producers in (64, 128):
            a = _f32_gathered_a(x, ws, stride, pad, groups, block_m, splits,
                                producers)
            k_total = kh * kw * cg
            np.testing.assert_array_equal(a[:, :, :k_total], patches.numpy())
            assert not a[:, :, k_total:].any()


def test_plain_conv_and_im2col_match_jax(rng):
    x, w, b = _np(rng, 2, 6, 10, 10), _np(rng, 4, 3, 3, 3), _np(rng, 4)
    np.testing.assert_allclose(
        tconv.im2col(torch.as_tensor(x), kernel=(3, 3), stride=(2, 1),
                     pad=(1, 0)).numpy(),
        np.asarray(jax_im2col(jnp.asarray(x), kernel=(3, 3), stride=(2, 1),
                              pad=(1, 0))), atol=0)
    np.testing.assert_allclose(
        tconv.conv2d(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                     stride=(2, 2), pad=(1, 1), groups=2).numpy(),
        np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              stride=(2, 2), pad=(1, 1), groups=2)),
        atol=1e-4)


def test_l2_normalize_rows_zero_row(rng):
    x = _np(rng, 5, 7)
    x[2] = 0.0
    got = l2_normalize_rows(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax_l2n(jnp.asarray(x)))
    assert np.isfinite(got).all() and (got[2] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    x3 = _np(rng, 3, 2, 4)
    np.testing.assert_allclose(l2_normalize_rows(torch.as_tensor(x3)).numpy(),
                               np.asarray(jax_l2n(jnp.asarray(x3))), rtol=1e-6)


def test_relu(rng):
    x = _np(rng, 4, 5)
    np.testing.assert_array_equal(relu(torch.as_tensor(x)).numpy(),
                                  np.maximum(x, 0))
    np.testing.assert_allclose(relu(torch.as_tensor(x), 0.1).numpy(),
                               np.where(x > 0, x, 0.1 * x), rtol=1e-6)


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_relu_gradient_at_the_tie_matches_jax(slope):
    """Value and gradient at -1, 0 and 1: JAX's maximum splits the tie at 0
    evenly, so the gradient there is 0.5 (0.5 + 0.5 * slope with a leak)."""
    from videovector_tpu.ops.activations import relu as jax_relu
    x = np.array([-1.0, 0.0, 1.0], np.float32)
    ref_v = np.asarray(jax_relu(jnp.asarray(x), slope))
    ref_g = np.asarray(jax.grad(lambda v: jnp.sum(jax_relu(v, slope)))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = relu(xt, slope)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), ref_v)
    np.testing.assert_array_equal(xt.grad.numpy(), ref_g)
    assert xt.grad[1].item() == np.float32(0.5 + 0.5 * slope)


def _mm_calls(fn) -> int:
    """aten::mm calls made by fn() (the CPU profiler's count)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::mm")


def test_tower_bf16_matches_jax_bit_for_bit():
    """The tower Function (ops.linear.tower_matmul, then relu) in bf16
    against JAX's VideoEmbeddingModel.embed, on integer inputs whose f32
    sums are exact: the forward, the bf16-rounded dW and db equal JAX's bit
    for bit; an all-zero input row against a zero bias hits the ReLU tie,
    whose gradient 0.5 reaches db; dX is computed only when asked for."""
    from videovector_tpu.models.embedding import (
        VideoEmbeddingConfig as JCfg, VideoEmbeddingModel as JModel,
    )
    from videovector_tpu_torch.ops.linear import tower_matmul
    rs = np.random.RandomState(0)
    m, d, e = 64, 64, 48
    x = rs.randint(-4, 5, (m, d)).astype(np.float32)
    x[0] = 0.0
    w = rs.randint(-4, 5, (d, e)).astype(np.float32)
    b = rs.randint(-8, 9, e).astype(np.float32)
    b[:8] = 0.0
    g = rs.randint(-8, 9, (m, e)).astype(np.float32)
    jm = JModel(JCfg(feature_dim=d, embed_dim=e, dropout_rate=0.0,
                     compute_dtype="bfloat16"))
    jp = {"tower": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    ref, vjp = jax.vjp(lambda p: jm.embed(p, jnp.asarray(x)), jp)
    jg = vjp(jnp.asarray(g))[0]["tower"]
    wt, bt = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    xt = torch.tensor(x)
    h = tower_matmul(xt, wt, bt, compute_dtype=torch.bfloat16)
    y = relu(h)
    n_mm = _mm_calls(lambda: y.backward(torch.tensor(g)))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg["w"]))
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(jg["b"]))
    # the tie: row 0 is zero and so is b[:8], so h[0, :8] == 0
    assert (h.detach()[0, :8] == 0).all()
    hn = h.detach().numpy()
    dy = g * np.where(hn > 0, 1.0, np.where(hn == 0, 0.5, 0.0))
    np.testing.assert_array_equal(bt.grad.numpy(), dy.sum(0))
    # dW really is rounded to bf16: the exact f32 product differs
    assert (x.T @ dy != wt.grad.numpy()).any()
    assert n_mm == 1 and xt.grad is None     # dW only
    xg = torch.tensor(x, requires_grad=True)
    y2 = relu(tower_matmul(xg, wt, bt, compute_dtype=torch.bfloat16))
    assert _mm_calls(lambda: y2.backward(torch.tensor(g))) == 2
    np.testing.assert_array_equal(
        xg.grad.numpy(),
        (torch.tensor(dy, dtype=torch.float32) @ torch.tensor(w).T)
        .bfloat16().float().numpy())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(tmp_path)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build_library(tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))
