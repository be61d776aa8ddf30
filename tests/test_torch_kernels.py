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

import jax
import jax.numpy as jnp
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
    ("f32", "core"),
    ("transposed_w", "core"),
    ("odd_row_stride", "core"),
    ("misaligned_offset", "core"),
    ("broadcast_rows", "core"),
    ("empty_k", "core"),
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
    assert k1.k1_route(x, w, out) == route


def _split_k_ranges(k, splits):
    """The [k0, k1) range of each split as csrc/matmul_sm90.cu computes it:
    split s takes BK tiles [s * T // splits, (s + 1) * T // splits) of the
    T = ceil(k / BK) tiles."""
    k_tiles = -(-k // k1.SM90_BK)
    return [(s * k_tiles // splits * k1.SM90_BK,
             min(k, (s + 1) * k_tiles // splits * k1.SM90_BK))
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


def test_k1_validates_before_dispatch():
    x = torch.ones(4, 8)
    with pytest.raises(TypeError):
        k1.matmul(x, torch.ones(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        k1.matmul(x, torch.ones(7, 4))
    with pytest.raises(TypeError):
        k1.matmul(x.double(), torch.ones(8, 4, dtype=torch.float64))
    # a non-CPU, non-CUDA tensor neither launches nor falls back
    with pytest.raises(ValueError, match="CUDA"):
        k1.matmul(x.to("meta"), torch.ones(8, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        k2.conv2d_im2col_gemm(torch.ones(1, 1, 3, 3, device="meta"),
                              torch.ones(1, 1, 1, 1, device="meta"))


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
    ("f32_out_f32_in", "core"),
    ("odd_channel_stride", "core"),
    ("misaligned_data", "core"),
    ("cg_12_stride_1", "core"),
    ("conv1_padded", "core"),
    ("conv1_ragged_step", "core"),
    ("og_not_multiple_of_8", "core"),
    ("w_not_contiguous", "core"),
    ("conv1_w_not_contiguous", "core"),
    ("conv1_misaligned_data", "core"),
])
def test_k2_route(case, route):
    name = case if case in CAFFENET_K2 else "conv3"
    xs, ws, s, p = CAFFENET_K2[name]
    x, w, out = _bf16(*xs), _bf16(*ws), torch.bfloat16
    if case == "conv3_f32_out":
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
