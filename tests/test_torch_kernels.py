"""The port's kernel modules (K1 ops/hopper/matmul.py, K2
ops/hopper/conv_gemm.py) and the plain ops around them, against the JAX
package on the CPU. On CPU tensors each wrapper runs its plain version; the
same numpy-seeded inputs go through the Pallas kernels in interpret mode.
All f32; tolerance atol 1e-3 as in tests/test_pallas.py unless stated."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


def test_k1_bf16_out_rounds_once_after_bias(rng):
    """bf16 output: round the sum, add the rounded bias, ReLU (the bf16 conv
    epilogue of MedNet): each of the three roundings is within half a bf16
    step (unit roundoff 2**-8, relative) of the value it rounds."""
    x, w, b = _np(rng, 20, 40), _np(rng, 40, 30), _np(rng, 30)
    got = k1.matmul(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                    fuse_relu=True, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    acc = x.astype(np.float64) @ w
    err = np.abs(got.float().numpy() - np.maximum(acc + b, 0))
    bound = 2.0 ** -8 * (2 * np.abs(acc) + 2 * np.abs(b)) + 1e-5
    assert (err <= bound).all(), (err - bound).max()


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
