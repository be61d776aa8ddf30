"""MedNet / CaffeNet feature tower (conv1..fc7); counterpart of
videovector_tpu/models/mednet.py.

Layouts are the JAX model's, so weights carry across unchanged: NHWC
activations, HWIO conv weights, (in, out) fc weights, and fc6's rows in
H, W, C order (the flatten before fc6 is HWC, not CHW).

Every convolution runs on K2 (ops/hopper/conv_gemm.py) with the bias + ReLU
epilogue fused (in bf16, one launch per conv on its sm90 route); fc6 and
fc7 run on K1 (ops/hopper/matmul.py). `plain=True` routes the same calls to the kernels'
plain PyTorch versions, for comparing the two on one device.

In bf16 mode each conv emits bf16 and the bias + ReLU, pooling and LRN run
in bf16; fc6 and fc7 sum in f32 and add their bias in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from videovector_tpu_torch.core import fillers
from videovector_tpu_torch.ops.hopper.conv_gemm import (
    conv2d_gemm_nhwc, conv2d_gemm_nhwc_plain,
)
from videovector_tpu_torch.ops.hopper.matmul import matmul, matmul_plain
from videovector_tpu_torch.ops.lrn import channel_window_sum
from videovector_tpu_torch.ops.pooling import _pool_geometry, max_pool


@dataclass(frozen=True)
class ConvSpec:
    name: str
    num_output: int
    kernel: int
    stride: int = 1
    pad: int = 0
    group: int = 1
    lrn: bool = False          # LRN after pool (CaffeNet norm1/norm2)
    pool: bool = False         # 3x3/2 max pool


CAFFENET_CONVS = (
    ConvSpec("conv1", 96, 11, stride=4, pool=True, lrn=True),
    ConvSpec("conv2", 256, 5, pad=2, group=2, pool=True, lrn=True),
    ConvSpec("conv3", 384, 3, pad=1),
    ConvSpec("conv4", 384, 3, pad=1, group=2),
    ConvSpec("conv5", 256, 3, pad=1, group=2, pool=True),
)


@dataclass(frozen=True)
class MedNetConfig:
    convs: tuple = CAFFENET_CONVS
    fc6: int = 4096
    fc7: int = 4096
    input_hw: tuple = (227, 227)
    compute_dtype: str = "bfloat16"


def torch_dtype(name: str) -> torch.dtype:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {name!r}")
    return dtypes[name]


class MedNet:
    def __init__(self, cfg: MedNetConfig = MedNetConfig(), *,
                 plain: bool = False):
        self.cfg = cfg
        self.plain = plain

    def init(self, generator: torch.Generator, in_channels: int = 3):
        """Gaussian weights (conv std 0.01, fc std 0.005) and zero biases, on
        the generator's device."""
        dev = generator.device
        params = {}
        c_in = in_channels
        for spec in self.cfg.convs:
            w = fillers.gaussian_fill(
                generator, (spec.kernel, spec.kernel, c_in // spec.group,
                            spec.num_output), std=0.01)          # HWIO
            params[spec.name] = {"w": w, "b": torch.zeros(spec.num_output,
                                                          device=dev)}
            c_in = spec.num_output
        size = self._spatial_out()
        flat = size * size * c_in
        for name, n_in, n_out in (("fc6", flat, self.cfg.fc6),
                                  ("fc7", self.cfg.fc6, self.cfg.fc7)):
            w = fillers.gaussian_fill(generator, (n_out, n_in), std=0.005)
            params[name] = {"w": w.T.contiguous(),
                            "b": torch.zeros(n_out, device=dev)}
        return params

    def _spatial_out(self) -> int:
        size = self.cfg.input_hw[0]
        for spec in self.cfg.convs:
            size = (size + 2 * spec.pad - spec.kernel) // spec.stride + 1
            if spec.pool:
                size, _, _, _ = _pool_geometry(size, size, (3, 3), (2, 2),
                                               (0, 0))
        return size

    def forward(self, params, images, *, upto: str = "fc7"):
        """images: (N, H, W, C) f32 (preprocessed) -> features (N, fc6|fc7)
        in f32. `upto`: fc6 | fc7 (fc7 output == Caffe's ip2 after ReLU)."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        conv = conv2d_gemm_nhwc_plain if self.plain else conv2d_gemm_nhwc
        mm = matmul_plain if self.plain else matmul
        x = images
        for spec in self.cfg.convs:
            p = params[spec.name]
            x = conv(x.to(cdt), p["w"].to(cdt), p["b"],
                     stride=(spec.stride, spec.stride),
                     pad=(spec.pad, spec.pad), groups=spec.group,
                     fuse_relu=True, out_dtype=cdt)
            if spec.pool:
                x = max_pool(x, kernel=(3, 3), stride=(2, 2), layout="NHWC")
            if spec.lrn:
                summed = channel_window_sum(x * x, 3, 5)
                x = x * torch.pow(1.0 + (1e-4 / 5) * summed, -0.75)
        x = x.reshape(x.shape[0], -1)        # H, W, C order: fc6's row order
        for name in ("fc6", "fc7"):
            p = params[name]
            x = mm(x.to(cdt), p["w"].to(cdt), p["b"], fuse_relu=True,
                   out_dtype=torch.float32)
            if upto == name:
                return x
        return x
