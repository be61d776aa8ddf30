"""MedNet / CaffeNet feature tower (conv1..fc7); counterpart of
videovector_tpu/models/mednet.py.

Layouts are the JAX model's, so weights carry across unchanged: NHWC
activations, HWIO conv weights, (in, out) fc weights, and fc6's rows in
H, W, C order (the flatten before fc6 is HWC, not CHW).

Every convolution runs on K2 (ops/hopper/conv_gemm.py) with the bias + ReLU
epilogue fused (in bf16, one launch per conv on its sm90 route); fc6 and
fc7 run on K1 (ops/hopper/matmul.py), and the max pools on ops/pooling.py's
NHWC kernel; each entry point runs its plain version on the CPU and
inside `device.plain_versions()`.

In bf16 mode each conv emits bf16 and the bias + ReLU, pooling and LRN run
in bf16; fc6 and fc7 sum in f32 and add their bias in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from videovector_tpu_torch.core import fillers
from videovector_tpu_torch.ops.hopper.conv_gemm import conv2d_gemm_nhwc
from videovector_tpu_torch.ops.hopper.matmul import matmul
from videovector_tpu_torch.ops.lrn import lrn_nhwc
from videovector_tpu_torch.ops.pooling import _pool_geometry, max_pool
from videovector_tpu_torch.utils.timer import count


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
    # the JAX model's option to run conv1 (11x11, stride 4, no padding) as a
    # stride-1 conv over space-to-depth blocks. Exact math, so here it is
    # accepted and changes nothing: K2 repacks conv1 that way on its own
    # (ops/hopper/conv_gemm.py::space_to_depth), whatever this says.
    conv1_space_to_depth: bool = False


def torch_dtype(name: str) -> torch.dtype:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {name!r}")
    return dtypes[name]


def cast_param(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`: t itself where it is in `dtype` already, else a copy,
    whose bytes the counter `vvtpu.cast_bytes` adds up."""
    out = t.to(dtype)
    if out is not t:
        count("vvtpu.cast_bytes", out.nbytes)
    return out


class MedNet:
    def __init__(self, cfg: MedNetConfig = MedNetConfig()):
        self.cfg = cfg

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
        x = images
        for spec in self.cfg.convs:
            p = params[spec.name]
            x = conv2d_gemm_nhwc(x.to(cdt), cast_param(p["w"], cdt), p["b"],
                     stride=(spec.stride, spec.stride),
                     pad=(spec.pad, spec.pad), groups=spec.group,
                     fuse_relu=True, out_dtype=cdt)
            if spec.pool:
                x = max_pool(x, kernel=(3, 3), stride=(2, 2), layout="NHWC")
            if spec.lrn:
                x = lrn_nhwc(x)
        x = x.reshape(x.shape[0], -1)        # H, W, C order: fc6's row order
        for name in ("fc6", "fc7"):
            p = params[name]
            x = matmul(x.to(cdt), cast_param(p["w"], cdt), p["b"],
                   fuse_relu=True, out_dtype=torch.float32)
            if upto == name:
                return x
        return x

    @staticmethod
    def params_from_graph_engine(net_params: dict, *,
                                 fc6_chw: tuple = (256, 6, 6),
                                 name_map: dict | None = None) -> dict:
        """The graph engine's CaffeNet params (NCHW/OIHW, fc weights (K, N))
        in this model's NHWC/HWIO layout. fc6's input is the CHW flatten in
        the engine and the HWC flatten here, so its weight rows are permuted
        to match. `name_map` maps graph layer names to this model's; a
        layer without a bias (bias_term: false) gets zeros, the same sum."""
        name_map = name_map or {}
        out = {}
        for name, lp in net_params.items():
            if "w" not in lp:
                continue
            tgt = name_map.get(name, name)
            w = lp["w"]

            def bias(width):
                b = lp.get("b")
                return b if b is not None else torch.zeros(
                    width, dtype=torch.float32, device=w.device)
            if w.dim() == 4:  # conv: OIHW -> HWIO
                out[tgt] = {"w": w.permute(2, 3, 1, 0).contiguous(),
                            "b": bias(w.shape[0])}
                continue
            if tgt == "fc6":
                c, h, wd = fc6_chw
                w = w.reshape(c, h, wd, -1).permute(1, 2, 0, 3) \
                    .reshape(c * h * wd, -1)
            out[tgt] = {"w": w.contiguous(), "b": bias(w.shape[1])}
        return out
