"""I3D, the Inflated 3D ConvNet (Carreira & Zisserman, "Quo Vadis, Action
Recognition? A New Model and the Kinetics Dataset", arXiv:1705.07750), as a
clip encoder: DeepMind's kinetics-i3d `InceptionI3d` (i3d.py), the RGB
stream, from its input to the features its `Logits` conv reads, 1,024 a
clip. The serving path's first clip backbone beside GoogLeNet
(models/googlenet.py), which it inflates into time.

  Conv3d_1a_7x7 (7x7x7/2) -> MaxPool3d_2a_3x3 (1x3x3 /1,2,2)
    -> Conv3d_2b_1x1 -> Conv3d_2c_3x3 (3x3x3)
    -> MaxPool3d_3a_3x3 (1x3x3 /1,2,2)
    -> Mixed_3b, 3c -> MaxPool3d_4a_3x3 (3x3x3 /2) -> Mixed_4b .. 4f
    -> MaxPool3d_5a_2x2 (2x2x2 /2) -> Mixed_5b, 5c
    -> AvgPool3d 2x7x7, stride 1, VALID -> mean over time

Every conv and pool pads by TF's SAME rule (`ops/conv.py::same_pads`:
the output ceil(n / s) an axis, the odd pad after), each conv has no bias
and is followed by BatchNorm (eps 1e-3, no scale: Sonnet's default) and
ReLU. A module is GoogLeNet's with its kernels inflated: four branches
concatenated along channels, 1x1x1; 1x1x1 -> 3x3x3; 1x1x1 -> 3x3x3 (where
BVLC's has a 5x5, as TF-slim's Inception-v1 has); a 3x3x3 stride-1 max
pool -> 1x1x1. Its widths are BVLC's (`BVLC_INCEPTIONS`): I3D's `Mixed_3b`
is BVLC's 3a, and so on, a letter on. The head averages 2x7x7 windows at
stride 1 over the last map (7 x 7 at 224: the whole map; the head here
takes the whole map at any size; `head_windows`: the tensor the published
Logits conv reads), then the mean over the windows in time (`forward`,
1,024 a clip: the logits conv is linear, so its mean over time, i3d.py's
last step, reads the same).

Layouts: NDHWC activations, DHWIO conv weights. `draw` draws each conv's
weight and BatchNorm's moving mean and variance and offset (beta),
{"w", "moving_mean", "moving_variance", "beta"} under I3D's names
("Conv3d_1a_7x7", "Mixed_3b/Branch_1/Conv3d_0b_3x3", ...);
`fold_batch_norm` folds them, once, into the {"w", "b"} that `forward`
reads (`init` gives both steps' result), so that every conv keeps K2's
bias + ReLU epilogue:
w' = w / sqrt(var + eps) and b' = beta - mean / sqrt(var + eps), per
output channel. Every conv runs on K2 (`conv3d_gemm_ndhwc`): the 1x1x1s
fold the frames into the batch and take the 2D route, the 3x3x3s K2's
depth route, conv1 after the 3D space-to-depth repack; the 1x3x3 pools run
on ops/pooling.py's NHWC kernel over the frames, the others on its NDHWC
kernel. The module loop is GoogLeNet's (`InceptionNet`: the spans
`vvtpu.inception` and the counter `vvtpu.concat_bytes`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from videovector_tpu_torch.models.googlenet import (
    BVLC_INCEPTIONS, InceptionNet, InceptionSpec,
)
from videovector_tpu_torch.models.mednet import cast_param, torch_dtype
from videovector_tpu_torch.ops.conv import same_pads
from videovector_tpu_torch.ops.hopper.conv_gemm import conv3d_gemm_ndhwc
from videovector_tpu_torch.ops.pooling import max_pool

# (name, window, stride) of the max pools that end the module stages
STAGE_POOLS = (("MaxPool3d_4a_3x3", (3, 3, 3), (2, 2, 2)),
               ("MaxPool3d_5a_2x2", (2, 2, 2), (2, 2, 2)))
STEM_POOL = ((1, 3, 3), (1, 2, 2))      # MaxPool3d_2a_3x3 and 3a_3x3
MODULE_POOL = ((3, 3, 3), (1, 1, 1))    # each module's Branch_3 pool
HEAD_FRAMES = 2                         # the AvgPool3d's window in time


def module_name(m: InceptionSpec) -> str:
    """I3D's name of a module of BVLC's table: "3a" -> "Mixed_3b"."""
    return f"Mixed_{m.name[0]}{chr(ord(m.name[1]) + 1)}"


def module_convs(m: InceptionSpec, c_in: int):
    """(name, kernel, c_in, c_out) of a module's six convs, in
    InceptionSpec.convs's order."""
    p = module_name(m) + "/"
    return ((p + "Branch_0/Conv3d_0a_1x1", 1, c_in, m.n1x1),
            (p + "Branch_1/Conv3d_0a_1x1", 1, c_in, m.n3x3_reduce),
            (p + "Branch_1/Conv3d_0b_3x3", 3, m.n3x3_reduce, m.n3x3),
            (p + "Branch_2/Conv3d_0a_1x1", 1, c_in, m.n5x5_reduce),
            (p + "Branch_2/Conv3d_0b_3x3", 3, m.n5x5_reduce, m.n5x5),
            (p + "Branch_3/Conv3d_0b_1x1", 1, c_in, m.pool_proj))


@dataclass(frozen=True)
class I3DConfig:
    conv1: int = 64
    conv2b: int = 64
    conv2c: int = 192
    inceptions: tuple = BVLC_INCEPTIONS
    compute_dtype: str = "bfloat16"
    bn_eps: float = 1e-3

    @property
    def feature_dim(self) -> int:
        return self.inceptions[-1].out

    def convs(self):
        """(name, kernel, stride, c_in, c_out) of all the convs, in the order
        the forward runs them, from 3 input channels; cubic kernels and
        strides, given by their side."""
        out = [("Conv3d_1a_7x7", 7, 2, 3, self.conv1),
               ("Conv3d_2b_1x1", 1, 1, self.conv1, self.conv2b),
               ("Conv3d_2c_3x3", 3, 1, self.conv2b, self.conv2c)]
        c = self.conv2c
        for m in self.inceptions:
            out += [(name, k, 1, ci, co)
                    for name, k, ci, co in module_convs(m, c)]
            c = m.out
        return out


class I3D(InceptionNet):
    # RGB in [-1, 1]; a call's frames are whole clips
    pixel_mean = 127.5
    pixel_scale = 1 / 127.5
    clip_input = True

    def __init__(self, cfg: I3DConfig = I3DConfig()):
        self.cfg = cfg

    def init(self, generator: torch.Generator):
        """The params `forward` reads: `draw`'s, BatchNorm folded."""
        return self.fold_batch_norm(self.draw(generator))

    def draw(self, generator: torch.Generator):
        """Gaussian conv weights at std sqrt(2 / fan_in) (a ReLU net's), and
        BatchNorm's statistics as a trained net holds them: moving means
        N(0, 0.1), moving variances log-uniform in [0.5, 2], offsets 0.1
        plus N(0, 0.05); on the generator's device."""
        dev = generator.device
        params = {}
        for name, k, _, c_in, c_out in self.cfg.convs():
            fan_in = k * k * k * c_in
            w = torch.randn((k, k, k, c_in, c_out), generator=generator,
                            device=dev) * (2.0 / fan_in) ** 0.5
            params[name] = {
                "w": w,
                "moving_mean": 0.1 * torch.randn(c_out, generator=generator,
                                                 device=dev),
                "moving_variance": torch.exp((torch.rand(
                    c_out, generator=generator, device=dev) * 2 - 1)
                    * 0.6931471805599453),
                "beta": 0.1 + 0.05 * torch.randn(c_out, generator=generator,
                                                 device=dev)}
        return params

    def fold_batch_norm(self, params):
        """{name: {"w", "moving_mean", "moving_variance", "beta"}} -> {name:
        {"w": w / sqrt(var + eps), "b": beta - mean / sqrt(var + eps)}},
        in f32, per output channel (DHWIO's last axis)."""
        out = {}
        for name, p in params.items():
            inv = torch.rsqrt(p["moving_variance"].float() + self.cfg.bn_eps)
            out[name] = {"w": p["w"].float() * inv,
                         "b": (p["beta"].float()
                               - p["moving_mean"].float() * inv)}
        return out

    def forward(self, params, clips):
        """clips: (N, T, H, W, C) f32 (preprocessed) -> features (N,
        feature_dim) in f32, the mean over time of `head_windows`;
        `params` the folded ones."""
        return self.served_features(params, clips)[1]

    def served_features(self, params, clips):
        """(`head_windows`, their mean over time): the pipeline keeps the
        windows and its tower reads the mean."""
        windows = self.head_windows(params, clips)
        return windows, windows.mean(dim=1)

    def head_windows(self, params, clips):
        """clips: (N, T, H, W, C) f32 (preprocessed) -> the head's
        AvgPool3d output (N, T' - 1, feature_dim) in f32, one row a 2-frame
        window of the last map: what i3d.py's Logits conv reads, before
        its mean over time."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        x = self._conv(params, "Conv3d_1a_7x7", clips.to(cdt), 2)
        x = self._pool(x, *STEM_POOL)                       # MaxPool3d_2a
        x = self._conv(params, "Conv3d_2b_1x1", x)
        x = self._conv(params, "Conv3d_2c_3x3", x)
        x = self._pool(x, *STEM_POOL)                       # MaxPool3d_3a
        x = self._modules(params, x)
        if x.shape[1] < HEAD_FRAMES:
            raise ValueError(f"a clip of {clips.shape[1]} frames leaves "
                             f"{x.shape[1]} in the last map, fewer than the "
                             f"head's window of {HEAD_FRAMES}")
        # AvgPool3d 2x7x7 VALID at stride 1 over the whole 7 x 7 map, in f32
        y = x.float().mean(dim=(2, 3))                      # (N, T', C)
        return (y[:, :-1] + y[:, 1:]) / HEAD_FRAMES

    def _conv(self, params, name, x, stride: int = 1):
        """The conv `name` with its folded BatchNorm and ReLU, SAME padding,
        in the compute dtype."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        p = params[name]
        k = p["w"].shape[0]
        pad = tuple(same_pads(n, k, stride) for n in x.shape[1:4])
        return conv3d_gemm_ndhwc(x, cast_param(p["w"], cdt), p["b"],
                                 stride=(stride,) * 3, pad=pad,
                                 fuse_relu=True, out_dtype=cdt)

    def _pool(self, x, window, stride):
        """A max pool of NDHWC x with SAME padding (the pads read as -inf:
        each window clipped to the clip)."""
        pad = tuple(same_pads(n, k, s)
                    for n, k, s in zip(x.shape[1:4], window, stride))
        return max_pool(x, kernel=window, stride=stride, pad=pad,
                        layout="NDHWC")

    def _stage_pool(self, x, stage: int):
        """MaxPool3d_4a_3x3 after Mixed_3c, MaxPool3d_5a_2x2 after Mixed_4f."""
        _, window, stride = STAGE_POOLS[stage]
        return self._pool(x, window, stride)

    def _branches(self, params, m: InceptionSpec, x):
        """A module's four branches, in i3d.py's order."""
        names = [name for name, *_ in module_convs(m, x.shape[-1])]
        conv = functools.partial(self._conv, params)
        return (conv(names[0], x),
                conv(names[2], conv(names[1], x)),
                conv(names[4], conv(names[3], x)),
                conv(names[5], self._pool(x, *MODULE_POOL)))
