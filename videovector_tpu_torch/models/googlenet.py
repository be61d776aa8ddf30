"""GoogLeNet (Inception v1) as a frame encoder: BVLC Caffe's
models/bvlc_googlenet deploy net from `data` to `pool5/7x7_s1`, the 1,024
features a frame (Szegedy et al., "Going Deeper with Convolutions",
arXiv:1409.4842). The second backbone of the serving path beside
models/mednet.py's CaffeNet, with its interface and conventions.

  conv1/7x7_s2 (7x7/2, pad 3) -> pool1 3x3/2 -> LRN
    -> conv2/3x3_reduce (1x1) -> conv2/3x3 (3x3, pad 1) -> LRN -> pool2 3x3/2
    -> inception 3a, 3b -> pool3 3x3/2 -> 4a .. 4e -> pool4 3x3/2 -> 5a, 5b
    -> pool5 7x7/1 average (global: the map is 7 x 7 at 224)

An inception module runs four branches on its input and concatenates them
along channels in BVLC's order: 1x1; 1x1 reduce -> 3x3 (pad 1); 1x1 reduce
-> 5x5 (pad 2); 3x3/1 max pool (pad 1) -> 1x1 projection. Every conv is
followed by its ReLU. Pools use Caffe's ceil geometry
(ops/pooling.py); LRN is CaffeNet's (size 5, alpha 1e-4, beta 0.75, across
channels). The classifier after pool5 (dropout, `loss3/classifier`) is not
part of the features, as fc8 is not part of CaffeNet's.

Layouts are MedNet's: NHWC activations, HWIO conv weights. Params are a
flat dict keyed by BVLC's layer names ("conv1/7x7_s2",
"inception_3a/3x3_reduce", ...), each {"w": HWIO, "b": (O,)}. Every conv
runs on K2 (ops/hopper/conv_gemm.py) with the bias + ReLU epilogue fused,
bf16 out in bf16 mode; conv1's 3 channels are repacked by K2's
space-to-depth, padding included, so all 57 convs take the sm90 route on
the card, and all 13 max pools run on ops/pooling.py's NHWC kernel.
Each entry point runs its plain version on the CPU and inside
`device.plain_versions()`. The branches meet in `torch.cat`: the counter
`vvtpu.concat_bytes` adds the bytes each concatenation writes, and each
module runs inside the span `vvtpu.inception`, its request id the
module's index. The module loop (`InceptionNet`) and the widths
(`BVLC_INCEPTIONS`) are shared with I3D (models/i3d.py), GoogLeNet
inflated into time.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from videovector_tpu_torch.core import fillers
from videovector_tpu_torch.models.mednet import (
    Backbone, cast_param, torch_dtype,
)
from videovector_tpu_torch.ops.hopper.conv_gemm import conv2d_gemm_nhwc
from videovector_tpu_torch.ops.lrn import lrn_nhwc
from videovector_tpu_torch.ops.pooling import max_pool
from videovector_tpu_torch.utils.timer import count, span

@dataclass(frozen=True)
class InceptionSpec:
    """One module's widths, as BVLC's table lists them, and whether the
    3x3/2 max pool that ends its stage follows it."""
    name: str               # "3a"
    n1x1: int
    n3x3_reduce: int
    n3x3: int
    n5x5_reduce: int
    n5x5: int
    pool_proj: int
    pool: bool = False

    @property
    def out(self) -> int:
        return self.n1x1 + self.n3x3 + self.n5x5 + self.pool_proj

    def convs(self, c_in: int):
        """(layer name, kernel, c_in, c_out) of the module's six convs."""
        p = f"inception_{self.name}/"
        return ((p + "1x1", 1, c_in, self.n1x1),
                (p + "3x3_reduce", 1, c_in, self.n3x3_reduce),
                (p + "3x3", 3, self.n3x3_reduce, self.n3x3),
                (p + "5x5_reduce", 1, c_in, self.n5x5_reduce),
                (p + "5x5", 5, self.n5x5_reduce, self.n5x5),
                (p + "pool_proj", 1, c_in, self.pool_proj))


BVLC_INCEPTIONS = (
    InceptionSpec("3a", 64, 96, 128, 16, 32, 32),
    InceptionSpec("3b", 128, 128, 192, 32, 96, 64, pool=True),
    InceptionSpec("4a", 192, 96, 208, 16, 48, 64),
    InceptionSpec("4b", 160, 112, 224, 24, 64, 64),
    InceptionSpec("4c", 128, 128, 256, 24, 64, 64),
    InceptionSpec("4d", 112, 144, 288, 32, 64, 64),
    InceptionSpec("4e", 256, 160, 320, 32, 128, 128, pool=True),
    InceptionSpec("5a", 256, 160, 320, 32, 128, 128),
    InceptionSpec("5b", 384, 192, 384, 48, 128, 128),
)


@dataclass(frozen=True)
class GoogLeNetConfig:
    conv1: int = 64
    conv2_reduce: int = 64
    conv2: int = 192
    inceptions: tuple = BVLC_INCEPTIONS
    compute_dtype: str = "bfloat16"

    @property
    def feature_dim(self) -> int:
        return self.inceptions[-1].out

    def convs(self):
        """(layer name, kernel, stride, pad, c_in, c_out) of all the convs,
        in the order the forward runs them, from 3 input channels."""
        out = [("conv1/7x7_s2", 7, 2, 3, 3, self.conv1),
               ("conv2/3x3_reduce", 1, 1, 0, self.conv1, self.conv2_reduce),
               ("conv2/3x3", 3, 1, 1, self.conv2_reduce, self.conv2)]
        c = self.conv2
        for m in self.inceptions:
            out += [(name, k, 1, k // 2, ci, co)
                    for name, k, ci, co in m.convs(c)]
            c = m.out
        return out


# the name GoogLeNet's forward looks up for its two LRNs (a fault check
# patches it)
lrn = lrn_nhwc


class InceptionNet(Backbone):
    """The module loop that GoogLeNet and I3D (models/i3d.py) share: each
    module of `cfg.inceptions` runs inside the span `vvtpu.inception` (its
    request id the module's index) as its four branches concatenated along
    channels, the last axis, whose bytes the counter `vvtpu.concat_bytes`
    adds; the pool that ends a stage follows a module with `pool` set. A
    net gives the branches (`_branches`) and the stage's pool
    (`_stage_pool`, by the stage's index from 0)."""

    def _branches(self, params, m: InceptionSpec, x):
        raise NotImplementedError

    def _stage_pool(self, x, stage: int):
        raise NotImplementedError

    def _modules(self, params, x):
        stage = 0
        for i, m in enumerate(self.cfg.inceptions):
            with span("vvtpu.inception", req=i):
                x = self._inception(params, m, x)
            if m.pool:
                x = self._stage_pool(x, stage)
                stage += 1
        return x

    def _inception(self, params, m: InceptionSpec, x):
        """One module: its branches concatenated along channels."""
        out = torch.cat(self._branches(params, m, x), dim=-1)
        count("vvtpu.concat_bytes", out.nbytes)
        return out


class GoogLeNet(InceptionNet):
    def __init__(self, cfg: GoogLeNetConfig = GoogLeNetConfig()):
        self.cfg = cfg

    def init(self, generator: torch.Generator):
        """BVLC's fillers: xavier weights (uniform within sqrt(3 / fan_in))
        and biases 0.2, on the generator's device."""
        params = {}
        for name, k, _, _, c_in, c_out in self.cfg.convs():
            w = fillers.xavier_fill(generator, (c_out, c_in, k, k))   # OIHW
            params[name] = {"w": w.permute(2, 3, 1, 0).contiguous(),
                            "b": torch.full((c_out,), 0.2,
                                            device=generator.device)}
        return params

    def forward(self, params, images):
        """images: (N, H, W, C) f32 (preprocessed) -> pool5 features (N,
        feature_dim) in f32."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        x = self._conv(params, "conv1/7x7_s2", images.to(cdt), 2, 3)
        x = self._conv(params, "conv2/3x3_reduce", lrn(self._pool(x, 2)))
        x = self._pool(lrn(self._conv(params, "conv2/3x3", x, pad=1)), 2)
        x = self._modules(params, x)
        # pool5: BVLC's 7x7/1 average, over the whole 7 x 7 map at 224
        return x.float().mean(dim=(1, 2))

    def _conv(self, params, name, x, stride=1, pad=0):
        """The conv `name` with its bias and ReLU, in the compute dtype."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        p = params[name]
        return conv2d_gemm_nhwc(x, cast_param(p["w"], cdt), p["b"],
                    stride=(stride, stride), pad=(pad, pad), fuse_relu=True,
                    out_dtype=cdt)

    def _pool(self, x, stride: int, pad: int = 0):
        """A 3x3 max pool of NHWC x with Caffe's geometry: ops/pooling.py's
        kernel on the card."""
        return max_pool(x, kernel=(3, 3), stride=(stride, stride),
                        pad=(pad, pad), layout="NHWC")

    def _branches(self, params, m: InceptionSpec, x):
        """A module's four branches, in BVLC's order."""
        p = f"inception_{m.name}/"
        conv = functools.partial(self._conv, params)
        return (conv(p + "1x1", x),
                conv(p + "3x3", conv(p + "3x3_reduce", x), pad=1),
                conv(p + "5x5", conv(p + "5x5_reduce", x), pad=2),
                conv(p + "pool_proj", self._pool(x, 1, 1)))

    def _stage_pool(self, x, stage: int):
        """BVLC's 3x3/2 max pool after modules 3b and 4e."""
        return self._pool(x, 2)

    @staticmethod
    def params_from_graph_engine(net_params: dict) -> dict:
        """The graph engine's params of a GoogLeNet prototxt with BVLC's
        layer names (OIHW conv weights) in this model's HWIO layout, under
        the same names. Layers without a 4-D weight (a classifier) are
        left out; a conv without a bias (bias_term: false) gets zeros, the
        same sum."""
        out = {}
        for name, lp in net_params.items():
            w = lp.get("w")
            if w is None or w.dim() != 4:
                continue
            b = lp.get("b")
            out[name] = {
                "w": w.permute(2, 3, 1, 0).contiguous(),
                "b": b if b is not None else torch.zeros(
                    w.shape[0], dtype=torch.float32, device=w.device)}
        return out
