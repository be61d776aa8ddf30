"""Plain reference of the `googlenet-retrieval` configuration: uint8 frames
-> crop and mirror -> GoogLeNet (Inception v1) to pool5 -> the 1024 ->
1024 tower -> L2 normalization -> f32 scores against the gallery -> the
stable top-k.

BVLC's GoogLeNet (models/bvlc_googlenet/deploy.prototxt; Szegedy et al.,
arXiv:1409.4842), from the configuration's table of widths: conv1/7x7_s2
(7x7, stride 2, pad 3), pool1 3x3/2, LRN, conv2/3x3_reduce (1x1),
conv2/3x3 (3x3, pad 1), LRN, pool2 3x3/2, then the inception modules (the
stages' ends followed by a 3x3/2 max pool) and pool5, a 7x7/1 average.
A module concatenates, along channels in this order: 1x1; 1x1 reduce ->
3x3 (pad 1); 1x1 reduce -> 5x5 (pad 2); a 3x3/1 max pool (pad 1) -> 1x1
projection. Every conv is followed by ReLU; max pools round up (Caffe's
ceil geometry, which F.max_pool2d's ceil_mode gives for these shapes);
LRN is CaffeNet's (size 5, alpha 1e-4, beta 0.75, across channels).

Departures from the deploy.prototxt:
- the net stops at `pool5/7x7_s1`: `pool5/drop_7x7_s1` (dropout, identity
  at TEST), `loss3/classifier` and `prob` are not part of the features;
- the auxiliary classifiers (`loss1/*`, `loss2/*`) are TRAIN-only in
  BVLC's train_val.prototxt and absent from the deploy net, so from here;
- the input is a crop of the frame with no mean subtracted and scale 1
  (the configuration's transform), not BVLC's mean values 104, 117, 123;
- weights are the benchmark's seeded ones, not the trained caffemodel.

Every product is f32 with TF32 off; `quant=fp8` rounds every operand of
every conv and of the tower to float8 first (the control: the precision
below the configuration's bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vvbench.reference import fp8, l2_normalize, matmul_precision
from vvbench.reference.caffenet import _lrn, _same, scores, top_k, transform

__all__ = ["features", "embed", "scores", "top_k", "transform"]


def features(params: dict, x: torch.Tensor, table: dict, q=_same):
    """(N, C, H, W) f32 -> pool5 features (N, D) f32 (flattened in (H, W,
    C) order: D = C at 224); `params` maps BVLC's layer names to {"w":
    HWIO, "b"}; `q` rounds each operand."""
    def conv(x, name, stride=1, pad=0):
        p = params[name]
        w = p["w"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        return F.relu(F.conv2d(q(x), q(w), p["b"], stride=stride,
                               padding=pad))

    def pool(x, stride, pad=0):
        return F.max_pool2d(x, 3, stride, padding=pad, ceil_mode=True)

    x = pool(conv(x, "conv1/7x7_s2", 2, 3), 2)
    x = conv(conv(_lrn(x), "conv2/3x3_reduce"), "conv2/3x3", pad=1)
    x = pool(_lrn(x), 2)
    for m in table["inceptions"]:
        p = f"inception_{m['name']}/"
        x = torch.cat([conv(x, p + "1x1"),
                       conv(conv(x, p + "3x3_reduce"), p + "3x3", pad=1),
                       conv(conv(x, p + "5x5_reduce"), p + "5x5", pad=2),
                       conv(pool(x, 1, 1), p + "pool_proj")], dim=1)
        if m.get("pool", False):
            x = pool(x, 2)
    x = F.avg_pool2d(x, table["pool5_kernel"], 1)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def embed(params: dict, frames_u8, h_off, w_off, mirror, cfg: dict,
          quant: str | None = None, feats_out: list | None = None):
    """Unit embeddings (N, E) of uint8 frames, f32 throughout with TF32 off
    (quant="fp8": the control). `feats_out`, a list, gets the pool5
    features appended."""
    q = fp8 if quant == "fp8" else _same
    with matmul_precision(False):
        x = transform(frames_u8, h_off, w_off, mirror, cfg["crop"])
        f = features(params["googlenet"], x, cfg, q)
        if feats_out is not None:
            feats_out.append(f)
        t = params["tower"]
        return l2_normalize(F.relu(q(f) @ q(t["w"]) + t["b"]))
