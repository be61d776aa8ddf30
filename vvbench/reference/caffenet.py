"""Plain reference of the `caffenet-retrieval` configuration: uint8 frames
-> crop and mirror -> CaffeNet conv1..fc7 -> the 4096 -> 4096 tower -> L2
normalization -> f32 scores against the gallery -> the stable top-k.

BVLC's CaffeNet (models/bvlc_reference_caffenet): each conv is followed by
ReLU; conv1 and conv2 by a 3x3/2 max pool (Caffe's ceil rounding) and
cross-channel LRN (size 5, alpha 1e-4, beta 0.75); conv5 by the pool. The
pool5 map is flattened in (H, W, C) order, the order of the weights the
benchmark hands to both sides. Every product is f32 with TF32 off;
`quant=fp8` rounds every operand of every conv and fc to float8 first (the
control: the precision below the configuration's bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vvbench.reference import fp8, l2_normalize, matmul_precision

LRN_SIZE, LRN_ALPHA, LRN_BETA = 5, 1e-4, 0.75


def transform(frames_u8, h_off, w_off, mirror, crop: int) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, C, crop, crop) f32: each frame cropped at
    its own offsets and flipped left to right where `mirror` says so. The
    configuration has no mean and a scale of 1."""
    out = []
    for i in range(frames_u8.shape[0]):
        h, w = int(h_off[i]), int(w_off[i])
        x = frames_u8[i, h:h + crop, w:w + crop].to(torch.float32)
        if bool(mirror[i]):
            x = torch.flip(x, dims=[1])
        out.append(x.permute(2, 0, 1))
    return torch.stack(out)


def _lrn(x: torch.Tensor) -> torch.Tensor:
    half = LRN_SIZE // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, LRN_SIZE - 1 - half))
    window = sum(sq[:, o:o + x.shape[1]] for o in range(LRN_SIZE))
    return x * torch.pow(1.0 + (LRN_ALPHA / LRN_SIZE) * window, -LRN_BETA)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def features(params: dict, x: torch.Tensor, convs: list, q=_same):
    """(N, C, H, W) f32 -> fc7 (N, 4096) f32; `q` rounds each operand."""
    for spec in convs:
        p = params[spec["name"]]
        w = p["w"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        x = F.relu(F.conv2d(q(x), q(w), p["b"], stride=spec["stride"],
                            padding=spec["pad"], groups=spec["group"]))
        if spec["pool"]:
            x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        if spec["lrn"]:
            x = _lrn(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for name in ("fc6", "fc7"):
        p = params[name]
        x = F.relu(q(x) @ q(p["w"]) + p["b"])
    return x


def embed(params: dict, frames_u8, h_off, w_off, mirror, cfg: dict,
          quant: str | None = None) -> torch.Tensor:
    """Unit embeddings (N, E) of uint8 frames, f32 throughout with TF32 off
    (quant="fp8": the control)."""
    q = fp8 if quant == "fp8" else _same
    with matmul_precision(False):
        x = transform(frames_u8, h_off, w_off, mirror, cfg["crop"])
        fc7 = features(params["mednet"], x, cfg["convs"], q)
        t = params["tower"]
        return l2_normalize(F.relu(q(fc7) @ q(t["w"]) + t["b"]))


def scores(emb: torch.Tensor, gallery: torch.Tensor,
           rows: int = 250_000) -> torch.Tensor:
    """f32 scores (N, G) against the gallery, TF32 off, in blocks of rows."""
    with matmul_precision(False):
        return torch.cat([emb @ gallery[s:s + rows].T
                          for s in range(0, gallery.shape[0], rows)], dim=1)


def top_k(s: torch.Tensor, k: int):
    """(values, indices) of the k largest per row; equal scores rank the
    lower index first."""
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]
