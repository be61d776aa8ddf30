"""Plain reference of the `i3d-retrieval` configuration: uint8 frames of
whole clips -> one crop and mirror a clip -> [-1, 1] -> I3D (the RGB
stream of InceptionI3d) to the features its Logits conv reads -> the 1024
-> 1024 tower -> L2 normalization -> f32 scores against the gallery -> the
stable top-k.

DeepMind's kinetics-i3d i3d.py (Carreira & Zisserman, arXiv:1705.07750),
from the configuration's table: Unit3D is a conv with no bias, padded by
TF's SAME rule, then BatchNorm (no scale, eps from the table, the moving
statistics: the network at test), then ReLU; the stem is Conv3d_1a_7x7
(stride 2), MaxPool3d_2a_3x3 (1x3x3 at 1,2,2), Conv3d_2b_1x1,
Conv3d_2c_3x3, MaxPool3d_3a_3x3; each Mixed module concatenates, along
channels in this order, Branch_0's 1x1x1, Branch_1's 1x1x1 -> 3x3x3,
Branch_2's 1x1x1 -> 3x3x3 and Branch_3's 3x3x3 stride-1 max pool ->
1x1x1; MaxPool3d_4a_3x3 (3x3x3 /2) follows Mixed_3c and MaxPool3d_5a_2x2
(2x2x2 /2) Mixed_4f. Max pools pad with -inf (TF's SAME max pool ignores
its padding). Then AvgPool3d (`head_pool`, stride 1, VALID) and the mean
over time.

Departures from i3d.py:
- the net stops before `Logits`: its dropout (identity at test), its 1x1x1
  conv to the classes, the squeeze and the mean of the logits over time
  are not part of the features; `windows` is the AvgPool3d's output,
  which the logits conv reads, and the features are its mean over time
  (the logits conv is linear, so its mean over time reads the same);
- BatchNorm is its own step with seeded moving statistics, not folded into
  the convs (the program folds them) and not a trained checkpoint's;
- the input is each frame's 224 crop, scaled to [-1, 1] by (pixel - 127.5)
  / 127.5, one crop and mirror a clip; the paper's test protocol runs the
  whole clip in one pass, as here;
- weights are the benchmark's seeded ones, not rgb_imagenet's.

Every product is f32 with TF32 off; `quant=fp8` rounds every operand of
every conv and of the tower to float8 first (the control: the precision
below the configuration's bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vvbench.reference import fp8, l2_normalize, matmul_precision
from vvbench.reference.caffenet import _same, scores, top_k

__all__ = ["features", "windows", "embed", "scores", "top_k",
           "transform"]

BRANCHES = ("Branch_0/Conv3d_0a_1x1", "Branch_1/Conv3d_0a_1x1",
            "Branch_1/Conv3d_0b_3x3", "Branch_2/Conv3d_0a_1x1",
            "Branch_2/Conv3d_0b_3x3", "Branch_3/Conv3d_0b_1x1")


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF's SAME padding: the output ceil(n / s); the total pad split with
    the odd one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_arg(x: torch.Tensor, window, stride) -> tuple:
    """F.pad's argument for SAME over the last three axes of x."""
    pads = [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], window, stride)]
    return tuple(v for p in reversed(pads) for v in p)


def transform(frames_u8, h_off, w_off, mirror, crop: int, frames: int,
              mean: float, scale: float) -> torch.Tensor:
    """(N T, H, W, C) uint8 frames of N clips -> (N, C, T, crop, crop) f32:
    each clip cropped at its own offsets, flipped left to right where its
    `mirror` says so, then (pixel - mean) * scale."""
    out = []
    for i in range(frames_u8.shape[0] // frames):
        h, w = int(h_off[i]), int(w_off[i])
        x = frames_u8[i * frames:(i + 1) * frames, h:h + crop,
                      w:w + crop].to(torch.float32)
        if bool(mirror[i]):
            x = torch.flip(x, dims=[2])
        out.append(((x - mean) * scale).permute(3, 0, 1, 2))
    return torch.stack(out)


def features(params: dict, x: torch.Tensor, cfg: dict, q=_same):
    """(N, C, T, H, W) f32 -> features (N, D) f32: the mean over time of
    `windows`."""
    return windows(params, x, cfg, q).mean(dim=1)


def windows(params: dict, x: torch.Tensor, cfg: dict, q=_same):
    """(N, C, T, H, W) f32 -> the AvgPool3d's output (N, T' - 1, D) f32,
    one row a window in time; `params` maps i3d.py's names to {"w":
    DHWIO, "moving_mean", "moving_variance", "beta"}; `q` rounds each conv
    operand."""
    eps = cfg["batch_norm"]["eps"]

    def unit(x, name, k, s=1):
        p = params[name]
        w = p["w"].permute(4, 3, 0, 1, 2)          # DHWIO -> OIDHW
        y = F.conv3d(F.pad(q(x), _pad_arg(x, (k,) * 3, (s,) * 3)), q(w),
                     stride=s)
        inv = torch.rsqrt(p["moving_variance"] + eps)[:, None, None, None]
        y = (y - p["moving_mean"][:, None, None, None]) * inv \
            + p["beta"][:, None, None, None]
        return F.relu(y)

    def pool(x, window, stride):
        xp = F.pad(x, _pad_arg(x, window, stride), value=-torch.inf)
        return F.max_pool3d(xp, tuple(window), tuple(stride))

    for layer in cfg["stem"]:
        if "window" in layer:
            x = pool(x, layer["window"], layer["stride"])
        else:
            x = unit(x, layer["name"], layer["kernel"], layer["stride"])
    mp = cfg["module_pool"]
    for m in cfg["modules"]:
        n = [f"{m['name']}/{b}" for b in BRANCHES]
        x = torch.cat([unit(x, n[0], 1),
                       unit(unit(x, n[1], 1), n[2], 3),
                       unit(unit(x, n[3], 1), n[4], 3),
                       unit(pool(x, mp["window"], mp["stride"]), n[5], 1)],
                      dim=1)
        if m["pool"]:
            x = pool(x, m["pool"]["window"], m["pool"]["stride"])
    x = F.avg_pool3d(x, tuple(cfg["head_pool"]), 1)    # VALID
    return x.mean(dim=(3, 4)).transpose(1, 2)


def embed(params: dict, frames_u8, h_off, w_off, mirror, cfg: dict,
          quant: str | None = None, feats_out: list | None = None):
    """Unit embeddings (N, E) of the uint8 frames of N clips, f32
    throughout with TF32 off (quant="fp8": the control). `feats_out`, a
    list, gets the windows' features (N, T' - 1, D) appended."""
    q = fp8 if quant == "fp8" else _same
    with matmul_precision(False):
        x = transform(frames_u8, h_off, w_off, mirror, cfg["crop"],
                      cfg["clip_frames"], cfg["pixel_mean"],
                      cfg["pixel_scale"])
        w = windows(params["i3d"], x, cfg, q)
        if feats_out is not None:
            feats_out.append(w)
        f = w.mean(dim=1)
        t = params["tower"]
        return l2_normalize(F.relu(q(f) @ q(t["w"]) + t["b"]))
