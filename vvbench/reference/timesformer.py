"""Plain reference of the `timesformer-l-retrieval` configuration: uint8
frames of whole clips -> one crop and mirror a clip -> (pixel / 255 -
0.45) / 0.225 -> TimeSformer with divided space-time attention to the
final norm's class row -> the 768 -> 768 tower -> L2 normalization -> f32
scores against the gallery -> the stable top-k.

facebookresearch/TimeSformer, timesformer/models/vit.py (Bertasius, Wang
and Torresani, arXiv:2102.05095), line for line at test time:
`PatchEmbed` (a 16/16 conv with bias over each frame, patches in (h w)
order), `VisionTransformer.forward_features` (cls and pos_embed, the
class row kept from x[:B, 0], the (b t) n m -> (b n) t m rearrange and
time_embed, back to b (n t) m, cat), `Block.forward` with
attention_type 'divided_space_time' (its rearranges, the temporal
`Attention`, `temporal_fc`, the class row `repeat`ed once a frame and
`cat` in front of each frame's tokens, the spatial `Attention`, the mean
of the class outputs over the frames, the `Mlp` with exact-erf GELU), the
final norm and row 0. The rearranges are written as reshape and permute;
the einops pattern is beside each.

Departures from vit.py:
- drop-path and dropout are off (the model at test);
- no positional interpolation: the clip has T = 96 frames, time_embed's
  length, and a 224 crop, pos_embed's 196 + 1 rows;
- `forward_features` returns the whole final-norm stream, (B, 1 + 196 T,
  D): `features` takes row 0 (vit.py's return), and `embed` also keeps
  the rows of the configuration's `kept_tokens` patch tokens for the
  check;
- x[:B, 0] is every clip's own class row, since every row 0 is cls +
  pos_embed[0];
- weights are the benchmark's seeded ones (no Kinetics checkpoint),
  linear weights stored (in, out), the transposes of nn.Linear's, and the
  patch conv's as a (16 16 3, D) matrix in (kh, kw, c) order;
- the MLP runs over row chunks of the stream (row-wise, so exact), so
  that a whole clip fits beside its activations on one card.

Every product is f32 with TF32 off; `quant=fp8` rounds every operand of
every linear layer and of both attention products (q, k; the softmax and
v) to float8 first (the control: the precision below the configuration's
bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vvbench.reference import fp8, l2_normalize, matmul_precision
from vvbench.reference.caffenet import _same, scores, top_k
from vvbench.reference.i3d import transform

__all__ = ["forward_features", "features", "kept_rows", "embed", "scores",
           "top_k", "transform", "block", "temporal_half", "spatial_half",
           "mlp_half"]

MLP_ROWS = 4096      # the MLP's row chunk


def kept_rows(patches: int, frames: int, k: int) -> torch.Tensor:
    """The stream rows (class row 0, tokens in (h w t) order from 1) of the
    k patch tokens the check compares: token i in frame floor(i T / k) at
    patch (97 i) mod P, as the configuration's `kept_tokens` says."""
    i = torch.arange(k, dtype=torch.int64)
    return 1 + (97 * i % patches) * frames + i * frames // k


def _linear(x, p, q):
    out = q(x) @ q(p["w"])
    return out + p["b"] if "b" in p else out


def _layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps)


def _attention(x, p, heads, q):
    """vit.py's `Attention`: qkv, (q @ k^T) * scale, softmax, @ v, proj."""
    b, n, c = x.shape
    qkv = _linear(x, p["qkv"], q).reshape(b, n, 3, heads, c // heads)
    qq, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = (q(qq) @ q(k).transpose(-2, -1)) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    x = (q(attn) @ q(v)).transpose(1, 2).reshape(b, n, c)
    return _linear(x, p["proj"], q)


def _mlp(x, p, q):
    return _linear(F.gelu(_linear(x, p["fc1"], q)), p["fc2"], q)


def temporal_half(x, p, b, t, w, cfg, q=_same):
    """The temporal half of vit.py's divided `Block.forward`: xt, the patch
    tokens plus temporal_fc of the temporal attention's output."""
    heads, eps = cfg["heads"], cfg["ln_eps"]
    num_spatial_tokens = (x.size(1) - 1) // t
    h = num_spatial_tokens // w
    m = x.shape[-1]
    # 'b (h w t) m -> (b h w) t m'
    xt = x[:, 1:, :].reshape(b * h * w, t, m)
    res_temporal = _attention(_layer_norm(xt, p["temporal_norm1"], eps),
                              p["temporal_attn"], heads, q)
    # '(b h w) t m -> b (h w t) m'
    res_temporal = res_temporal.reshape(b, h * w * t, m)
    res_temporal = _linear(res_temporal, p["temporal_fc"], q)
    return x[:, 1:, :] + res_temporal


def spatial_half(x, xt, p, b, t, w, cfg, q=_same):
    """The spatial half: cat(init_cls_token, xt) + cat(the class outputs'
    mean over the frames, the spatial attention's patch outputs), the
    stream the MLP reads."""
    heads, eps = cfg["heads"], cfg["ln_eps"]
    h = xt.shape[1] // t // w
    m = x.shape[-1]
    init_cls_token = x[:, 0, :].unsqueeze(1)
    cls_token = init_cls_token.repeat(1, t, 1)
    cls_token = cls_token.reshape(b * t, m).unsqueeze(1)  # 'b t m -> (b t) m'
    # 'b (h w t) m -> (b t) (h w) m'
    xs = xt.reshape(b, h * w, t, m).permute(0, 2, 1, 3).reshape(
        b * t, h * w, m)
    xs = torch.cat((cls_token, xs), 1)
    res_spatial = _attention(_layer_norm(xs, p["norm1"], eps), p["attn"],
                             heads, q)
    # the class token: averaged over the frames
    cls_token = res_spatial[:, 0, :]
    cls_token = cls_token.reshape(b, t, m)               # '(b t) m -> b t m'
    cls_token = torch.mean(cls_token, 1, True)
    res_spatial = res_spatial[:, 1:, :]
    # '(b t) (h w) m -> b (h w t) m'
    res = res_spatial.reshape(b, t, h * w, m).permute(0, 2, 1, 3).reshape(
        b, h * w * t, m)
    return torch.cat((init_cls_token, xt), 1) + torch.cat((cls_token, res), 1)


def mlp_half(x, p, cfg, q=_same):
    """x + mlp(norm2(x)), over row chunks of MLP_ROWS."""
    x = x.clone()
    for r in range(0, x.shape[1], MLP_ROWS):
        part = x[:, r:r + MLP_ROWS]
        x[:, r:r + MLP_ROWS] = part + _mlp(
            _layer_norm(part, p["norm2"], cfg["ln_eps"]), p["mlp"], q)
    return x


def block(x, p, b, t, w, cfg, q=_same):
    """vit.py's `Block.forward`, attention_type 'divided_space_time'."""
    xt = temporal_half(x, p, b, t, w, cfg, q)
    return mlp_half(spatial_half(x, xt, p, b, t, w, cfg, q), p, cfg, q)


def forward_features(params: dict, x: torch.Tensor, cfg: dict, q=_same):
    """(B, C, T, H, W) f32 -> the final norm's stream (B, 1 + P T, D) f32,
    tokens in (h w t) order; `q` rounds each product's operands."""
    b, c, t, hh, ww = x.shape
    p = params["patch_embed"]
    size = cfg["patch"]
    d = p["w"].shape[1]
    weight = p["w"].reshape(size, size, c, d).permute(3, 2, 0, 1)
    # PatchEmbed: 'b c t h w -> (b t) c h w', the conv, flatten(2).T
    frames = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, hh, ww)
    x = F.conv2d(q(frames), q(weight), p["b"], stride=size)
    w = x.size(-1)
    x = x.flatten(2).transpose(1, 2)
    cls_tokens = params["cls_token"].expand(x.size(0), 1, -1)
    x = torch.cat((cls_tokens, x), dim=1)
    x = x + params["pos_embed"]
    # time embeddings
    cls_tokens = x[:b, 0, :].unsqueeze(1)
    x = x[:, 1:]
    n = x.shape[1]
    x = x.reshape(b, t, n, d).permute(0, 2, 1, 3).reshape(b * n, t, d)
    x = x + params["time_embed"]                 # '(b t) n m -> (b n) t m'
    x = x.reshape(b, n * t, d)                   # '(b n) t m -> b (n t) m'
    x = torch.cat((cls_tokens, x), dim=1)
    for i in range(len(params["blocks"])):
        x = block(x, params["blocks"][str(i)], b, t, w, cfg, q)
    return _layer_norm(x, params["norm"], cfg["ln_eps"])


def features(params: dict, x: torch.Tensor, cfg: dict, q=_same):
    """(B, C, T, H, W) f32 -> features (B, D) f32: vit.py's
    `forward_features`, the final norm's class row."""
    return forward_features(params, x, cfg, q)[:, 0]


def embed(params: dict, frames_u8, h_off, w_off, mirror, cfg: dict,
          quant: str | None = None, feats_out: list | None = None):
    """Unit embeddings (N, E) of the uint8 frames of N clips, f32
    throughout with TF32 off (quant="fp8": the control). `feats_out`, a
    list, gets the final norm's class row and its `kept_tokens` patch rows
    appended, (N, 1 + kept_tokens, D)."""
    q = fp8 if quant == "fp8" else _same
    with matmul_precision(False):
        x = transform(frames_u8, h_off, w_off, mirror, cfg["crop"],
                      cfg["clip_frames"], cfg["pixel_mean"],
                      cfg["pixel_scale"])
        stream = forward_features(params["timesformer"], x, cfg, q)
        if feats_out is not None:
            grid = cfg["crop"] // cfg["patch"]
            rows = kept_rows(grid * grid, cfg["clip_frames"],
                             cfg["kept_tokens"]).to(stream.device)
            feats_out.append(torch.cat([stream[:, :1], stream[:, rows]],
                                       dim=1))
        f = stream[:, 0]
        t = params["tower"]
        return l2_normalize(F.relu(q(f) @ q(t["w"]) + t["b"]))
