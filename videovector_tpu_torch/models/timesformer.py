"""TimeSformer with divided space-time attention (Bertasius, Wang and
Torresani, "Is Space-Time Attention All You Need for Video
Understanding?", ICML 2021, arXiv:2102.05095) as a clip encoder:
facebookresearch/TimeSformer's `VisionTransformer` (timesformer/models/
vit.py) with `attention_type='divided_space_time'`, from a clip's frames to
the final norm's class row, D a clip. The defaults are TimeSformer-L: D
768, 12 blocks of 12 heads of 64, MLP 3,072, 16 x 16 patches of a 224
crop (196 a frame), 96 frames, LayerNorm eps 1e-6, qkv with bias.

  patches (a 16/16 conv: a patchify copy and one K1 GEMM) + pos_embed;
  cls + pos_embed[0]; the patch tokens in (h w t) order + time_embed[t]
  12 x block:
    temporal: x[1:] += temporal_fc(proj(attn_t(temporal_norm1(x[1:]))))
              over one sequence of T tokens a patch
    spatial:  x += [mean_t c_t; s] with (c_t, s) = proj(attn_s(norm1(x)))
              over one sequence a frame: [cls; its 196 tokens]
    mlp:      x += fc2(gelu(fc1(norm2(x))))
  features: norm(x)[0]

Arithmetic, as autocast runs the published module: the residual stream x
is f32, each LayerNorm runs in f32 and its output is rounded to bf16 for
the GEMM that reads it, each GEMM (K1, ops/hopper/matmul.py) sums in f32,
adds its bias in f32 and rounds once to bf16 (fc1 applies GELU, exact erf,
before the rounding), and each residual sum adds a bf16 branch to the f32
stream. Attention (ops/attention.py) reads bf16 q, k and v, computes
scores and softmax in f32 at scale 64^-0.5, rounds the probabilities to
bf16 for their product with v (as attention under autocast does) and
rounds its output once.
With compute_dtype float32 every GEMM and the attention run in f32 (the
CPU's plain versions: the card's kernels take bf16).

Reorderings of vit.py that are exact in real arithmetic:
- The tokens stay in (h w t) order throughout. The temporal heads read
  each patch's T tokens, contiguous rows, in place; the spatial heads read
  a frame's tokens at a stride of T rows in place (`Sequences`). Nothing
  re-orders tokens between the two layouts on the card: the counter
  `vvtpu.attn.layout_bytes`, which counts the bytes the attention copies
  to lay out its sequences (per-frame class rows among them), reads 0
  there; the plain version's gathers count.
- vit.py repeats the class row once a frame before norm1 and qkv. Here
  norm1 and qkv run once on the class row, as one more row of the stream
  (row 0 of each clip), and the attention gives every frame's class query
  the key and value of that one row.
- vit.py averages the T class outputs after `proj`; here they are
  averaged (in f32) before it, one row a clip. `proj` is affine, so the
  mean of proj(o_t) is proj of the mean of o_t.
- vit.py applies `temporal_fc` after rearranging the temporal outputs back
  to (h w t); the rows are in that order already.
- x[1:] and x are updated in place.

Layouts: NDHWC clips (N, T, H, W, 3); linear weights (in, out), the
transposes of nn.Linear's, as K1 reads them; the patch embedding's weight
(16 16 3, D) in (kh, kw, c) order, a patch's pixels as its rows. `draw`
draws f32 params on the generator's device at the stds it is given (the
benchmark passes its configuration's, vvbench/configs/
timesformer-l-retrieval.json's `weights`; `INIT` by default),
`cast_weights` casts the linear weights to the compute dtype once, and
`init` gives both steps' result; a weight in another dtype is cast at each
call (counted in `vvtpu.cast_bytes`). Spans (utils/
timer.py): `vvtpu.timesformer.block` (request id: the block's index)
around each block, `vvtpu.attn.temporal` and `vvtpu.attn.spatial` around
each attention call.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from videovector_tpu_torch.models.mednet import (
    Backbone, cast_param, torch_dtype,
)
from videovector_tpu_torch.ops.attention import Sequences, attention
from videovector_tpu_torch.ops.hopper.matmul import matmul
from videovector_tpu_torch.utils.timer import span

# `draw`'s stds by default, under the keys of the benchmark configuration's
# `weights` (a test holds the two equal): qkv's weights gaussian at qkv_std,
# which makes the attention logits of both kinds spread by about 1.5 (std),
# where the published trunc_normal(0.02) leaves them at about 0.3 and
# softmax nearly flat; the other linear weights at 1 / sqrt(fan_in); the
# rest below
INIT = {"qkv_std": 0.045, "bias_std": 0.05, "norm_gain_std": 0.1,
        "norm_bias_std": 0.05, "cls_std": 0.5, "pos_std": 0.5,
        "time_std": 0.5}


@dataclass(frozen=True)
class TimeSformerConfig:
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    patch: int = 16
    crop: int = 224
    frames: int = 96
    ln_eps: float = 1e-6
    qkv_bias: bool = True
    compute_dtype: str = "bfloat16"
    # the final-norm patch rows that `served_features` keeps beside the
    # class row (`kept_tokens`)
    kept_tokens: int = 64

    @property
    def feature_dim(self) -> int:
        return self.dim

    @property
    def patches(self) -> int:
        return (self.crop // self.patch) ** 2


def kept_tokens(patches: int, frames: int, k: int,
                device=None) -> torch.Tensor:
    """(k,) int64 on `device`: the rows, in (h w t) order, of the patch
    tokens whose final-norm rows `served_features` keeps: token i in frame
    i T // k at patch (97 i) mod P, spread over every frame and across the
    grid."""
    i = torch.arange(k, dtype=torch.int64, device=device)
    return (97 * i % patches) * frames + i * frames // k


def linear_shapes(cfg: TimeSformerConfig) -> list[tuple[str, int, int]]:
    """(path, in, out) of every linear layer, `blocks/<i>/...` a block's."""
    d, m = cfg.dim, cfg.mlp_dim
    out = [("patch_embed", cfg.patch * cfg.patch * 3, d)]
    for i in range(cfg.depth):
        b = f"blocks/{i}/"
        out += [(b + "temporal_attn/qkv", d, 3 * d),
                (b + "temporal_attn/proj", d, d), (b + "temporal_fc", d, d),
                (b + "attn/qkv", d, 3 * d), (b + "attn/proj", d, d),
                (b + "mlp/fc1", d, m), (b + "mlp/fc2", m, d)]
    return out


def norm_names(cfg: TimeSformerConfig) -> list[str]:
    names = []
    for i in range(cfg.depth):
        names += [f"blocks/{i}/{n}"
                  for n in ("temporal_norm1", "norm1", "norm2")]
    return names + ["norm"]


def _cast_linears(tree, dtype: torch.dtype):
    """`tree` with each linear layer's "w" in `dtype`, the rest as it is."""
    if isinstance(tree, torch.Tensor):
        return tree
    if "w" in tree:
        return {**tree, "w": tree["w"].to(dtype)}
    return {k: _cast_linears(v, dtype) for k, v in tree.items()}


def _put(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


class TimeSformer(Backbone):
    # the SlowFast defaults TimeSformer's configs use: mean 0.45 and std
    # 0.225 of 255 on every channel
    pixel_mean = 0.45 * 255
    pixel_scale = 1 / (0.225 * 255)
    clip_input = True

    def __init__(self, cfg: TimeSformerConfig = TimeSformerConfig()):
        self.cfg = cfg

    def init(self, generator: torch.Generator):
        """The params `forward` serves: `draw`'s, `cast_weights`'d."""
        return self.cast_weights(self.draw(generator))

    def cast_weights(self, params):
        """params with every linear weight in the compute dtype, once, as
        the GEMMs read them (autocast casts them at every call); biases,
        norms and embeddings stay f32."""
        return _cast_linears(params, torch_dtype(self.cfg.compute_dtype))

    def draw(self, generator: torch.Generator, stds=INIT):
        """f32 params on the generator's device, drawn at `stds` (`INIT`'s
        keys): linear weights gaussian (qkv at qkv_std, the others at 1 /
        sqrt(fan_in)), biases N(0, bias_std) (qkv's none without qkv_bias),
        LayerNorm gains 1 + N(0, norm_gain_std) and offsets N(0,
        norm_bias_std), cls, pos_embed and time_embed gaussian."""
        cfg, dev = self.cfg, generator.device

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=generator, device=dev) * std
        params: dict = {}
        for path, n_in, n_out in linear_shapes(cfg):
            std = (stds["qkv_std"] if path.endswith("qkv")
                   else n_in ** -0.5)
            layer = {"w": randn(n_in, n_out, std=std)}
            if cfg.qkv_bias or not path.endswith("qkv"):
                layer["b"] = randn(n_out, std=stds["bias_std"])
            _put(params, path, layer)
        for path in norm_names(cfg):
            _put(params, path, {
                "g": 1 + randn(cfg.dim, std=stds["norm_gain_std"]),
                "b": randn(cfg.dim, std=stds["norm_bias_std"])})
        params["cls_token"] = randn(cfg.dim, std=stds["cls_std"])
        params["pos_embed"] = randn(1 + cfg.patches, cfg.dim,
                                    std=stds["pos_std"])
        params["time_embed"] = randn(cfg.frames, cfg.dim,
                                     std=stds["time_std"])
        return params

    def forward(self, params, clips):
        """clips: (N, T, H, W, 3) f32 (preprocessed) -> features (N, D) f32,
        the final norm's class row."""
        return self.served_features(params, clips)[1]

    def served_features(self, params, clips):
        """((N, 1 + kept_tokens, D) f32: the final norm's class row, then
        its rows of the `kept_tokens` patch tokens; the features (N, D)):
        the check reads patch rows too, so that a fault that the class row
        averages away still shows."""
        x = self.stream(params, clips)
        n, t = clips.shape[0], clips.shape[1]
        # made on the device: a captured query copies nothing from the host
        rows = 1 + kept_tokens(self.cfg.patches, t, self.cfg.kept_tokens,
                               x.device)
        kept = self._norm(torch.cat([x[:, :1], x[:, rows]], dim=1),
                          params["norm"])
        return kept, kept[:, 0]

    def stream(self, params, clips):
        """The residual stream after the last block, (N, 1 + P T, D) f32:
        each clip's class row, then its patch tokens in (h w t) order."""
        cfg = self.cfg
        n, t, h, w, c = clips.shape
        p, grid = cfg.patch, h // cfg.patch
        if (h, w, c) != (cfg.crop, cfg.crop, 3) or h % p:
            raise ValueError(f"TimeSformer reads {cfg.crop} x {cfg.crop} x 3 "
                             f"frames, got {(h, w, c)}")
        if params["time_embed"].shape[0] != t:
            raise ValueError(f"a clip of {t} frames against a time_embed of "
                             f"{params['time_embed'].shape[0]}: no "
                             "interpolation")
        x = self._embed(params, clips, n, t, grid)
        for i in range(cfg.depth):
            with span("vvtpu.timesformer.block", req=i):
                self._block(params["blocks"][str(i)], x, n, grid * grid, t)
        return x

    # ------------------------------------------------------------------
    def _embed(self, params, clips, n, t, grid):
        """The stream before the first block: the patch embedding (a copy of
        each patch's pixels as a row, in (h w t) order, and one GEMM) plus
        pos_embed and time_embed; the class row cls + pos_embed[0]."""
        cfg, d = self.cfg, self.cfg.dim
        cdt = torch_dtype(cfg.compute_dtype)
        p = cfg.patch
        patches = clips.reshape(n, t, grid, p, grid, p, 3).permute(
            0, 2, 4, 1, 3, 5, 6)                       # n h w t i j c
        rows = torch.empty((n * grid * grid * t, p * p * 3), dtype=cdt,
                           device=clips.device)
        rows.view(patches.shape).copy_(patches)
        pe = params["patch_embed"]
        emb = matmul(rows, cast_param(pe["w"], cdt), pe["b"], out_dtype=cdt)
        pos = params["pos_embed"].float()
        x = torch.empty((n, 1 + grid * grid * t, d), dtype=torch.float32,
                        device=clips.device)
        x[:, 0] = params["cls_token"].float() + pos[0]
        torch.add(emb.view(n, grid * grid, t, d),
                  pos[1:, None] + params["time_embed"].float()[None],
                  out=x[:, 1:].view(n, grid * grid, t, d))
        return x

    def _norm(self, x, p):
        return F.layer_norm(x, (self.cfg.dim,), p["g"].float(),
                            p["b"].float(), self.cfg.ln_eps)

    def _linear(self, x, p, **kw):
        cdt = torch_dtype(self.cfg.compute_dtype)
        return matmul(x, cast_param(p["w"], cdt), p.get("b"), out_dtype=cdt,
                      **kw)

    def _rows(self, x, p):
        """LayerNorm p of x's rows (f32), rounded to the compute dtype, as
        one (rows, D) matrix."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        return self._norm(x, p).to(cdt).reshape(-1, self.cfg.dim)

    def _block(self, bp, x, n, patches, t):
        """One divided block on the stream x (N, 1 + P T, D), in place."""
        self._temporal_half(bp, x, n, patches, t)
        self._spatial_half(bp, x, n, patches, t)
        self._mlp_half(bp, x)

    def _temporal_half(self, bp, x, n, patches, t):
        """x[:, 1:] += temporal_fc(proj(temporal attention)): each patch's T
        tokens, contiguous rows, read in place."""
        d, heads = self.cfg.dim, self.cfg.heads
        qkv = self._linear(self._rows(x[:, 1:], bp["temporal_norm1"]),
                           bp["temporal_attn"]["qkv"])
        with span("vvtpu.attn.temporal"):
            o, _ = attention(qkv, heads, Sequences.temporal(n, patches, t))
        r = self._linear(self._linear(o, bp["temporal_attn"]["proj"]),
                         bp["temporal_fc"])
        x[:, 1:] += r.view(n, patches * t, d)

    def _spatial_half(self, bp, x, n, patches, t):
        """x += proj(spatial attention), each frame's tokens with the clip's
        one class row, the class outputs' mean over the frames in row 0."""
        d, heads = self.cfg.dim, self.cfg.heads
        qkv = self._linear(self._rows(x, bp["norm1"]), bp["attn"]["qkv"])
        with span("vvtpu.attn.spatial"):
            o, cls = attention(qkv, heads,
                               Sequences.spatial(n, patches, t))
        o.view(n, 1 + patches * t, d)[:, 0] = self._class_mean(cls, n, t)
        x += self._linear(o, bp["attn"]["proj"]).view(x.shape)

    def _mlp_half(self, bp, x):
        """x += fc2(gelu(fc1(norm2(x)))), GELU in fc1's K1 epilogue."""
        h = self._linear(self._rows(x, bp["norm2"]), bp["mlp"]["fc1"],
                         fuse_gelu=True)
        x += self._linear(h, bp["mlp"]["fc2"]).view(x.shape)

    def _class_mean(self, cls, n, t):
        """The mean over the T frames of the class query's outputs (f32,
        before `proj`)."""
        return cls.view(n, t, self.cfg.dim).mean(dim=1)
