"""The flagship temporal video-embedding model; counterpart of
videovector_tpu/models/embedding.py.

A window's 15 role blobs [target | 4 context | 10 negatives] are one
(R, B, D) tensor, and the fc7 tower over all of them is one (R.B, D) x
(D, E) GEMM on K1. Then ReLU, dropout 0.9 at train time, the context mean,
cosine-form scores against the target and the negatives, and the margin-2
L2 max-margin loss (ops/losses.py).

At test time without gradients (the serving path) the tower is one K1
launch with the bias + ReLU epilogue. Where a gradient is wanted, or at
train time, it is ops.linear.tower_matmul (K1 with the bias epilogue,
autograd backward in torch.matmul) and the ReLU runs outside the kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from videovector_tpu_torch.core import fillers
from videovector_tpu_torch.models.mednet import torch_dtype
from videovector_tpu_torch.ops import activations
from videovector_tpu_torch.ops.hopper.matmul import matmul, matmul_plain
from videovector_tpu_torch.ops.linear import no_tf32, tower_matmul
from videovector_tpu_torch.ops.losses import max_margin_loss
from videovector_tpu_torch.ops.normalization import l2_normalize_rows


class _NegDot(torch.autograd.Function):
    """einsum("nbd,bd->nb"): each negative's dot with its context mean, its
    products in full f32 (TF32 off) in forward and backward alike, whatever
    the process sets (autograd runs a backward outside any block that the
    forward ran in)."""

    @staticmethod
    def forward(ctx, negs, ctx_avg):
        ctx.save_for_backward(negs, ctx_avg)
        with no_tf32():
            return torch.einsum("nbd,bd->nb", negs, ctx_avg)

    @staticmethod
    def backward(ctx, g):
        negs, ctx_avg = ctx.saved_tensors
        d_negs = d_ctx = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                d_negs = torch.einsum("nb,bd->nbd", g, ctx_avg)
            if ctx.needs_input_grad[1]:
                d_ctx = torch.einsum("nb,nbd->bd", g, negs)
        return d_negs, d_ctx


@dataclass(frozen=True)
class VideoEmbeddingConfig:
    feature_dim: int = 4096
    embed_dim: int = 4096
    num_context: int = 4          # context_size 5 -> 4 context shots
    num_negatives: int = 10
    margin: float = 2.0
    norm: str = "L2"              # margin-loss norm
    dropout_rate: float = 0.9
    weight_std: float = 0.001     # ref fc7 gaussian std .001
    compute_dtype: str = "bfloat16"     # the tower GEMM's operands
    activation_dtype: str = "float32"   # the (R, B, E) tower activations
    # recompute the tower in backward (torch.utils.checkpoint): one more
    # forward GEMM for not keeping the (R, B, E) activations
    remat_tower: bool = False

    @property
    def num_roles(self) -> int:
        return 1 + self.num_context + self.num_negatives


class VideoEmbeddingModel:
    """Params are a plain dict {"tower": {"w": (D, E), "b": (E,)}}.
    `plain=True` runs K1's plain version in place of the kernel (to compare
    the two on one device)."""

    def __init__(self, cfg: VideoEmbeddingConfig, *, plain: bool = False):
        self.cfg = cfg
        self.plain = plain

    def init(self, generator: torch.Generator):
        cfg = self.cfg
        w = fillers.gaussian_fill(generator, (cfg.embed_dim, cfg.feature_dim),
                                  std=cfg.weight_std)
        return {"tower": {"w": w.T.contiguous(),
                          "b": torch.zeros(cfg.embed_dim,
                                           device=generator.device)}}

    # -- embedding tower -------------------------------------------------
    def embed(self, params, x, *, generator: torch.Generator | None = None,
              train: bool = False):
        """x: (..., D) -> (..., E). fc7 + ReLU (+ dropout at train time,
        with masks drawn from `generator`)."""
        cfg = self.cfg
        t = params["tower"]
        lead = x.shape[:-1]
        flat = x.reshape(-1, cfg.feature_dim)
        cdt = torch_dtype(cfg.compute_dtype)
        wants_grad = torch.is_grad_enabled() and any(
            v.requires_grad for v in (flat, t["w"], t["b"]))
        if not train and not wants_grad:
            mm = matmul_plain if self.plain else matmul
            h = mm(flat.to(cdt), t["w"].to(cdt), t["b"], fuse_relu=True,
                   out_dtype=torch.float32)
            h = h.to(torch_dtype(cfg.activation_dtype))
            return h.reshape(*lead, cfg.embed_dim)
        mask = None
        if train and cfg.dropout_rate > 0:
            if cfg.dropout_rate >= 1.0:
                raise ValueError(
                    f"dropout rate must be < 1 (got {cfg.dropout_rate})")
            if generator is None:
                # the reference always drops at TRAIN: training without
                # dropout because no generator was passed would train
                # another model than the one configured
                raise ValueError("train=True with dropout_rate > 0 needs "
                                 "generator= (a torch.Generator)")
            # drawn outside the recomputed region: checkpoint restores the
            # default generator's state only, not an explicit one's
            mask = activations.dropout_mask(
                (flat.shape[0], cfg.embed_dim), 1.0 - cfg.dropout_rate,
                generator, flat.device)
        fn = functools.partial(self._tower, cdt=cdt, mask=mask)
        if cfg.remat_tower:
            h = torch.utils.checkpoint.checkpoint(fn, flat, t["w"], t["b"],
                                                  use_reentrant=False)
        else:
            h = fn(flat, t["w"], t["b"])
        return h.reshape(*lead, cfg.embed_dim)

    def _tower(self, flat, w, b, *, cdt, mask):
        cfg = self.cfg
        h = activations.relu(tower_matmul(flat, w, b, compute_dtype=cdt,
                                          plain=self.plain))
        if mask is not None:
            h = activations.apply_dropout(h, mask, 1.0 - cfg.dropout_rate)
        return h.to(torch_dtype(cfg.activation_dtype))

    # -- scoring ---------------------------------------------------------
    @staticmethod
    def _safe_inv_norm(sq, eps=1e-10):
        """1/(||x|| + eps), but exactly 0 (value and gradient) for zero rows,
        as the reference's normalization backward returns 0 there."""
        nonzero = sq > 0
        norm = torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq)))
        return torch.where(nonzero, 1.0 / (norm + eps), torch.zeros_like(sq))

    def scores(self, params, data, *, generator=None, train: bool = False,
               role_major: bool = False):
        """data: (B, R, D), or (R, B, D) with role_major=True -> (s_true (B,),
        s_neg (B, N), embeddings dict). Cosine form,
        s = (x.y) / ((||x|| + eps)(||y|| + eps)), which equals the
        reference's normalize-then-dot without materializing normalized
        (N, B, E) tensors."""
        cfg = self.cfg
        x = data if role_major else data.transpose(0, 1)
        n_roles = cfg.num_roles
        if x.shape[0] != n_roles:
            # a surplus role would silently become a phantom negative
            raise ValueError(
                f"data carries {x.shape[0]} roles but the config declares "
                f"{n_roles} (1 target + {cfg.num_context} context + "
                f"{cfg.num_negatives} negatives)")
        h = self.embed(params, x, generator=generator, train=train)  # (R, B, E)
        target = h[0].float()                                   # (B, E)
        context = h[1:1 + cfg.num_context]                      # (C, B, E)
        negs = h[1 + cfg.num_context:]                          # (N, B, E)

        ctx_avg = torch.mean(context.float(), dim=0)
        ctx_inv = self._safe_inv_norm(torch.sum(ctx_avg * ctx_avg, -1))  # (B,)
        tgt_inv = self._safe_inv_norm(torch.sum(target * target, -1))    # (B,)
        neg_inv = self._safe_inv_norm(
            torch.sum((negs * negs).float(), -1))                        # (N, B)

        s_true = torch.sum(ctx_avg * target, -1) * ctx_inv * tgt_inv     # (B,)
        ctx_dot_negs = _NegDot.apply(negs.float(), ctx_avg)            # (N, B)
        s_neg = (ctx_dot_negs * neg_inv * ctx_inv[None, :]).T           # (B, N)
        emb = {"target": target * tgt_inv[:, None],
               "context": ctx_avg * ctx_inv[:, None]}
        return s_true, s_neg, emb

    # -- losses ----------------------------------------------------------
    def loss(self, params, batch, *, generator=None, train: bool = True,
             weights=None, role_major: bool = False):
        """batch: dict with "data" (B, R, D), or (R, B, D) with
        role_major=True; optional "weights", per sample, (B,) or (B, 1).
        Returns (loss, aux dict)."""
        cfg = self.cfg
        s_true, s_neg, _ = self.scores(params, batch["data"],
                                       generator=generator, train=train,
                                       role_major=role_major)
        s_true_b = torch.broadcast_to(s_true[:, None], s_neg.shape)
        w = weights if weights is not None else batch.get("weights")
        if w is not None:
            # (B,) or (B, 1) -> (B, 1), so that the weights broadcast along
            # the negatives (a bare (B,) would align with the N axis)
            w = torch.as_tensor(w, device=s_neg.device)
            if w.dim() == 1 or (w.dim() == 2 and w.shape[1] == 1):
                if w.shape[0] != s_neg.shape[0]:
                    raise ValueError(
                        f"weights carry {w.shape[0]} entries for batch "
                        f"size {s_neg.shape[0]}")
                w = w.reshape(-1, 1)
        loss, violations = max_margin_loss(
            s_true_b, s_neg, margin=cfg.margin, norm=cfg.norm, weights=w)
        return loss, {"violations": violations,
                      "mean_true_score": torch.mean(s_true),
                      "mean_neg_score": torch.mean(s_neg)}

    # -- eval ------------------------------------------------------------
    def extract(self, params, feats):
        """feats (B, F, D) frame features -> (B, E) normalized embeddings:
        the raw frames are averaged first, then embedded (Caffe's TEST
        branch)."""
        avg = torch.mean(feats, dim=1) if feats.dim() == 3 else feats
        return l2_normalize_rows(self.embed(params, avg))
