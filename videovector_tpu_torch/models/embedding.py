"""The video-embedding model's serving half; counterpart of
videovector_tpu/models/embedding.py (`VideoEmbeddingConfig`, `init`,
`embed` at test time and `extract`).

The tower (fc7 4096 -> 4096 + ReLU) is one K1 launch with the bias + ReLU
epilogue. Scoring, the loss, dropout and rematerialization belong to the
training slice and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from videovector_tpu_torch.core import fillers
from videovector_tpu_torch.models.mednet import torch_dtype
from videovector_tpu_torch.ops.hopper.matmul import matmul, matmul_plain
from videovector_tpu_torch.ops.normalization import l2_normalize_rows


@dataclass(frozen=True)
class VideoEmbeddingConfig:
    """The serving fields of the JAX config; the training fields (roles,
    margin, norm, remat_tower) come with the training slice."""
    feature_dim: int = 4096
    embed_dim: int = 4096
    dropout_rate: float = 0.9     # train time only; embed(train=True) raises
    weight_std: float = 0.001     # ref fc7 gaussian std .001
    compute_dtype: str = "bfloat16"
    activation_dtype: str = "float32"


class VideoEmbeddingModel:
    """Params are a plain dict {"tower": {"w": (D, E), "b": (E,)}}."""

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

    def embed(self, params, x, *, train: bool = False):
        """x: (..., D) -> (..., E). fc7 + ReLU (test time)."""
        if train:
            raise NotImplementedError(
                "embed(train=True) (dropout) arrives with the training slice")
        cfg = self.cfg
        t = params["tower"]
        lead = x.shape[:-1]
        flat = x.reshape(-1, cfg.feature_dim)
        cdt = torch_dtype(cfg.compute_dtype)
        mm = matmul_plain if self.plain else matmul
        h = mm(flat.to(cdt), t["w"].to(cdt), t["b"], fuse_relu=True,
               out_dtype=torch.float32)
        h = h.to(torch_dtype(cfg.activation_dtype))
        return h.reshape(*lead, cfg.embed_dim)

    def extract(self, params, feats):
        """feats (B, F, D) frame features -> (B, E) normalized embeddings:
        the raw frames are averaged first, then embedded (Caffe's TEST
        branch)."""
        avg = torch.mean(feats, dim=1) if feats.dim() == 3 else feats
        return l2_normalize_rows(self.embed(params, avg))
