"""End-to-end video retrieval — frames in, ranked videos out; counterpart of
videovector_tpu/models/retrieval_pipeline.py.

  uint8 frames (N, H, W, C) on the device
    -> crop/mirror/mean transform       (data/transformer.py)
    -> MedNet conv1..fc7                (models/mednet.py: K2 convs, K1 fc)
    -> embedding tower + L2 normalize   (models/embedding.py: K1)
    -> scores vs a device-resident gallery (torch.matmul), top-k

Top-k breaks ties as lax.top_k does, lower gallery index first, through a
stable descending sort.

Under a profiler each stage is a span (utils/timer.py): `vvtpu.query`
(its request id the pipeline's count of queries) around the call, and
`vvtpu.query.transform`, `.mednet`, `.tower`, `.scores` and `.topk`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from videovector_tpu_torch.convert import map_params
from videovector_tpu_torch.data.transformer import (
    TransformConfig, make_batch_transform,
)
from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.models.embedding import (
    VideoEmbeddingConfig, VideoEmbeddingModel,
)
from videovector_tpu_torch.models.mednet import MedNet, MedNetConfig
from videovector_tpu_torch.ops.linear import no_tf32
from videovector_tpu_torch.ops.normalization import l2_normalize_rows
from videovector_tpu_torch.utils.timer import span


@dataclass
class RetrievalPipelineConfig:
    image_hw: tuple = (256, 256)
    crop: int = 227
    embed_dim: int = 4096
    top_k: int = 5
    compute_dtype: str = "bfloat16"
    # "NHWC": frames in decode order (H, W, C); "NCHW" accepts Caffe blobs
    pixels_layout: str = "NHWC"


def top_k_stable(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest per row; among equal scores the
    lower index comes first (lax.top_k's order, which torch.topk does not
    promise)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RetrievalPipeline:
    def __init__(self, cfg: RetrievalPipelineConfig = RetrievalPipelineConfig(),
                 *, mean: np.ndarray | None = None, device=DEFAULT,
                 plain: bool = False):
        """Runs on the card unless `device` asks for the CPU; without a card
        a CUDA device raises here. `plain=True` runs every kernel's plain
        PyTorch version instead of the kernel (to compare the two on one
        device)."""
        self.cfg = cfg
        self.device = resolve(device)
        self.mednet = MedNet(MedNetConfig(
            input_hw=(cfg.crop, cfg.crop), fc7=4096,
            compute_dtype=cfg.compute_dtype), plain=plain)
        self.embedder = VideoEmbeddingModel(VideoEmbeddingConfig(
            feature_dim=4096, embed_dim=cfg.embed_dim,
            compute_dtype=cfg.compute_dtype, dropout_rate=0.0), plain=plain)
        self.transform = make_batch_transform(
            TransformConfig(crop_size=cfg.crop), mean, cfg.image_hw,
            layout=cfg.pixels_layout, device=self.device)
        self.queries = 0    # the request id of the `vvtpu.query` spans

    def init(self, generator: torch.Generator):
        """Random params from `generator`, placed on the pipeline's device."""
        params = {"mednet": self.mednet.init(generator),
                  "tower": self.embedder.init(generator)["tower"]}
        return map_params(lambda t: t.to(self.device), params)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def embed_frames(self, params, pixels_u8, h_off, w_off, mirror):
        """uint8 frames ((N,H,W,C) for pixels_layout NHWC, (N,C,H,W) for
        NCHW) -> (N, E) unit embeddings (f32)."""
        with span("vvtpu.query.transform"):
            x = self.transform(pixels_u8, h_off, w_off, mirror)
            if self.cfg.pixels_layout == "NCHW":
                x = x.permute(0, 2, 3, 1)                      # -> NHWC
        with span("vvtpu.query.mednet"):
            fc7 = self.mednet.forward(params["mednet"], x)     # (N, 4096)
        with span("vvtpu.query.tower"):
            emb = self.embedder.embed({"tower": params["tower"]}, fc7)
            return l2_normalize_rows(emb)

    @torch.no_grad()
    def query(self, params, pixels_u8, h_off, w_off, mirror, gallery,
              gallery_ids):
        """Frames -> embeddings -> scores vs the gallery -> (top-k ids,
        top-k scores). gallery: (G, E) unit rows on the device."""
        self.queries += 1
        with span("vvtpu.query", req=self.queries):
            emb = self.embed_frames(params, pixels_u8, h_off, w_off, mirror)
            # f32 scores, as JAX's; they decide the top-k
            with span("vvtpu.query.scores"), no_tf32():
                scores = torch.matmul(emb, gallery.T)
            with span("vvtpu.query.topk"):
                top_scores, top_idx = top_k_stable(scores, self.cfg.top_k)
                return gallery_ids[top_idx], top_scores

    # ------------------------------------------------------------------
    def build_gallery(self, params, frame_batches, video_ids_per_batch):
        """Average frame embeddings per video -> (num_videos, E) unit gallery
        and its int32 ids (sorted), both on the device.
        frame_batches: iterable of (pixels, h_off, w_off, mirror) tuples;
        video_ids_per_batch: the matching iterable of per-batch id arrays."""
        sums: dict[int, np.ndarray] = {}
        counts: dict[int, int] = {}
        for (pix, h, w, m), vids in zip(frame_batches, video_ids_per_batch):
            emb = self.embed_frames(params, pix, h, w, m).cpu().numpy()
            for e, v in zip(emb, np.asarray(vids)):
                v = int(v)
                if v in sums:
                    sums[v] += e
                    counts[v] += 1
                else:
                    sums[v] = e.copy()
                    counts[v] = 1
        ids = sorted(sums)
        mat = np.stack([sums[v] / counts[v] for v in ids])
        mat /= np.linalg.norm(mat, axis=1, keepdims=True) + 1e-10
        return (torch.as_tensor(mat, device=self.device),
                torch.as_tensor(ids, dtype=torch.int32, device=self.device))
