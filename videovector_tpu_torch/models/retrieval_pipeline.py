"""End-to-end video retrieval — frames in, ranked videos out; counterpart of
videovector_tpu/models/retrieval_pipeline.py.

  uint8 frames (N, H, W, C) on the device
    -> crop/mirror/mean transform       (data/transformer.py)
    -> the backbone: MedNet conv1..fc7  (models/mednet.py: K2 convs, K1 fc)
       or GoogLeNet to pool5            (models/googlenet.py: K2 convs)
    -> embedding tower + L2 normalize   (models/embedding.py: K1)
    -> scores vs a device-resident gallery (torch.matmul), top-k

`RetrievalPipelineConfig.backbone` picks the backbone: "caffenet" (the
default; 4,096 features, params under "mednet") or "googlenet" (BVLC's
widths, 1,024 features, params under "googlenet"). The tower's input
width is the backbone's.

Top-k breaks ties as lax.top_k does, lower gallery index first, through a
stable descending sort.

On the card a query is one CUDA graph replay once its inputs repeat: a
call with the `query_graph_key` of the last query run eagerly captures
the whole query (while no profiler records), and every later call with
that key copies its frames, offsets and mirrors into the graph's
buffers, replays it and returns copies of its outputs. The graph reads
the params and the gallery where they lie, so updates made to them in
place are seen. It runs the same kernels in the same order as the eager
query, so the answers are the same bits. A pipeline keeps one graph, the
newest key's; any other call (the CPU, `device.plain_versions()`, host
offsets, a new gallery, params or batch size) runs eagerly.

Under a profiler each stage is a span (utils/timer.py): `vvtpu.query`
(its request id the pipeline's count of queries) around the call, and
`vvtpu.query.transform`, `.mednet` (`.googlenet` for that backbone),
`.tower`, `.scores` and `.topk`, or
`vvtpu.query.replay` around a replay, which also adds 1 to the counter
`vvtpu.query.graph_replays` and again what the captured query counted
(`vvtpu.cast_bytes`).

`features` holds the backbone's (N, D) f32 features of the last frames
embedded; after a replay it is the graph's own buffer, which the next
replay overwrites.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from videovector_tpu_torch.convert import leaves_with_paths, map_params
from videovector_tpu_torch.data.transformer import (
    TransformConfig, make_batch_transform,
)
from videovector_tpu_torch.device import DEFAULT, resolve, runs_kernel
from videovector_tpu_torch.models.embedding import (
    VideoEmbeddingConfig, VideoEmbeddingModel,
)
from videovector_tpu_torch.models.googlenet import GoogLeNet, GoogLeNetConfig
from videovector_tpu_torch.models.mednet import MedNet, MedNetConfig
from videovector_tpu_torch.ops.linear import no_tf32
from videovector_tpu_torch.ops.normalization import l2_normalize_rows
from videovector_tpu_torch.utils.timer import count, span, tally


@dataclass
class RetrievalPipelineConfig:
    image_hw: tuple = (256, 256)
    crop: int = 227
    embed_dim: int = 4096
    top_k: int = 5
    compute_dtype: str = "bfloat16"
    # "NHWC": frames in decode order (H, W, C); "NCHW" accepts Caffe blobs
    pixels_layout: str = "NHWC"
    # "caffenet" or "googlenet"
    backbone: str = "caffenet"


def top_k_stable(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest per row; among equal scores the
    lower index comes first (lax.top_k's order, which torch.topk does not
    promise)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def query_graph_key(params, pixels_u8, h_off, w_off, mirror, gallery,
                    gallery_ids) -> tuple:
    """What a captured query is valid for: the per-query inputs' shapes,
    dtypes and strides, and the address, shape, strides and dtype of every
    tensor the graph reads where it lies (each leaf of `params`, by its
    path, the gallery and its ids)."""
    def layout(t):
        return t.shape, t.stride(), t.dtype

    resident = list(leaves_with_paths(params))
    resident += [("gallery", gallery), ("gallery_ids", gallery_ids)]
    return (tuple(layout(t) for t in (pixels_u8, h_off, w_off, mirror)),
            tuple((path, t.data_ptr(), *layout(t)) for path, t in resident))


class _QueryGraph:
    """One query captured in a CUDA graph: its key, the buffers its
    per-query inputs are copied into, its outputs, and what `count` added
    while it was captured."""

    def __init__(self, key, run, inputs):
        self.key = key
        self.inputs = [t.clone() for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        with tally() as self.counts, torch.cuda.graph(self.graph):
            self.outputs = run(*self.inputs)

    def replay(self, inputs):
        with span("vvtpu.query.replay"):
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
            self.graph.replay()
            count("vvtpu.query.graph_replays", 1)
            for name, n in self.counts.items():
                count(name, n)
            # copies, so that a later replay does not overwrite this answer
            return tuple(t.clone() for t in self.outputs)


class RetrievalPipeline:
    def __init__(self, cfg: RetrievalPipelineConfig = RetrievalPipelineConfig(),
                 *, mean: np.ndarray | None = None, device=DEFAULT):
        """Runs on the card unless `device` asks for the CPU; without a card
        a CUDA device raises here."""
        self.cfg = cfg
        self.device = resolve(device)
        # backbone_key: the attribute that holds the backbone, and its
        # params' key
        if cfg.backbone == "caffenet":
            self.backbone_key = "mednet"
            self.mednet = MedNet(MedNetConfig(
                input_hw=(cfg.crop, cfg.crop), fc7=4096,
                compute_dtype=cfg.compute_dtype))
            feature_dim = 4096
        elif cfg.backbone == "googlenet":
            self.backbone_key = "googlenet"
            self.googlenet = GoogLeNet(GoogLeNetConfig(
                compute_dtype=cfg.compute_dtype))
            feature_dim = self.googlenet.cfg.feature_dim
        else:
            raise ValueError("backbone must be 'caffenet' or 'googlenet', "
                             f"got {cfg.backbone!r}")
        self.embedder = VideoEmbeddingModel(VideoEmbeddingConfig(
            feature_dim=feature_dim, embed_dim=cfg.embed_dim,
            compute_dtype=cfg.compute_dtype, dropout_rate=0.0))
        self.transform = make_batch_transform(
            TransformConfig(crop_size=cfg.crop), mean, cfg.image_hw,
            layout=cfg.pixels_layout, device=self.device)
        self.queries = 0    # the request id of the `vvtpu.query` spans
        self._graph = None      # the captured query (_QueryGraph)
        self._last_key = None   # the key of the last query run eagerly
        self.features = None    # the last frames' features (docstring)

    @property
    def backbone(self):
        """The backbone model: `self.mednet` or `self.googlenet`."""
        return getattr(self, self.backbone_key)

    def init(self, generator: torch.Generator):
        """Random params from `generator`, placed on the pipeline's device."""
        params = {self.backbone_key: self.backbone.init(generator),
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
        key = self.backbone_key
        with span("vvtpu.query." + key):
            feats = self.backbone.forward(params[key], x)     # (N, D) f32
            self.features = feats
        with span("vvtpu.query.tower"):
            emb = self.embedder.embed({"tower": params["tower"]}, feats)
            return l2_normalize_rows(emb)

    @torch.no_grad()
    def query(self, params, pixels_u8, h_off, w_off, mirror, gallery,
              gallery_ids):
        """Frames -> embeddings -> scores vs the gallery -> (top-k ids,
        top-k scores). gallery: (G, E) unit rows on the device. On the card
        a call whose key repeats replays a CUDA graph (module docstring)."""
        self.queries += 1
        inputs = (pixels_u8, h_off, w_off, mirror)
        with span("vvtpu.query", req=self.queries):
            graph = self._graph_for(params, inputs, gallery, gallery_ids)
            if graph is not None:
                out = graph.replay(inputs)
                self.features = graph.features
                return out
            return self._query(params, *inputs, gallery, gallery_ids)

    def _query(self, params, pixels_u8, h_off, w_off, mirror, gallery,
               gallery_ids):
        emb = self.embed_frames(params, pixels_u8, h_off, w_off, mirror)
        # f32 scores, as JAX's; they decide the top-k
        with span("vvtpu.query.scores"), no_tf32():
            scores = torch.matmul(emb, gallery.T)
        with span("vvtpu.query.topk"):
            top_scores, top_idx = top_k_stable(scores, self.cfg.top_k)
            return gallery_ids[top_idx], top_scores

    def _graph_for(self, params, inputs, gallery, gallery_ids):
        """The captured query to replay for this call, captured here if
        the last query run eagerly had its key and no profiler records;
        None to run this one eagerly (so inside `device.plain_versions()`).
        """
        if self.device.type != "cuda" or not all(
                isinstance(t, torch.Tensor) and runs_kernel(t)
                for t in inputs):
            return None
        key = query_graph_key(params, *inputs, gallery, gallery_ids)
        if self._graph is not None and self._graph.key == key:
            return self._graph
        if (key != self._last_key
                or torch.autograd.profiler._is_profiler_enabled):
            self._last_key = key
            return None
        self._graph = None              # the old graph's memory goes first
        # so that a later profiler sees the graph's kernels by name
        from torch.profiler._utils import _init_for_cuda_graphs
        _init_for_cuda_graphs()

        def run(*captured):
            return self._query(params, *captured, gallery, gallery_ids)
        with torch.cuda.device(self.device):
            self._graph = _QueryGraph(key, run, inputs)
        self._graph.features = self.features   # the graph's buffer
        return self._graph

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
