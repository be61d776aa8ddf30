"""End-to-end video retrieval — frames in, ranked videos out; counterpart of
videovector_tpu/models/retrieval_pipeline.py.

  uint8 frames (N, H, W, C) on the device
    -> crop/mirror/mean transform       (data/transformer.py)
    -> the backbone: MedNet conv1..fc7  (models/mednet.py: K2 convs, K1 fc)
       or GoogLeNet to pool5            (models/googlenet.py: K2 convs)
       or I3D over whole clips          (models/i3d.py: K2's 2D and depth
                                         routes)
       or TimeSformer over whole clips  (models/timesformer.py: K1 and
                                         the attention kernel)
    -> embedding tower + L2 normalize   (models/embedding.py: K1)
    -> scores vs a device-resident gallery (torch.matmul), top-k

`RetrievalPipelineConfig.backbone` picks the backbone: "caffenet" (the
default; 4,096 features, params under "mednet"), "googlenet" (BVLC's
widths, 1,024 features, params under "googlenet"), "i3d" (1,024
features a clip, params under "i3d", BatchNorm folded) or "timesformer"
(TimeSformer-L, 768 features a clip at the config's crop, params under
"timesformer", linear weights in the compute dtype). The tower's input
width is the backbone's. What else differs the backbone declares
(models/mednet.py::Backbone): the transform's mean and scale (I3D reads
RGB in [-1, 1]: 127.5 unless the caller gives a mean, and 1 / 127.5;
TimeSformer 0.45 and 1 / 0.225 of 255),
whether it reads whole clips, and the features the pipeline keeps. The
frame backbones embed each frame; a clip backbone's call of N T frames
with N crop offsets and mirror flags is N clips of T consecutive frames,
each offset and flag taken by every frame of its clip, and it gives N
embeddings and N rows of top-k.

Top-k breaks ties as lax.top_k does, lower gallery index first: on the
card through the per-row selection kernel (ops/topk.py), which reads the
scores once, elsewhere through a stable descending sort, with the same
bits.

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
`vvtpu.query.transform`, `.mednet` (`.googlenet`, `.i3d` or
`.timesformer` for those backbones), `.tower`, `.scores` and `.topk`, or
`vvtpu.query.replay` around a replay, which also adds 1 to the counter
`vvtpu.query.graph_replays` and again what the captured query counted
(`vvtpu.cast_bytes`).

`features` holds what the backbone's `served_features` keeps of the last
frames embedded, in f32: the (N, D) features a frame backbone gives (for
I3D its head's (N, windows, D), the 2-frame windows of the last map,
whose mean over time the tower reads; for TimeSformer (N, 1 + 64, D), the
final norm's class row, which the tower reads, and its rows of 64 patch
tokens spread over the clip); after a replay it is the graph's
own buffer, which the next replay overwrites.
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
from videovector_tpu_torch.models.i3d import I3D, I3DConfig
from videovector_tpu_torch.models.mednet import MedNet, MedNetConfig
from videovector_tpu_torch.models.timesformer import (
    TimeSformer, TimeSformerConfig,
)
from videovector_tpu_torch.ops.linear import no_tf32
from videovector_tpu_torch.ops.normalization import l2_normalize_rows
from videovector_tpu_torch.ops.topk import top_k_rows
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
    # "caffenet", "googlenet", "i3d" or "timesformer"
    backbone: str = "caffenet"


def top_k_stable(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest per row; among equal scores the
    lower index comes first (lax.top_k's order, which torch.topk does not
    promise). Where `runs_kernel(scores)`, the selection kernel
    (ops/topk.py, up to 32 a row), else `top_k_stable_plain`; the same
    bits either way. The counter `vvtpu.topk.calls` adds each call."""
    count("vvtpu.topk.calls", 1)
    if runs_kernel(scores):
        return top_k_rows(scores, k)
    return top_k_stable_plain(scores, k)


def top_k_stable_plain(scores: torch.Tensor, k: int):
    """`top_k_stable` as a stable descending sort of each whole row."""
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
        elif cfg.backbone == "i3d":
            self.backbone_key = "i3d"
            self.i3d = I3D(I3DConfig(compute_dtype=cfg.compute_dtype))
            feature_dim = self.i3d.cfg.feature_dim
        elif cfg.backbone == "timesformer":
            self.backbone_key = "timesformer"
            self.timesformer = TimeSformer(TimeSformerConfig(
                crop=cfg.crop, compute_dtype=cfg.compute_dtype))
            feature_dim = self.timesformer.cfg.feature_dim
        else:
            raise ValueError("backbone must be 'caffenet', 'googlenet', "
                             f"'i3d' or 'timesformer', got {cfg.backbone!r}")
        self.embedder = VideoEmbeddingModel(VideoEmbeddingConfig(
            feature_dim=feature_dim, embed_dim=cfg.embed_dim,
            compute_dtype=cfg.compute_dtype, dropout_rate=0.0))
        if mean is None and self.backbone.pixel_mean is not None:
            mean = np.full((3, *cfg.image_hw), self.backbone.pixel_mean,
                           np.float32)
        self.transform = make_batch_transform(
            TransformConfig(crop_size=cfg.crop,
                            scale=self.backbone.pixel_scale),
            mean, cfg.image_hw, layout=cfg.pixels_layout, device=self.device)
        self.queries = 0    # the request id of the `vvtpu.query` spans
        self._graph = None      # the captured query (_QueryGraph)
        self._last_key = None   # the key of the last query run eagerly
        self.features = None    # the last frames' features (docstring)

    @property
    def backbone(self):
        """The backbone model: `self.mednet`, `self.googlenet`,
        `self.i3d` or `self.timesformer`."""
        return getattr(self, self.backbone_key)

    def init(self, generator: torch.Generator):
        """Random params from `generator`, placed on the pipeline's device
        (the backbone's `init`: I3D's BatchNorm folded into its convs,
        TimeSformer's linear weights in the compute dtype)."""
        params = {self.backbone_key: self.backbone.init(generator),
                  "tower": self.embedder.init(generator)["tower"]}
        return map_params(lambda t: t.to(self.device), params)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def embed_frames(self, params, pixels_u8, h_off, w_off, mirror):
        """uint8 frames ((N,H,W,C) for pixels_layout NHWC, (N,C,H,W) for
        NCHW) -> (N, E) unit embeddings (f32); for a clip backbone, N T
        frames of N clips with (N,) offsets and flags -> (N, E)."""
        clips = self.backbone.clip_input
        with span("vvtpu.query.transform"):
            if clips:
                h_off, w_off, mirror, t = self._per_frame(
                    pixels_u8, h_off, w_off, mirror)
            x = self.transform(pixels_u8, h_off, w_off, mirror)
            if self.cfg.pixels_layout == "NCHW":
                x = x.permute(0, 2, 3, 1)                      # -> NHWC
            if clips:
                x = x.reshape(-1, t, *x.shape[1:])             # -> NDHWC
        key = self.backbone_key
        with span("vvtpu.query." + key):
            self.features, feats = self.backbone.served_features(
                params[key], x)
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

    def _per_frame(self, pixels_u8, h_off, w_off, mirror):
        """Each clip's crop offsets and mirror flag repeated for its
        frames, and the frames a clip: as many clips as offsets."""
        per = [torch.as_tensor(v, device=self.device).reshape(-1)
               for v in (h_off, w_off, mirror)]
        n = per[0].shape[0]
        if any(v.shape[0] != n for v in per) or n < 1 or (
                pixels_u8.shape[0] % n):
            raise ValueError(
                f"{pixels_u8.shape[0]} frames are not whole clips of the "
                f"offsets and flags {[tuple(v.shape) for v in per]}")
        t = pixels_u8.shape[0] // n
        return (*(v[:, None].expand(n, t).reshape(-1) for v in per), t)

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
        """Average frame (for I3D, clip) embeddings per video ->
        (num_videos, E) unit gallery and its int32 ids (sorted), both on the
        device. frame_batches: iterable of (pixels, h_off, w_off, mirror)
        tuples as `embed_frames` takes them; video_ids_per_batch: the
        matching iterable of id arrays, one id a frame (for I3D, a
        clip)."""
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
