"""Data-source factory: host batch sources from data-layer configs;
counterpart of videovector_tpu/graph/data_factory.py.

The reference's data layers construct themselves from LayerParameter inside
Net::Init (ref:src/caffe/layer_factory.cpp:177-309 dispatch; per-layer params
ref:src/caffe/proto/caffe.proto:497-688,1010-1041). Here the Net treats their
tops as inputs and this factory builds the matching host-side source from
the same LayerParameter message, renaming source fields to the layer's top
names so that batches slot straight into `Net.apply`.

Every data layer of the JAX package's factory is built here: the
flagship's VIDEO_SAMPLED_SHOTS_DATA (the C++ sampler for a VVR WINDOW
source, as the JAX package chooses, else the Python one: an LMDB or
LevelDB store feeds the Python sampler; with `device_negatives: true`
the Python one without negatives, the reservoir living on the card) and
VIDEO_SHOT_WINDOW_TEST_DATA;
the exhaustive TRAIN source VIDEO_SHOTS_DATA and the fixed gallery
FIXED_VIDEO_SHOT_TEST_DATA; the reference's window trainer
VIDEO_SHOT_WINDOW_DATA (and its VIDEO_ID_TEXT backend); the image sources
DATA, IMAGE_DATA, WINDOW_DATA and FLEXIBLE_DATA, with their
transform_param and mean file; HDF5_DATA; the trajectory workload's
TRACKING_WINDOWS_DATA and TRACKING_WINDOWS_SOCIAL_DATA (time-major
batches, their `batch_axes` declared). Stores open by content (VVR, LMDB
or LevelDB). MEMORY_DATA is fed by its caller, as in the JAX package, and
has no factory.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np

from videovector_tpu_torch.config.textformat import Message
from videovector_tpu_torch.data import native
from videovector_tpu_torch.data.generic import (
    DatumRecordSource, FlexibleDataConfig, FlexibleDataSource, HDF5Source,
    ImageDataConfig, ImageDataSource, VideoIdTextSource, VideoShotWindowSource,
    WindowDataConfig, WindowDataSource,
)
from videovector_tpu_torch.data.records import convert_dir_or_file, is_vvr
from videovector_tpu_torch.data.shots import (
    ExhaustiveShotsConfig, FixedVideoShotGallery, NegativeReservoir,
    SampledShotsConfig,
    ShotDataset, TestWindowDataset, VideoSampledShotsSource, VideoShotsSource,
    VideoShotWindowTestSource,
)
from videovector_tpu_torch.data.tracking import (
    TrackingConfig, TrackingWindowDataset, TrackingWindowsSocialSource,
    TrackingWindowsSource,
)
from videovector_tpu_torch.data.transformer import TransformConfig
from videovector_tpu_torch.data.wire import BlobProto

class _RenamingSource:
    """Wrap a source whose dict keys are positional; rename to top names."""

    def __init__(self, source, field_order: list[str], tops: list[str]):
        self.source = source
        self.mapping = dict(zip(field_order, tops))

    def next_batch(self):
        batch = self.source.next_batch()
        return {self.mapping[k]: v for k, v in batch.items()
                if k in self.mapping}

    def batch_axes(self) -> dict:
        """top name -> batch axis (the axis a grad_microbatch split cuts).
        0 unless the source declares a `batch_axes` attribute keyed by
        canonical field names."""
        src_axes = getattr(self.source, "batch_axes", {})
        return {top: src_axes.get(canon, 0)
                for canon, top in self.mapping.items()}

    def __iter__(self):
        while True:
            yield self.next_batch()


def _transform_cfg(layer: Message) -> TransformConfig:
    return TransformConfig.from_message(layer.get_msg("transform_param"))


def _load_mean(layer: Message) -> np.ndarray | None:
    """transform_param's mean_file, a BlobProto (1, C, H, W), as (C, H, W)."""
    path = layer.get_msg("transform_param").get("mean_file")
    if not path:
        return None
    with open(path, "rb") as f:
        return BlobProto.decode(f.read()).to_array()[0]


def make_data_source(layer: Message, *, phase: str = "TRAIN", seed: int = 1234):
    """layer: a data-layer LayerParameter Message. Returns an iterator of
    batches (numpy arrays) keyed by the layer's top names. `seed`: the
    JAX SolverDriver passes the solver's random_seed, or 1234 when it is
    -1."""
    ltype = layer.get("type")
    tops = [str(t) for t in layer.get_list("top")]
    train = phase == "TRAIN"

    if ltype == "VIDEO_SAMPLED_SHOTS_DATA":
        p = layer.get_msg("video_sampled_shots_data_param")
        cfg = SampledShotsConfig.from_message(p)
        cfg.seed = seed
        cfg.output_video_ids = len(tops) > 1
        if p.get("device_negatives"):
            return _device_negatives_source(p, cfg, tops, seed)
        # the C++ sampler (WINDOW mode, no separate negative dataset, VVR
        # store) with its own prefetch thread, as the JAX package's factory
        # chooses it; VVTPU_NATIVE_DATA=0 disables
        if (cfg.context_type == "WINDOW" and not p.get("negative_dataset")
                and is_vvr(p.get("source"))
                and os.environ.get("VVTPU_NATIVE_DATA", "1") != "0"
                and native.available()):
            src = native.NativeSampledShotsSource(
                convert_dir_or_file(p.get("source")),
                batch_size=cfg.batch_size,
                context_size=cfg.context_size,
                num_negative_samples=cfg.num_negative_samples,
                max_buffer_size=cfg.max_buffer_size,
                negative_swap_percentage=cfg.negative_swap_percentage,
                max_same_video_negs=cfg.max_same_video_negs, seed=seed)
            return _RenamingSource(src, ["data", "video_id"], tops)
        ds = ShotDataset.from_records(convert_dir_or_file(p.get("source")))
        neg = p.get("negative_dataset")
        neg_ds = ShotDataset.from_records(convert_dir_or_file(neg)) if neg else None
        src = VideoSampledShotsSource(ds, cfg, neg_ds)
        return _RenamingSource(src, ["data", "video_id"], tops)

    if ltype == "VIDEO_SHOTS_DATA":
        p = layer.get_msg("video_shots_data_param")
        kw = {f: p.get(f) for f in (
            "batch_size", "num_negative_samples", "max_buffer_size",
            "negative_swap_percentage", "max_same_video_negs", "context_type",
            "context_size", "output_shot_distance", "max_shot_distance")
            if p.has(f)}
        cfg = ExhaustiveShotsConfig(seed=seed, output_video_ids=len(tops) > 1,
                                    **kw)
        ds = ShotDataset.from_records(convert_dir_or_file(p.get("source")))
        return _RenamingSource(VideoShotsSource(ds, cfg), ["data", "video_id"],
                               tops)

    if ltype == "VIDEO_SHOT_WINDOW_DATA":
        p = layer.get_msg("video_shot_window_data_param")
        if p.get("backend") == "VIDEO_ID_TEXT":
            src = VideoIdTextSource(p.get("source"),
                                    int(p.get("batch_size", 1)))
            return _RenamingSource(src, ["data"], tops)
        src = VideoShotWindowSource(
            convert_dir_or_file(p.get("source")),
            int(p.get("batch_size", 1)),
            num_negative_samples=int(p.get("num_negative_samples", 0)),
            max_buffer_size=int(p.get("max_buffer_size", 0)),
            negative_swap_percentage=int(p.get("negative_swap_percentage", 0)),
            negative_path=p.get("negative_dataset") or None, seed=seed,
            display_all_ids=bool(p.get("display_all_ids", False)))
        return _RenamingSource(src, ["data", "video_id"], tops)

    if ltype == "VIDEO_SHOT_WINDOW_TEST_DATA":
        p = layer.get_msg("video_shot_window_test_data_param")
        ds = TestWindowDataset.from_records(convert_dir_or_file(p.get("source")))
        src = VideoShotWindowTestSource(
            ds, int(p.get("batch_size", 1)),
            include_positives=bool(p.get("include_positives", True)),
            include_negatives=bool(p.get("include_negatives", True)),
            display_all_ids=bool(p.get("display_all_ids", False)))
        return _RenamingSource(src, ["data", "video_ids"], tops)

    if ltype == "FIXED_VIDEO_SHOT_TEST_DATA":
        p = layer.get_msg("fixed_video_shot_test_data_param")
        gallery = FixedVideoShotGallery.from_records(
            convert_dir_or_file(p.get("source")))
        return _RenamingSource(_ConstantSource(gallery.batch()),
                               ["data", "video_ids"], tops)

    if ltype == "DATA":
        p = layer.get_msg("data_param")
        src = DatumRecordSource(
            convert_dir_or_file(p.get("source")), int(p.get("batch_size", 1)),
            transform=_transform_cfg(layer), mean=_load_mean(layer),
            train=train, rand_skip=int(p.get("rand_skip", 0)), seed=seed)
        return _RenamingSource(src, ["data", "label"], tops)

    if ltype == "IMAGE_DATA":
        p = layer.get_msg("image_data_param")
        cfg = ImageDataConfig(
            source=p.get("source"), batch_size=int(p.get("batch_size", 1)),
            new_height=int(p.get("new_height", 0)),
            new_width=int(p.get("new_width", 0)),
            shuffle=bool(p.get("shuffle", False)),
            rand_skip=int(p.get("rand_skip", 0)))
        src = ImageDataSource(cfg, transform=_transform_cfg(layer),
                              mean=_load_mean(layer), train=train, seed=seed)
        return _RenamingSource(src, ["data", "label"], tops)

    if ltype == "WINDOW_DATA":
        p = layer.get_msg("window_data_param")
        t = layer.get_msg("transform_param")
        cfg = WindowDataConfig(
            source=p.get("source"), batch_size=int(p.get("batch_size", 32)),
            fg_threshold=float(p.get("fg_threshold", 0.5)),
            bg_threshold=float(p.get("bg_threshold", 0.5)),
            fg_fraction=float(p.get("fg_fraction", 0.25)),
            context_pad=int(p.get("context_pad", 0)),
            crop_mode=str(p.get("crop_mode", "warp")),
            crop_size=int(t.get("crop_size", 0)),
            mirror=bool(t.get("mirror", False)))  # the proto's default
        if cfg.crop_size <= 0:
            # ref window_data_layer.cpp:153 CHECK_GT(crop_size, 0)
            raise ValueError("WINDOW_DATA requires transform_param "
                             "crop_size > 0")
        src = WindowDataSource(cfg, mean=_load_mean(layer), seed=seed)
        return _RenamingSource(src, ["data", "label"], tops)

    if ltype == "HDF5_DATA":
        p = layer.get_msg("hdf5_data_param")
        src = HDF5Source(p.get("source"), int(p.get("batch_size", 1)))
        return _RenamingSource(src, ["data", "label"], tops)

    if ltype == "FLEXIBLE_DATA":
        p = layer.get_msg("flexible_data_param")
        dp = layer.get_msg("data_param")
        cfg = FlexibleDataConfig(
            source=convert_dir_or_file(dp.get("source")),
            flexible_source=convert_dir_or_file(p.get("flexible_source")),
            flexible_key_suffix=p.get("flexible_key_suffix", ""),
            forward_len=int(p.get("forward_len", 0)),
            backward_len=int(p.get("backward_len", 0)),
            use_center_datum=bool(p.get("use_center_datum", True)),
            batch_size=int(dp.get("batch_size", 8)))
        src = FlexibleDataSource(cfg, transform=_transform_cfg(layer),
                                 mean=_load_mean(layer), train=train, seed=seed)
        return _RenamingSource(src, ["data", "label"], tops)

    if ltype in ("TRACKING_WINDOWS_DATA", "TRACKING_WINDOWS_SOCIAL_DATA"):
        p = layer.get_msg("tracking_windows_data_param")
        cfg = TrackingConfig(
            batch_size=int(p.get("batch_size", 32)),
            temporal_observed_size=int(p.get("temporal_observed_size", 10)),
            temporal_predicted_size=int(p.get("temporal_predicted_size", 20)),
            encoder_bit=bool(p.get("encoder_bit", True)),
            use_static_scene=bool(p.get("use_static_scene", False)),
            track_scale=float(p.get("track_scale", 1.0)),
            max_number_positions=int(p.get("max_number_positions", -1)),
            output_labels=len(tops) >= 5)
        ds = TrackingWindowDataset.from_records(
            convert_dir_or_file(p.get("source")))
        if ltype == "TRACKING_WINDOWS_DATA":
            return _RenamingSource(TrackingWindowsSource(ds, cfg), [
                "observed", "cont_observed", "predicted", "cont_predicted",
                "labels", "scene_ids"], tops)
        return _RenamingSource(TrackingWindowsSocialSource(ds, cfg), [
            "observed", "mean_pos", "predicted", "relations", "is_valid",
            "labels", "scene_ids"], tops)

    raise NotImplementedError(f"no data-source factory for {ltype!r}")


def _device_negatives_source(p: Message, cfg: SampledShotsConfig,
                              tops: list[str], seed: int):
    """The on-device negative sampler's host half (data/device_sampler.py):
    the Python sampler with no negatives, so the host ships only (B, C, D)
    target+context rows, and the seed of the device reservoir, the
    reference's initial fill (one random shot per video, key dedup;
    NegativeReservoir), in `device_negatives["buffer"]`. The driver samples
    and updates the reservoir inside the train step. The C++ sampler does
    not take this path."""
    if cfg.num_negative_samples <= 0 or cfg.max_buffer_size <= 0:
        raise ValueError(
            "device_negatives needs num_negative_samples > 0 and "
            "max_buffer_size > 0")
    if cfg.max_same_video_negs > 0:
        raise ValueError(
            "device_negatives samples ALL negatives from the device "
            "reservoir; same-video hard negatives are a host-path feature: "
            "set max_same_video_negs: 0 or drop device_negatives")
    ds = ShotDataset.from_records(convert_dir_or_file(p.get("source")))
    neg = p.get("negative_dataset")
    neg_ds = ShotDataset.from_records(convert_dir_or_file(neg)) if neg else None
    host_res = NegativeReservoir(cfg.max_buffer_size, ds.feature_dim,
                                 cfg.negative_swap_percentage,
                                 np.random.RandomState(seed))
    host_res.fill(neg_ds or ds, all_shots=neg_ds is not None)
    host_cfg = replace(cfg, num_negative_samples=0, max_same_video_negs=0)
    wrapped = _RenamingSource(VideoSampledShotsSource(ds, host_cfg),
                              ["data", "video_id"], tops)
    wrapped.device_negatives = {
        "top": tops[0],
        "num_negatives": cfg.num_negative_samples,
        "swap_percentage": float(cfg.negative_swap_percentage),
        "buffer": host_res.buffer.copy(),
    }
    return wrapped


class _ConstantSource:
    """The same batch on every call (a fixed gallery's Forward is a
    constant)."""

    def __init__(self, batch: dict):
        self.batch = batch

    def next_batch(self) -> dict:
        return self.batch

    def __iter__(self):
        while True:
            yield self.next_batch()


class MergedSource:
    """Merge several data-layer sources feeding one net (Caffe nets can hold
    multiple data layers per phase)."""

    def __init__(self, sources: list):
        self.sources = sources

    def next_batch(self) -> dict:
        out: dict = {}
        for s in self.sources:
            out.update(s.next_batch())
        return out

    @property
    def device_negatives(self) -> dict | None:
        """The one child source configured with `device_negatives: true`
        (the on-device sampler's wiring), or None. Two such layers in one
        net is a config error: the driver carries ONE device reservoir."""
        found = [s.device_negatives for s in self.sources
                 if getattr(s, "device_negatives", None)]
        if len(found) > 1:
            raise ValueError("at most one data layer may set "
                             "device_negatives")
        return found[0] if found else None

    def batch_axes(self) -> dict:
        out: dict = {}
        for s in self.sources:
            if hasattr(s, "batch_axes"):
                out.update(s.batch_axes())
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()
