"""Video-shot datasets and the sampling data sources; counterpart of
videovector_tpu/data/shots.py, a copy of it.

The reference's four video data layers
(ref:src/caffe/layers/video_sampled_shots_data_layer.cpp,
video_shots_data_layer.cpp, video_shot_window_data_layer.cpp,
video_shot_window_test_data_layer.cpp, fixed_video_shot_test_data_layer.cpp)
as host-side batch sources of numpy arrays. The code draws from numpy's
RandomState in the JAX package's order, so a source gives the JAX package's
batches bit for bit for the same seed and dataset.

Sampling semantics are the reference's (reservoir with swap-percentage and
"video:shot" key dedup, context modes, same-video negative rules, skip
conditions, stateful exhaustive cursors); the RNG is numpy (statistical
parity with the reference, which uses libc rand()).

Layout contract (the reference's channel layout, so the same prototxts
slice correctly):
  sampled/train  : data (B, context_size + num_negatives, D)  with
                   channel 0 = target, 1..context_size-1 = contexts,
                   rest = negatives (context_size counts the target,
                   ref video_sampled_shots_data_layer.cpp:410-415)
  exhaustive     : data (B, 1 + context_size + num_negatives, D)
  test windows   : data (B, context + positives + negatives, D), video_ids
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from videovector_tpu_torch.data.records import RecordWriter, open_store
from videovector_tpu_torch.data.wire import TestVideoShotWindows, VideoShots, Datum


# ---------------------------------------------------------------------------
# Dataset containers
# ---------------------------------------------------------------------------

@dataclass
class ShotVideo:
    video_id: int
    shot_ids: np.ndarray          # (S,) int32
    features: np.ndarray          # (S, D) float32
    video_name: str = ""

    @property
    def num_shots(self) -> int:
        return len(self.shot_ids)


class ShotDataset:
    """Ordered collection of ShotVideo — the analogue of a VideoShots LMDB."""

    def __init__(self, videos: list[ShotVideo]):
        if not videos:
            raise ValueError("empty dataset")
        self.videos = videos
        self.feature_dim = videos[0].features.shape[1]

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i) -> ShotVideo:
        return self.videos[i]

    # -- VVR round-trip (VideoShots wire protos as record values) ---------
    @classmethod
    def from_records(cls, path: str) -> "ShotDataset":
        reader = open_store(path)
        videos = []
        for _, value in reader:
            msg = VideoShots.decode(bytes(value))
            feats = np.stack([np.asarray(d.float_data, np.float32)
                              for d in msg.shot_words])
            sids = np.asarray(msg.shot_ids if msg.shot_ids
                              else range(len(msg.shot_words)), np.int32)
            videos.append(ShotVideo(msg.video_id, sids, feats, msg.video_name))
        reader.close()
        return cls(videos)

    def to_records(self, path: str) -> None:
        with RecordWriter(path) as w:
            for i, v in enumerate(self.videos):
                msg = VideoShots(
                    video_id=int(v.video_id),
                    shot_ids=[int(s) for s in v.shot_ids],
                    shot_words=[Datum(height=self.feature_dim, width=1,
                                      channels=1, float_data=f)
                                for f in v.features],
                    video_name=v.video_name)
                w.append(f"{i:08d}", msg.encode())


# ---------------------------------------------------------------------------
# Negative reservoir
# ---------------------------------------------------------------------------

class NegativeReservoir:
    """In-memory negative-sample buffer with probabilistic replacement.

    ref:src/caffe/layers/video_sampled_shots_data_layer.cpp:24-44 (AddToBuffer
    + Fisher-Yates top-n sampling) and :245-341 (initial fill: cycle the
    dataset, one random shot per video, dedup by "video:shot" key, until
    max_buffer_size entries)."""

    def __init__(self, max_size: int, feature_dim: int, swap_percentage: int,
                 rng: np.random.RandomState):
        if not (0 <= swap_percentage <= 99):
            raise ValueError("swap percentage must be in [0, 99]")
        self.max_size = max_size
        self.swap_percentage = swap_percentage
        self.rng = rng
        self.buffer = np.zeros((max_size, feature_dim), np.float32)
        self.keys: list[str] = []
        self.key_set: set[str] = set()

    def fill(self, dataset: ShotDataset, *, max_tries_factor: int = 100,
             all_shots: bool = False) -> None:
        """all_shots=True mirrors the separate-negative-dataset path (every
        shot of each record); False samples one random shot per video."""
        added = 0
        n = len(dataset)
        for attempt in range(max_tries_factor * self.max_size):
            video = dataset[attempt % n]
            if all_shots:
                picks = range(video.num_shots)
            else:
                picks = [self.rng.randint(video.num_shots)]
            for s in picks:
                key = f"{video.video_id}:{video.shot_ids[s]}"
                if key in self.key_set:
                    continue
                self.buffer[added] = video.features[s]
                self.keys.append(key)
                self.key_set.add(key)
                added += 1
                if added >= self.max_size:
                    return
        raise RuntimeError("could not fill negative reservoir (too few "
                           "distinct shots)")

    def maybe_add(self, key: str, feat: np.ndarray) -> None:
        """After a video is consumed, each of its shots is offered; with
        probability swap%/100 a random slot is replaced (skip if the key is
        already present) — ref :885-905."""
        if key in self.key_set:
            return
        if self.rng.randint(100) < self.swap_percentage:
            slot = self.rng.randint(self.max_size)
            old = self.keys[slot]
            self.key_set.discard(old)
            self.buffer[slot] = feat
            self.keys[slot] = key
            self.key_set.add(key)

    def offer_video(self, video: ShotVideo) -> None:
        if self.swap_percentage <= 0:
            return
        for s in range(video.num_shots):
            self.maybe_add(f"{video.video_id}:{video.shot_ids[s]}",
                           video.features[s])

    def sample(self, n: int) -> np.ndarray:
        """n distinct random buffer rows (Fisher-Yates top-n,
        ref RandomShuffleTopids :41-44)."""
        ids = self.rng.choice(self.max_size, size=n, replace=False)
        return self.buffer[ids]


# ---------------------------------------------------------------------------
# Flagship TRAIN source: VideoSampledShotsDataLayer
# ---------------------------------------------------------------------------

@dataclass
class SampledShotsConfig:
    """Mirror of VideoSampledShotsDataParameter (ref caffe.proto:560-620)."""
    batch_size: int = 128
    num_negative_samples: int = 0
    max_buffer_size: int = 0
    negative_swap_percentage: int = 0
    max_same_video_negs: int = 0
    context_type: str = "PAIRWISE"   # PAIRWISE | WINDOW | PAST |
    #                                  PAST_CONTINUOUS | PAST_CONTINUOUS_FIXED
    context_size: int = 1
    output_shot_distance: bool = False
    max_shot_distance: float = 5.0
    output_video_ids: bool = True
    rand_skip: int = 0
    seed: int = 1234

    @classmethod
    def from_message(cls, msg) -> "SampledShotsConfig":
        kw = {}
        for f in ("batch_size", "num_negative_samples", "max_buffer_size",
                  "negative_swap_percentage", "max_same_video_negs",
                  "context_type", "context_size", "output_shot_distance",
                  "max_shot_distance", "rand_skip"):
            if msg.has(f):
                kw[f] = msg.get(f)
        return cls(**kw)


class VideoSampledShotsSource:
    """Stateful batch generator matching VideoSampledShotsDataLayer.

    Emits dict(data=(B, C+N, D) f32[, video_id=(B,) f32]) where C =
    context_size (2 for PAIRWISE; includes the target at channel 0) and N =
    num_negative_samples. Channels C..C+N hold [same-video hard negatives |
    reservoir negatives] (ref AddSamplesToTop :371-765, thread loop :768-909).
    """

    def __init__(self, dataset: ShotDataset, cfg: SampledShotsConfig,
                 negative_dataset: ShotDataset | None = None):
        self.dataset = dataset
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        self.context_size = 2 if cfg.context_type == "PAIRWISE" else cfg.context_size
        if self.context_size < 2:
            raise ValueError("context_size must be >= 2")
        self.feature_dim = dataset.feature_dim
        self.channels = self.context_size + cfg.num_negative_samples
        # async-SGD staggering (ref caffe.proto rand_skip: skip point =
        # rand_skip * rand(0,1))
        self._cursor = (self.rng.randint(cfg.rand_skip) % len(dataset)
                        if cfg.rand_skip else 0)
        self.reservoir = None
        if cfg.num_negative_samples > 0:
            self.reservoir = NegativeReservoir(
                cfg.max_buffer_size, self.feature_dim,
                cfg.negative_swap_percentage, self.rng)
            self.reservoir.fill(negative_dataset or dataset,
                                all_shots=negative_dataset is not None)

    # -- context samplers (one video → one batch item) --------------------
    def _sample_item(self, video: ShotVideo):
        """Returns (roles (C, D), same_video_negs list, video_id) or None to
        skip this video."""
        cfg = self.cfg
        S = video.num_shots
        cs = self.context_size
        if S < 2:
            return None
        feats = video.features
        rng = self.rng
        negs: list[np.ndarray] = []
        # capped by the negative slot count: the reference's loop bound is
        # max_same_video_negs alone (ref:src/caffe/layers/
        # video_sampled_shots_data_layer.cpp:485) and overruns the item's
        # negative channels when max_same_video_negs > num_negative_samples
        max_negs = (min(cfg.max_same_video_negs, cfg.num_negative_samples)
                    if cfg.num_negative_samples > 0 else 0)

        if cfg.context_type == "PAIRWISE":
            i, j = rng.choice(S, size=2, replace=False)
            roles = np.stack([feats[i], feats[j]])
            if cfg.output_shot_distance:
                vid = min(abs(int(i) - int(j)), int(cfg.max_shot_distance))
            else:
                vid = video.video_id
            return roles, negs, vid

        if S < cs:
            return None
        perm = rng.permutation(S)
        if cfg.context_type == "WINDOW":
            if cs % 2 != 1:
                raise ValueError("WINDOW context_size must be odd")
            half = cs // 2
            chosen = np.sort(perm[:cs])
            target = chosen[half]
            ctx = np.concatenate([chosen[:half], chosen[half + 1:]])
            roles = np.concatenate([feats[None, target], feats[ctx]])
            if max_negs:
                lo, hi = chosen[half - 1], chosen[half + 1]
                rest = perm[cs:].copy()
                rng.shuffle(rest)
                for nid in rest:
                    if len(negs) >= max_negs:
                        break
                    if nid < lo or nid > hi:
                        negs.append(feats[nid])
            return roles, negs, video.video_id

        if cfg.context_type == "PAST":
            chosen = np.sort(perm[:cs])
            target = chosen[-1]
            ctx = chosen[:-1]
            roles = np.concatenate([feats[None, target], feats[ctx]])
            if max_negs:
                rest = perm[cs:].copy()
                rng.shuffle(rest)
                for nid in rest:
                    if len(negs) >= max_negs:
                        break
                    # accept only shots strictly before the 2nd chosen id
                    # (ref :568 — `rand_perm_ids[nid] < rand_perm_ids[1]`)
                    if nid < chosen[1]:
                        negs.append(feats[nid])
            return roles, negs, video.video_id

        if cfg.context_type in ("PAST_CONTINUOUS", "PAST_CONTINUOUS_FIXED"):
            max_len = (S - cs) // (cs - 1)
            if cfg.context_type == "PAST_CONTINUOUS":
                stride = rng.randint(max_len + 1)
                begin = rng.randint(S - (cs - 1) * stride - cs + 1)
            else:
                stride = max_len - 1 if max_len >= 1 else 0
                begin = S - (cs - 1) * stride - cs
            idx = begin + np.arange(cs) * (stride + 1)
            target = idx[-1]
            ctx = idx[:-1]
            roles = np.concatenate([feats[None, target], feats[ctx]])
            if max_negs and begin > 0:
                for nid in range(begin - 1, -1, -1):
                    if len(negs) >= max_negs:
                        break
                    negs.append(feats[nid])
            return roles, negs, video.video_id

        raise ValueError(f"Unknown context type {cfg.context_type!r}")

    # -- batch assembly ----------------------------------------------------
    def next_batch(self) -> dict:
        cfg = self.cfg
        B = cfg.batch_size
        data = np.zeros((B, self.channels, self.feature_dim), np.float32)
        vids = np.zeros((B,), np.float32)
        item = 0
        skipped = 0  # full dataset pass with zero yields → error, not hang
        while item < B:
            video = self.dataset[self._cursor]
            self._cursor = (self._cursor + 1) % len(self.dataset)
            out = self._sample_item(video)
            if out is None:
                skipped += 1
                if skipped >= len(self.dataset):
                    raise ValueError(
                        f"no video in the dataset can yield an item under "
                        f"this config (context_type={cfg.context_type!r}, "
                        f"context_size={cfg.context_size}) — every video "
                        f"was skipped; the reference CHECK-fails instead "
                        f"of looping")
                continue
            skipped = 0
            roles, negs, vid = out
            data[item, :self.context_size] = roles
            if cfg.num_negative_samples > 0:
                for k, nf in enumerate(negs):
                    data[item, self.context_size + k] = nf
                n_rest = cfg.num_negative_samples - len(negs)
                if n_rest > 0:
                    data[item, self.context_size + len(negs):] = \
                        self.reservoir.sample(n_rest)
            vids[item] = vid
            item += 1
            # offer this video's shots to the reservoir (ref :885-905)
            if cfg.num_negative_samples > 0:
                self.reservoir.offer_video(video)
        batch = {"data": data}
        if cfg.output_video_ids:
            batch["video_id"] = vids
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# Exhaustive TRAIN source: VideoShotsDataLayer
# ---------------------------------------------------------------------------

@dataclass
class ExhaustiveShotsConfig:
    """Mirror of VideoShotsDataParameter (ref caffe.proto:623-679)."""
    batch_size: int = 128
    num_negative_samples: int = 0
    max_buffer_size: int = 0
    negative_swap_percentage: int = 0
    max_same_video_negs: int = 0
    context_type: str = "PAIRWISE"   # PAIRWISE | WINDOW | PAST
    context_size: int = 1
    output_shot_distance: bool = False
    max_shot_distance: float = 5.0
    output_video_ids: bool = True
    seed: int = 1234


class VideoShotsSource:
    """Stateful exhaustive context generator matching VideoShotsDataLayer
    (ref:src/caffe/layers/video_shots_data_layer.cpp:377-520): iterates ALL
    ordered shot pairs (PAIRWISE) or all sliding windows (WINDOW, even
    context_size, zero-padding + flag-in-last-feature at borders; PAST
    analogous) with target/context cursors persisted across batches.

    Channel layout: [target, context×C, negatives×N] — note unlike the
    sampled layer, C here EXCLUDES the target (channels = 1 + C + N).
    """

    def __init__(self, dataset: ShotDataset, cfg: ExhaustiveShotsConfig,
                 negative_dataset: ShotDataset | None = None):
        self.dataset = dataset
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        self.feature_dim = dataset.feature_dim
        if cfg.context_type == "PAIRWISE":
            self.context_channels = 1
        else:
            if cfg.context_type == "WINDOW" and cfg.context_size % 2 != 0:
                raise ValueError("WINDOW context_size must be even here")
            self.context_channels = cfg.context_size
        self.channels = 1 + self.context_channels + cfg.num_negative_samples
        self._video_idx = 0
        self._target_ctr = 0
        self._context_ctr = 0
        self.reservoir = None
        if cfg.num_negative_samples > 0:
            self.reservoir = NegativeReservoir(
                cfg.max_buffer_size, self.feature_dim,
                cfg.negative_swap_percentage, self.rng)
            self.reservoir.fill(negative_dataset or dataset,
                                all_shots=negative_dataset is not None)

    def _advance_video(self):
        if self.reservoir is not None:
            self.reservoir.offer_video(self.dataset[self._video_idx])
        self._video_idx = (self._video_idx + 1) % len(self.dataset)
        self._target_ctr = 0
        self._context_ctr = 0

    def _emit_negatives(self, data, item, video, exclude_idx):
        cfg = self.cfg
        if cfg.num_negative_samples <= 0:
            return
        added = 0
        # same num_negative_samples cap as the sampled source (the
        # reference overruns its negative slots here, see _sample_item)
        same_cap = min(cfg.max_same_video_negs, cfg.num_negative_samples)
        if same_cap > 0:
            order = self.rng.permutation(video.num_shots)
            for nid in order:
                if added >= same_cap:
                    break
                if nid == exclude_idx:
                    continue
                data[item, 1 + self.context_channels + added] = video.features[nid]
                added += 1
        n_rest = cfg.num_negative_samples - added
        if n_rest > 0:
            data[item, 1 + self.context_channels + added:] = \
                self.reservoir.sample(n_rest)

    def next_batch(self) -> dict:
        cfg = self.cfg
        B = cfg.batch_size
        D = self.feature_dim
        data = np.zeros((B, self.channels, D), np.float32)
        vids = np.zeros((B,), np.float32)
        item = 0
        skipped = 0  # full dataset pass with zero yields → error, not hang
        while item < B:
            video = self.dataset[self._video_idx]
            feats = video.features
            S = video.num_shots
            if S < 2:
                skipped += 1
                if skipped >= len(self.dataset):
                    raise ValueError(
                        "no video in the dataset has >= 2 shots — the "
                        "exhaustive source cannot yield any item (the "
                        "reference CHECK-fails instead of looping)")
                self._advance_video()
                continue
            skipped = 0

            if cfg.context_type == "PAIRWISE":
                # normalize the (target, context) cursor to the next valid
                # ordered pair (i, j), i ≠ j, row-major
                i, j = self._target_ctr, self._context_ctr
                while i < S and (j >= S or i == j):
                    if j >= S:
                        i, j = i + 1, 0
                    else:
                        j += 1
                if i >= S:
                    self._advance_video()
                    continue
                data[item, 0] = feats[i]
                data[item, 1] = feats[j]
                if cfg.output_shot_distance:
                    vids[item] = min(abs(i - j), int(cfg.max_shot_distance))
                else:
                    vids[item] = video.video_id
                self._emit_negatives(data, item, video, i)
                item += 1
                self._target_ctr, self._context_ctr = i, j + 1
                continue

            # WINDOW / PAST: one item per target shot
            i = self._target_ctr
            if i >= S:
                self._advance_video()
                continue
            data[item, 0] = feats[i]
            half = cfg.context_size // 2
            if cfg.context_type == "WINDOW":
                js = [j for j in range(i - half, i + half + 1) if j != i]
            elif cfg.context_type == "PAST":
                js = list(range(i - cfg.context_size, i))
            else:
                raise ValueError(f"Unknown context type {cfg.context_type!r}")
            for c, j in enumerate(js):
                if 0 <= j < S:
                    data[item, 1 + c] = feats[j]
                else:
                    # border padding: zeros + flag 1 in the last feature
                    # (ref video_shots_data_layer.cpp:487-493)
                    data[item, 1 + c, :] = 0
                    data[item, 1 + c, D - 1] = 1
            vids[item] = video.video_id
            self._emit_negatives(data, item, video, i)
            item += 1
            self._target_ctr += 1
            if self._target_ctr >= S:
                self._advance_video()

        batch = {"data": data}
        if cfg.output_video_ids:
            batch["video_id"] = vids
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# TEST sources
# ---------------------------------------------------------------------------

class TestWindowDataset:
    """TestVideoShotWindows records (context + positives + negatives per
    window) — eager in-memory load."""

    def __init__(self, windows: list[TestVideoShotWindows]):
        if not windows:
            raise ValueError("empty test window dataset")
        self.windows = windows
        w0 = windows[0]
        self.feature_dim = len(w0.context_shot_words[0].float_data)
        self.context_size = len(w0.context_shot_words)
        self.positive_size = len(w0.positive_shot_words)
        self.negative_size = len(w0.negative_shot_words)

    @classmethod
    def from_records(cls, path: str) -> "TestWindowDataset":
        reader = open_store(path)
        windows = [TestVideoShotWindows.decode(bytes(v)) for _, v in reader]
        reader.close()
        return cls(windows)


class VideoShotWindowTestSource:
    """Batch generator matching VideoShotWindowTestDataLayer
    (ref:src/caffe/layers/video_shot_window_test_data_layer.cpp:40-265):
    channel layout [context | positives | negatives] (each section optional
    via include flags), second top = video_id."""

    def __init__(self, dataset: TestWindowDataset, batch_size: int, *,
                 include_positives: bool = True, include_negatives: bool = True,
                 display_all_ids: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.include_positives = include_positives
        self.include_negatives = include_negatives
        self.display_all_ids = display_all_ids
        self.positive_size = dataset.positive_size if include_positives else 0
        self.negative_size = dataset.negative_size if include_negatives else 0
        self.channels = (dataset.context_size + self.positive_size
                         + self.negative_size)
        self._cursor = 0

    def next_batch(self) -> dict:
        ds = self.dataset
        B = self.batch_size
        data = np.zeros((B, self.channels, ds.feature_dim), np.float32)
        vids = np.zeros((B,), np.float32)
        for item in range(B):
            w = ds.windows[self._cursor]
            self._cursor = (self._cursor + 1) % len(ds.windows)
            c = 0
            for d in w.context_shot_words:
                data[item, c] = np.asarray(d.float_data, np.float32)
                c += 1
            if self.include_positives:
                for d in w.positive_shot_words:
                    data[item, c] = np.asarray(d.float_data, np.float32)
                    c += 1
            if self.include_negatives:
                for d in w.negative_shot_words:
                    data[item, c] = np.asarray(d.float_data, np.float32)
                    c += 1
            vids[item] = w.video_id
            if self.display_all_ids:
                # ref video_shot_window_test_data_layer.cpp:235-238
                # (LOG(WARNING); shot column = first positive shot id)
                from videovector_tpu_torch.utils.logging import get_logger
                pid = (w.positive_shot_id[0]
                       if getattr(w, "positive_shot_id", None) else 0)
                get_logger(__name__).warning(
                    "Item-id:Video-id:Shot-id:%d:%d:%d",
                    item, w.video_id, pid)
        return {"data": data, "video_ids": vids}

    def __iter__(self):
        while True:
            yield self.next_batch()


class FixedVideoShotGallery:
    """Eagerly-loaded fixed retrieval gallery
    (ref:src/caffe/layers/fixed_video_shot_test_data_layer.cpp:10-140):
    positives labeled by their video_id, negatives labeled −1; Forward is a
    constant — here simply two arrays."""

    def __init__(self, features: np.ndarray, video_ids: np.ndarray):
        self.features = np.asarray(features, np.float32)
        self.video_ids = np.asarray(video_ids, np.float32)

    @classmethod
    def from_records(cls, path: str) -> "FixedVideoShotGallery":
        reader = open_store(path)
        feats, vids = [], []
        for _, value in reader:
            w = TestVideoShotWindows.decode(bytes(value))
            for d in w.positive_shot_words:
                feats.append(np.asarray(d.float_data, np.float32))
                vids.append(w.video_id)
            for d in w.negative_shot_words:
                feats.append(np.asarray(d.float_data, np.float32))
                vids.append(-1)
        reader.close()
        return cls(np.stack(feats), np.asarray(vids))

    def batch(self) -> dict:
        return {"data": self.features, "video_ids": self.video_ids}
