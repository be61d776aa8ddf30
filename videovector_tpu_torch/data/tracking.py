"""Trajectory ("tracking windows") data sources; counterpart of
videovector_tpu/data/tracking.py, a copy of it: the numpy arithmetic is the
JAX package's, so a source gives its batches bit for bit.

ref:src/caffe/layers/tracking_windows_data_layer.cpp and
tracking_windows_social_data_layer.cpp: inputs for the trajectory-forecasting
(social-pooling) workload. Records are TrackingWindow protos: a scene with
several TrackPositions (agent tracks with x/y series and optional static
scene features).

Emission semantics:
- positions scaled by `track_scale` and recentered on the agent's LAST
  OBSERVED position (ref :307-318)
- observed features: [dx, dy(, encoder_bit=0)(, static scene feats tiled over
  time)] with shape (T_obs, B, F)
- predicted-window input: zeros + encoder_bit=1 (or static scene feats),
  shape (T_pred, B, F)
- labels: future (dx, dy), shape (T_pred, B, 2)
- plain variant cont bits: observed cont row 0 is 0 (sequence start), rest 1;
  predicted cont all 1 (state flows from the encoder)
- social variant: packs whole scenes into the batch; emits last-observed
  positions (B, 2), a B x B neighbour matrix (scene blocks, zero diagonal,
  ref social :320-327), and an is_valid mask (B,) for padded slots; scenes
  with more tracks than the batch are skipped (ref social :258-259).

Batches are TIME-MAJOR: sequence tops are (T, B, ...), and each source's
`batch_axes` says so (1 for them, 0 for per-agent tops).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from videovector_tpu_torch.data.records import open_store
from videovector_tpu_torch.data.wire import TrackingWindow


@dataclass
class TrackingConfig:
    """Mirror of TrackingWindowsDataParameter (ref caffe.proto:1010-1041)."""
    batch_size: int = 32
    temporal_observed_size: int = 10
    temporal_predicted_size: int = 20
    encoder_bit: bool = True
    use_static_scene: bool = False
    track_scale: float = 1.0
    max_number_positions: int = -1
    output_labels: bool = True
    output_scene_ids: bool = True


class TrackingWindowDataset:
    def __init__(self, windows: list[TrackingWindow]):
        if not windows:
            raise ValueError("empty tracking dataset")
        self.windows = windows

    @classmethod
    def from_records(cls, path: str) -> "TrackingWindowDataset":
        r = open_store(path)
        windows = [TrackingWindow.decode(bytes(v)) for _, v in r]
        r.close()
        return cls(windows)


class _BaseTrackingSource:
    def __init__(self, dataset: TrackingWindowDataset, cfg: TrackingConfig):
        self.dataset = dataset
        self.cfg = cfg
        feat = 3 if cfg.encoder_bit else 2
        if cfg.use_static_scene:
            scene = dataset.windows[0].track_positions[0].static_scene
            feat += len(scene.float_data)
        self.feature_size = feat
        self._win_idx = 0
        self._track_idx = 0
        self._num_positions = 0  # rolling max_number_positions counter

    def _emit_track(self, tp, out0, out2, labels, scenes, item):
        cfg = self.cfg
        t_obs, t_pred = cfg.temporal_observed_size, cfg.temporal_predicted_size
        x = np.asarray(tp.x, np.float32) * cfg.track_scale
        y = np.asarray(tp.y, np.float32) * cfg.track_scale
        if len(x) < t_obs + t_pred:
            raise ValueError("track shorter than observed+predicted window")
        mean_x, mean_y = x[t_obs - 1], y[t_obs - 1]
        out0[:t_obs, item, 0] = x[:t_obs] - mean_x
        out0[:t_obs, item, 1] = y[:t_obs] - mean_y
        off = 2
        if cfg.encoder_bit:
            out0[:, item, 2] = 0.0
            off = 3
        if cfg.use_static_scene:
            sf = np.asarray(tp.static_scene.float_data, np.float32)
            out0[:, item, off:off + len(sf)] = sf[None, :]
            out2[:, item, off:off + len(sf)] = sf[None, :]
        if cfg.encoder_bit:
            out2[:, item, 2] = 1.0
        if labels is not None:
            labels[:, item, 0] = x[t_obs:t_obs + t_pred] - mean_x
            labels[:, item, 1] = y[t_obs:t_obs + t_pred] - mean_y
        if scenes is not None:
            scenes[item] = tp.id
        return mean_x, mean_y

    def __iter__(self):
        while True:
            yield self.next_batch()


class TrackingWindowsSource(_BaseTrackingSource):
    """Plain variant: tops observed / cont_observed / predicted /
    cont_predicted / labels / scene_ids."""

    # tracking batches are TIME-MAJOR (T, B, ...): the batch axis (the one
    # a microbatch split cuts) is axis 1 for sequence tops
    batch_axes = {"observed": 1, "cont_observed": 1, "predicted": 1,
                  "cont_predicted": 1, "labels": 1, "scene_ids": 0}

    def next_batch(self) -> dict:
        cfg = self.cfg
        b = cfg.batch_size
        t_obs, t_pred = cfg.temporal_observed_size, cfg.temporal_predicted_size
        out0 = np.zeros((t_obs, b, self.feature_size), np.float32)
        out2 = np.zeros((t_pred, b, self.feature_size), np.float32)
        labels = np.zeros((t_pred, b, 2), np.float32) if cfg.output_labels else None
        scenes = np.zeros((b,), np.float32) if cfg.output_scene_ids else None
        emitted = 0
        skipped = 0  # full pass with zero emits → error, not a hang
        while emitted < b:
            win = self.dataset.windows[self._win_idx]
            if self._track_idx >= len(win.track_positions):
                self._win_idx = (self._win_idx + 1) % len(self.dataset.windows)
                self._track_idx = 0
                skipped += 1
                if skipped > len(self.dataset.windows):
                    raise ValueError(
                        "no TrackingWindow in the dataset has any "
                        "track_positions — the source can never emit")
                continue
            skipped = 0
            tp = win.track_positions[self._track_idx]
            self._track_idx += 1
            self._emit_track(tp, out0, out2, labels, scenes, emitted)
            emitted += 1
            # reference max_number_positions: a ROLLING cap — every
            # max-th emitted track skips the remainder of the current
            # window (num_positions_ resets only on hitting the cap,
            # ref tracking_windows_data_layer.cpp:393-400)
            if cfg.max_number_positions > 0:
                self._num_positions += 1
                if self._num_positions >= cfg.max_number_positions:
                    self._num_positions = 0
                    self._track_idx = len(win.track_positions)
        cont_obs = np.ones((t_obs, b), np.float32)
        cont_obs[0] = 0.0
        cont_pred = np.ones((t_pred, b), np.float32)
        batch = {"observed": out0, "cont_observed": cont_obs,
                 "predicted": out2, "cont_predicted": cont_pred}
        if labels is not None:
            batch["labels"] = labels
        if scenes is not None:
            batch["scene_ids"] = scenes
        return batch


class TrackingWindowsSocialSource(_BaseTrackingSource):
    """Social variant: scenes packed whole; adds last-observed positions,
    the B×B neighbor matrix, and the validity mask."""

    # time-major sequence tops have their batch on axis 1, per-agent tops
    # on axis 0; relations is (B, B) and couples all agents of a batch.
    # cont_* are emitted for nets that thread LSTM cont bits (the
    # reference social layer has no cont tops), declared here so that an
    # axes.get(k, 0) consumer does not cut their TIME axis.
    batch_axes = {"observed": 1, "mean_pos": 0, "predicted": 1,
                  "relations": 0, "is_valid": 0, "labels": 1,
                  "scene_ids": 0, "cont_observed": 1, "cont_predicted": 1}

    def next_batch(self) -> dict:
        cfg = self.cfg
        b = cfg.batch_size
        t_obs, t_pred = cfg.temporal_observed_size, cfg.temporal_predicted_size
        out0 = np.zeros((t_obs, b, self.feature_size), np.float32)
        out2 = np.zeros((t_pred, b, self.feature_size), np.float32)
        mean_pos = np.zeros((b, 2), np.float32)
        group = np.zeros((b, b), np.float32)
        is_valid = np.zeros((b,), np.float32)
        labels = np.zeros((t_pred, b, 2), np.float32) if cfg.output_labels else None
        scenes = np.zeros((b,), np.float32) if cfg.output_scene_ids else None

        item = 0
        windows = self.dataset.windows
        skipped = 0  # consecutive never-fit scenes; a full pass of them
        # must not spin forever (the old total-attempts cap shipped
        # mostly-padded batches when oversized scenes dominated)
        while item < b:
            win = windows[self._win_idx]
            k = len(win.track_positions)
            if k > b or k == 0:   # scene can never fit (ref social :258)
                self._win_idx = (self._win_idx + 1) % len(windows)
                skipped += 1
                if skipped >= len(windows):
                    if item == 0:
                        raise ValueError(
                            f"no scene fits batch_size={b} (every window "
                            f"has 0 or > {b} tracks)")
                    break      # only unusable scenes remain → pad
                continue
            skipped = 0
            if k > b - item:   # doesn't fit in the remaining slots → pad
                break
            # neighbor block: rows item..item+k-1 connected, zero diagonal
            group[item:item + k, item:item + k] = 1.0
            np.fill_diagonal(group[item:item + k, item:item + k], 0.0)
            for j, tp in enumerate(win.track_positions):
                mx, my = self._emit_track(tp, out0, out2, labels, scenes,
                                          item + j)
                mean_pos[item + j] = (mx, my)
                is_valid[item + j] = 1.0
            item += k
            self._win_idx = (self._win_idx + 1) % len(windows)

        cont_obs = np.ones((t_obs, b), np.float32)
        cont_obs[0] = 0.0
        cont_pred = np.ones((t_pred, b), np.float32)
        batch = {"observed": out0, "mean_pos": mean_pos, "predicted": out2,
                 "relations": group, "is_valid": is_valid,
                 "cont_observed": cont_obs, "cont_predicted": cont_pred}
        if labels is not None:
            batch["labels"] = labels
        if scenes is not None:
            batch["scene_ids"] = scenes
        return batch
