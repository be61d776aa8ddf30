"""Generic data sources, the Caffe-inherited data layer zoo; counterpart of
videovector_tpu/data/generic.py.

Host-side batch generators mirroring:
  DATA          ref:src/caffe/layers/data_layer.cpp        (Datum records)
  IMAGE_DATA    ref:src/caffe/layers/image_data_layer.cpp  (file list + decode)
  MEMORY_DATA   ref:src/caffe/layers/memory_data_layer.cpp
  HDF5_DATA     ref:src/caffe/layers/hdf5_data_layer.cpp   (data/hdf5.py reads)
  WINDOW_DATA   ref:src/caffe/layers/window_data_layer.cpp (R-CNN windows)
  FLEXIBLE_DATA ref:src/caffe/layers/flexible_data_layer.cpp (two-store
                temporal stacking: index record -> key into a second store,
                walk the backward/forward neighbours, stack frames as
                channels with one shared crop/mirror per item)
  VIDEO_SHOT_WINDOW_DATA ref:src/caffe/layers/video_shot_window_data_layer.cpp
                (precomputed target + context windows, reservoir negatives;
                its VIDEO_ID_TEXT backend cycles ids from a text file)

Each yields dicts of numpy arrays, drawing every random choice from one
np.random.RandomState(seed), so that the same stores, lists and seed give
the JAX package's batches bit for bit. Stores open through
data/records.open_store (VVR, LMDB or LevelDB, by content).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from videovector_tpu_torch.data import native
from videovector_tpu_torch.data.hdf5 import read_hdf5
from videovector_tpu_torch.data.records import open_store
from videovector_tpu_torch.data.shots import NegativeReservoir
from videovector_tpu_torch.data.transformer import TransformConfig, transform_datum
from videovector_tpu_torch.data.wire import Datum, VideoShotWindow
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _rand_skip_cursor(rng, rand_skip: int, n: int) -> int:
    """Reference rand_skip: caffe_rng_rand() % rand_skip, a skip in [0,
    rand_skip - 1] (data_layer.cpp DataLayerSetUp); it must fit the
    dataset, or the first read would index out of range."""
    if not rand_skip:
        return 0
    if rand_skip > n:
        raise ValueError(f"rand_skip {rand_skip} exceeds the dataset size "
                         f"{n} (the reference would walk off the cursor)")
    return int(rng.randint(rand_skip))


class DatumRecordSource:
    """Cyclic reader over Datum records with DataTransformer preprocessing."""

    def __init__(self, path: str, batch_size: int, *,
                 transform: TransformConfig | None = None,
                 mean: np.ndarray | None = None, train: bool = False,
                 rand_skip: int = 0, seed: int = 1234):
        self.reader = open_store(path)
        self.batch_size = batch_size
        self.transform = transform or TransformConfig()
        self.mean = mean
        self.train = train
        self.rng = np.random.RandomState(seed)
        self._cursor = _rand_skip_cursor(self.rng, rand_skip,
                                         len(self.reader))

    def next_batch(self) -> dict:
        data, labels = [], []
        for _ in range(self.batch_size):
            datum = Datum.decode(bytes(self.reader.value(self._cursor)))
            self._cursor = (self._cursor + 1) % len(self.reader)
            data.append(transform_datum(datum, self.transform, mean=self.mean,
                                        train=self.train, rng=self.rng))
            labels.append(datum.label or 0)
        return {"data": np.stack(data),
                "label": np.asarray(labels, np.float32)}

    def __iter__(self):
        while True:
            yield self.next_batch()


@dataclass
class ImageDataConfig:
    """Mirror of ImageDataParameter."""
    source: str = ""
    batch_size: int = 1
    new_height: int = 0
    new_width: int = 0
    shuffle: bool = False
    rand_skip: int = 0


def _decode_bgr(path: str, tw: int, th: int) -> np.ndarray:
    """An image file as (H, W, 3) uint8 BGR, resized to (th, tw) when both
    are set: the native libjpeg decoder for a .jpg/.jpeg (unless
    VVTPU_NATIVE_DECODE=0), then cv2 (cv::imread and cv::resize, the
    reference's, ref:src/caffe/util/io.cpp:69-88), then PIL (whose resize
    resamples slightly differently), the JAX module's order."""
    if (os.environ.get("VVTPU_NATIVE_DECODE", "1") != "0"
            and path.lower().endswith((".jpg", ".jpeg"))):
        with open(path, "rb") as f:
            hwc = native.decode_jpeg_bgr(f.read(), tw, th)
        if hwc is not None:
            return hwc
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, 1)  # BGR HWC, like the reference
        if img is not None:
            return cv2.resize(img, (tw, th)) if tw and th else img
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if tw and th:
        img = img.resize((tw, th))
    return np.asarray(img, np.uint8)[:, :, ::-1]  # RGB -> BGR


class ImageDataSource:
    """Reads `cfg.source`, a list of "path [label]" lines, and decodes each
    image into a BGR CHW Datum before the transform; reshuffles the list
    at each wrap when `cfg.shuffle`."""

    def __init__(self, cfg: ImageDataConfig, *,
                 transform: TransformConfig | None = None,
                 mean: np.ndarray | None = None, train: bool = False,
                 seed: int = 1234):
        self.cfg = cfg
        self.transform = transform or TransformConfig()
        self.mean = mean
        self.train = train
        self.rng = np.random.RandomState(seed)
        self.items: list[tuple[str, int]] = []
        with open(cfg.source) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.rsplit(None, 1)
                path, label = (parts[0], int(parts[1])) if len(parts) == 2 \
                    else (parts[0], 0)
                self.items.append((path, label))
        if cfg.shuffle:
            self.rng.shuffle(self.items)
        self._cursor = _rand_skip_cursor(self.rng, cfg.rand_skip,
                                         len(self.items))

    def _load(self, path: str) -> Datum:
        hwc = _decode_bgr(path, int(self.cfg.new_width or 0),
                          int(self.cfg.new_height or 0))
        # Caffe/OpenCV blob order is BGR, CHW
        bgr = np.asarray(hwc, np.uint8).transpose(2, 0, 1)
        return Datum(channels=3, height=bgr.shape[1], width=bgr.shape[2],
                     data=np.ascontiguousarray(bgr).tobytes())

    def next_batch(self) -> dict:
        data, labels = [], []
        for _ in range(self.cfg.batch_size):
            path, label = self.items[self._cursor]
            self._cursor += 1
            if self._cursor >= len(self.items):
                self._cursor = 0
                if self.cfg.shuffle:
                    self.rng.shuffle(self.items)
            datum = self._load(path)
            data.append(transform_datum(datum, self.transform, mean=self.mean,
                                        train=self.train, rng=self.rng))
            labels.append(label)
        return {"data": np.stack(data),
                "label": np.asarray(labels, np.float32)}

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# MEMORY_DATA
# ---------------------------------------------------------------------------

class MemoryDataSource:
    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        sizes = {v.shape[0] for v in self.arrays.values()}
        if len(sizes) != 1:
            raise ValueError("all arrays need the same leading dim")
        self.n = sizes.pop()
        self.batch_size = batch_size
        self._cursor = 0

    def next_batch(self) -> dict:
        idx = np.arange(self._cursor, self._cursor + self.batch_size) % self.n
        self._cursor = int((self._cursor + self.batch_size) % self.n)
        return {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------

class HDF5Source:
    """Reads the datasets of each file listed in a text file (ref
    hdf5_data_layer.cpp: files cycled in order, rows in order), through
    data/hdf5.read_hdf5 (no h5py)."""

    def __init__(self, list_file: str, batch_size: int):
        with open(list_file) as f:
            self.paths = [l.strip() for l in f if l.strip()]
        self.batch_size = batch_size
        self._file_idx = 0
        self._row = 0
        self._load(0)

    def _load(self, idx: int):
        self.datasets = read_hdf5(self.paths[idx])
        self.n = next(iter(self.datasets.values())).shape[0]

    def next_batch(self) -> dict:
        out = {k: [] for k in self.datasets}
        for _ in range(self.batch_size):
            if self._row >= self.n:
                self._file_idx = (self._file_idx + 1) % len(self.paths)
                self._load(self._file_idx)
                self._row = 0
            for k in self.datasets:
                out[k].append(self.datasets[k][self._row])
            self._row += 1
        return {k: np.stack(v).astype(np.float32) for k, v in out.items()}

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# WINDOW_DATA — R-CNN-style fg/bg window sampling
# ---------------------------------------------------------------------------

@dataclass
class WindowDataConfig:
    """Mirror of WindowDataParameter (subset)."""
    source: str = ""
    batch_size: int = 32
    fg_threshold: float = 0.5
    bg_threshold: float = 0.5
    fg_fraction: float = 0.25
    context_pad: int = 0
    crop_size: int = 227
    crop_mode: str = "warp"            # "warp" | "square" (ref :200-202)
    mirror: bool = False               # proto default (caffe.proto mirror)


def window_geometry(box, img_w: int, img_h: int, crop_size: int,
                    context_pad: int, *, use_square: bool = False,
                    do_mirror: bool = False):
    """The reference's pad-then-warp box arithmetic, value-exact
    (ref:src/caffe/layers/window_data_layer.cpp:238-324): expand the box so
    that after warping to crop_size×crop_size there is exactly context_pad
    padding per side, clip to the image, and compute where the warped
    clipped region lands in the output canvas.

    box is (x1, y1, x2, y2) INCLUSIVE pixel coordinates. Returns
    (roi (x1, y1, x2, y2) inclusive, (resize_w, resize_h), pad_w, pad_h).
    The caller zero-fills the canvas (ref :205) and pastes the resized
    patch at [pad_h : pad_h+resize_h, pad_w : pad_w+resize_w]."""
    x1, y1, x2, y2 = (int(v) for v in box)
    pad_w = pad_h = 0
    resize_w = resize_h = crop_size
    if context_pad > 0 or use_square:
        if crop_size - 2 * context_pad <= 0:
            # the reference divides by <=0 here (undefined behavior); fail
            # loudly instead of producing an inverted box
            raise ValueError(
                f"context_pad {context_pad} must be < crop_size/2 "
                f"({crop_size}/2)")
        context_scale = crop_size / float(crop_size - 2 * context_pad)
        half_height = (y2 - y1 + 1) / 2.0
        half_width = (x2 - x1 + 1) / 2.0
        center_x = x1 + half_width
        center_y = y1 + half_height
        if use_square:
            half_width = half_height = max(half_width, half_height)
        x1 = int(round(center_x - half_width * context_scale))
        x2 = int(round(center_x + half_width * context_scale))
        y1 = int(round(center_y - half_height * context_scale))
        y2 = int(round(center_y + half_height * context_scale))

        unclipped_h = y2 - y1 + 1
        unclipped_w = x2 - x1 + 1
        pad_x1 = max(0, -x1)
        pad_y1 = max(0, -y1)
        pad_x2 = max(0, x2 - img_w + 1)
        pad_y2 = max(0, y2 - img_h + 1)
        x1 += pad_x1
        x2 -= pad_x2
        y1 += pad_y1
        y2 -= pad_y2
        clipped_h = y2 - y1 + 1
        clipped_w = x2 - x1 + 1

        scale_x = crop_size / float(unclipped_w)
        scale_y = crop_size / float(unclipped_h)
        resize_w = int(round(clipped_w * scale_x))
        resize_h = int(round(clipped_h * scale_y))
        pad_x1 = int(round(pad_x1 * scale_x))
        pad_x2 = int(round(pad_x2 * scale_x))
        pad_y1 = int(round(pad_y1 * scale_y))

        pad_h = pad_y1
        # mirroring mirrors the padding too (ref :309-314)
        pad_w = pad_x2 if do_mirror else pad_x1
        if pad_h + resize_h > crop_size:
            resize_h = crop_size - pad_h
        if pad_w + resize_w > crop_size:
            resize_w = crop_size - pad_w
    return (x1, y1, x2, y2), (resize_w, resize_h), pad_w, pad_h


class WindowDataSource:
    """Parses the reference's window-file format
    (`# <idx>\\n<img path>\\n<channels>\\n<h>\\n<w>\\n<num windows>\\n` then
    `<label> <overlap> <x1> <y1> <x2> <y2>` lines), samples fg/bg windows per
    batch by fraction, crops with the reference's context-pad/warp geometry
    (window_geometry above) and resizes with OpenCV INTER_LINEAR — the exact
    operations of ref:src/caffe/layers/window_data_layer.cpp:326-352."""

    def __init__(self, cfg: WindowDataConfig, *, mean: np.ndarray | None = None,
                 seed: int = 1234):
        self.cfg = cfg
        self.mean = mean
        self.rng = np.random.RandomState(seed)
        self.fg: list[tuple[str, int, tuple]] = []
        self.bg: list[tuple[str, int, tuple]] = []
        self._parse(cfg.source)

    def _parse(self, path: str):
        with open(path) as f:
            lines = [l.rstrip("\n") for l in f]
        i = 0
        while i < len(lines):
            if not lines[i].startswith("#"):
                i += 1
                continue
            img_path = lines[i + 1].strip()
            num = int(lines[i + 5])
            for j in range(num):
                parts = lines[i + 6 + j].split()
                label, overlap = int(parts[0]), float(parts[1])
                box = tuple(int(v) for v in parts[2:6])
                if overlap >= self.cfg.fg_threshold:
                    self.fg.append((img_path, label, box))
                elif overlap < self.cfg.bg_threshold:
                    self.bg.append((img_path, 0, box))
            i += 6 + num

    def _crop(self, img_path: str, box) -> np.ndarray:
        cs = self.cfg.crop_size
        # cv::imread(CV_LOAD_IMAGE_COLOR) as the reference (ref :230),
        # through the port's decoder order
        img = _decode_bgr(img_path, 0, 0)
        img_h, img_w = img.shape[:2]
        do_mirror = bool(self.cfg.mirror and self.rng.randint(2))
        (x1, y1, x2, y2), (rw, rh), pad_w, pad_h = window_geometry(
            box, img_w, img_h, cs, self.cfg.context_pad,
            use_square=self.cfg.crop_mode == "square", do_mirror=do_mirror)
        patch = img[y1:y2 + 1, x1:x2 + 1]
        try:
            import cv2
            patch = cv2.resize(patch, (rw, rh), interpolation=cv2.INTER_LINEAR)
        except ImportError:
            from PIL import Image
            patch = np.asarray(Image.fromarray(patch[:, :, ::-1]).resize(
                (rw, rh), Image.BILINEAR), np.uint8)[:, :, ::-1]
        if do_mirror:
            patch = patch[:, ::-1]
        # zero canvas + paste at the pad offset (ref :205, :343-348);
        # mean subtraction applies only to the pasted region, with the
        # mean indexed at the SAME padded offsets
        out = np.zeros((3, cs, cs), np.float32)
        hwc = patch.astype(np.float32)
        region = hwc.transpose(2, 0, 1)
        if self.mean is not None:
            mean_off = (self.mean.shape[-1] - cs) // 2
            m = self.mean[:, mean_off + pad_h:mean_off + pad_h + rh,
                          mean_off + pad_w:mean_off + pad_w + rw]
            region = region - m
        out[:, pad_h:pad_h + rh, pad_w:pad_w + rw] = region
        return out

    def next_batch(self) -> dict:
        b = self.cfg.batch_size
        n_fg = int(round(b * self.cfg.fg_fraction))
        data, labels = [], []
        for pool, count in ((self.fg, n_fg), (self.bg, b - n_fg)):
            src = pool if pool else (self.fg or self.bg)
            for _ in range(count):
                img, label, box = src[self.rng.randint(len(src))]
                data.append(self._crop(img, box))
                labels.append(label)
        return {"data": np.stack(data),
                "label": np.asarray(labels, np.float32)}

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# FLEXIBLE_DATA — two-store temporal stacking
# ---------------------------------------------------------------------------

@dataclass
class FlexibleDataConfig:
    """Mirror of FlexibleDataParameter (ref caffe.proto:682-688) + the
    data_param/transform_param fields the layer uses."""
    source: str = ""              # index store
    flexible_source: str = ""     # frame store (ordered keys!)
    flexible_key_suffix: str = ""
    forward_len: int = 0
    backward_len: int = 0
    use_center_datum: bool = True
    batch_size: int = 8
    key_prefix_len: int = 9       # index key chars skipped (ref :232)
    label_chars: int = 4          # leading value chars = label (ref :234)


class FlexibleDataSource:
    """Index record → key into the frame store; walk ±backward/forward
    neighbor records; every frame shares ONE crop/mirror draw and lands in
    its own channel window of the item (ref flexible_data_layer.cpp:173-329)."""

    def __init__(self, cfg: FlexibleDataConfig, *,
                 transform: TransformConfig | None = None,
                 mean: np.ndarray | None = None, train: bool = False,
                 seed: int = 1234):
        self.cfg = cfg
        self.transform = transform or TransformConfig()
        self.mean = mean
        self.train = train
        self.rng = np.random.RandomState(seed)
        self.index = open_store(cfg.source)
        self.frames = open_store(cfg.flexible_source)
        self._cursor = 0
        self.frames_per_item = (cfg.backward_len + cfg.forward_len
                                + (1 if cfg.use_center_datum else 0))

    def next_batch(self) -> dict:
        cfg = self.cfg
        items, labels = [], []
        for _ in range(cfg.batch_size):
            key, value = self.index[self._cursor]
            self._cursor = (self._cursor + 1) % len(self.index)
            base = key.decode()[cfg.key_prefix_len:]
            label = int(bytes(value)[:cfg.label_chars])
            center = self.frames.index_of(base + cfg.flexible_key_suffix)

            # one transform draw shared by all frames of the item
            first = Datum.decode(bytes(self.frames.value(center)))
            h, w = first.height, first.width
            cs = self.transform.crop_size
            if cs and self.train:
                h_off = self.rng.randint(h - cs)
                w_off = self.rng.randint(w - cs)
            else:
                h_off = (h - cs) // 2 if cs else 0
                w_off = (w - cs) // 2 if cs else 0
            do_mirror = bool(self.transform.mirror and self.rng.randint(2))

            frames = []
            lo = center - cfg.backward_len
            hi = center + cfg.forward_len
            if lo < 0 or hi >= len(self.frames):
                # the reference CHECK-fails at the store boundary
                # (flexible_data_layer.cpp rewind loop on MDB_PREV) — a
                # Python-wrapped negative index would silently stack the
                # END of the store (a different video) into this item
                raise ValueError(
                    f"FLEXIBLE_DATA: frame window [{lo}, {hi}] around "
                    f"{base!r} leaves the store bounds [0, "
                    f"{len(self.frames) - 1}] (backward_len="
                    f"{cfg.backward_len}, forward_len={cfg.forward_len})")
            for idx in range(lo, hi + 1):
                if idx == center and not cfg.use_center_datum:
                    continue
                datum = Datum.decode(bytes(self.frames.value(idx)))
                frames.append(self._apply(datum, h_off, w_off, do_mirror))
            items.append(np.concatenate(frames, axis=0))
            labels.append(label)
        return {"data": np.stack(items),
                "label": np.asarray(labels, np.float32)}

    def _apply(self, datum: Datum, h_off: int, w_off: int, do_mirror: bool):
        # one copy of the transform semantics: the reference's
        # preset-transform path (data_transformer.cpp:53-55), the item's
        # shared crop/mirror draw applied to every frame
        return transform_datum(datum, self.transform, mean=self.mean,
                               preset=(h_off, w_off, do_mirror))

    def __iter__(self):
        while True:
            yield self.next_batch()


class VideoIdTextSource:
    """VIDEO_ID_TEXT backend of VideoShotWindowDataLayer
    (ref:src/caffe/layers/video_shot_window_data_layer.cpp:154-183, :379-383):
    cycles the integer ids in a whitespace-separated text file, emitting one
    (batch,) array per batch — used to feed id-driven layers at test time."""

    def __init__(self, path: str, batch_size: int):
        with open(path) as f:
            self.ids = [int(tok) for tok in f.read().split()]
        if not self.ids:
            raise ValueError(f"{path}: no video ids")
        self.batch_size = batch_size
        self._cursor = 0

    def next_batch(self) -> dict:
        out = np.empty((self.batch_size,), np.float32)
        for i in range(self.batch_size):
            out[i] = self.ids[self._cursor]
            self._cursor = (self._cursor + 1) % len(self.ids)
        return {"data": out}

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# VIDEO_SHOT_WINDOW_DATA — precomputed windows + reservoir negatives
# ---------------------------------------------------------------------------

class VideoShotWindowSource:
    """VideoShotWindow records (target + fixed contexts); negatives come
    entirely from the reservoir (ref video_shot_window_data_layer.cpp:68-497).
    Channel layout: [target, contexts..., negatives...]."""

    def __init__(self, path: str, batch_size: int, *,
                 num_negative_samples: int = 0, max_buffer_size: int = 0,
                 negative_swap_percentage: int = 0,
                 negative_path: str | None = None, seed: int = 1234,
                 display_all_ids: bool = False):
        self.reader = open_store(path)
        self.batch_size = batch_size
        self.num_negatives = num_negative_samples
        self.display_all_ids = display_all_ids
        self.rng = np.random.RandomState(seed)
        self._cursor = 0
        first = VideoShotWindow.decode(bytes(self.reader.value(0)))
        self.context_size = len(first.context_shot_words)
        self.feature_dim = len(first.target_shot_word.float_data)
        self.channels = 1 + self.context_size + num_negative_samples
        self.reservoir = None
        if num_negative_samples > 0:
            if max_buffer_size < num_negative_samples:
                # fail at setup like the reference's reservoir CHECKs —
                # sampling num_negatives DISTINCT slots from a smaller
                # (or zero) buffer would crash mid-training with an
                # opaque numpy error
                raise ValueError(
                    f"num_negative_samples={num_negative_samples} needs "
                    f"max_buffer_size >= that (got {max_buffer_size})")
            self.reservoir = NegativeReservoir(
                max_buffer_size, self.feature_dim, negative_swap_percentage,
                self.rng)
            self._fill_reservoir(negative_path)

    def _fill_reservoir(self, negative_path: str | None):
        """Seed the buffer. Without a separate negative dataset the
        reference consumes the MAIN cursor (video_shot_window_data_layer
        .cpp:259-341): training then starts AFTER the seed windows, not at
        record 0 — re-emitting them as targets while they sit in the
        buffer would change both the data order and the negative
        co-occurrence vs a reference run."""
        separate = negative_path is not None
        reader = open_store(negative_path) if separate else self.reader
        added = 0
        i = 0
        while added < self.reservoir.max_size:
            pos = (i % len(reader)) if separate else self._cursor
            w = VideoShotWindow.decode(bytes(reader.value(pos)))
            if not separate:
                self._cursor = (self._cursor + 1) % len(self.reader)
            key = f"{w.video_id}:{w.shot_id}"
            if key not in self.reservoir.key_set:
                self.reservoir.buffer[added] = np.asarray(
                    w.target_shot_word.float_data, np.float32)
                self.reservoir.keys.append(key)
                self.reservoir.key_set.add(key)
                added += 1
            i += 1
            if i > 100 * self.reservoir.max_size:
                raise RuntimeError("not enough distinct shots for reservoir")

    def next_batch(self) -> dict:
        b = self.batch_size
        data = np.zeros((b, self.channels, self.feature_dim), np.float32)
        vids = np.zeros((b,), np.float32)
        for item in range(b):
            w = VideoShotWindow.decode(bytes(self.reader.value(self._cursor)))
            self._cursor = (self._cursor + 1) % len(self.reader)
            if len(w.context_shot_words) != self.context_size:
                # heterogeneous windows would silently truncate (the
                # negatives slice overwrites the extras) or IndexError
                # mid-epoch; the layout is sized from the first record
                raise ValueError(
                    f"VideoShotWindow {w.video_id}:{w.shot_id} has "
                    f"{len(w.context_shot_words)} contexts; this store's "
                    f"layout was sized at {self.context_size}")
            data[item, 0] = np.asarray(w.target_shot_word.float_data, np.float32)
            for c, d in enumerate(w.context_shot_words):
                data[item, 1 + c] = np.asarray(d.float_data, np.float32)
            if self.num_negatives:
                data[item, 1 + self.context_size:] = \
                    self.reservoir.sample(self.num_negatives)
                self.reservoir.maybe_add(
                    f"{w.video_id}:{w.shot_id}",
                    np.asarray(w.target_shot_word.float_data, np.float32))
            vids[item] = w.video_id
            if self.display_all_ids:
                # ref video_shot_window_data_layer.cpp:469-471 (LOG(WARNING))
                log.warning(
                    "Item-id:Video-id:Shot-id:%d:%d:%d",
                    item, w.video_id, w.shot_id)
        return {"data": data, "video_id": vids}

    def __iter__(self):
        while True:
            yield self.next_batch()
