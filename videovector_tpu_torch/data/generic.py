"""Generic image data sources; counterpart of the DATA and IMAGE_DATA parts of
videovector_tpu/data/generic.py.

Host-side batch generators mirroring:
  DATA        ref:src/caffe/layers/data_layer.cpp        (Datum records)
  IMAGE_DATA  ref:src/caffe/layers/image_data_layer.cpp  (file list + decode)

Both yield {"data": (B, C, crop, crop) f32, "label": (B,) f32} numpy
batches through the host `transform_datum`, drawing crops and mirrors from
one np.random.RandomState(seed), so that the same store, list and seed give
the JAX package's batches bit for bit. The other sources of the JAX module
(MEMORY, HDF5, WINDOW, FLEXIBLE, VIDEO_SHOT_WINDOW) wait for ROADMAP item 1b.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from videovector_tpu_torch.data import native
from videovector_tpu_torch.data.records import open_store
from videovector_tpu_torch.data.transformer import TransformConfig, transform_datum
from videovector_tpu_torch.data.wire import Datum


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
