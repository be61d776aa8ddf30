"""Image Datum preprocessing (Caffe's DataTransformer); counterpart of
videovector_tpu/data/transformer.py.

Two paths, as there:
- `transform_datum`: the host path in numpy, one Datum at a time, with the
  reference's exact per-item semantics (data_transformer.cpp:9-152).
- `make_batch_transform`: the fused device path. uint8 pixels go to the
  device; crop, mirror, mean subtraction and scale run there. The crop
  gathers uint8 pixels and the mean at the source positions, so only the
  cropped window is widened to f32.

The JAX module imports jax.numpy at its top, so the port carries its own copy
of the host-side pieces (the config, the numpy paths and the parameter
sampler) instead of importing them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from videovector_tpu_torch.data.wire import Datum
from videovector_tpu_torch.device import DEFAULT, resolve


@dataclass
class TransformConfig:
    """Mirror of TransformationParameter (ref caffe.proto:393-404)."""
    crop_size: int = 0
    mirror: bool = False
    scale: float = 1.0
    use_datum_scales: bool = False

    @classmethod
    def from_message(cls, msg) -> "TransformConfig":
        kw = {}
        for f in ("crop_size", "mirror", "scale", "use_datum_scales"):
            if msg.has(f):
                kw[f] = msg.get(f)
        return cls(**kw)


def datum_to_array(datum: Datum) -> np.ndarray:
    """uint8 `data` preferred, else float_data (ref :118-140)."""
    c, h, w = datum.channels, datum.height, datum.width
    if datum.data:
        return np.frombuffer(datum.data, np.uint8).reshape(c, h, w)
    return np.asarray(datum.float_data, np.float32).reshape(c, h, w)


def transform_datum(datum: Datum, cfg: TransformConfig, *,
                    mean: np.ndarray | None = None,
                    train: bool = False,
                    rng: np.random.RandomState | None = None,
                    preset: tuple | None = None) -> np.ndarray:
    """Exact reference semantics, one datum -> (C, crop, crop) f32.

    `preset=(h_off, w_off, do_mirror)` is the reference's preset-transform
    path (ref data_transformer.cpp:53-55): a multi-frame item draws ONE
    crop/mirror and applies it to every frame."""
    arr = datum_to_array(datum)
    c, h, w = arr.shape
    if cfg.crop_size:
        cs = cfg.crop_size
        if preset is not None:
            h_off, w_off, do_mirror = preset
        elif not datum.data:
            raise ValueError("cropping requires uint8 data (ref :52)")
        elif train:
            rng = rng or np.random.RandomState()
            h_off = rng.randint(h - cs)
            w_off = rng.randint(w - cs)
            do_mirror = bool(cfg.mirror and rng.randint(2))
        else:
            h_off = (h - cs) // 2
            w_off = (w - cs) // 2
            do_mirror = False
        patch = arr[:, h_off:h_off + cs, w_off:w_off + cs].astype(np.float32)
        if cfg.use_datum_scales:
            mins = np.asarray(datum.min, np.float32)[:, None, None]
            maxs = np.asarray(datum.max, np.float32)[:, None, None]
            means = np.asarray(datum.mean, np.float32)[:, None, None]
            out = mins + patch * (maxs - mins) / 255.0 - means
        else:
            m = (mean[:, h_off:h_off + cs, w_off:w_off + cs]
                 if mean is not None else 0.0)
            out = (patch - m) * cfg.scale
        if do_mirror:
            out = out[:, :, ::-1]
        return np.ascontiguousarray(out)
    if cfg.use_datum_scales:
        raise ValueError("use_datum_scales requires crop (ref :115)")
    if cfg.mirror:
        # ref data_transformer.cpp:43-45: LOG(FATAL) "Current implementation
        # requires mirror and crop_size to be set at the same time"
        raise ValueError("mirror requires crop_size (ref "
                         "data_transformer.cpp:43-45 LOG(FATAL))")
    out = arr.astype(np.float32)
    if mean is not None:
        out = out - mean
    return out * cfg.scale


def make_batch_transform(cfg: TransformConfig, mean: np.ndarray | None,
                         image_hw: tuple[int, int], *, layout: str = "NCHW",
                         device=DEFAULT):
    """Build f(pixels_u8, h_off (N,), w_off (N,), mirror (N,)) -> f32 batch on
    `device`, in `layout` ("NCHW", Caffe blob order, or "NHWC", decode order).
    `device` is the card unless the caller asks for the CPU; without a card
    a CUDA device raises here.

    Python-int offsets with no mirroring take the static center-crop branch
    (slices); otherwise each item is gathered at its own offsets, and
    mirroring flips the column indices, so (pixel - mean) is flipped jointly
    (the mean is indexed at the source position, as in Caffe)."""
    device = resolve(device)
    cs = cfg.crop_size
    h, w = image_hw
    if cfg.use_datum_scales:
        # the per-item min/max/mean rescale needs each datum's own scale
        # vectors, which the (pixels, offsets, mirror) signature does not
        # carry: transform_datum implements it
        raise ValueError("use_datum_scales is not supported by the fused "
                         "batch transform — use the host transform_datum "
                         "path")
    if cfg.mirror and not cs:
        raise ValueError("mirror requires crop_size (ref "
                         "data_transformer.cpp:43-45 LOG(FATAL))")
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"layout must be NCHW or NHWC, got {layout!r}")
    mean_hwc = None
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim != 3:
            raise ValueError(f"mean must be (C, H, W), got {mean.shape}")
        mean_hwc = torch.as_tensor(mean.transpose(1, 2, 0).copy(),
                                   device=device)
    h_axis, w_axis = (2, 3) if layout == "NCHW" else (1, 2)

    def f(pixels, h_off, w_off, mirror):
        pixels = torch.as_tensor(pixels, device=device)
        if pixels.dim() == 4 and (pixels.shape[h_axis],
                                  pixels.shape[w_axis]) != (h, w):
            raise ValueError(
                f"pixels shape {tuple(pixels.shape)} does not place image_hw "
                f"({h}, {w}) at the {layout} spatial axes — wrong "
                f"pixels_layout?")
        hwc = pixels if layout == "NHWC" else pixels.permute(0, 2, 3, 1)
        if not cs:
            x = hwc.float()
            if mean_hwc is not None:
                x = x - mean_hwc
        elif _static_offsets(h_off, w_off, mirror):
            ho, wo = int(h_off), int(w_off)
            x = hwc[:, ho:ho + cs, wo:wo + cs].float()
            if mean_hwc is not None:
                x = x - mean_hwc[ho:ho + cs, wo:wo + cs]
        else:
            ar = torch.arange(cs, device=device)
            ho = torch.as_tensor(h_off, device=device).long()
            wo = torch.as_tensor(w_off, device=device).long()
            flip = torch.as_tensor(mirror, device=device).bool()
            rows = ho[:, None] + ar                           # (N, cs)
            cols = wo[:, None] + ar                           # (N, cs)
            cols = torch.where(flip[:, None], cols.flip(1), cols)
            n = torch.arange(hwc.shape[0], device=device)
            x = hwc[n[:, None, None], rows[:, :, None], cols[:, None, :]]
            x = x.float()                                     # (N, cs, cs, C)
            if mean_hwc is not None:
                x = x - mean_hwc[rows[:, :, None], cols[:, None, :]]
        x = x * cfg.scale
        return x if layout == "NHWC" else x.permute(0, 3, 1, 2)

    return f


def _static_offsets(h_off, w_off, mirror) -> bool:
    """True when crop offsets are python/0-d numpy constants and mirroring is
    off — the deterministic TEST-phase transform."""
    def scalar(v):
        return isinstance(v, (int, np.integer)) or (
            isinstance(v, np.ndarray) and v.shape == ())

    if not (scalar(h_off) and scalar(w_off)):
        return False
    if mirror is None or mirror is False:
        return True
    if isinstance(mirror, (np.ndarray, list, tuple, bool, int)):
        return not np.asarray(mirror).any()
    return False


def sample_transform_params(n: int, image_hw, cfg: TransformConfig, *,
                            train: bool, rng: np.random.RandomState):
    """Host-side RNG for the fused path: per-item crop offsets + mirror."""
    h, w = image_hw
    cs = cfg.crop_size
    if train:
        h_off = rng.randint(0, h - cs, size=n)
        w_off = rng.randint(0, w - cs, size=n)
        mirror = (rng.randint(0, 2, size=n) > 0) if cfg.mirror \
            else np.zeros(n, bool)
    else:
        h_off = np.full(n, (h - cs) // 2)
        w_off = np.full(n, (w - cs) // 2)
        mirror = np.zeros(n, bool)
    return (h_off.astype(np.int32), w_off.astype(np.int32), mirror)
