"""The serving path's max pools and a plain model of the NHWC pool kernel,
shared by the CPU tests (tests/test_torch_max_pool.py) and the card's
(tests/test_torch_cuda_kernels.py). Imports no JAX.

GEOMETRIES: (name, (H, W, C), kernel, stride, pad) of each 3x3 max pool
that GoogLeNet (224 crop: pool1, pool2, the nine inception modules' 3x3/1
pad-1 branch pools, pool3, pool4) and CaffeNet (227 crop: after conv1,
conv2 and conv5) run, in the order a forward runs them.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch.ops.pooling import _pool_geometry

GOOGLENET = (
    ("pool1", (112, 112, 64), 3, 2, 0),
    ("pool2", (56, 56, 192), 3, 2, 0),
    ("3a", (28, 28, 192), 3, 1, 1),
    ("3b", (28, 28, 256), 3, 1, 1),
    ("pool3", (28, 28, 480), 3, 2, 0),
    ("4a", (14, 14, 480), 3, 1, 1),
    ("4b", (14, 14, 512), 3, 1, 1),
    ("4c", (14, 14, 512), 3, 1, 1),
    ("4d", (14, 14, 512), 3, 1, 1),
    ("4e", (14, 14, 528), 3, 1, 1),
    ("pool4", (14, 14, 832), 3, 2, 0),
    ("5a", (7, 7, 832), 3, 1, 1),
    ("5b", (7, 7, 832), 3, 1, 1),
)
CAFFENET = (
    ("pool1", (55, 55, 96), 3, 2, 0),
    ("pool2", (27, 27, 256), 3, 2, 0),
    ("pool5", (13, 13, 256), 3, 2, 0),
)
GEOMETRIES = tuple((f"{net}-{c[0]}",) + c[1:]
                   for net, cases in (("googlenet", GOOGLENET),
                                      ("caffenet", CAFFENET))
                   for c in cases)
IDS = [g[0] for g in GEOMETRIES]


def pool_args(case):
    """((H, W, C), kernel, stride, pad) of a GEOMETRIES entry, the last
    three as pairs."""
    _, hwc, k, s, p = case
    return hwc, (k, k), (s, s), (p, p)


def _fold(v, m, inside=True):
    """aten's rule where `inside`: m takes v where v > m or v is NaN,
    compared in f32, kept in v's dtype."""
    vf = v.float()
    return torch.where(((vf > m.float()) | vf.isnan()) & inside, v, m)


def _taps(x, kernel, stride, pad):
    """(oh, ow, tap(a, b)): tap(a, b) is each window's element at offset
    (a, b) of (N, H, W, C) x and where that element lies in the image."""
    n, h, w, c = x.shape
    oh, ow, _, _ = _pool_geometry(h, w, kernel, stride, pad)
    rows = torch.arange(oh) * stride[0] - pad[0]
    cols = torch.arange(ow) * stride[1] - pad[1]

    def tap(a, b):
        y, xx = rows + a, cols + b
        inside = (((y >= 0) & (y < h))[:, None]
                  & ((xx >= 0) & (xx < w))[None, :])[None, :, :, None]
        return x[:, y.clamp(0, h - 1)][:, :, xx.clamp(0, w - 1)], inside
    return oh, ow, tap


def clipped_window_max(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    """What csrc/max_pool_nhwc.cu computes for one window a thread, in
    plain tensor code: each window of (N, H, W, C) x clipped to the image,
    scanned row-major from -inf by aten's rule."""
    oh, ow, tap = _taps(x, kernel, stride, pad)
    m = torch.full((x.shape[0], oh, ow, x.shape[3]), -float("inf"),
                   dtype=x.dtype)
    for a in range(kernel[0]):
        for b in range(kernel[1]):
            v, inside = tap(a, b)
            m = _fold(v, m, inside)
    return m


def strip_window_max(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    """What the kernel's strips compute: each window row's maximum scanned
    left to right from -inf, then the rows' maxima folded top to bottom
    (a row outside the image reads -inf, which changes nothing), by the
    same rule."""
    oh, ow, tap = _taps(x, kernel, stride, pad)
    full = (x.shape[0], oh, ow, x.shape[3])
    m = torch.full(full, -float("inf"), dtype=x.dtype)
    for a in range(kernel[0]):
        row = torch.full(full, -float("inf"), dtype=x.dtype)
        for b in range(kernel[1]):
            v, inside = tap(a, b)
            row = _fold(v, row, inside)
        m = _fold(row, m)
    return m


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal shapes and dtypes, NaN where the other has NaN, and the same
    bits everywhere else (so -0.0 and 0.0 differ)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        return False
    ints = {2: torch.int16, 4: torch.int32}[want.element_size()]
    return torch.equal(got[~nan].view(ints), want[~nan].view(ints))
