"""Operations and bytes of the `googlenet-retrieval` configuration's work,
from its table of widths alone (never read from a kernel), at the H100
peaks of vvbench/flops.py.

A conv's bytes count its NHWC input in the compute dtype once, its HWIO
weights in the compute dtype once, its f32 bias and its output in the
compute dtype once, as flops.caffenet_convs counts CaffeNet's: what K2
gathers again from L2, conv1's repack and the concatenations are not the
work's.
"""

from __future__ import annotations

from vvbench.flops import BYTES, PEAK_BF16, PEAK_F32, least_s, score_ops


def _pooled(size: int, stride: int) -> int:
    # Caffe's 3x3 max pool rounds up; the modules' (stride 1, pad 1) keep
    # the size
    return -(-(size - 3) // stride) + 1 if stride > 1 else size


def conv_layers(cfg: dict) -> list[tuple]:
    """(name, kernel, stride, pad, c_in, c_out, input side) of every conv
    at cfg["crop"], in the forward's order: conv1, the two conv2s, then
    each module's 1x1, 3x3_reduce, 3x3, 5x5_reduce, 5x5, pool_proj."""
    stem = cfg["stem"]
    size = cfg["crop"]
    out = [("conv1/7x7_s2", 7, 2, 3, 3, stem["conv1"], size)]
    size = _pooled((size + 6 - 7) // 2 + 1, 2)
    out += [("conv2/3x3_reduce", 1, 1, 0, stem["conv1"],
             stem["conv2_reduce"], size),
            ("conv2/3x3", 3, 1, 1, stem["conv2_reduce"], stem["conv2"],
             size)]
    size, c = _pooled(size, 2), stem["conv2"]
    for m in cfg["inceptions"]:
        p = f"inception_{m['name']}/"
        out += [(p + "1x1", 1, 1, 0, c, m["1x1"], size),
                (p + "3x3_reduce", 1, 1, 0, c, m["3x3_reduce"], size),
                (p + "3x3", 3, 1, 1, m["3x3_reduce"], m["3x3"], size),
                (p + "5x5_reduce", 1, 1, 0, c, m["5x5_reduce"], size),
                (p + "5x5", 5, 1, 2, m["5x5_reduce"], m["5x5"], size),
                (p + "pool_proj", 1, 1, 0, c, m["pool_proj"], size)]
        c = m["1x1"] + m["3x3"] + m["5x5"] + m["pool_proj"]
        if m.get("pool", False):
            size = _pooled(size, 2)
    return out


def googlenet_convs(batch: int, cfg: dict) -> list[dict]:
    """Per conv of `conv_layers`: name, operations and bytes, for `batch`
    frames."""
    e = BYTES[cfg["compute_dtype"]]
    out = []
    for name, k, stride, pad, c_in, c_out, size in conv_layers(cfg):
        ho = (size + 2 * pad - k) // stride + 1
        out.append({"name": name,
                    "ops": 2.0 * batch * ho * ho * c_out * k * k * c_in,
                    "bytes": float(batch * size * size * c_in * e
                                   + k * k * c_in * c_out * e + c_out * 4
                                   + batch * ho * ho * c_out * e)})
    return out


def frame_ops(cfg: dict, tower: bool = True) -> float:
    """Operations of one frame through GoogLeNet's convs (and the tower)."""
    convs = sum(c["ops"] for c in googlenet_convs(1, cfg))
    return convs + (2.0 * cfg["feature_dim"] * cfg["embed_dim"] if tower
                    else 0.0)


def k2_least_s(batch: int, cfg: dict) -> float:
    """K2's least time: per conv the larger of operations at the bf16 peak
    and bytes at HBM bandwidth, summed."""
    return sum(least_s(c["ops"], c["bytes"], PEAK_BF16)
               for c in googlenet_convs(batch, cfg))


def query_least_s(batch: int, gallery: int, cfg: dict) -> float:
    """GoogLeNet and the tower at the compute dtype's peak, plus the f32
    scores (TF32 off) at the f32 peak."""
    return (batch * frame_ops(cfg) / PEAK_BF16
            + score_ops(batch, gallery, cfg["embed_dim"]) / PEAK_F32)
