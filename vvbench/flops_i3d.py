"""Operations and bytes of the `i3d-retrieval` configuration's work, from
its table alone (never read from a kernel), at the H100 peaks of
vvbench/flops.py.

Every conv and pool pads by TF's SAME rule: an axis of n at stride s gives
ceil(n / s). A conv's bytes count its NDHWC input in the compute dtype
once, its DHWIO weights in the compute dtype once, its f32 bias (the
folded BatchNorm) and its output in the compute dtype once, as
flops_googlenet counts GoogLeNet's; a max pool's its input and its output
once. What K2 gathers again from L2, conv1's repack and the
concatenations are not the work's.
"""

from __future__ import annotations

from vvbench.flops import (
    BYTES, PEAK_BF16, PEAK_BYTES, PEAK_F32, least_s, score_ops,
)

BRANCHES = ("Branch_0/Conv3d_0a_1x1", "Branch_1/Conv3d_0a_1x1",
            "Branch_1/Conv3d_0b_3x3", "Branch_2/Conv3d_0a_1x1",
            "Branch_2/Conv3d_0b_3x3", "Branch_3/Conv3d_0b_1x1")


def _same(size: tuple, stride) -> tuple:
    stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    return tuple(-(-n // s) for n, s in zip(size, stride))


def layers(cfg: dict, frames: int | None = None) -> tuple[list, list]:
    """(convs, pools) of one clip of `frames` (cfg["clip_frames"] by
    default) at cfg["crop"], in the forward's order. A conv is (name,
    kernel, stride, c_in, c_out, input (T, H, W), output (T, H, W)), its
    kernel and stride cubic; a pool (name, window, stride, channels, input,
    output)."""
    size = (frames or cfg["clip_frames"], cfg["crop"], cfg["crop"])
    convs, pools, c = [], [], 3

    def conv(name, k, s, c_in, c_out, at):
        out = _same(at, s)
        convs.append((name, k, s, c_in, c_out, at, out))
        return out

    def pool(name, window, stride, ch, at):
        out = _same(at, stride)
        pools.append((name, tuple(window), tuple(stride), ch, at, out))
        return out

    for layer in cfg["stem"]:
        if "window" in layer:
            size = pool(layer["name"], layer["window"], layer["stride"], c,
                        size)
        else:
            size = conv(layer["name"], layer["kernel"], layer["stride"], c,
                        layer["out"], size)
            c = layer["out"]
    mp = cfg["module_pool"]
    for m in cfg["modules"]:
        p = m["name"] + "/"
        w = [m[b] for b in BRANCHES]
        conv(p + BRANCHES[0], 1, 1, c, w[0], size)
        conv(p + BRANCHES[1], 1, 1, c, w[1], size)
        conv(p + BRANCHES[2], 3, 1, w[1], w[2], size)
        conv(p + BRANCHES[3], 1, 1, c, w[3], size)
        conv(p + BRANCHES[4], 3, 1, w[3], w[4], size)
        pool(p + "Branch_3/MaxPool3d_0a_3x3", mp["window"], mp["stride"], c,
             size)
        conv(p + BRANCHES[5], 1, 1, c, w[5], size)
        c = w[0] + w[2] + w[4] + w[5]
        if m["pool"]:
            size = pool(m["pool"]["name"], m["pool"]["window"],
                        m["pool"]["stride"], c, size)
    return convs, pools


def _prod(size: tuple) -> int:
    out = 1
    for n in size:
        out *= n
    return out


def i3d_convs(clips: int, cfg: dict, frames: int | None = None) -> list[dict]:
    """Per conv of `layers`: name, operations and bytes, for `clips` clips."""
    e = BYTES[cfg["compute_dtype"]]
    out = []
    for name, k, _, c_in, c_out, at, to in layers(cfg, frames)[0]:
        taps = k ** 3
        out.append({"name": name, "kernel": k,
                    "ops": 2.0 * clips * _prod(to) * c_out * taps * c_in,
                    "bytes": float(clips * _prod(at) * c_in * e
                                   + taps * c_in * c_out * e + c_out * 4
                                   + clips * _prod(to) * c_out * e)})
    return out


def i3d_pools(clips: int, cfg: dict, frames: int | None = None) -> list[dict]:
    """Per max pool of `layers`: name, window depth and bytes (input and
    output once, the compute dtype), for `clips` clips."""
    e = BYTES[cfg["compute_dtype"]]
    return [{"name": name, "depth": window[0],
             "bytes": float(clips * (_prod(at) + _prod(to)) * ch * e)}
            for name, window, _, ch, at, to in layers(cfg, frames)[1]]


def clip_ops(cfg: dict, tower: bool = True) -> float:
    """Operations of one clip through I3D's convs (and the tower)."""
    convs = sum(c["ops"] for c in i3d_convs(1, cfg))
    return convs + (2.0 * cfg["feature_dim"] * cfg["embed_dim"] if tower
                    else 0.0)


def k2_least_s(clips: int, cfg: dict) -> float:
    """K2's least time: per conv the larger of operations at the bf16 peak
    and bytes at HBM bandwidth, summed."""
    return sum(least_s(c["ops"], c["bytes"], PEAK_BF16)
               for c in i3d_convs(clips, cfg))


def pool_least_s(clips: int, cfg: dict) -> float:
    """The max pools' least time: their bytes at HBM bandwidth."""
    return sum(p["bytes"] for p in i3d_pools(clips, cfg)) / PEAK_BYTES


def query_least_s(clips: int, gallery: int, cfg: dict) -> float:
    """I3D and the tower at the compute dtype's peak, plus the f32 scores
    (TF32 off) at the f32 peak."""
    return (clips * clip_ops(cfg) / PEAK_BF16
            + score_ops(clips, gallery, cfg["embed_dim"]) / PEAK_F32)
