"""K2: convolution as an implicit GEMM (CUDA C++ for sm_90a).

Counterpart of videovector_tpu/ops/pallas/conv_gemm.py. Unlike the Pallas
path, no patch matrix is written: the kernels gather patches while they load
their tiles. Three hand-written routes, picked from the operands alone by
`k2_route`:
- "sm90": csrc/conv_gemm_sm90.cu, cp.async gathers + TMA weights + wgmma,
  one launch per conv with every group in its grid (`k2_sm90_plan`), for
  bf16 NHWC/HWIO operands it can address;
- "f32": csrc/conv_gemm_f32_sm90.cu, cp.async gathers + TMA weights + FFMA
  (exact f32 products, no TF32), one launch per conv with every group in
  its grid and a deterministic split-K (`k2_f32_plan`), for f32 NHWC/HWIO
  operands it can address with an f32 output: the f32 Net's CONVOLUTION;
- "core": csrc/conv_gemm.cu on the GEMM core K1's core route uses
  (csrc/gemm_core.cuh), one launch per group, for everything else (odd
  strides or channel counts, f32 operands with a bf16 output).
On both Hopper routes a strided conv over too few channels for 16-byte
gathers (CaffeNet's conv1 and GoogLeNet's, 3 channels) is repacked by
`space_to_depth`, padding included. Each source note says what bounds its
kernel on the H100.

Three entry points: `conv2d_im2col_gemm`, the JAX signature (NCHW/OIHW,
f32 out, no groups, always the core); `conv2d_gemm_nhwc`, MedNet's conv
(NHWC/HWIO, groups, bias + ReLU epilogue, chosen out dtype); and
`conv2d_nchw`, the graph engine's CONVOLUTION (NCHW/OIHW, groups,
differentiable, JAX's Net numerics: one rounding of the f32 sum plus the
f32 bias).
The counters (utils/timer.py): `vvtpu.k2.launches` every K2 launch,
`vvtpu.k2.sm90_launches` and `vvtpu.k2.f32_launches` those of the sm90
and f32 routes, `vvtpu.s2d.launches` the repacks, `vvtpu.k2.layout_copies`
the channels_last copies `conv2d_nchw` makes of its inputs.
The epilogue is MedNet's (`conv_epilogue_plain`), not K1's: a bf16 output
rounds the sum, adds the rounded bias, rounds again, then applies ReLU.
Each launches a kernel where `device.runs_kernel` says so, else runs its
plain version (`*_plain`: im2col + matmul). `conv2d_gemm_nhwc` and
`conv2d_nchw` reach the kernels through the custom op
`vvtpu::k2_conv2d_nhwc`: its real implementation checks the operands,
picks the route (reading their addresses), repacks conv1 and launches,
counting each launch; its fake implementation checks their shapes and
dtypes and gives the output's, so `torch.export` traces K2 into a serving
artifact (tools/serving.py) as one node, and the artifact's launches count
too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from videovector_tpu_torch import _build
from videovector_tpu_torch.device import runs_kernel
from videovector_tpu_torch.ops.conv import im2col
from videovector_tpu_torch.ops.hopper.matmul import (
    DTYPE_CODES, INT_MAX, bias_f32, dtype_code, forward_only, same_device,
)
from videovector_tpu_torch.ops.linear import no_tf32
from videovector_tpu_torch.utils.timer import count, span

# the sm90 route's tiles (csrc/conv_gemm_sm90.cu): output columns per block
# (wgmma widths), and rows per block (64 per consumer warpgroup)
SM90_BLOCK_N = (192, 128, 96, 64)
SM90_BLOCK_M = (128, 64)
SM90_TILES = tuple((bm, bn) for bm in sorted(SM90_BLOCK_M)
                   for bn in sorted(SM90_BLOCK_N))
# the f32 route's tiles (csrc/conv_gemm_f32_sm90.cu): (block_m, block_n) ->
# (the blocks that share an SM, each of eight consumer warps an SM; the
# share of its SMs' FFMA peak the tile reached on the H100 where the grid
# fills its waves: CaffeNet's conv2..conv5 at batch 256,
# scripts/torch_k2_f32_tiles.py, PERF.md). K per stage.
F32_TILES = {(128, 128): (1, 0.68), (128, 64): (2, 0.65),
             (64, 128): (2, 0.69)}
F32_BK = 32
F32_MAX_SPLITS = 8
# what `k2_f32_plan` weighs its candidates with: one H100 SM's FFMA peak
# (67 TFLOP/s over 132 SMs); for split-K, HBM's 3.35 TB/s for the partial
# sums and the time of one more launch (the reduction's)
F32_SM_FMA_S = 67e12 / 2 / 132
HBM_BYTES_S = 3.35e12
SPLIT_LAUNCH_S = 5e-6


def conv_epilogue_plain(acc: torch.Tensor, b: torch.Tensor | None,
                        fuse_relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """K2's epilogue on an f32 sum, as models/mednet.py's bf16 conv: round
    to out_dtype, add the bias rounded to out_dtype, ReLU (the f32 case is
    act(acc + b), as K1's)."""
    y = acc.to(out_dtype)
    if b is not None:
        y = y + b.to(out_dtype)
    return torch.relu(y) if fuse_relu else y


def _out_hw(h, w, kh, kw, stride, pad):
    oh = (h + 2 * pad[0] - kh) // stride[0] + 1
    ow = (w + 2 * pad[1] - kw) // stride[1] + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv output would be empty: ({h},{w}) k=({kh},{kw})")
    return oh, ow


def _check(x, w, groups, out_dtype):
    """x: (N, C, H, W) and w: (O, C/groups, kh, kw), as logical views."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv wants 4-D x and w, got {tuple(x.shape)}, {tuple(w.shape)}")
    c, o = x.shape[1], w.shape[0]
    if c % groups or o % groups or w.shape[1] != c // groups:
        raise ValueError(f"channels {c} -> {o} with groups={groups} do not "
                         f"fit weight {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"x and w dtypes differ: {x.dtype} vs {w.dtype}")
    dtype_code(x.dtype, "x")
    dtype_code(out_dtype, "out_dtype")


def _conv_plain(x, w, b, stride, pad, groups, fuse_relu, out_dtype):
    """Plain K2 on logical NCHW/OIHW views: im2col + f32 matmul per group."""
    _check(x, w, groups, out_dtype)
    n, _, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh, ow = _out_hw(h, wd, kh, kw, stride, pad)
    cols = im2col(x.float(), kernel=(kh, kw), stride=stride, pad=pad)
    ck, og = cg * kh * kw, o // groups
    outs = []
    for g in range(groups):
        lhs = cols[:, g * ck:(g + 1) * ck].permute(0, 2, 3, 1).reshape(-1, ck)
        rhs = w[g * og:(g + 1) * og].float().reshape(og, ck).T
        bg = None if b is None else b[g * og:(g + 1) * og]
        outs.append(conv_epilogue_plain(lhs @ rhs, bg, fuse_relu,
                                        out_dtype).reshape(n, oh, ow, og))
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2)


def _space_to_depth_shape(h, wd, c, k, stride, pad, itemsize):
    """(kb, hb, wb, e, ep) of the repack: the repacked kernel's taps kb =
    ceil(k / s); the blocks hb x wb that the stride-1 conv over them reads
    (its output, (h + 2 pad - k) // s + 1, plus kb - 1); the s*s*C channels
    of a block and that count rounded up to a 16-byte chunk."""
    kb = -(-k // stride)
    hb = (h + 2 * pad - k) // stride + kb
    wb = (wd + 2 * pad - k) // stride + kb
    e = stride * stride * c
    chunk = 16 // itemsize
    return kb, hb, wb, e, -(-e // chunk) * chunk


def space_to_depth_plain(x, w, stride: int, pad: int = 0):
    """A stride-`stride` conv of x (N, H, W, C) with w (k, k, C, O), padded
    by `pad` on every side, as an unpadded stride-1 conv of xs (N, HB, WB,
    E) with ws (kb, kb, E, O), kb = ceil(k / s): each s x s block of the
    padded image becomes one pixel, and the kernel is zero-padded to kb*s
    taps. xs[n, bi, bj, (a s + b) C + c] = x[n, bi s + a - pad, bj s + b -
    pad, c], zero outside the image; HB = (H + 2 pad - k) // s + kb, so the
    output is the original conv's, and rows or columns the original steps
    past are cut. E is s*s*C rounded up to a 16-byte chunk of x's dtype (8
    bf16, 4 f32), the extra channels zero in xs and in ws. CaffeNet's conv1
    (11x11/4 over 227x227x3) becomes a 3x3 conv over 57x57x48; GoogLeNet's
    (7x7/2, pad 3, over 224x224x3) a 4x4 conv over 115x115x16 in bf16."""
    n, h, wd, c = x.shape
    k, o = w.shape[0], w.shape[3]
    kb, hb, wb, e, ep = _space_to_depth_shape(h, wd, c, k, stride, pad,
                                              x.element_size())
    t = kb * stride - k
    # negative end pads cut what the conv steps past
    xs = F.pad(x, (0, 0, pad, wb * stride - pad - wd,
                   pad, hb * stride - pad - h)) \
        .reshape(n, hb, stride, wb, stride, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, hb, wb, e)
    ws = F.pad(w, (0, 0, 0, 0, 0, t, 0, t)) \
        .reshape(kb, stride, kb, stride, c, o).permute(0, 2, 1, 3, 4, 5) \
        .reshape(kb, kb, e, o)
    return (F.pad(xs, (0, ep - e)), F.pad(ws, (0, 0, 0, ep - e)))


def space_to_depth(x, w, stride: int, pad: int = 0):
    """`space_to_depth_plain`'s repack: where `runs_kernel(x)` (contiguous,
    both bf16 or both f32) one launch of csrc/conv_gemm_sm90.cu's repack
    kernel, which zero-pads as it gathers (no padded copy of x is made),
    counted in `vvtpu.s2d.launches`; else the plain version. The host's
    time in it is the span `vvtpu.s2d`, the ctypes call
    `vvtpu.s2d.launch`."""
    with span("vvtpu.s2d"):
        if not runs_kernel(x):
            return space_to_depth_plain(x, w, stride, pad)
        forward_only(x, w)
        same_device(x, w)
        k, c = w.shape[0], x.shape[3]
        if not (x.dtype == w.dtype and x.dtype in DTYPE_CODES
                and x.is_contiguous() and w.is_contiguous()
                and w.shape[1] == k and w.shape[2] == c):
            raise ValueError(
                "space_to_depth on the card wants contiguous x (N, H, W, C) "
                "and w (k, k, C, O), both bf16 or both f32, got "
                f"{tuple(x.shape)} {x.dtype}, {tuple(w.shape)} {w.dtype}")
        return _space_to_depth(x, w, stride, pad)


def _space_to_depth(x, w, stride: int, pad: int):
    """One launch of the repack kernel on operands that fit it."""
    n, h, wd, c = x.shape
    k, o = w.shape[0], w.shape[3]
    kb, hb, wb, _, ep = _space_to_depth_shape(h, wd, c, k, stride, pad,
                                              x.element_size())
    xs = torch.empty((n, hb, wb, ep), dtype=x.dtype, device=x.device)
    ws = torch.empty((kb, kb, ep, o), dtype=w.dtype, device=w.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with span("vvtpu.s2d.launch"):
        rc = lib.vv_space_to_depth(
            x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(), n, h,
            wd, c, o, k, stride, pad, DTYPE_CODES[x.dtype],
            x.device.index or 0, stream)
    _build.check(rc, "K2 space_to_depth")
    count("vvtpu.s2d.launches", 1)
    return xs, ws


def _space_to_depth_fits(x, w, stride, pad, groups) -> bool:
    """Whether `space_to_depth` takes this NHWC/HWIO conv onto a Hopper
    route: one group, one stride > 1 and one pad for a square kernel, and
    a non-empty output. The repack pads the image and rounds its channels
    up to 16-byte chunks itself."""
    h, wd = x.shape[1:3]
    k = w.shape[0]
    s, p = stride[0], pad[0]
    return (groups == 1 and stride[1] == s > 1 and pad[1] == p >= 0
            and w.shape[1] == k and h + 2 * p >= k and wd + 2 * p >= k)


def k2_route(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype, *,
             stride=(1, 1), pad=(0, 0)) -> str:
    """The route a CUDA `conv2d_gemm_nhwc` call with x (N, H, W, C) and HWIO
    w (kh, kw, C/groups, O) takes: "sm90" for bf16 operands with an f32 or
    bf16 output, "f32" for f32 operands with an f32 output, when the
    kernel's 16-byte gathers can address them (channels contiguous, pixel
    strides and channels per group multiples of a chunk, 8 bf16 or 4 f32;
    16-byte-aligned data, contiguous w, output channels per group a
    multiple of a chunk), or contiguous, aligned ones that `space_to_depth`
    makes so; "core" otherwise (so a strided view of w, x one element past
    an aligned address, or f32 operands with a bf16 output, take the core).
    groups = C / w.shape[2]."""
    if (x.dim() != 4 or w.dim() != 4 or x.dtype != w.dtype
            or min(x.shape) == 0 or min(w.shape) == 0):
        return "core"
    if x.dtype == torch.bfloat16 and out_dtype in (torch.float32,
                                                    torch.bfloat16):
        route = "sm90"
    elif x.dtype == torch.float32 and out_dtype == torch.float32:
        route = "f32"
    else:
        return "core"
    chunk = 16 // x.element_size()
    c, cg, o = x.shape[3], w.shape[2], w.shape[3]
    if c % cg or o % (c // cg) or (o // (c // cg)) % chunk:
        return "core"
    if cg % chunk:
        fits = (x.is_contiguous() and w.is_contiguous()
                and x.data_ptr() % 16 == 0
                and _space_to_depth_fits(x, w, stride, pad, c // cg))
        return route if fits else "core"
    addressable = (x.stride(3) == 1
                   and all(st % chunk == 0 for st in x.stride()[:3])
                   and x.data_ptr() % 16 == 0
                   and w.is_contiguous() and w.data_ptr() % 16 == 0)
    return route if addressable else "core"


def k2_sm90_plan(m: int, og: int, groups: int, sms: int):
    """(block_m, block_n, grid) of the sm90 route for a conv with m output
    pixels and og output channels in each of `groups` groups, on a card with
    `sms` SMs. block_n is the widest tile that wastes fewest columns of a
    group (one that divides og where there is one: 96, 128, 192 on
    CaffeNet); a tile never reaches into the next group, whose columns the
    kernel masks. block_m is 128 (two consumer warpgroups) when that gives
    at least two blocks per SM, else 64: on the H100 the smaller blocks,
    two to an SM, ran conv3..conv5 at batch 50 faster, and the larger ones
    every conv at batch 256 (scripts/torch_k2_tiles.py). grid = (M tiles, N
    tiles of a group, groups): block (i, j, g) writes rows [i*block_m,
    (i+1)*block_m) and the group's columns g*og + [j*block_n,
    min((j+1)*block_n, og))."""
    block_n = min(SM90_BLOCK_N, key=lambda bn: (-(-og // bn) * bn, -bn))
    n_tiles = -(-og // block_n)
    block_m = 128 if -(-m // 128) * n_tiles * groups >= 2 * sms else 64
    return block_m, block_n, (-(-m // block_m), n_tiles, groups)


def k2_f32_plan(m: int, og: int, groups: int, k: int, sms: int):
    """(block_m, block_n, splits) of the f32 route for a conv with m output
    pixels, og output channels in each of `groups` groups and a reduction
    of k = kh*kw*Cg, on a card with `sms` SMs. The grid is (M tiles, N
    tiles of a group, groups * splits): block (i, j, g * splits + s) writes
    rows [i*block_m, (i+1)*block_m) and the group's columns g*og +
    [j*block_n, min((j+1)*block_n, og)), summed over the K tiles (F32_BK
    each) [s*KT // splits, (s+1)*KT // splits). Of F32_TILES and 1 to
    F32_MAX_SPLITS splits (no more than KT), the plan takes the least
    modelled time: the waves of `sms` x (blocks per SM) blocks, each wave
    as long as its blocks' FFMAs at the tile's share of F32_SM_FMA_S an
    SM, plus, with splits,
    the partial sums' HBM traffic (splits written, splits read, the output
    written) and the reduction's launch; ties go to fewer splits, then to
    the larger tile. So a tile that divides og wastes no columns, and a
    grid that leaves most of its last wave empty is split along K."""
    k_tiles = max(1, -(-k // F32_BK))
    return min(((bm, bn, s) for bm, bn in F32_TILES
                for s in range(1, min(k_tiles, F32_MAX_SPLITS) + 1)),
               key=lambda c: (f32_plan_seconds(m, og, groups, k, sms, *c),
                              c[2], -c[0] * c[1], -c[0]))


def f32_plan_seconds(m: int, og: int, groups: int, k: int, sms: int,
                     block_m: int, block_n: int, splits: int) -> float:
    """`k2_f32_plan`'s modelled time of one candidate, in seconds."""
    per_sm, rate = F32_TILES[(block_m, block_n)]
    k_tiles = max(1, -(-k // F32_BK))
    tiles = -(-m // block_m) * -(-og // block_n) * groups
    waves = -(-tiles * splits // (sms * per_sm))
    fmas = waves * per_sm * block_m * block_n * -(-k_tiles // splits) * F32_BK
    t = fmas / (F32_SM_FMA_S * rate)
    if splits > 1:
        t += SPLIT_LAUNCH_S + (2 * splits + 1) * m * og * groups * 4 / HBM_BYTES_S
    return t


def _conv_hopper(route, x, w, b, stride, pad, fuse_relu, out_dtype):
    """Launches the sm90 or the f32 route once for an NHWC/HWIO conv whose
    operands `k2_route` sent there, after conv1's repack where the channels
    per group do not fill 16-byte chunks; returns the (N, oh, ow, O)
    output. `k2_route` has checked that the repack fits the operands."""
    if w.shape[2] % (16 // x.element_size()):
        with span("vvtpu.s2d"):
            x, w = _space_to_depth(x, w, stride[0], pad[0])
        stride, pad = (1, 1), (0, 0)
    n, h, wd, c = x.shape
    kh, kw, cg, o = w.shape
    groups = c // cg
    oh, ow = _out_hw(h, wd, kh, kw, stride, pad)
    m = n * oh * ow
    if max(m, kh * kw * cg, o) > INT_MAX:
        raise ValueError("conv GEMM dims beyond int32")
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=x.device)
    bias = bias_f32(b, o)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = _build.load_library()
    args = (x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr())
    geom = (n, h, wd, c, o, kh, kw, stride[0], stride[1], pad[0], pad[1], oh,
            ow, groups, x.stride(0), x.stride(1), x.stride(2))
    tail = (int(fuse_relu), x.device.index or 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if route == "sm90":
        block_m, block_n, _ = k2_sm90_plan(m, o // groups, groups, sms)
        with span("vvtpu.k2.launch"):
            rc = lib.vv_conv_gemm_sm90(*args, *geom, block_m, block_n,
                                       DTYPE_CODES[out_dtype], *tail)
        _build.check(rc, "K2 conv_gemm (sm90 route)")
        count("vvtpu.k2.sm90_launches", 1)
    else:
        block_m, block_n, splits = k2_f32_plan(m, o // groups, groups,
                                               kh * kw * cg, sms)
        ws = (torch.empty((splits, m, o), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        with span("vvtpu.k2.launch"):
            rc = lib.vv_conv_gemm_f32_sm90(
                *args, ws.data_ptr() if ws is not None else None, *geom,
                block_m, block_n, splits, *tail)
        _build.check(rc, "K2 conv_gemm (f32 route)")
        count("vvtpu.k2.f32_launches", 1)
    count("vvtpu.k2.launches", 1)
    return out


def _conv_kernel(x, w, b, out, stride, pad, groups, fuse_relu):
    """Launches the core route once per group on logical NCHW/OIHW/NCHW views (any
    strides), writing each group's channel slice of `out`, on operands its
    caller has checked."""
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh, ow = out.shape[2], out.shape[3]
    if max(n * oh * ow, cg * kh * kw, o) > INT_MAX:
        raise ValueError("conv GEMM dims beyond int32")
    if out.numel() == 0:
        return out
    og = o // groups
    bias = bias_f32(b, o)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg]
        wg = w[g * og:(g + 1) * og]
        outg = out[:, g * og:(g + 1) * og]
        bg = None if bias is None else bias[g * og:(g + 1) * og]
        with span("vvtpu.k2.launch"):
            rc = lib.vv_conv_gemm(
                xg.data_ptr(), wg.data_ptr(),
                bg.data_ptr() if bg is not None else None, outg.data_ptr(), n,
                cg, h, wd, og, kh, kw, stride[0], stride[1], pad[0], pad[1],
                oh, ow, *xg.stride(), *wg.stride(), *outg.stride(),
                DTYPE_CODES[x.dtype], DTYPE_CODES[out.dtype], int(fuse_relu),
                x.device.index or 0, stream)
        _build.check(rc, "K2 conv_gemm")
        count("vvtpu.k2.launches", 1)
    return out


def conv2d_im2col_gemm_plain(x, w, b=None, *, stride=(1, 1), pad=(0, 0)):
    if x.shape[1] != w.shape[1]:
        raise ValueError("conv_gemm path does not support groups")
    return _conv_plain(x, w, b, stride, pad, 1, False, torch.float32)


def conv2d_im2col_gemm(x, w, b=None, *, stride=(1, 1), pad=(0, 0)):
    """x: (N, C, H, W); w: (O, C, kh, kw); b: (O,) -> (N, O, oh, ow) f32.
    Groups unsupported on this entry point (as in the JAX module)."""
    if not runs_kernel(x):
        return conv2d_im2col_gemm_plain(x, w, b, stride=stride, pad=pad)
    if x.dim() == 4 and w.dim() == 4 and x.shape[1] != w.shape[1]:
        raise ValueError("conv_gemm path does not support groups")
    _check(x, w, 1, torch.float32)
    forward_only(x, w, b)
    same_device(x, w, b)
    oh, ow = _out_hw(x.shape[2], x.shape[3], w.shape[2], w.shape[3], stride, pad)
    out = torch.empty((x.shape[0], w.shape[0], oh, ow), dtype=torch.float32,
                      device=x.device)
    return _conv_kernel(x, w, b, out, stride, pad, 1, False)


def conv2d_gemm_nhwc_plain(x, w, b=None, *, stride=(1, 1), pad=(0, 0),
                           groups: int = 1, fuse_relu: bool = False,
                           out_dtype=torch.float32):
    y = _conv_plain(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride,
                    pad, groups, fuse_relu, out_dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_gemm_nhwc(x, w, b=None, *, stride=(1, 1), pad=(0, 0),
                     groups: int = 1, fuse_relu: bool = False,
                     out_dtype=torch.float32):
    """x: (N, H, W, C); w: (kh, kw, C/groups, O) HWIO; b: (O,) ->
    act(conv + b): (N, oh, ow, O) in out_dtype, contiguous NHWC."""
    if runs_kernel(x):
        forward_only(x, w, b)
        return torch.ops.vvtpu.k2_conv2d_nhwc(
            x, w, b, list(stride), list(pad), int(groups), fuse_relu,
            out_dtype)
    with span("vvtpu.k2"):
        return conv2d_gemm_nhwc_plain(x, w, b, stride=stride, pad=pad,
                                      groups=groups, fuse_relu=fuse_relu,
                                      out_dtype=out_dtype)


@torch.library.custom_op(
    "vvtpu::k2_conv2d_nhwc", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor? b, int[] stride, int[] pad, "
           "int groups, bool fuse_relu, ScalarType out_dtype) -> Tensor")
def k2_conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   stride: list[int], pad: list[int], groups: int,
                   fuse_relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """K2 as a custom op: `conv2d_gemm_nhwc`'s launch on CUDA tensors (the
    route from `k2_route`, counted), its plain version on CPU tensors; the
    host's time in it is the span `vvtpu.k2`, each ctypes call
    `vvtpu.k2.launch` (conv1's repack, `vvtpu.s2d`, runs inside it)."""
    with span("vvtpu.k2"):
        if x.device.type == "cpu":
            return conv2d_gemm_nhwc_plain(x, w, b, stride=stride, pad=pad,
                                          groups=groups, fuse_relu=fuse_relu,
                                          out_dtype=out_dtype)
        return _k2_launch(x, w, b, tuple(stride), tuple(pad), groups,
                          fuse_relu, out_dtype)


def _k2_launch(x, w, b, stride, pad, groups, fuse_relu, out_dtype):
    xv, wv = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    _check(xv, wv, groups, out_dtype)
    same_device(x, w, b)
    route = k2_route(x, w, out_dtype, stride=stride, pad=pad)
    if route != "core":
        return _conv_hopper(route, x, w, b, stride, pad, fuse_relu, out_dtype)
    oh, ow = _out_hw(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, pad)
    out = torch.empty((x.shape[0], oh, ow, w.shape[3]), dtype=out_dtype,
                      device=x.device)
    _conv_kernel(xv, wv, b, out.permute(0, 3, 1, 2), stride, pad, groups,
                 fuse_relu)
    return out


@k2_conv2d_nhwc.register_fake
def _k2_conv2d_nhwc_fake(x, w, b, stride, pad, groups, fuse_relu, out_dtype):
    _check(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), groups, out_dtype)
    oh, ow = _out_hw(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride,
                     pad)
    return x.new_empty((x.shape[0], oh, ow, w.shape[3]), dtype=out_dtype)


def _conv_nchw_f32(x, w, b, stride, pad, groups):
    """conv(x, w) + b with an f32 sum and the f32 bias added in f32, as an
    (N, O, oh, ow) f32 tensor: where `runs_kernel(x)`, K2 through
    channels_last views (a copy of x unless it is channels_last already,
    counted in `vvtpu.k2.layout_copies`), so that its output has NHWC
    strides: the f32 route for f32 operands, the sm90 route for bf16 ones,
    the core for what neither addresses; else the plain version."""
    if not runs_kernel(x):
        return _conv_plain(x, w, b, stride, pad, groups, False, torch.float32)
    if not x.is_contiguous(memory_format=torch.channels_last):
        count("vvtpu.k2.layout_copies", 1)
    y = torch.ops.vvtpu.k2_conv2d_nhwc(
        x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1),
        w.permute(2, 3, 1, 0).contiguous(), b, list(stride), list(pad),
        groups, False, torch.float32)
    return y.permute(0, 3, 1, 2)


class _ConvNCHW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, pad, groups, cdt):
        xc, wc = x.to(cdt), w.to(cdt)
        with no_tf32():
            y = _conv_nchw_f32(xc, wc, b, stride, pad, groups)
        ctx.save_for_backward(xc, wc)
        ctx.geometry = (stride, pad, groups)
        ctx.dtypes = (x.dtype, w.dtype)
        return y.to(cdt)

    @staticmethod
    def backward(ctx, dy):
        xc, wc = ctx.saved_tensors
        stride, pad, groups = ctx.geometry
        dy = dy.float()
        dx = dw = db = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(
                    xc.shape, wc.float(), dy, stride, pad, groups=groups)
                dx = dx.to(xc.dtype).to(ctx.dtypes[0])
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(
                    xc.float(), wc.shape, dy, stride, pad, groups=groups)
                dw = dw.to(wc.dtype).to(ctx.dtypes[1])
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 2, 3))
        return dx, dw, db, None, None, None, None


def conv2d_nchw(x, w, b=None, *, stride=(1, 1), pad=(0, 0), groups: int = 1,
                compute_dtype: torch.dtype | None = None):
    """The graph engine's convolution: x (N, C, H, W), w (O, C/groups, kh,
    kw) OIHW, b (O,) f32 -> (N, O, oh, ow) in the compute dtype (x's dtype
    when None), differentiable in all three.

    x and w are cast to the compute dtype, the sum and the bias stay f32,
    and the result is rounded once, as the JAX Net's CONVOLUTION
    (ops/conv.py::conv2d with preferred_element_type f32). So a bf16 conv
    takes K2's f32 output and casts it, rather than K2's bf16 epilogue
    (MedNet's: round, add the rounded bias, round again). Where
    `runs_kernel(x)` the forward is K2 (`_conv_nchw_f32`; the output keeps
    K2's NHWC strides, as a channels_last tensor), else its plain version.
    The backward is plain PyTorch with TF32 off (the JAX package has no
    backward kernel): dx and dw in f32, each rounded to its operand's
    compute dtype, as the cotangents of JAX's casts are."""
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    return _ConvNCHW.apply(x, w, b, tuple(stride), tuple(pad), int(groups),
                           cdt)
