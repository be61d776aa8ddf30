"""K2: convolution as an implicit GEMM (CUDA C++ for sm_90a).

Counterpart of videovector_tpu/ops/pallas/conv_gemm.py. Unlike the Pallas
path, no patch matrix is written: the kernels gather patches while they load
their tiles. Two hand-written routes, picked from the operands alone by
`k2_route`:
- "sm90": csrc/conv_gemm_sm90.cu, cp.async gathers + TMA weights + wgmma,
  one launch per conv with every group in its grid (`k2_sm90_plan`), for
  bf16 NHWC/HWIO operands it can address. A conv over too few channels for
  16-byte gathers (CaffeNet's conv1, 3 channels) is repacked by
  `space_to_depth` when its geometry allows;
- "core": csrc/conv_gemm.cu on the GEMM core K1's core route uses
  (csrc/gemm_core.cuh), one launch per group, for everything else (f32
  operands, odd strides or channel counts).
Each source note says what bounds its kernel on the H100.

Two entry points: `conv2d_im2col_gemm`, the JAX signature (NCHW/OIHW, f32
out, no groups, always the core), and `conv2d_gemm_nhwc`, MedNet's conv
(NHWC/HWIO, groups, bias + ReLU epilogue, chosen out dtype).
`conv2d_im2col_gemm.launches` counts every K2 launch of either,
`conv2d_im2col_gemm.launches_sm90` those of the sm90 route.
The epilogue is MedNet's (`conv_epilogue_plain`), not K1's: a bf16 output
rounds the sum, adds the rounded bias, rounds again, then applies ReLU.
Each runs its plain version (`*_plain`: im2col + matmul) for CPU tensors and
launches a kernel for CUDA tensors; on any other device it raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videovector_tpu_torch import _build
from videovector_tpu_torch.ops.conv import im2col
from videovector_tpu_torch.ops.hopper.matmul import (
    DTYPE_CODES, INT_MAX, bias_f32, check_cuda_operands, dtype_code,
)

# the sm90 route's tiles (csrc/conv_gemm_sm90.cu): output columns per block
# (wgmma widths), and rows per block (64 per consumer warpgroup)
SM90_BLOCK_N = (192, 128, 96, 64)
SM90_BLOCK_M = (128, 64)
SM90_TILES = tuple((bm, bn) for bm in sorted(SM90_BLOCK_M)
                   for bn in sorted(SM90_BLOCK_N))


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


def space_to_depth_plain(x, w, stride: int):
    """An unpadded stride-`stride` conv of x (N, H, W, C) with w (k, k, C, O)
    as a stride-1 conv of xs (N, H', W', s*s*C) with ws (kb, kb, s*s*C, O),
    kb = ceil(k / s): each s x s block of pixels becomes one pixel, and the
    kernel is zero-padded to kb*s taps. Needs (H - k) % s == 0 and
    (W - k) % s == 0; the input is padded by kb*s - k rows and columns at
    the end, which meet only the zero taps. CaffeNet's conv1 (11x11/4 over
    227x227x3) becomes a 3x3 conv over 57x57x48."""
    n, h, wd, c = x.shape
    k, o = w.shape[0], w.shape[3]
    kb = -(-k // stride)
    e = kb * stride - k
    hb, wb = (h + e) // stride, (wd + e) // stride
    xs = F.pad(x, (0, 0, 0, e, 0, e)) \
        .reshape(n, hb, stride, wb, stride, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, hb, wb, stride * stride * c)
    ws = F.pad(w, (0, 0, 0, 0, 0, e, 0, e)) \
        .reshape(kb, stride, kb, stride, c, o).permute(0, 2, 1, 3, 4, 5) \
        .reshape(kb, kb, stride * stride * c, o)
    return xs, ws


def space_to_depth(x, w, stride: int):
    """`space_to_depth_plain`'s repack: for CUDA tensors (contiguous bf16)
    one launch of csrc/conv_gemm_sm90.cu's repack kernel, counted in
    `space_to_depth.launches`; for CPU tensors the plain version."""
    if x.device.type == "cpu":
        return space_to_depth_plain(x, w, stride)
    check_cuda_operands(x, w)
    n, h, wd, c = x.shape
    k, o = w.shape[0], w.shape[3]
    if not (x.dtype == w.dtype == torch.bfloat16 and x.is_contiguous()
            and w.is_contiguous() and w.shape[1] == k and w.shape[2] == c):
        raise ValueError("space_to_depth on the card wants contiguous bf16 x "
                         f"(N, H, W, C) and w (k, k, C, O), got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(w.shape)} {w.dtype}")
    kb = -(-k // stride)
    e = kb * stride - k
    xs = torch.empty((n, (h + e) // stride, (wd + e) // stride,
                      stride * stride * c), dtype=x.dtype, device=x.device)
    ws = torch.empty((kb, kb, stride * stride * c, o), dtype=w.dtype,
                     device=w.device)
    rc = _build.load_library().vv_space_to_depth(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(), n, h, wd, c,
        o, k, stride, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "K2 space_to_depth")
    space_to_depth.launches += 1
    return xs, ws


space_to_depth.launches = 0


def _space_to_depth_fits(x, w, stride, pad, groups) -> bool:
    """Whether `space_to_depth` takes this NHWC/HWIO conv onto the sm90
    route: one group, no padding, one stride > 1 for a square kernel that
    steps exactly across the image, and s*s*C channels in 16-byte chunks."""
    h, wd, c = x.shape[1:]
    k = w.shape[0]
    s = stride[0]
    return (groups == 1 and tuple(pad) == (0, 0) and stride[1] == s > 1
            and w.shape[1] == k and h >= k and wd >= k
            and (h - k) % s == 0 and (wd - k) % s == 0
            and (s * s * c) % 8 == 0)


def k2_route(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype, *,
             stride=(1, 1), pad=(0, 0)) -> str:
    """The route a CUDA `conv2d_gemm_nhwc` call with x (N, H, W, C) and HWIO
    w (kh, kw, C/groups, O) takes: "sm90" for bf16 operands the kernel can
    address (channels contiguous, pixel strides and channels per group
    multiples of 8, 16-byte-aligned data, contiguous w, output channels per
    group a multiple of 8), or contiguous, aligned ones that
    `space_to_depth` makes so, with an f32 or bf16 output; "core" otherwise
    (so a strided view of w, or x one element past an aligned address,
    forces the core). groups = C / w.shape[2]."""
    if (x.dim() != 4 or w.dim() != 4 or x.dtype != torch.bfloat16
            or w.dtype != torch.bfloat16
            or out_dtype not in (torch.float32, torch.bfloat16)
            or min(x.shape) == 0 or min(w.shape) == 0):
        return "core"
    c, cg, o = x.shape[3], w.shape[2], w.shape[3]
    if c % cg or o % (c // cg) or (o // (c // cg)) % 8:
        return "core"
    if cg % 8:
        fits = (x.is_contiguous() and w.is_contiguous()
                and x.data_ptr() % 16 == 0
                and _space_to_depth_fits(x, w, stride, pad, c // cg))
        return "sm90" if fits else "core"
    addressable = (x.stride(3) == 1
                   and all(st % 8 == 0 for st in x.stride()[:3])
                   and x.data_ptr() % 16 == 0
                   and w.is_contiguous() and w.data_ptr() % 16 == 0)
    return "sm90" if addressable else "core"


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


def _conv_sm90(x, w, b, stride, pad, fuse_relu, out_dtype):
    """Launches the sm90 route once for an NHWC/HWIO conv whose operands
    `k2_route` sent there; returns the (N, oh, ow, O) output."""
    check_cuda_operands(x, w, b)
    if w.shape[2] % 8:
        x, w = space_to_depth(x, w, stride[0])
        stride = (1, 1)
    n, h, wd, c = x.shape
    kh, kw, cg, o = w.shape
    groups = c // cg
    oh, ow = _out_hw(h, wd, kh, kw, stride, pad)
    if max(n * oh * ow, kh * kw * cg, o) > INT_MAX:
        raise ValueError("conv GEMM dims beyond int32")
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=x.device)
    bias = bias_f32(b, o)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    block_m, block_n, _ = k2_sm90_plan(n * oh * ow, o // groups, groups, sms)
    rc = _build.load_library().vv_conv_gemm_sm90(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), n, h, wd, c, o, kh, kw, stride[0], stride[1], pad[0],
        pad[1], oh, ow, groups, x.stride(0), x.stride(1), x.stride(2),
        block_m, block_n, DTYPE_CODES[out_dtype], int(fuse_relu),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "K2 conv_gemm (sm90 route)")
    conv2d_im2col_gemm.launches += 1
    conv2d_im2col_gemm.launches_sm90 += 1
    return out


def _conv_kernel(x, w, b, out, stride, pad, groups, fuse_relu):
    """Launches the core route once per group on logical NCHW/OIHW/NCHW views (any
    strides), writing each group's channel slice of `out`."""
    check_cuda_operands(x, w, b, out)
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
        rc = lib.vv_conv_gemm(
            xg.data_ptr(), wg.data_ptr(), bg.data_ptr() if bg is not None else None,
            outg.data_ptr(), n, cg, h, wd, og, kh, kw, stride[0], stride[1],
            pad[0], pad[1], oh, ow, *xg.stride(), *wg.stride(), *outg.stride(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[out.dtype], int(fuse_relu),
            x.device.index or 0, stream)
        _build.check(rc, "K2 conv_gemm")
        conv2d_im2col_gemm.launches += 1
    return out


def _device_kind(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CUDA or (plain) CPU tensors, not {x.device}")
    return x.device.type


def conv2d_im2col_gemm_plain(x, w, b=None, *, stride=(1, 1), pad=(0, 0)):
    if x.shape[1] != w.shape[1]:
        raise ValueError("conv_gemm path does not support groups")
    return _conv_plain(x, w, b, stride, pad, 1, False, torch.float32)


def conv2d_im2col_gemm(x, w, b=None, *, stride=(1, 1), pad=(0, 0)):
    """x: (N, C, H, W); w: (O, C, kh, kw); b: (O,) -> (N, O, oh, ow) f32.
    Groups unsupported on this entry point (as in the JAX module)."""
    if _device_kind(x) == "cpu":
        return conv2d_im2col_gemm_plain(x, w, b, stride=stride, pad=pad)
    if x.dim() == 4 and w.dim() == 4 and x.shape[1] != w.shape[1]:
        raise ValueError("conv_gemm path does not support groups")
    _check(x, w, 1, torch.float32)
    oh, ow = _out_hw(x.shape[2], x.shape[3], w.shape[2], w.shape[3], stride, pad)
    out = torch.empty((x.shape[0], w.shape[0], oh, ow), dtype=torch.float32,
                      device=x.device)
    return _conv_kernel(x, w, b, out, stride, pad, 1, False)


conv2d_im2col_gemm.launches = 0
conv2d_im2col_gemm.launches_sm90 = 0


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
    if _device_kind(x) == "cpu":
        return conv2d_gemm_nhwc_plain(x, w, b, stride=stride, pad=pad,
                                      groups=groups, fuse_relu=fuse_relu,
                                      out_dtype=out_dtype)
    xv, wv = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    _check(xv, wv, groups, out_dtype)
    if k2_route(x, w, out_dtype, stride=stride, pad=pad) == "sm90":
        return _conv_sm90(x, w, b, stride, pad, fuse_relu, out_dtype)
    oh, ow = _out_hw(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, pad)
    out = torch.empty((x.shape[0], oh, ow, w.shape[3]), dtype=out_dtype,
                      device=x.device)
    _conv_kernel(xv, wv, b, out.permute(0, 3, 1, 2), stride, pad, groups,
                 fuse_relu)
    return out
