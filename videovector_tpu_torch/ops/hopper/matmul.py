"""K1: GEMM with a fused bias + ReLU epilogue (CUDA C++ for sm_90a).

Counterpart of videovector_tpu/ops/pallas/matmul.py: out = round(act(x.w +
b)), an f32 sum with the bias and ReLU applied in f32 and one rounding to
the output type at the end, as the Pallas kernel does. The sm90 route also
takes GELU as its activation (`fuse_gelu`: exact erf, in f32 before the
rounding; TimeSformer's fc1), which the Pallas kernel has not. Three
hand-written routes, picked from the operands alone by `k1_route`:
- "sm90": csrc/matmul_sm90.cu, a TMA + wgmma GEMM with split-K
  (`k1_split_plan`), for bf16 operands that TMA can address;
- "f32": csrc/matmul_f32_sm90.cu, a TMA-fed FFMA GEMM with split-K
  (`k1_f32_plan`), for f32 operands that TMA can address (exact f32
  products, no TF32): the f32 Net's INNER_PRODUCT;
- "core": csrc/matmul.cu on the core in csrc/gemm_core.cuh, for everything
  else (transposed or odd-strided views, on f32 FMA or bf16 WMMA tiles).
Each source note says what bounds its kernel on the H100.

`matmul` launches a kernel where `device.runs_kernel` says so, else runs
`matmul_plain`, the plain PyTorch version. It reaches the kernels through
the custom op `vvtpu::k1_matmul`, whose real implementation checks the
operands, picks the route (reading their addresses) and launches, and
whose fake implementation checks their shapes and dtypes and gives the
output's: so `torch.export` traces K1 into a serving artifact
(tools/serving.py) as one node, and the artifact launches it when it runs.
The op counts each launch in `vvtpu.k1.launches`, those of the sm90 and
f32 routes in `vvtpu.k1.sm90_launches` and `vvtpu.k1.f32_launches`, those
with GELU in `vvtpu.k1.gelu_launches` (utils/timer.py), an artifact's too.
The kernels are forward only, as the Pallas kernel is: the training tower
reaches K1 through ops.linear.tower_matmul, an autograd Function whose
backward is torch.matmul.
"""

from __future__ import annotations

from typing import Optional

import torch

from videovector_tpu_torch import _build
from videovector_tpu_torch.device import runs_kernel
from videovector_tpu_torch.utils.timer import count, span

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT_MAX = 2**31 - 1
# the sm90 route's tile: output columns per block, K per pipeline stage
SM90_BN = 128
SM90_BK = 64
# the f32 route's tile (output rows and columns per block) and K per stage
F32_BM = F32_BN = 128
F32_BK = 32
# the share of its waves of one block per SM that the f32 route's plan fills
F32_FILL = 0.95


def dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def same_device(*tensors: torch.Tensor | None) -> None:
    """A launch's operands (None skipped) lie on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")


def forward_only(*tensors: torch.Tensor | None) -> None:
    """No autograd graph to extend. Checked in the entry points: a custom
    op's real implementation, like an autograd Function's forward, runs
    with grad mode off."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            "the Hopper kernels are forward only: call them under "
            "torch.no_grad(), or through ops.linear.tower_matmul, whose "
            "autograd Function carries the backward")


def bias_f32(b: torch.Tensor | None, n: int) -> torch.Tensor | None:
    if b is None:
        return None
    if b.shape != (n,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({n},)")
    return b.to(torch.float32).contiguous()


def epilogue_plain(acc: torch.Tensor, b: torch.Tensor | None, fuse_relu: bool,
                   out_dtype: torch.dtype, fuse_gelu: bool = False
                   ) -> torch.Tensor:
    """K1's epilogue on an f32 sum: act(acc + b) in f32, rounded once to
    out_dtype (the Pallas `_matmul_kernel`'s last K step); act is ReLU,
    GELU with the exact erf, or none."""
    _check_act(fuse_relu, fuse_gelu)
    y = acc if b is None else acc + b.float()
    if fuse_relu:
        y = torch.relu(y)
    elif fuse_gelu:
        y = torch.nn.functional.gelu(y.float())
    return y.to(out_dtype)


def _check_act(fuse_relu: bool, fuse_gelu: bool) -> None:
    if fuse_relu and fuse_gelu:
        raise ValueError("K1's epilogue takes ReLU or GELU, not both")


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} x {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"x and w dtypes differ: {x.dtype} vs {w.dtype}")
    dtype_code(x.dtype, "x")
    dtype_code(out_dtype, "out_dtype")


def matmul_plain(x, w, b=None, *, fuse_relu: bool = False,
                 out_dtype=torch.float32, fuse_gelu: bool = False):
    """Plain PyTorch K1: f32 product of the given operands, then the epilogue.
    """
    _check(x, w, out_dtype)
    return epilogue_plain(x.float() @ w.float(), b, fuse_relu, out_dtype,
                          fuse_gelu)


def _tma_ok(t: torch.Tensor, dtype: torch.dtype) -> bool:
    """TMA can address t as a row-major matrix of dtype: unit inner stride,
    a row stride that is a multiple of 16 bytes and no shorter than a row,
    16-byte aligned data."""
    align = 16 // t.element_size()
    return (t.dtype == dtype and t.stride(1) == 1 and t.stride(0) % align == 0
            and t.stride(0) >= t.shape[1] and t.data_ptr() % 16 == 0)


def k1_route(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> str:
    """The route a CUDA call with these operands takes, when no dimension
    is empty and the output is f32 or bf16: "sm90" when TMA can address
    both operands as bf16, "f32" when it can address both as f32; "core"
    otherwise."""
    m, k = x.shape
    n = w.shape[1]
    if min(m, k, n) < 1 or out_dtype not in (torch.float32, torch.bfloat16):
        return "core"
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "f32")):
        if _tma_ok(x, dtype) and _tma_ok(w, dtype):
            return route
    return "core"


def k1_split_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(block_m, splits) of the sm90 route for an (m, k) x (k, n) product on
    a card with `sms` SMs. block_m is 64 for m <= 64 (one consumer
    warpgroup), else 128. When the output tiles alone fill fewer than `sms`
    blocks, K is split into as many ranges as keep tiles x splits within one
    block per SM, but never into more splits than K has BK tiles. (On the
    H100 one block per SM streams w as fast as two, and every extra split
    adds M x N x 4 bytes of partial sums to write and read back.)"""
    block_m = 64 if m <= 64 else 128
    tiles = -(-m // block_m) * -(-n // SM90_BN)
    k_tiles = max(1, -(-k // SM90_BK))
    splits = 1 if tiles >= sms else min(k_tiles, sms // tiles)
    return block_m, splits


def k1_f32_plan(m: int, n: int, k: int, sms: int) -> tuple[tuple[int, int], int]:
    """((block_m, block_n), splits) of the f32 route for an (m, k) x (k, n)
    product on a card with `sms` SMs, which runs one block per SM. With T
    output tiles and KT tiles of F32_BK along K, splits is the fewest s in
    1..KT whose T s blocks fill their ceil(T s / sms) waves to F32_FILL or
    more, and KT when none does. (The time is about the waves times the K
    tiles a block walks, and each split adds m x n x 4 bytes of partial
    sums to write and read back.)"""
    tiles = -(-m // F32_BM) * -(-n // F32_BN)
    k_tiles = max(1, -(-k // F32_BK))
    splits = next((s for s in range(1, k_tiles + 1)
                   if tiles * s >= F32_FILL * -(-tiles * s // sms) * sms),
                  k_tiles)
    return (F32_BM, F32_BN), splits


def matmul(x, w, b=None, *, fuse_relu: bool = False, out_dtype=torch.float32,
           fuse_gelu: bool = False):
    """x: (M, K), w: (K, N), b: (N,) optional -> act(x.w + b): (M, N).

    x and w share a dtype, float32 or bfloat16 (bfloat16 runs on the tensor
    cores, float32 on FFMA); the sum is f32; any strides. act is ReLU
    (`fuse_relu`), exact-erf GELU (`fuse_gelu`, on the card the sm90 route
    only: bf16 operands TMA can address) or none. Where `runs_kernel(x)`,
    through `vvtpu::k1_matmul`; else `matmul_plain`."""
    if runs_kernel(x):
        forward_only(x, w, b)
        return torch.ops.vvtpu.k1_matmul(x, w, b, fuse_relu, out_dtype,
                                         fuse_gelu)
    with span("vvtpu.k1"):
        return matmul_plain(x, w, b, fuse_relu=fuse_relu, out_dtype=out_dtype,
                            fuse_gelu=fuse_gelu)


# `fuse_gelu` came last, with a default, so that calls recorded before it
# (serving artifacts) read as before
@torch.library.custom_op(
    "vvtpu::k1_matmul", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor? b, bool fuse_relu, "
           "ScalarType out_dtype, bool fuse_gelu=False) -> Tensor")
def k1_matmul(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              fuse_relu: bool, out_dtype: torch.dtype,
              fuse_gelu: bool = False) -> torch.Tensor:
    """K1 as a custom op: `matmul`'s launch on CUDA tensors (the route
    from `k1_route`, counted), `matmul_plain` on CPU tensors; the host's
    time in it is the span `vvtpu.k1`, the ctypes call `vvtpu.k1.launch`."""
    with span("vvtpu.k1"):
        if x.device.type == "cpu":
            return matmul_plain(x, w, b, fuse_relu=fuse_relu,
                                out_dtype=out_dtype, fuse_gelu=fuse_gelu)
        return _k1_launch(x, w, b, fuse_relu, out_dtype, fuse_gelu)


def _k1_launch(x, w, b, fuse_relu, out_dtype, fuse_gelu):
    _check(x, w, out_dtype)
    _check_act(fuse_relu, fuse_gelu)
    same_device(x, w, b)
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) > INT_MAX:
        raise ValueError(f"matmul dims beyond int32: {(m, k, n)}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    bias = bias_f32(b, n)
    bias_ptr = bias.data_ptr() if bias is not None else None
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    device = x.device.index or 0
    route = k1_route(x, w, out_dtype)
    if fuse_gelu and route != "sm90":
        raise ValueError(f"K1's GELU epilogue is on its sm90 route alone "
                         f"(bf16 operands TMA can address); these operands "
                         f"take the {route} route")
    if route in ("sm90", "f32"):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        if route == "sm90":
            block_m, splits = k1_split_plan(m, n, k, sms)
        else:
            _, splits = k1_f32_plan(m, n, k, sms)
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        args = (x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
                ws.data_ptr() if ws is not None else None, m, n, k, x.stride(0),
                w.stride(0), out.stride(0), out.stride(1))
        act = 2 if fuse_gelu else int(fuse_relu)
        tail = (splits, DTYPE_CODES[out_dtype], act, device, stream)
        if route == "sm90":
            with span("vvtpu.k1.launch"):
                rc = lib.vv_matmul_sm90(*args, block_m, *tail)
            _build.check(rc, "K1 matmul (sm90 route)")
            count("vvtpu.k1.sm90_launches", 1)
            if fuse_gelu:
                count("vvtpu.k1.gelu_launches", 1)
        else:
            with span("vvtpu.k1.launch"):
                rc = lib.vv_matmul_f32_sm90(*args, *tail)
            _build.check(rc, "K1 matmul (f32 route)")
            count("vvtpu.k1.f32_launches", 1)
    else:
        with span("vvtpu.k1.launch"):
            rc = lib.vv_matmul(
                x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), m, n,
                k, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
                out.stride(0), out.stride(1), DTYPE_CODES[x.dtype],
                DTYPE_CODES[out_dtype], int(fuse_relu), device, stream)
        _build.check(rc, "K1 matmul")
    count("vvtpu.k1.launches", 1)
    return out


@k1_matmul.register_fake
def _k1_matmul_fake(x, w, b, fuse_relu, out_dtype, fuse_gelu=False):
    _check(x, w, out_dtype)
    _check_act(fuse_relu, fuse_gelu)
    return x.new_empty((x.shape[0], w.shape[1]), dtype=out_dtype)


# The Pallas module zero-pads to block multiples here; this kernel masks the
# ragged edges itself, so the name stays for readers and the function is one.
matmul_padded = matmul
