"""K1: GEMM with a fused bias + ReLU epilogue (CUDA C++ for sm_90a).

Counterpart of videovector_tpu/ops/pallas/matmul.py: out = round(act(x.w +
b)), an f32 sum with the bias and ReLU applied in f32 and one rounding to
the output type at the end, as the Pallas kernel does. Two hand-written
routes, picked from the operands alone by `k1_route`:
- "sm90": csrc/matmul_sm90.cu, a TMA + wgmma GEMM with split-K
  (`k1_split_plan`), for bf16 operands that TMA can address;
- "core": csrc/matmul.cu on the core in csrc/gemm_core.cuh, for everything
  else (f32 operands on f32 FMA tiles, transposed or odd-strided views).
Each source note says what bounds its kernel on the H100.

`matmul` launches a kernel for CUDA tensors and runs `matmul_plain`, the
plain PyTorch version, for CPU tensors; on any other device it raises.
`matmul.launches` counts every launch, `matmul.launches_sm90` those of the
sm90 route. The kernels are forward only, as the Pallas kernel is: the
training tower reaches K1 through ops.linear.tower_matmul, an autograd
Function whose backward is torch.matmul.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT_MAX = 2**31 - 1
# the sm90 route's tile: output columns per block, K per pipeline stage
SM90_BN = 128
SM90_BK = 64


def dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def check_cuda_operands(*tensors: torch.Tensor | None) -> None:
    """The common launch preconditions: CUDA tensors on one device, and no
    autograd graph to extend (inside an autograd Function's forward, grad
    mode is off and the check passes)."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.requires_grad and torch.is_grad_enabled():
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
                   out_dtype: torch.dtype) -> torch.Tensor:
    """K1's epilogue on an f32 sum: act(acc + b) in f32, rounded once to
    out_dtype (the Pallas `_matmul_kernel`'s last K step)."""
    y = acc if b is None else acc + b.float()
    if fuse_relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} x {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"x and w dtypes differ: {x.dtype} vs {w.dtype}")
    dtype_code(x.dtype, "x")
    dtype_code(out_dtype, "out_dtype")


def matmul_plain(x, w, b=None, *, fuse_relu: bool = False,
                 out_dtype=torch.float32):
    """Plain PyTorch K1: f32 product of the given operands, then the epilogue.
    """
    _check(x, w, out_dtype)
    return epilogue_plain(x.float() @ w.float(), b, fuse_relu, out_dtype)


def k1_route(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> str:
    """The route a CUDA call with these operands takes: "sm90" when TMA can
    address both bf16 operands (unit inner stride, row strides a multiple of
    16 bytes and no shorter than a row, 16-byte aligned data, no empty
    dimension) and the output is f32 or bf16; "core" otherwise."""
    m, k = x.shape
    n = w.shape[1]
    tma_ok = all(t.dtype == torch.bfloat16 and t.stride(1) == 1
                 and t.stride(0) % 8 == 0 and t.stride(0) >= t.shape[1]
                 and t.data_ptr() % 16 == 0 for t in (x, w))
    ok = (tma_ok and min(m, k, n) >= 1
          and out_dtype in (torch.float32, torch.bfloat16))
    return "sm90" if ok else "core"


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


def matmul(x, w, b=None, *, fuse_relu: bool = False, out_dtype=torch.float32):
    """x: (M, K), w: (K, N), b: (N,) optional -> act(x.w + b): (M, N).

    x and w share a dtype, float32 or bfloat16 (bfloat16 runs on the tensor
    cores, float32 on f32 FMA tiles); the sum is f32; any strides."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, b, fuse_relu=fuse_relu, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, not {x.device}")
    _check(x, w, out_dtype)
    check_cuda_operands(x, w, b)
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
    if k1_route(x, w, out_dtype) == "sm90":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        block_m, splits = k1_split_plan(m, n, k, sms)
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        rc = lib.vv_matmul_sm90(
            x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, n, k, x.stride(0),
            w.stride(0), out.stride(0), out.stride(1), block_m, splits,
            DTYPE_CODES[out_dtype], int(fuse_relu), device, stream)
        _build.check(rc, "K1 matmul (sm90 route)")
        matmul.launches_sm90 += 1
    else:
        rc = lib.vv_matmul(
            x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), m, n, k,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1), out.stride(0),
            out.stride(1), DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
            int(fuse_relu), device, stream)
        _build.check(rc, "K1 matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
matmul.launches_sm90 = 0

# The Pallas module zero-pads to block multiples here; this kernel masks the
# ragged edges itself, so the name stays for readers and the function is one.
matmul_padded = matmul
