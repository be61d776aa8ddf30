"""K1: GEMM with a fused bias + ReLU epilogue (CUDA C++ for sm_90a).

Counterpart of videovector_tpu/ops/pallas/matmul.py. The kernel is
csrc/matmul.cu on the core in csrc/gemm_core.cuh; its source note says what
bounds it on the H100. Its block sizes are the kernel's own constants.

`matmul` launches the kernel for CUDA tensors and runs `matmul_plain`, the
plain PyTorch version, for CPU tensors; on any other device it raises. The
kernel is forward only: the backward comes with the training slice.
"""

from __future__ import annotations

import torch

from videovector_tpu_torch import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT_MAX = 2**31 - 1


def dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def check_cuda_operands(*tensors: torch.Tensor | None) -> None:
    """The common launch preconditions: CUDA tensors on one device, no graph.
    """
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the Hopper kernels are forward only; their backward arrives "
                "with the training slice (run under torch.no_grad())")


def bias_f32(b: torch.Tensor | None, n: int) -> torch.Tensor | None:
    if b is None:
        return None
    if b.shape != (n,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({n},)")
    return b.to(torch.float32).contiguous()


def epilogue_plain(acc: torch.Tensor, b: torch.Tensor | None, fuse_relu: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' epilogue on an f32 sum: round to out_dtype, add the bias
    rounded to out_dtype, ReLU (the f32 case is act(acc + b))."""
    y = acc.to(out_dtype)
    if b is not None:
        y = y + b.to(out_dtype)
    return torch.relu(y) if fuse_relu else y


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.load_library().vv_matmul(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), m, n, k, x.stride(0), x.stride(1), w.stride(0),
        w.stride(1), out.stride(0), out.stride(1), DTYPE_CODES[x.dtype],
        DTYPE_CODES[out_dtype], int(fuse_relu), x.device.index or 0, stream)
    _build.check(rc, "K1 matmul")
    matmul.launches += 1
    return out


matmul.launches = 0

# The Pallas module zero-pads to block multiples here; this kernel masks the
# ragged edges itself, so the name stays for readers and the function is one.
matmul_padded = matmul
