"""int8 post-training quantization ops: the INNER_PRODUCT and CONVOLUTION
branches of the JAX Net's `quant` side table (videovector_tpu/graph/
layers.py), built by tools/quantize.py.

- `quantize_input`: round(x / s_x) clipped to +-127, int8 (round half to
  even, as jnp.round).
- `int8_matmul`: the exact int8 x int8 -> int32 product. JAX computes it
  with jnp.dot(preferred_element_type=int32), outside any Pallas kernel;
  here torch._int_mm. On the card _int_mm wants more than 16 rows, K and
  N multiples of 8 and contiguous operands, so the operands are padded
  with zero rows and columns (exact: a zero adds nothing to a sum) and the
  result cut back.
- `int8_inner_product`: y = int32(x_q . w_q) * (s_x * s_w) + b in f32, in
  JAX's order.
- `int8_conv2d`: the same for a convolution, im2col then `int8_matmul`
  per group, dequantized per output channel.
- `dequantize_conv_weight`: the `weight_only` mode's w_q * s_w (per output
  channel), in f32; the layer casts it to bf16 for K2's sm90 route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on `like`'s device: on CUDA a division by a host
    scalar becomes a multiply by its reciprocal, which rounds otherwise."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def quantize_input(x: torch.Tensor, s_x) -> torch.Tensor:
    """x in f32 (a bf16 x widened exactly, as JAX promotes it against the
    f32 scale) / s_x, rounded and clipped to int8."""
    x = x.to(torch.float32)
    return torch.clamp(torch.round(x / _scalar(s_x, x)), -127, 127) \
        .to(torch.int8)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t.contiguous()
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 . b (K, N) int8 -> (M, N) int32, exact."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cuda":
        up = lambda v: -(-v // INT_MM_ALIGN) * INT_MM_ALIGN  # noqa: E731
        mp, kp, np_ = max(m, INT_MM_MIN_ROWS), up(k), up(n)
        out = torch._int_mm(_pad_to(a, mp, kp), _pad_to(b, kp, np_))
        return out[:m, :n]
    return torch._int_mm(a.contiguous(), b.contiguous())


def _dequantize(acc: torch.Tensor, s_x, s_w: torch.Tensor) -> torch.Tensor:
    """acc int32 (..., N) -> acc * (s_x * s_w) in f32; the scale's product
    is rounded to f32 first, as JAX's."""
    return acc.to(torch.float32) * (_scalar(s_x, acc) * s_w.to(acc.device))


def int8_inner_product(x: torch.Tensor, q: dict,
                       b: torch.Tensor | None) -> torch.Tensor:
    """x (M, ...) f32 flattened to (M, K); q {"w_q" (K, N) int8, "s_w" (N,)
    f32, "s_x"} -> (M, N) f32."""
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = _dequantize(int8_matmul(quantize_input(x, q["s_x"]), q["w_q"]),
                    q["s_x"], q["s_w"])
    return y + b if b is not None else y


def int8_conv2d(x: torch.Tensor, q: dict, b: torch.Tensor | None, *,
                stride=(1, 1), pad=(0, 0), groups: int = 1) -> torch.Tensor:
    """x (N, C, H, W) f32; q {"w_q" (O, C/groups, kh, kw) int8, "s_w" (O,)
    f32, "s_x"} -> (N, O, oh, ow) f32: the exact int32 sum, dequantized per
    output channel, plus the bias."""
    w_q = q["w_q"]
    o, cg, kh, kw = w_q.shape
    n, _, h, wd = x.shape
    oh = (h + 2 * pad[0] - kh) // stride[0] + 1
    ow = (wd + 2 * pad[1] - kw) // stride[1] + 1
    # im2col of the int8 values in f32, which holds them exactly
    cols = F.unfold(quantize_input(x, q["s_x"]).to(torch.float32), (kh, kw),
                    padding=tuple(pad), stride=tuple(stride))
    cols = cols.to(torch.int8).transpose(1, 2).reshape(n * oh * ow, -1)
    ck, og = cg * kh * kw, o // groups
    acc = torch.cat([
        int8_matmul(cols[:, g * ck:(g + 1) * ck],
                    w_q[g * og:(g + 1) * og].reshape(og, ck).T)
        for g in range(groups)], dim=1)
    y = _dequantize(acc, q["s_x"], q["s_w"])
    if b is not None:
        y = y + b
    return y.reshape(n, oh, ow, o).permute(0, 3, 1, 2)


def dequantize_conv_weight(q: dict) -> torch.Tensor:
    """w_q (O, ...) int8 * s_w (O,) -> f32 OIHW."""
    return q["w_q"].to(torch.float32) * q["s_w"][:, None, None, None]
