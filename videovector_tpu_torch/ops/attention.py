"""Scaled dot-product attention over token sequences read in place from a
qkv projection's output: csrc/attention_sm90.cu, the port's first
attention (TimeSformer's two kinds of head, models/timesformer.py).

`attention(qkv, heads, seqs)` takes the (rows, 3 D) output of a qkv
projection, each row a token's q, k and v (3, heads, D / heads), and a
`Sequences`, which says where each sequence's tokens lie among the rows:
token i of sequence (o, j), o < n_outer and j < n_inner, is row

    base + o * outer_stride + j * inner_stride + i * token_stride,

and, where `extra_base` is not -1, every sequence of outer index o has one
more token in front, row extra_base + o * outer_stride, whose key and value
every query sees and whose query attends over the sequence with it (the
class token that TimeSformer's spatial heads share across frames). Each
head of each sequence computes softmax(q k^T * scale) v with the scores,
the softmax and the sums in f32 (scale head_dim^-0.5 unless given); the
kernel rounds the unnormalised probabilities exp(s - max) to bf16 as the
operand of the product with v, as attention under autocast rounds its
probabilities, and divides by their f32 sum after it. It
returns (out, extra): out (rows, D) in qkv's dtype, each sequence token's
output at its own row, rounded once, rows that no sequence holds left
unwritten (unspecified); extra (n_outer n_inner, D) f32, the extra query's
output in each sequence ((0, D) without an extra row).

Where `device.runs_kernel(qkv)`, one launch of the kernel through the
custom op `vvtpu::attention` (bf16 qkv, head size 64, up to 256 tokens a
sequence with the extra one), whose fake gives the outputs' shapes; else
the plain version `attention_plain`, the same mathematics in torch
operations (f32 from the given operands; on the CPU inside the op, so
that `torch.export` records one node either way). The kernel is forward
only: a call that autograd records raises on a card and takes the plain
version on the CPU. The counter `vvtpu.attn.calls` adds each call,
`vvtpu.attn.launches` and `vvtpu.attn.<kind>_launches` each launch, and
`vvtpu.attn.layout_bytes` the bytes a call copies to lay its sequences'
tokens out apart from qkv's rows and back: the plain version's gather of
each sequence's q, k and v (the extra row once a sequence) and its
scatter of the outputs, 0 for a launch, which reads and writes every row
in place (utils/timer.py). Nothing here calls a library's attention.
"""

from __future__ import annotations

from dataclasses import astuple, dataclass

import torch

from videovector_tpu_torch import _build
from videovector_tpu_torch.device import runs_kernel
from videovector_tpu_torch.ops.hopper.matmul import forward_only
from videovector_tpu_torch.ops.linear import no_tf32
from videovector_tpu_torch.utils.timer import count

HEAD_DIM = 64          # the kernel's head size
MAX_TOKENS = 256       # the kernel's longest sequence, the extra token in


@dataclass(frozen=True)
class Sequences:
    """Where the tokens of the sequences lie among qkv's rows (module
    docstring); `kind` names them for the launch counters."""
    kind: str
    length: int
    n_outer: int
    n_inner: int
    base: int
    outer_stride: int
    inner_stride: int
    token_stride: int
    extra_base: int = -1

    @classmethod
    def temporal(cls, clips: int, patches: int, frames: int) -> "Sequences":
        """TimeSformer's temporal heads over rows in (b h w t) order: one
        sequence a clip's patch, its `frames` tokens contiguous."""
        return cls("temporal", frames, clips * patches, 1, 0, frames, 0, 1)

    @classmethod
    def spatial(cls, clips: int, patches: int, frames: int) -> "Sequences":
        """TimeSformer's spatial heads over the rows of the residual stream,
        each clip [class; its patch tokens in (h w t) order]: one sequence
        a clip's frame, its `patches` tokens a stride of `frames` rows
        apart, the clip's class row in front."""
        stream = 1 + patches * frames
        return cls("spatial", patches, clips, frames, 1, stream, 1, frames, 0)

    @property
    def sequences(self) -> int:
        return self.n_outer * self.n_inner

    @property
    def extra(self) -> bool:
        return self.extra_base >= 0

    def geometry(self) -> list[int]:
        """The integers of the custom op's `geometry` argument."""
        return list(astuple(self)[1:])

    @classmethod
    def from_geometry(cls, kind: str, geometry) -> "Sequences":
        return cls(kind, *(int(v) for v in geometry))

    def token_rows(self, device=None) -> torch.Tensor:
        """(sequences, length) int64: the row of each sequence's each
        token."""
        def ar(n):
            return torch.arange(n, dtype=torch.int64, device=device)
        o = ar(self.n_outer)[:, None, None] * self.outer_stride
        j = ar(self.n_inner)[None, :, None] * self.inner_stride
        i = ar(self.length)[None, None, :] * self.token_stride
        return (self.base + o + j + i).reshape(self.sequences, self.length)

    def extra_rows(self, device=None) -> torch.Tensor:
        """(sequences,) int64: the extra row of each sequence."""
        o = torch.arange(self.n_outer, dtype=torch.int64, device=device)
        rows = self.extra_base + o * self.outer_stride
        return rows.repeat_interleave(self.n_inner)

    def span_rows(self) -> tuple[int, int]:
        """The lowest and highest row any sequence reads."""
        steps = ((self.n_outer - 1) * self.outer_stride,
                 (self.n_inner - 1) * self.inner_stride,
                 (self.length - 1) * self.token_stride)
        low = self.base + sum(min(0, v) for v in steps)
        high = self.base + sum(max(0, v) for v in steps)
        if self.extra:
            low = min(low, self.extra_base + min(0, steps[0]))
            high = max(high, self.extra_base + max(0, steps[0]))
        return low, high


def attention(qkv: torch.Tensor, heads: int, seqs: Sequences,
              scale: float | None = None):
    """(out, extra) of the sequences' attention (module docstring): where
    `runs_kernel(qkv)`, one launch of csrc/attention_sm90.cu through
    `vvtpu::attention`; else the plain version."""
    count("vvtpu.attn.calls", 1)
    if scale is None:
        scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    if runs_kernel(qkv):
        forward_only(qkv)
    elif qkv.device.type != "cpu" or (torch.is_grad_enabled()
                                      and qkv.requires_grad):
        return attention_plain(qkv, heads, seqs, scale)
    return torch.ops.vvtpu.attention(qkv, heads, seqs.geometry(),
                                     float(scale), seqs.kind)


def attention_plain(qkv: torch.Tensor, heads: int, seqs: Sequences,
                    scale: float):
    """`attention` in torch operations: the sequences' rows gathered, f32
    scores, softmax and sums (TF32 off), the outputs rounded once to qkv's
    dtype and scattered back to their rows (rows no sequence holds are
    zero); the gather's and the scatter's bytes counted in
    `vvtpu.attn.layout_bytes`."""
    _check(qkv, heads, seqs)
    rows, d = qkv.shape[0], qkv.shape[1] // 3
    hd = d // heads
    idx = seqs.token_rows(qkv.device)
    if seqs.extra:
        idx = torch.cat([seqs.extra_rows(qkv.device)[:, None], idx], dim=1)
    n = idx.shape[1]
    n_seq = seqs.sequences
    q, k, v = qkv[idx].float().view(n_seq, n, 3, heads, hd).unbind(2)
    with no_tf32():
        p = torch.softmax(torch.einsum("sqhd,skhd->shqk", q, k) * scale,
                          dim=-1)
        o = torch.einsum("shqk,skhd->sqhd", p, v).reshape(n_seq, n, d)
    ex = int(seqs.extra)
    out = qkv.new_zeros((rows, d))
    out[idx[:, ex:]] = o[:, ex:].to(qkv.dtype)
    count("vvtpu.attn.layout_bytes",
          (idx.numel() * 3 + idx[:, ex:].numel()) * d * qkv.element_size())
    extra = o[:, 0] if ex else o.new_zeros((0, d))
    return out, extra.contiguous()


def _check(qkv, heads, seqs: Sequences) -> None:
    if qkv.dim() != 2 or heads < 1 or qkv.shape[1] % (3 * heads):
        raise ValueError(f"attention wants (rows, 3 x heads x head_dim) qkv, "
                         f"got {tuple(qkv.shape)} with {heads} heads")
    if min(seqs.length, seqs.n_outer, seqs.n_inner) < 1:
        raise ValueError(f"attention over no tokens: {seqs}")
    low, high = seqs.span_rows()
    if low < 0 or high >= qkv.shape[0]:
        raise ValueError(f"{seqs} reads rows {low}..{high} of "
                         f"{qkv.shape[0]}")


def _out_shapes(qkv, seqs: Sequences):
    d = qkv.shape[1] // 3
    return (qkv.shape[0], d), (seqs.sequences if seqs.extra else 0, d)


@torch.library.custom_op(
    "vvtpu::attention", mutates_args=(),
    schema="(Tensor qkv, int heads, int[] geometry, float scale, str kind) "
           "-> (Tensor, Tensor)")
def _attention_op(qkv: torch.Tensor, heads: int, geometry: list[int],
                  scale: float, kind: str):
    """`attention` as a custom op: the kernel's launch on a CUDA tensor,
    the plain version on a CPU tensor."""
    seqs = Sequences.from_geometry(kind, geometry)
    if qkv.device.type == "cpu":
        return attention_plain(qkv, heads, seqs, scale)
    return _attention_kernel(qkv, heads, seqs, scale)


@_attention_op.register_fake
def _attention_fake(qkv, heads, geometry, scale, kind):
    seqs = Sequences.from_geometry(kind, geometry)
    _check(qkv, heads, seqs)
    out, extra = _out_shapes(qkv, seqs)
    return qkv.new_empty(out), qkv.new_empty(extra, dtype=torch.float32)


def _attention_kernel(qkv, heads, seqs: Sequences, scale: float):
    """One launch of csrc/attention_sm90.cu, counted."""
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or (plain) CPU tensors, "
                         f"not {qkv.device}")
    _check(qkv, heads, seqs)
    d = qkv.shape[1] // 3
    if (qkv.dtype != torch.bfloat16 or d != heads * HEAD_DIM
            or seqs.length + seqs.extra > MAX_TOKENS):
        raise ValueError(
            f"the attention kernel takes bf16 qkv, heads of {HEAD_DIM} and "
            f"up to {MAX_TOKENS} tokens a sequence: got {qkv.dtype}, "
            f"{d // heads} a head, {seqs.length + seqs.extra} tokens")
    if qkv.stride(1) != 1 or qkv.stride(0) % 8 or qkv.data_ptr() % 16:
        raise ValueError("the attention kernel reads 16-byte chunks of qkv's "
                         "rows: unit column stride, row stride a multiple "
                         "of 8, 16-byte aligned data")
    out_shape, extra_shape = _out_shapes(qkv, seqs)
    out = torch.empty(out_shape, dtype=qkv.dtype, device=qkv.device)
    extra = torch.empty(extra_shape, dtype=torch.float32, device=qkv.device)
    lib = _build.load_library()
    rc = lib.vv_attention(
        qkv.data_ptr(), out.data_ptr(),
        extra.data_ptr() if seqs.extra else None, heads, d, qkv.stride(0),
        out.stride(0), *seqs.geometry(), scale, qkv.device.index or 0,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, f"attention ({seqs.kind})")
    count("vvtpu.attn.launches", 1)
    count(f"vvtpu.attn.{seqs.kind}_launches", 1)
    count("vvtpu.attn.layout_bytes", 0)
    return out, extra
