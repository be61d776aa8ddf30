"""Operations and bytes of the `timesformer-l-retrieval` configuration's
work, from its widths alone (never read from a kernel), at the H100 peaks
of vvbench/flops.py.

A clip of T frames at a crop of C has P = (C / patch)^2 patches a frame
and P T tokens, and the residual stream one more row, the class token's.
Per block, as vit.py computes it: the temporal qkv, proj and temporal_fc
over the P T tokens; the spatial qkv and proj over T (P + 1) rows, the
class row once a frame (the program runs them over the stream's P T + 1
rows, the class row once, 0.12% fewer operations in all); fc1 and fc2
over the P T + 1 rows of the stream; the temporal attention over P
sequences of T tokens, the spatial over T of P + 1. Before the blocks the
patch embedding (P T rows of 3 patch^2 pixels), after them the tower on
the class row. So a 96-frame clip at 224 is vit.py's 4.760 TFLOP, 2.38 T
multiply-adds: times the paper's three test views, its 7.14 T.

A GEMM's bytes count its input and weights in the compute dtype once, its
f32 bias once and its output in the compute dtype once (the tower's in
f32); an attention's q, k and v read once and its output written once in
the compute dtype (the spatial class outputs in f32). What a kernel reads
again from L2 is not the work's. Each LayerNorm and residual add is
bandwidth work outside these counts.
"""

from __future__ import annotations

from vvbench.flops import BYTES, PEAK_BF16, PEAK_F32, least_s, score_ops


def _sizes(cfg: dict, frames: int | None = None) -> tuple[int, int, int]:
    """(P, T, P T) of one clip."""
    p = (cfg["crop"] // cfg["patch"]) ** 2
    t = frames or cfg["clip_frames"]
    return p, t, p * t


def gemms(clips: int, cfg: dict, frames: int | None = None) -> list[dict]:
    """Per GEMM of one query of `clips` clips, in the forward's order:
    name, (m, k, n), operations and bytes."""
    e = BYTES[cfg["compute_dtype"]]
    d, m_dim = cfg["dim"], cfg["mlp_dim"]
    p, t, tokens = _sizes(cfg, frames)
    rows = clips * tokens
    stream = clips * (tokens + 1)
    frame_rows = clips * t * (p + 1)
    shapes = [("patch_embed", rows, 3 * cfg["patch"] ** 2, d)]
    for i in range(cfg["depth"]):
        b = f"blocks/{i}/"
        shapes += [(b + "temporal_attn/qkv", rows, d, 3 * d),
                   (b + "temporal_attn/proj", rows, d, d),
                   (b + "temporal_fc", rows, d, d),
                   (b + "attn/qkv", frame_rows, d, 3 * d),
                   (b + "attn/proj", frame_rows, d, d),
                   (b + "mlp/fc1", stream, d, m_dim),
                   (b + "mlp/fc2", stream, m_dim, d)]
    out = [{"name": name, "shape": (m, k, n), "ops": 2.0 * m * k * n,
            "bytes": float((m * k + k * n) * e + n * 4 + m * n * e)}
           for name, m, k, n in shapes]
    d_in, e_out = cfg["feature_dim"], cfg["embed_dim"]
    out.append({"name": "tower", "shape": (clips, d_in, e_out),
                "ops": 2.0 * clips * d_in * e_out,
                "bytes": float((clips * d_in + d_in * e_out) * e + e_out * 4
                               + clips * e_out * 4)})
    return out


def attentions(clips: int, cfg: dict, frames: int | None = None
               ) -> list[dict]:
    """Per attention call of one query, in the forward's order: kind,
    sequences, tokens a sequence, operations (q k^T and p v) and bytes."""
    e = BYTES[cfg["compute_dtype"]]
    d, heads = cfg["dim"], cfg["heads"]
    hd = d // heads
    p, t, tokens = _sizes(cfg, frames)
    out = []
    for _ in range(cfg["depth"]):
        for kind, seqs, n, rows_in, rows_out, extra in (
                ("temporal", clips * p, t, tokens, tokens, 0),
                ("spatial", clips * t, p + 1, tokens + 1, tokens, t)):
            out.append({
                "kind": kind, "sequences": seqs, "tokens": n,
                "ops": 4.0 * seqs * heads * n * n * hd,
                "bytes": float(clips * (rows_in * 3 * d * e
                                        + rows_out * d * e + extra * d * 4))})
    return out


def parameters(cfg: dict) -> int:
    """The backbone's parameters (the tower's not among them)."""
    d, m = cfg["dim"], cfg["mlp_dim"]
    p, t, _ = _sizes(cfg)
    block = (2 * (d * 3 * d + 3 * d) + 2 * (d * d + d) + (d * d + d)
             + (d * m + m) + (m * d + d) + 3 * 2 * d)
    return (cfg["depth"] * block + 3 * cfg["patch"] ** 2 * d + d + d
            + (p + 1) * d + t * d + 2 * d)


def clip_ops(cfg: dict, tower: bool = True) -> float:
    """Operations of one clip: the GEMMs and both attention kinds (and the
    tower)."""
    g = gemms(1, cfg)
    ops = sum(x["ops"] for x in (g if tower else g[:-1]))
    return ops + sum(a["ops"] for a in attentions(1, cfg))


def k1_least_s(clips: int, cfg: dict) -> float:
    """K1's least time in a query: per GEMM the larger of operations at the
    bf16 peak and bytes at HBM bandwidth, summed."""
    return sum(least_s(g["ops"], g["bytes"], PEAK_BF16)
               for g in gemms(clips, cfg))


def attn_least_s(clips: int, cfg: dict) -> float:
    """The attention kernel's least time in a query: per call the larger of
    operations at the bf16 peak and bytes at HBM bandwidth, summed."""
    return sum(least_s(a["ops"], a["bytes"], PEAK_BF16)
               for a in attentions(clips, cfg))


def query_least_s(clips: int, gallery: int, cfg: dict) -> float:
    """TimeSformer and the tower at the compute dtype's peak, plus the f32
    scores (TF32 off) at the f32 peak."""
    return (clips * clip_ops(cfg) / PEAK_BF16
            + score_ops(clips, gallery, cfg["embed_dim"]) / PEAK_F32)
