"""Retrieval evaluation metrics (mAP, hit@k, median rank, recall@k);
counterpart of videovector_tpu/metrics/retrieval.py.

The reference's per-row std::sort loops
(ref:src/caffe/layers/retrieval_stats_layer.cpp,
ref:src/caffe/layers/retrieval_rank_stats_layer.cpp) become one stable
argsort over the (B, N) "distance" matrix and masked cumulative sums, or,
in the count engine, integer compare-reductions.

Distance convention preserved from the reference: d(i, j) = -2·xᵢ·xⱼᵀ (GEMM
with alpha -2, no norm terms; rank-equivalent to Euclidean distance only when
rows are L2-normalized). The products are f32 with TF32 off; bf16 operands
are multiplied exactly and summed in f32 (`_neg2_dot`).

Every ranking breaks ties by (distance, index), as the JAX package does:
stable sorts, and argmin-and-mask for the report's top-5 (argmin returns the
first minimum). Functions given tensors compute where those tensors are. The
gallery-scale functions (`retrieval_stats_chunked`, `retrieval_stats_report`
and the rank-stats reports) take host arrays and run on `device`, the card
unless "cpu" is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.ops.linear import no_tf32

_I32_MIN = -2**31
_I32_MAX = 2**31 - 1


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _neg2_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-2·a·bᵀ in f32 (the reference's GEMM with alpha -2; the JAX package's
    dot with preferred_element_type=f32). f32 operands multiply with TF32
    off. Two bf16 operands give products of bf16 values summed in f32: on
    the card one bf16 GEMM with an f32 output, so that a bf16 gallery is
    never copied to f32; on the CPU an upcast to f32, which is exact."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return -2.0 * torch.mm(a, b.T, out_dtype=torch.float32)
    with no_tf32():
        return -2.0 * (a.float() @ b.float().T)


class IdToClassMap:
    """video_id -> class_id lookup table.

    The reference reads a `video_id,class_id` csv
    (ref:src/caffe/layers/retrieval_stats_layer.cpp:29-44) into a std::map;
    lookups of unknown ids default-insert class 0, and so give 0 here.
    """

    def __init__(self, ids, classes):
        ids = np.asarray(ids)
        order = np.argsort(ids, kind="stable")
        self.ids = torch.as_tensor(ids[order].astype(np.int32))
        self.classes = torch.as_tensor(
            np.asarray(classes)[order].astype(np.int32))

    @classmethod
    def from_csv(cls, path: str) -> "IdToClassMap":
        ids, classes = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(",")
                ids.append(int(a))
                classes.append(int(b))
        return cls(ids, classes)

    def lookup(self, query):
        """query: ids, any shape -> int32 class ids on the query's device (0
        for unknown ids, the reference's std::map::operator[] default)."""
        q = torch.as_tensor(query).to(torch.int32)
        ids = self.ids.to(q.device)
        pos = torch.searchsorted(ids, q).clamp(0, ids.shape[0] - 1)
        found = ids[pos] == q
        return torch.where(found, self.classes.to(q.device)[pos], 0)


def video_level_average(features, video_ids, num_videos: int):
    """Average shot features per video (ref video_level_retrieval mode,
    ref:src/caffe/layers/retrieval_stats_layer.cpp:165-205). Returns
    (video_features (num_videos, D), unique_video_ids (num_videos,) int32),
    videos ordered by first occurrence (the reference's sequential scan).

    `num_videos` should equal the number of distinct ids (the reference
    CHECKs it; `check_num_videos` is the host-side check). As in the JAX
    package, extra videos are dropped and missing segments pad with zero
    features and int32-min ids."""
    feats = torch.as_tensor(features)
    dev = feats.device
    vids = torch.as_tensor(video_ids, device=dev).reshape(-1).to(torch.int32)
    n = vids.shape[0]
    eq = vids[:, None] == vids[None, :]
    first_idx = torch.argmax(eq.to(torch.int32), dim=1)  # first position of my id
    is_first = first_idx == torch.arange(n, device=dev)
    seg = (torch.cumsum(is_first, 0) - 1)[first_idx]     # first-occurrence order
    # JAX's segment_sum drops segment ids >= num_videos; index_add_ would
    # raise on them instead
    keep = seg < num_videos
    sums = feats.new_zeros((num_videos,) + tuple(feats.shape[1:]))
    sums.index_add_(0, seg[keep], feats[keep])
    counts = feats.new_zeros(num_videos).index_add_(
        0, seg[keep], torch.ones_like(seg[keep], dtype=feats.dtype))
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    uniq = torch.full((num_videos,), _I32_MIN, dtype=torch.int32, device=dev)
    first = is_first & keep
    uniq[seg[first]] = vids[first]
    return means, uniq


def check_num_videos(video_ids, num_videos: int) -> None:
    """Host-side twin of the reference's CHECK_EQ on max_num_videos
    (ref:src/caffe/layers/retrieval_stats_layer.cpp:188): raise if the
    distinct-id count differs from the segment count that
    video_level_average was (or will be) called with."""
    actual = len(np.unique(_host(video_ids).reshape(-1)))
    if actual != num_videos:
        raise ValueError(
            f"video_level_retrieval: batch has {actual} distinct video ids "
            f"but max_num_videos = {num_videos} (the reference CHECKs these "
            f"equal; a mismatch silently corrupts video-level mAP)")


def _ap_and_hits(valid: torch.Tensor, match: torch.Tensor):
    """Per-query (ap, acc@1, acc@5) from the ranked masks: ap = Σ_match
    (ret/val) / ret_total, acc@1 = a match in the first valid position,
    acc@5 = matches among the first 5 valid / 5."""
    vf = valid.to(torch.float32)
    mf = match.to(torch.float32)
    val = torch.cumsum(vf, dim=1)
    ret = torch.cumsum(mf, dim=1)
    ret_total = ret[:, -1]
    ap = torch.sum(mf * ret / torch.clamp(val, min=1.0), dim=1)
    ap = torch.where(ret_total > 0, ap / torch.clamp(ret_total, min=1.0), 0.0)
    acc1 = torch.sum(mf * (val <= 1.0), dim=1)
    acc5 = torch.sum(mf * (val <= 5.0), dim=1) / 5.0
    return ap, acc1, acc5


def _chunk_retrieval_stats(feats, vids, cls, q_feats, q_vid, q_cls, q_pos,
                           exclude_same_video_shots: bool):
    """Rank by SORT, one query chunk: per query row, all items ranked by
    -2·x·xᵀ ascending with the query item forced first (distance -1e15) and
    skipped; returns per-query (ap, acc1, acc5, include) f32."""
    n = feats.shape[0]
    dist = _neg2_dot(q_feats, feats)
    dist.scatter_(1, q_pos.long()[:, None], -1e15)
    order = torch.argsort(dist, dim=1, stable=True)   # ascending; self first
    valid = (torch.arange(n, device=dist.device) >= 1)[None, :].expand_as(dist)
    if exclude_same_video_shots:
        valid = valid & (vids[order] != q_vid[:, None])
    match = valid & (cls[order] == q_cls[:, None])
    ap, acc1, acc5 = _ap_and_hits(valid, match)
    return ap, acc1, acc5, (q_cls >= 0).to(torch.float32)


def retrieval_stats(features, video_ids, class_ids, *,
                    exclude_same_video_shots: bool = False):
    """Shot-to-shot retrieval mAP / hit@1 / hit@5 over the dense (N, N)
    distances, on the device of `features`.

    ref:src/caffe/layers/retrieval_stats_layer.cpp:104-141 (ComputeStats) and
    :143-355 (Forward_cpu). Per query row: rank all items by -2·x·xᵀ
    ascending with the self item forced first and skipped; optionally skip
    items from the same video; a retrieved item matches when its class
    equals the query's. Queries with class < 0 are excluded from the means.

    Args:
      features: (N, D) tensor, rows L2-normalized.
      video_ids: (N,) ids.
      class_ids: (N,) per-item class (IdToClassMap.lookup).
    Returns dict(mean_ap, hit_at_1, hit_at_5) of f32 0-d tensors.
    """
    dev = features.device
    vids = torch.as_tensor(video_ids, device=dev).reshape(-1)
    cls = torch.as_tensor(class_ids, device=dev).reshape(-1)
    pos = torch.arange(features.shape[0], device=dev)
    ap, acc1, acc5, include = _chunk_retrieval_stats(
        features, vids, cls, features, vids, cls, pos,
        exclude_same_video_shots)
    denom = torch.clamp(torch.sum(include), min=1.0)
    return {"mean_ap": torch.sum(ap * include) / denom,
            "hit_at_1": torch.sum(acc1 * include) / denom,
            "hit_at_5": torch.sum(acc5 * include) / denom}


def _mono_i32(d: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose SIGNED order equals the float order (sign-flip
    trick). -0.0 is canonicalized to +0.0 first (-2·0.0 is -0.0), so ties
    match float-compare semantics exactly."""
    d = d + 0.0  # IEEE: -0.0 + 0.0 == +0.0
    bits = d.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _key64(mono: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(mono, idx) int32 pairs packed into one int64 whose order is their
    lexicographic order: mono·2³² + idx, exact for any int32 idx."""
    return mono.to(torch.int64) * 2**32 + idx.to(torch.int64)


def _chunked_rank_count(c_mono, c_idx, q_mono, q_idx, chunk: int = 512):
    """#(candidate key < query key) per query member, int32, the candidate
    keys scanned in `chunk`-column blocks so that the (Q, M, chunk) compare
    cube bounds the working set.

    Candidates c_mono/c_idx: (Q, K) int32 (distance, index) key pairs with
    invalid entries pre-masked to _I32_MAX; queries q_mono/q_idx: (Q, M).
    `less` is the lexicographic stable-argsort order. The JAX package
    compares the two int32 keys in three steps (x64 is off there); here each
    pair is one int64 (`_key64`), one compare per cube element, with the
    same counts."""
    c_key = _key64(c_mono, c_idx)[:, None, :]                 # (Q, 1, K)
    q_key = _key64(q_mono, q_idx)[:, :, None]                 # (Q, M, 1)
    cnt = torch.zeros(q_key.shape[:2], dtype=torch.int32, device=q_key.device)
    for s in range(0, c_key.shape[2], chunk):
        cnt += torch.sum(c_key[:, :, s:s + chunk] < q_key, dim=2,
                         dtype=torch.int32)
    return cnt


def _chunk_retrieval_counts(feats, vids, cls, q_feats, q_vid, q_cls, q_pos,
                            rel_idx, exclude_same_video_shots: bool):
    """Rank by COUNTING, one query chunk: the same results as the sort
    engine, no argsort.

    mAP/hit@1/hit@5 only need, for each relevant candidate of each query,
    its rank among valid candidates and among relevant ones: both are
    #(key < my key) counts, with key = (distance, index) lexicographic (the
    stable argsort's order). Invalid gallery keys are masked to MAX once per
    (Q, N) row; the match rank scans only the query's M class members.

    rel_idx: (Q, M) gallery positions of each query's class members (-1
    pads). Returns per-query (ap, acc1, acc5, include) f32."""
    n = feats.shape[0]
    mono = _mono_i32(_neg2_dot(q_feats, feats))                 # (Q, N)
    gidx = torch.arange(n, dtype=torch.int32, device=mono.device)[None, :]
    q_pos = q_pos.to(torch.int32)[:, None]

    safe_rel = rel_idx.clamp(0, n - 1).long()
    mono_rel = torch.gather(mono, 1, safe_rel)                  # (Q, M)
    # a relevant candidate must itself be valid: not the query item, not a
    # pad, and (optionally) not from the query's video
    rel_ok = (rel_idx >= 0) & (rel_idx != q_pos)
    if exclude_same_video_shots:
        rel_ok = rel_ok & (vids[safe_rel] != q_vid[:, None])

    valid = gidx != q_pos
    if exclude_same_video_shots:
        valid = valid & (vids[None, :] != q_vid[:, None])
    cnt_v = _chunked_rank_count(torch.where(valid, mono, _I32_MAX),
                                torch.where(valid, gidx, _I32_MAX),
                                mono_rel, rel_idx)
    # match rank: compare the (Q, M) member keys against themselves, masked
    # to valid members
    cnt_m = _chunked_rank_count(torch.where(rel_ok, mono_rel, _I32_MAX),
                                torch.where(rel_ok, rel_idx, _I32_MAX),
                                mono_rel, rel_idx)

    valrank = (cnt_v + 1).to(torch.float32)                     # 1-based
    matchrank = (cnt_m + 1).to(torch.float32)
    okf = rel_ok.to(torch.float32)
    ret_total = torch.sum(okf, dim=1)
    ap = torch.sum(okf * matchrank / valrank, dim=1)
    ap = torch.where(ret_total > 0, ap / torch.clamp(ret_total, min=1.0), 0.0)
    acc1 = torch.sum(okf * (valrank <= 1.0), dim=1)
    acc5 = torch.sum(okf * (valrank <= 5.0), dim=1) / 5.0
    return ap, acc1, acc5, (q_cls >= 0).to(torch.float32)


def _run_chunk_engine(use_count: bool, feats, vids, cls, table, qp, qc, qr,
                      exclude: bool):
    """One query chunk through the sort or the count engine: the single
    dispatch of retrieval_stats_chunked and retrieval_stats_report."""
    q_feats, q_vid = feats[qp], vids[qp]
    if use_count:
        return _chunk_retrieval_counts(feats, vids, cls, q_feats, q_vid, qc,
                                       qp, table[qr], exclude)
    return _chunk_retrieval_stats(feats, vids, cls, q_feats, q_vid, qc, qp,
                                  exclude)


def _class_member_table(cls_np: np.ndarray):
    """(member_table (C+1, M) int32 w/ -1 pads, row_of_query (N,)) — row C
    is all-pads, assigned to negative-class queries (they are excluded
    from the means but still flow through the chunk in padded slots)."""
    n = cls_np.shape[0]
    nonneg = cls_np >= 0
    uniq, inv = np.unique(cls_np[nonneg], return_inverse=True)
    c = len(uniq)
    counts = np.bincount(inv, minlength=c) if c else np.zeros(0, np.int64)
    m = int(counts.max()) if c else 1
    table = np.full((c + 1, m), -1, np.int32)
    order = np.argsort(inv, kind="stable")
    pos_nonneg = np.flatnonzero(nonneg).astype(np.int32)
    starts = np.zeros(c + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    for ci in range(c):
        mem = pos_nonneg[order[starts[ci]:starts[ci + 1]]]
        table[ci, :len(mem)] = mem
    row_of_query = np.full(n, c, np.int32)
    row_of_query[nonneg] = inv
    return table, row_of_query


def _ids_int32(video_ids, class_ids, message: str):
    """Host int32 copies of the ids; ids beyond int32 raise (device ids are
    int32, as in the JAX package: no silent aliasing mod 2³²)."""
    out = []
    for name, arr in (("video_ids", video_ids), ("class_ids", class_ids)):
        a = _host(arr).astype(np.int64).reshape(-1)
        if a.size and (a.max() > _I32_MAX or a.min() < _I32_MIN):
            raise ValueError(f"{name} exceed int32 range — {message}")
        out.append(a.astype(np.int32))
    return out


def _cast_gallery_host(features, gallery_dtype: str):
    """Validate/cast the gallery for `gallery_dtype` BEFORE it goes to the
    device. bf16 halves the gallery's footprint (1M x 4096 = 8.4 GB instead
    of 16.8); host arrays are rounded to bf16 once, in host memory, so no
    f32 copy lands on the device (a device tensor is cast where it is).

    Exactness semantics: features quantize to bf16 once; distances are
    products of bf16 operands summed in f32, and the rank engines are exact
    with respect to those distances (count == sort at any dtype). The only
    deviation from f32 is input rounding."""
    if gallery_dtype in ("float32", "f32", None):
        return features
    if gallery_dtype not in ("bfloat16", "bf16"):
        raise ValueError(f"gallery_dtype must be float32 or bfloat16, "
                         f"got {gallery_dtype!r}")
    if not isinstance(features, torch.Tensor):
        features = torch.as_tensor(np.asarray(features, np.float32))
    return features.to(torch.bfloat16)


def _on_device(features, dev: torch.device) -> torch.Tensor:
    """The gallery on `dev`, bf16 if it is bf16, else f32."""
    feats = torch.as_tensor(features)
    dtype = torch.bfloat16 if feats.dtype == torch.bfloat16 else torch.float32
    return feats.to(dev, dtype)


def _check_driver(chunk_driver: str, mesh, shard_gallery: bool) -> None:
    """chunk_driver keeps the JAX package's values: "scan" and "host" run
    the same loop here (one query chunk at a time). The mesh engines are not
    ported yet."""
    if chunk_driver not in ("auto", "scan", "host"):
        raise ValueError(f"chunk_driver must be auto, scan or host, got "
                         f"{chunk_driver!r}")
    if mesh is not None or shard_gallery:
        raise NotImplementedError(
            "mesh= and shard_gallery=True wait for the port's parallelism "
            "(ROADMAP queue 1, item 11)")


def _auto_uses_count(dev: torch.device, members: int, n: int) -> bool:
    """method="auto": the JAX package's rule, the count engine off the CPU
    unless the largest class (`members` rows) is degenerate, else sort."""
    return dev.type != "cpu" and members <= max(256, n // 8)


def _chunk_inputs(features, vids_np, cls_np, method: str, device,
                  query_chunk):
    """What the query-chunk loop of retrieval_stats_chunked and
    retrieval_stats_report needs on `device`: the engine's leading
    arguments (use_count, feats, vids, cls, member table) and the (query
    positions, classes, member-table rows) of each chunk of
    query_chunk(N) rows, the last chunk padded as the JAX package pads it:
    position N-1, class -1 (include 0) and the all-pad table row."""
    dev = resolve(device)
    feats = _on_device(features, dev)
    n = feats.shape[0]
    table, row_of_query = _class_member_table(cls_np)
    use_count = (method == "count" if method != "auto"
                 else _auto_uses_count(dev, table.shape[1], n))
    q = query_chunk(n)
    nk = -(-n // q)
    npad = nk * q - n
    qpos = np.concatenate([np.arange(n, dtype=np.int32),
                           np.full(npad, n - 1, np.int32)])
    qcls = np.concatenate([cls_np, np.full(npad, -1, np.int32)])
    rows = np.concatenate([row_of_query,
                           np.full(npad, table.shape[0] - 1, np.int32)])
    on_dev = [torch.as_tensor(a, device=dev) for a in (vids_np, cls_np, table)]
    chunks = zip(*(torch.as_tensor(a.reshape(nk, q), device=dev)
                   for a in (qpos, qcls, rows)))
    return (use_count, feats, *on_dev), list(chunks)


def retrieval_stats_chunked(features, video_ids, class_ids, *,
                            exclude_same_video_shots: bool = False,
                            query_chunk: int = 256, method: str = "auto",
                            mesh=None, shard_gallery: bool = False,
                            gallery_dtype: str = "float32",
                            chunk_driver: str = "auto", device=DEFAULT):
    """Gallery-scale retrieval_stats: the same results (mAP, hit@1, hit@5,
    stable tie-breaking included) with O(Q·N) device memory instead of
    O(N²), one query chunk of `query_chunk` rows at a time.

    Engines, identical outputs:
    - "count": rank by counting (`_chunk_retrieval_counts`): an O(Q·M·N)
      compare cube for the valid rank and O(Q·M·M) for the match rank, M the
      largest class;
    - "sort": the (Q, N) stable argsort and cumsums;
    - "auto": the JAX package's rule, count off the CPU unless the largest
      class is degenerate (M > max(256, N/8)), else sort.
    "search", `mesh=` and `shard_gallery=True` raise NotImplementedError.

    features: (N, D) host array or tensor; `gallery_dtype` "bfloat16"
    rounds it to bf16 once (see _cast_gallery_host). It goes to `device`
    (the card unless "cpu" is asked for; raises without a card).
    `chunk_driver` ("auto", "scan" or "host") is validated and otherwise
    inert: every chunk is one Python loop step. Each chunk's four f32
    partial sums are reduced on the host in f64 in chunk order, as the JAX
    package does.

    Returns dict(mean_ap, hit_at_1, hit_at_5) of f32 0-d CPU tensors.
    """
    vids_np, cls_np = _ids_int32(
        video_ids, class_ids,
        "remap ids (e.g. np.unique(..., return_inverse=True)) before "
        "retrieval eval")
    features = _cast_gallery_host(features, gallery_dtype)
    _check_driver(chunk_driver, mesh, shard_gallery)
    if method == "search":
        raise NotImplementedError(
            "method='search' (the binary-search engine, a cross-check the "
            "JAX package never picks) is not ported (ROADMAP queue 1, "
            "item 5); use 'count' or 'sort'")
    if method not in ("auto", "count", "sort"):
        raise ValueError(f"unknown method {method!r}")
    engine_args, chunks = _chunk_inputs(features, vids_np, cls_np, method,
                                        device, lambda n: min(query_chunk, n))
    parts = []
    for qp, qc, qr in chunks:
        ap, acc1, acc5, inc = _run_chunk_engine(*engine_args, qp, qc, qr,
                                                exclude_same_video_shots)
        parts.append(torch.stack([torch.sum(ap * inc), torch.sum(acc1 * inc),
                                  torch.sum(acc5 * inc), torch.sum(inc)]))
    sums = np.zeros(4, np.float64)
    for row in torch.stack(parts).cpu().numpy():
        sums += row.astype(np.float64)
    denom = max(sums[3], 1.0)
    return {k: torch.tensor(sums[i] / denom, dtype=torch.float32)
            for i, k in enumerate(("mean_ap", "hit_at_1", "hit_at_5"))}


def _report_chunk(use_count: bool, feats, vids, cls, table, qp, qc, qr,
                  exclude: bool):
    """One query chunk of retrieval_stats_report: per-query (ap, acc@1,
    acc@5, include) from the chunk engine plus the stable top-5 retrieved
    from OTHER videos (ref:src/caffe/layers/retrieval_stats_layer.cpp:
    315-321) and whether each slot was filled — 5 iterated argmin + mask
    passes, whose first-minimum rule is the stable ascending (distance,
    index) order (torch.topk's order on ties is unspecified)."""
    k5 = min(5, feats.shape[0])
    ap, acc1, acc5, inc = _run_chunk_engine(use_count, feats, vids, cls,
                                            table, qp, qc, qr, exclude)
    q_vid = vids[qp]
    d = _neg2_dot(feats[qp], feats)
    d.masked_fill_(vids[None, :] == q_vid[:, None], float("inf"))
    tops, valids = [], []
    for _ in range(k5):
        i = torch.argmin(d, dim=1, keepdim=True)
        tops.append(i[:, 0])
        valids.append(torch.isfinite(torch.gather(d, 1, i)[:, 0]))
        d.scatter_(1, i, float("inf"))
    return ap, acc1, acc5, inc, torch.stack(tops, 1), torch.stack(valids, 1)


def retrieval_stats_report(features, video_ids, class_ids, path: str, *,
                           exclude_same_video_shots: bool = False,
                           mesh=None, shard_gallery: bool = False,
                           method: str = "auto",
                           gallery_dtype: str = "float32",
                           chunk_driver: str = "auto",
                           device=DEFAULT) -> dict:
    """The reference's per-query `stats_output_file` csv
    (ref:src/caffe/layers/retrieval_stats_layer.cpp:148-155, 310-340):
    header `#video_id,class_id,ap,acc@1,acc@5,` + the top-5 retrieved (from
    OTHER videos, ref :315-321) indices and their classes; float fields
    with %g, the reference's ostream formatting. Rows of class < 0 are not
    written. Returns the aggregate stats as Python floats.

    Query chunks of max(1, min(256, 2²⁵ // N)) rows through the sort or the
    count engine (`method` as in retrieval_stats_chunked, without
    "search") on `device`, the card unless "cpu" is asked for;
    `gallery_dtype`, `chunk_driver`, `mesh=` and `shard_gallery` as there.
    """
    features = _cast_gallery_host(features, gallery_dtype)
    vids_np, cls_np = _ids_int32(video_ids, class_ids,
                                 "remap ids before retrieval eval")
    vids64, cls64 = vids_np.astype(np.int64), cls_np.astype(np.int64)
    if method not in ("auto", "count", "sort"):
        raise ValueError(f"unknown method {method!r} (report engines: "
                         f"auto/count/sort)")
    _check_driver(chunk_driver, mesh, shard_gallery)
    engine_args, chunks = _chunk_inputs(
        features, vids_np, cls_np, method, device,
        lambda n: max(1, min(256, (1 << 25) // max(n, 1))))
    n, nk = len(vids_np), len(chunks)
    outs = [_report_chunk(*engine_args, qp, qc, qr, exclude_same_video_shots)
            for qp, qc, qr in chunks]
    ap_c, acc1_c, acc5_c, inc_c, top5_c, valid5_c = (
        torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(6))
    # per-chunk f32 partials accumulated in f64 in chunk order
    sums = np.zeros(4, np.float64)
    for ci in range(nk):
        sums += [float(np.sum(ap_c[ci] * inc_c[ci])),
                 float(np.sum(acc1_c[ci] * inc_c[ci])),
                 float(np.sum(acc5_c[ci] * inc_c[ci])),
                 float(np.sum(inc_c[ci]))]

    ap = ap_c.reshape(-1)[:n]
    acc1 = acc1_c.reshape(-1)[:n]
    acc5 = acc5_c.reshape(-1)[:n]
    k5 = top5_c.shape[-1]
    top5 = top5_c.reshape(-1, k5)[:n].astype(np.int64)
    valid5 = valid5_c.reshape(-1, k5)[:n]
    if k5 < 5:
        top5 = np.pad(top5, ((0, 0), (0, 5 - k5)))
        valid5 = np.pad(valid5, ((0, 0), (0, 5 - k5)))

    with open(path, "w") as f:
        f.write("#video_id,class_id,ap,acc@1,acc@5"
                ",ret_id_1,ret_id_2,ret_id_3,ret_id_4,ret_id_5"
                ",class_id_1,class_id_2,class_id_3,class_id_4,class_id_5\n")
        lines = []
        # the reference's top_5_ids vector lives OUTSIDE the query loop
        # (retrieval_stats_layer.cpp:216, filled :310-317): a query with
        # fewer than 5 other-video retrievals leaves its unfilled slots
        # holding the PREVIOUS written row's ids (0 before any fill), and
        # the class columns print those carried ids' classes — preserved
        # byte-for-byte. Fills are a rank prefix, so valid5 masks exactly
        # the slots the reference overwrites.
        carry = np.zeros(5, np.int64)
        for i in range(n):  # formatting only — no ranking math
            if cls_np[i] < 0:
                continue
            carry = np.where(valid5[i], top5[i], carry)
            lines.append(
                f"{vids64[i]},{cls64[i]},{ap[i]:g},{acc1[i]:g},"
                f"{acc5[i]:g},"
                + ",".join(str(j) for j in carry) + ","
                + ",".join(str(c) for c in cls64[carry]) + "\n")
        f.write("".join(lines))

    denom = max(sums[3], 1.0)
    return {"mean_ap": sums[0] / denom, "hit_at_1": sums[1] / denom,
            "hit_at_5": sums[2] / denom}


def _bucket_video_id(item_idx, num_videos: int, positive_size: int):
    """ref GetVideoId (retrieval_rank_stats_layer.cpp:108-129): items are laid
    out in buckets of num_videos; the first positive_size buckets are
    positives (id = item % num_videos), the rest negatives
    (id = −(item % num_videos)). Note −0 == 0: video 0's negatives alias its
    positives — preserved deliberately for parity."""
    bucket = item_idx // num_videos
    vid = item_idx % num_videos
    return torch.where(bucket >= positive_size, -vid, vid)


def _rank_means(ranks_f, rec1, rec5, rec10, mean_ap) -> dict:
    return {"median_rank": _median_rank(ranks_f),
            "recall_at_1": torch.mean(rec1),
            "recall_at_5": torch.mean(rec5),
            "recall_at_10": torch.mean(rec10),
            "mean_ap": mean_ap}


def retrieval_rank_stats(context, targets, *, compute_ap: bool = False,
                         positive_size: int = 0, negative_size: int = 0):
    """Context-vs-target retrieval: median rank, recall@1/5/10, mAP, on the
    device of `context`.

    ref:src/caffe/layers/retrieval_rank_stats_layer.cpp. Scores are
    −2·context·targetsᵀ, ranked ascending (stable) per query.

    Without compute_ap (identity mode, B == F): rank of target i for query i;
    recall@k = 1[rank ≤ k]; mean_ap output is 0.

    With compute_ap: relevance via the positive/negative bucket layout (see
    _bucket_video_id); ap = Σ ret/val over matches / ret_total; rank = first
    match position (1e4 without one); rec@5 normalized by min(ret, 5),
    rec@10 by min(ret, 10) (ref ComputeApStats:131-182).

    Returns dict(median_rank, recall_at_1, recall_at_5, recall_at_10,
    mean_ap) of f32 0-d tensors.
    """
    return _rank_means(*_rank_stats_peritem(context, targets, compute_ap,
                                            positive_size, negative_size)[2:])


def _ranked_stats(match: torch.Tensor):
    """(first-match rank (1e4 without one), rec@1, rec@5, rec@10, ap) per
    row from the (B, F) ranked 0/1 match matrix; rec@5 and rec@10 are
    normalized by min(ret_total, k)."""
    val = torch.arange(match.shape[1], dtype=torch.float32,
                       device=match.device)[None, :] + 1.0
    ret = torch.cumsum(match, dim=1)
    ret_total = ret[:, -1]
    ap = torch.sum(match * ret / val, dim=1)
    ap = torch.where(ret_total > 0, ap / torch.clamp(ret_total, min=1.0), 0.0)
    first = torch.amin(torch.where(match > 0, val, 1e4), dim=1)
    rec1 = torch.sum(match * (val <= 1.0), dim=1)
    recs = [torch.where(ret_total > 0,
                        torch.sum(match * (val <= k), dim=1)
                        / torch.clamp(torch.clamp(ret_total, min=1.0), max=k),
                        0.0) for k in (5.0, 10.0)]
    return first, rec1, recs[0], recs[1], ap


def _rank_stats_peritem(context, targets, compute_ap, positive_size,
                        negative_size):
    """Per-item pieces shared by retrieval_rank_stats and its csv report:
    (dist (B, F), stable ascending order (B, F), rank, rec@1/5/10 arrays
    (B,), mean_ap scalar)."""
    b = context.shape[0]
    f = targets.shape[0]
    dist = _neg2_dot(context, targets)
    order = torch.argsort(dist, dim=1, stable=True)    # (B, F) ascending
    rows = torch.arange(b, device=dist.device)[:, None]
    if not compute_ap:
        if b != f:
            raise ValueError("identity mode requires batch == num_frames")
        # rank of item i in row i (1-based)
        pos = torch.arange(f, device=dist.device)[None, :]
        rank = torch.sum(torch.where(order == rows, pos, 0), dim=1) + 1
        rank_f = rank.to(torch.float32)
        return (dist, order, rank_f, (rank == 1).to(torch.float32),
                (rank <= 5).to(torch.float32), (rank <= 10).to(torch.float32),
                torch.zeros((), device=dist.device))
    num_videos = f // max(positive_size + negative_size, 1)
    gv = _bucket_video_id(order, num_videos, positive_size)     # (B, F)
    first, rec1, rec5, rec10, ap = _ranked_stats(
        (gv == rows).to(torch.float32))
    return dist, order, first, rec1, rec5, rec10, torch.mean(ap)


def _median_rank(ranks_f):
    """ref median: sort, exact middle (mean of the two central elements
    for even counts), retrieval_rank_stats_layer.cpp:287-295."""
    b = ranks_f.shape[0]
    s = torch.sort(ranks_f, stable=True).values
    if b % 2 == 0:
        return (s[b // 2 - 1] + s[b // 2]) / 2.0
    return s[b // 2]


def _write_rank_stats_csv(path, dist, order, ranks_f, rec1, rec5,
                          video_ids=None):
    """The reference rank-stats csv (retrieval_rank_stats_layer.cpp:
    188-268, retrieval_rank_stats_fixed_ref_layer.cpp:120-221): header
    `#item_id,rank,rec@1,rec@5,ret_id_1..5`, rows
    `i[,video_id],rank,rec1,rec5,id1..id5,d1..d5` — the header names
    neither the fixed-ref video_id column nor the five distance columns,
    and the top-5 id slots beyond min(batch, 5) keep their initial 0
    (the reference's `jj < num_samples` cap with num_samples = batch
    size) — all preserved byte-for-byte. Truncates per call (default
    ofstream::open)."""
    dist, order, ranks, rec1, rec5 = (_host(a) for a in
                                      (dist, order, ranks_f, rec1, rec5))
    b = order.shape[0]
    k = min(b, 5, order.shape[1])
    top5 = np.zeros((b, 5), np.int64)
    top5[:, :k] = order[:, :k]
    d5 = np.take_along_axis(dist, top5, axis=1)
    with open(path, "w") as f:
        f.write("#item_id,rank,rec@1,rec@5"
                ",ret_id_1,ret_id_2,ret_id_3,ret_id_4,ret_id_5\n")
        lines = []
        for i in range(b):
            vid = f"{int(video_ids[i])}," if video_ids is not None else ""
            lines.append(
                f"{i},{vid}{int(ranks[i])},{rec1[i]:g},{rec5[i]:g},"
                + ",".join(str(int(j)) for j in top5[i]) + ","
                + ",".join(f"{float(v):g}" for v in d5[i]) + "\n")
        f.write("".join(lines))


def retrieval_rank_stats_report(context, targets, path: str, *,
                                compute_ap: bool = False,
                                positive_size: int = 0,
                                negative_size: int = 0,
                                device=DEFAULT) -> dict:
    """retrieval_rank_stats on `device` (the card unless "cpu" is asked
    for) + the reference's per-item csv dump
    (ref:src/caffe/layers/retrieval_rank_stats_layer.cpp:188-268).
    Returns the same aggregate dict."""
    dev = resolve(device)
    dist, order, ranks_f, rec1, rec5, rec10, mean_ap = _rank_stats_peritem(
        torch.as_tensor(context, device=dev),
        torch.as_tensor(targets, device=dev), compute_ap, positive_size,
        negative_size)
    _write_rank_stats_csv(path, dist, order, ranks_f, rec1, rec5)
    return _rank_means(ranks_f, rec1, rec5, rec10, mean_ap)


def retrieval_rank_stats_fixed_ref(features, video_ids, ref_features,
                                   ref_video_ids):
    """Rank stats against a fixed reference gallery
    (ref:src/caffe/layers/retrieval_rank_stats_fixed_ref_layer.cpp:116-233),
    on the device of `features`. A gallery item is relevant for query i
    when its video id matches the query's; gallery ids < 0 are global
    negatives.

    Returns dict(median_rank, recall_at_1, recall_at_5, recall_at_10,
    mean_ap) of f32 0-d tensors.
    """
    (_, _, first, rec1, rec5, rec10,
     ap) = _fixed_ref_peritem(features, video_ids, ref_features,
                              ref_video_ids)
    return _rank_means(first, rec1, rec5, rec10, torch.mean(ap))


def _fixed_ref_peritem(features, video_ids, ref_features, ref_video_ids):
    dev = features.device
    vids = torch.as_tensor(video_ids, device=dev).reshape(-1)
    ref_vids = torch.as_tensor(ref_video_ids, device=dev).reshape(-1)
    dist = _neg2_dot(features, ref_features)
    order = torch.argsort(dist, dim=1, stable=True)
    match = (ref_vids[order] == vids[:, None]).to(torch.float32)
    return (dist, order) + _ranked_stats(match)


def retrieval_rank_stats_fixed_ref_report(features, video_ids, ref_features,
                                          ref_video_ids, path: str, *,
                                          device=DEFAULT) -> dict:
    """retrieval_rank_stats_fixed_ref on `device` (the card unless "cpu"
    is asked for) + the reference's per-item csv
    (ref:src/caffe/layers/retrieval_rank_stats_fixed_ref_layer.cpp:
    120-221; rows carry an extra video_id column the header does not
    name). Returns the same aggregate dict."""
    dev = resolve(device)
    vids, ref_vids = (torch.as_tensor(v, device=dev).reshape(-1)
                      .to(torch.int32) for v in (video_ids, ref_video_ids))
    (dist, order, first, rec1, rec5, rec10,
     ap) = _fixed_ref_peritem(torch.as_tensor(features, device=dev), vids,
                              torch.as_tensor(ref_features, device=dev),
                              ref_vids)
    _write_rank_stats_csv(path, dist, order, first, rec1, rec5,
                          video_ids=_host(vids))
    return _rank_means(first, rec1, rec5, rec10, torch.mean(ap))
