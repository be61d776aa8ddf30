"""The port's metrics (videovector_tpu_torch.metrics: retrieval and
classification) against the JAX package on the CPU.

Two kinds of input:
- the JAX tests' own (tests/test_metrics.py, tests/test_gallery_bf16.py),
  drawn with numpy from the same seeds: aggregates within rtol 1e-6 and atol
  1e-7, JAX's own dense-vs-chunked tolerance (both packages sum in their own
  order, so a near-tie may order otherwise);
- exact inputs: small integers times a power of two, so that every dot
  product is exact in any order, with many exact ties (duplicate rows,
  one-hot rows, a zero row, whose distances are -0.0). There every rank,
  top-5 id, class column, acc@1 and acc@5 equals JAX's bit for bit; ap,
  a sum of inexact quotients, within rtol 1e-6 (1e-5 as printed by %g).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.metrics import classification as jcls
from videovector_tpu.metrics import retrieval as jr
from videovector_tpu_torch import metrics as tmetrics
from videovector_tpu_torch.metrics import classification as tcls
from videovector_tpu_torch.metrics import retrieval as tr

torch.set_num_threads(1)

AGG = ("mean_ap", "hit_at_1", "hit_at_5")
RANK = ("median_rank", "recall_at_1", "recall_at_5", "recall_at_10",
        "mean_ap")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got: dict, ref: dict, keys, rtol=1e-6, atol=1e-7):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# -- inputs ---------------------------------------------------------------

def _test_metrics_inputs():
    """tests/test_metrics.py::test_retrieval_stats_matches_oracle's."""
    rng = np.random.RandomState(1701)
    n, d = 24, 8
    feats = rng.randn(n, d).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    vids = rng.randint(0, 8, size=(n,))
    return feats, vids, vids % 3


def _chunked_inputs():
    """tests/test_metrics.py::test_retrieval_stats_chunked_matches_dense's:
    531 rows (ragged against the chunk), duplicate rows, class -1 queries.
    """
    rng = np.random.RandomState(1701)
    n, d = 531, 24
    feats = rng.randn(n, d).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    feats[100] = feats[7]
    feats[101] = feats[7]
    vids = rng.randint(0, 40, size=(n,))
    cls = vids % 7
    cls[::50] = -1
    return feats, vids, cls


def _gallery(n=600, d=32, classes=12, seed=0):
    """tests/test_gallery_bf16.py's."""
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, classes, size=n)
    centers = rng.randn(classes, d).astype(np.float32)
    feats = centers[cls] + 0.6 * rng.randn(n, d).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    vids = rng.randint(0, 80, size=n)
    return feats, vids, cls


def _exact_inputs(n=71, d=6, seed=3):
    """Features in {-2..2}/4, so every dot product is exact; rows 10-12
    duplicate row 3, rows 20-25 are one-hot, row 30 is zero; ids and
    classes with class -1 queries."""
    rng = np.random.RandomState(seed)
    feats = rng.randint(-2, 3, size=(n, d)).astype(np.float32) * 0.25
    feats[10:13] = feats[3]
    feats[20:26] = np.eye(d, dtype=np.float32)
    feats[30] = 0.0
    vids = rng.randint(0, 9, size=n)
    cls = vids % 4
    cls[::13] = -1
    return feats, vids, cls


# -- dense and chunked ----------------------------------------------------

@pytest.mark.parametrize("exclude", [False, True])
def test_retrieval_stats_dense_matches_jax(exclude):
    feats, vids, cls = _test_metrics_inputs()
    ref = jr.retrieval_stats(jnp.asarray(feats), jnp.asarray(vids),
                             jnp.asarray(cls), exclude_same_video_shots=exclude)
    got = tr.retrieval_stats(_t(feats), _t(vids), _t(cls),
                             exclude_same_video_shots=exclude)
    assert all(got[k].dtype == torch.float32 and got[k].dim() == 0
               for k in AGG)
    _close(got, ref, AGG)


def test_retrieval_stats_negative_class_excluded():
    """tests/test_metrics.py::test_retrieval_stats_negative_class_excluded's
    inputs: half the queries of class -1."""
    rng = np.random.RandomState(1701)
    feats = rng.randn(10, 4).astype(np.float32)
    vids, cls = np.arange(10), np.array([-1] * 5 + [1] * 5)
    ref = jr.retrieval_stats(jnp.asarray(feats), jnp.asarray(vids),
                             jnp.asarray(cls))
    _close(tr.retrieval_stats(_t(feats), _t(vids), _t(cls)), ref, AGG)


@pytest.mark.parametrize("method", ["sort", "count"])
@pytest.mark.parametrize("exclude", [False, True])
def test_chunked_engines_match_jax(method, exclude):
    """Port chunked (ragged last chunk, duplicates, class -1 queries)
    against JAX's dense path and JAX's chunked engine of the same name."""
    feats, vids, cls = _chunked_inputs()
    dense = jr.retrieval_stats(jnp.asarray(feats), jnp.asarray(vids),
                               jnp.asarray(cls),
                               exclude_same_video_shots=exclude)
    jchunk = jr.retrieval_stats_chunked(feats, vids, cls, query_chunk=128,
                                        method=method,
                                        exclude_same_video_shots=exclude)
    got = tr.retrieval_stats_chunked(feats, vids, cls, query_chunk=128,
                                     method=method, device="cpu",
                                     exclude_same_video_shots=exclude)
    _close(got, dense, AGG)
    _close(got, jchunk, AGG)
    _close(tr.retrieval_stats(_t(feats), _t(vids), _t(cls),
                              exclude_same_video_shots=exclude), dense, AGG)


def _chunk_rows(mod, engine, feats, vids, cls, exclude):
    """Per-query (ap, acc1, acc5, include) of one engine, all queries in
    one chunk, as numpy."""
    n = feats.shape[0]
    table, rows = mod._class_member_table(cls.astype(np.int32))
    arr = _t if mod is tr else jnp.asarray
    f, v, c = arr(feats), arr(vids.astype(np.int32)), arr(cls.astype(np.int32))
    pos = arr(np.arange(n, dtype=np.int32))
    if engine == "count":
        out = mod._chunk_retrieval_counts(f, v, c, f, v, c, pos,
                                          arr(table[rows]), exclude)
    else:
        out = mod._chunk_retrieval_stats(f, v, c, f, v, c, pos, exclude)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("engine", ["sort", "count"])
@pytest.mark.parametrize("exclude", [False, True])
def test_exact_inputs_per_query_bit_for_bit(engine, exclude):
    """On exact inputs with many ties, each query's acc@1, acc@5 and include
    equal JAX's bit for bit, its ap within rtol 1e-6; hit@1 aggregates
    equal bit for bit through the chunked driver."""
    feats, vids, cls = _exact_inputs()
    got = _chunk_rows(tr, engine, feats, vids, cls, exclude)
    ref = _chunk_rows(jr, engine, feats, vids, cls, exclude)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-7)
    # the two engines agree on every included query (a class -1 query
    # matches class -1 items in the sort engine and nothing in the count
    # engine; it is excluded from the means either way)
    other = _chunk_rows(tr, "sort" if engine == "count" else "count", feats,
                        vids, cls, exclude)
    inc = got[3] > 0
    assert inc.sum() < len(inc)
    for g, o in zip(got[1:], other[1:]):
        np.testing.assert_array_equal(g[inc], o[inc])
    out = tr.retrieval_stats_chunked(feats, vids, cls, query_chunk=16,
                                     method=engine, device="cpu",
                                     exclude_same_video_shots=exclude)
    jout = jr.retrieval_stats_chunked(feats, vids, cls, query_chunk=16,
                                      method=engine,
                                      exclude_same_video_shots=exclude)
    assert float(out["hit_at_1"]) == float(jout["hit_at_1"])
    _close(out, jout, AGG)


def test_mono_keys_equal_jax_bit_for_bit():
    """The count engine's monotone int32 keys, -0.0 canonicalized to +0.0,
    on signed zeros, infinities, the smallest normals and the -1e15 self
    key. (Not on subnormals: XLA:CPU flushes them to zero in `d + 0.0`,
    PyTorch keeps them.)"""
    d = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 2.0**-126,
                  -2.0**-126, -1e15, 3.5, -2.0 * 0.0, 2.0**-125], np.float32)
    got = tr._mono_i32(_t(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jr._mono_i32(jnp.asarray(d))))
    assert got[0] == got[1] == got[10] == 0
    order = np.argsort(d, kind="stable")
    assert (np.diff(got[order].astype(np.int64)) >= 0).all()


@pytest.mark.parametrize("chunk", [3, 512])
def test_chunked_rank_count_equals_jax(chunk):
    """Lexicographic (mono, index) counts with ties in mono, -1 query pads
    and MAX-masked candidates, across column chunks."""
    rng = np.random.RandomState(5)
    q, k, m = 4, 23, 7
    c_mono = rng.randint(-3, 4, size=(q, k)).astype(np.int32)
    c_idx = np.tile(np.arange(k, dtype=np.int32), (q, 1))
    c_mono[:, ::5] = tr._I32_MAX
    c_idx[:, ::5] = tr._I32_MAX
    q_mono = rng.randint(-3, 4, size=(q, m)).astype(np.int32)
    q_idx = rng.randint(-1, k, size=(q, m)).astype(np.int32)
    got = tr._chunked_rank_count(_t(c_mono), _t(c_idx), _t(q_mono),
                                 _t(q_idx), chunk=chunk)
    ref = jr._chunked_rank_count(*map(jnp.asarray, (c_mono, c_idx, q_mono,
                                                    q_idx)), chunk=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cls", [[3, 1, -1, 3, 7, 1, 3], [-1, -1], [2]])
def test_class_member_table_equals_jax(cls):
    cls = np.asarray(cls, np.int32)
    for g, r in zip(tr._class_member_table(cls), jr._class_member_table(cls)):
        np.testing.assert_array_equal(g, r)


# -- bf16 galleries -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_count_equals_sort_and_jax(dtype):
    """count == sort exactly at either dtype (tests/test_gallery_bf16.py's
    property), and both within rtol 1e-6 of JAX's engine."""
    feats, vids, cls = _gallery()
    kw = dict(query_chunk=128, gallery_dtype=dtype)
    a = tr.retrieval_stats_chunked(feats, vids, cls, method="count",
                                   device="cpu", **kw)
    b = tr.retrieval_stats_chunked(feats, vids, cls, method="sort",
                                   device="cpu", **kw)
    for k in AGG:
        assert float(a[k]) == float(b[k]), k
    _close(a, jr.retrieval_stats_chunked(feats, vids, cls, method="count",
                                         **kw), AGG)


def test_bf16_gallery_cast_once_on_the_host():
    """The host cast gives a compact bf16 tensor with JAX's (ml_dtypes')
    round-to-nearest-even bits; a bf16 tensor passes through; other dtypes
    raise."""
    feats = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    cast = tr._cast_gallery_host(feats, "bfloat16")
    assert cast.dtype == torch.bfloat16 and cast.device.type == "cpu"
    assert cast.numel() * cast.element_size() == feats.nbytes // 2
    ref = np.asarray(jr._cast_gallery_host(feats, "bfloat16")).astype(
        np.float32)
    np.testing.assert_array_equal(cast.float().numpy(), ref)
    assert tr._cast_gallery_host(cast, "bf16") is cast
    assert tr._cast_gallery_host(feats, "float32") is feats
    with pytest.raises(ValueError, match="gallery_dtype"):
        tr._cast_gallery_host(feats, "int4")


def test_bf16_distances_are_exact_products_summed_in_f32():
    """bf16 x bf16 on the CPU upcasts (exact); the result is f32 and equals
    the f32 product of the rounded operands."""
    rng = np.random.RandomState(1)
    a = torch.as_tensor(rng.randn(5, 9).astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.randn(7, 9).astype(np.float32)).bfloat16()
    d = tr._neg2_dot(a, b)
    assert d.dtype == torch.float32
    assert torch.equal(d, -2.0 * (a.float() @ b.float().T))


def test_drivers_are_equal_and_validated():
    """"scan", "host" and "auto" run the same loop; an unknown driver
    raises, as in the JAX package."""
    feats, vids, cls = _gallery(n=300)
    outs = [tr.retrieval_stats_chunked(feats, vids, cls, query_chunk=64,
                                       method="count", chunk_driver=d,
                                       device="cpu")
            for d in ("auto", "scan", "host")]
    for o in outs[1:]:
        assert all(float(o[k]) == float(outs[0][k]) for k in AGG)
    with pytest.raises(ValueError, match="chunk_driver"):
        tr.retrieval_stats_chunked(feats, vids, cls, chunk_driver="turbo",
                                   device="cpu")
    with pytest.raises(ValueError, match="chunk_driver"):
        tr.retrieval_stats_report(feats, vids, cls, "unused.csv",
                                  chunk_driver="turbo", device="cpu")


def test_auto_method_rule():
    """Sort on the CPU and on the card at every size: the JAX rule's count
    picks (a card, the largest class within max(256, N/8) rows) included."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not tr._auto_uses_count(cpu, 10, 20_000)
    assert not tr._auto_uses_count(cuda, 2_500, 20_000)
    assert not tr._auto_uses_count(cuda, 2_501, 20_000)
    assert not tr._auto_uses_count(cuda, 256, 100)


@pytest.mark.parametrize("members,n", [(1, 673), (400, 20_000),
                                       (2_000, 100_000)])
def test_auto_method_picks_sort_on_cuda_without_a_card(members, n):
    """The pure rule on torch.device("cuda"), with no card: the flagship's
    test batch, the 20k and the 100k galleries all take sort."""
    assert tr._auto_uses_count(torch.device("cuda"), members, n) is False


# -- the csv report -------------------------------------------------------

def _report_inputs(kind):
    rng = np.random.RandomState(1701)
    if kind == "top5_ties":      # test_retrieval_report_top5_stable_ties
        feats = rng.randn(37, 8).astype(np.float32)
        feats[9] = feats[3]
        feats[21] = feats[3]
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        vids = rng.randint(0, 6, size=(37,))
        return feats, vids, vids % 3
    if kind == "underfilled":    # test_retrieval_stats_report_underfilled_top5_carry
        feats = rng.randn(8, 6).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        return (feats, np.asarray([0, 0, 0, 0, 1, 1, 1, 1]),
                np.asarray([2, 3, -1, 2, 3, 2, 3, 2]))
    if kind == "bf16":
        return _gallery(n=120)
    return _exact_inputs()


def _assert_csv_equal(got: str, ref: str, ap_col: int = 2):
    """Header and every column but ap byte-equal; ap within rtol 1e-5 as
    parsed (%g keeps 6 digits)."""
    g, r = got.splitlines(), ref.splitlines()
    assert len(g) == len(r) and g[0] == r[0]
    for gl, rl in zip(g[1:], r[1:]):
        gc, rc = gl.split(","), rl.split(",")
        assert gc[:ap_col] + gc[ap_col + 1:] == rc[:ap_col] + rc[ap_col + 1:], \
            (gl, rl)
        np.testing.assert_allclose(float(gc[ap_col]), float(rc[ap_col]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["sort", "count"])
@pytest.mark.parametrize("kind", ["top5_ties", "underfilled", "exact", "bf16"])
def test_report_csv_matches_jax(tmp_path, kind, method):
    """The stable top-5 over exact ties, the underfilled stale carry, the
    skipped class -1 rows and the bf16 gallery: csv against JAX's, and the
    aggregates, Python floats, within rtol 1e-6."""
    feats, vids, cls = _report_inputs(kind)
    dtype = "bfloat16" if kind == "bf16" else "float32"
    kw = dict(method=method, gallery_dtype=dtype)
    ref = jr.retrieval_stats_report(feats, vids, cls, str(tmp_path / "j.csv"),
                                    **kw)
    got = tr.retrieval_stats_report(feats, vids, cls, str(tmp_path / "t.csv"),
                                    device="cpu", **kw)
    assert all(isinstance(got[k], float) for k in AGG)
    _close(got, ref, AGG)
    _assert_csv_equal((tmp_path / "t.csv").read_text(),
                      (tmp_path / "j.csv").read_text())
    rows = (tmp_path / "t.csv").read_text().splitlines()[1:]
    assert len(rows) == int((np.asarray(cls) >= 0).sum())


def test_report_chunks_rows_as_jax_does(tmp_path, monkeypatch):
    """More rows than one report chunk (256 rows below 2¹⁷ rows), the last
    one ragged and padded: the same csv as JAX's."""
    feats, vids, cls = _exact_inputs(n=300)
    ref = jr.retrieval_stats_report(feats, vids, cls, str(tmp_path / "j.csv"))
    calls = []
    real = tr._report_chunk

    def spy(*a):
        calls.append(a[5].shape[0])
        return real(*a)
    monkeypatch.setattr(tr, "_report_chunk", spy)
    got = tr.retrieval_stats_report(feats, vids, cls, str(tmp_path / "t.csv"),
                                    device="cpu")
    assert calls == [256, 256]
    _close(got, ref, AGG)
    _assert_csv_equal((tmp_path / "t.csv").read_text(),
                      (tmp_path / "j.csv").read_text())


# -- rank stats -----------------------------------------------------------

@pytest.mark.parametrize("b", [12, 11])
def test_rank_stats_identity_mode_matches_jax(b):
    """tests/test_metrics.py::test_rank_stats_identity_mode's inputs at
    b=12 (even median) and b=11 (odd)."""
    rng = np.random.RandomState(1701)
    ctx = rng.randn(b, 6).astype(np.float32)
    tgt = ctx + 0.01 * rng.randn(b, 6).astype(np.float32)
    ref = jr.retrieval_rank_stats(jnp.asarray(ctx), jnp.asarray(tgt))
    got = tr.retrieval_rank_stats(_t(ctx), _t(tgt))
    assert float(got["median_rank"]) == float(ref["median_rank"])
    _close(got, ref, RANK)
    with pytest.raises(ValueError, match="batch == num_frames"):
        tr.retrieval_rank_stats(_t(ctx), _t(tgt[:-1]))


@pytest.mark.parametrize("num_videos,pos,neg", [(6, 2, 3), (5, 1, 2)])
def test_rank_stats_ap_mode_matches_jax(num_videos, pos, neg):
    """The positive/negative bucket layout (video 0's negatives alias its
    positives, -0 == 0), rec@5/@10 over min(ret, k), the 1e4 no-match
    rank."""
    rng = np.random.RandomState(1701)
    f = num_videos * (pos + neg)
    ctx = rng.randn(num_videos, 5).astype(np.float32)
    tgt = rng.randn(f, 5).astype(np.float32)
    kw = dict(compute_ap=True, positive_size=pos, negative_size=neg)
    ref = jr.retrieval_rank_stats(jnp.asarray(ctx), jnp.asarray(tgt), **kw)
    got = tr.retrieval_rank_stats(_t(ctx), _t(tgt), **kw)
    assert float(got["median_rank"]) == float(ref["median_rank"])
    _close(got, ref, RANK)
    np.testing.assert_array_equal(
        tr._bucket_video_id(torch.arange(f), num_videos, pos).numpy(),
        np.asarray(jr._bucket_video_id(jnp.arange(f), num_videos, pos)))


def test_rank_stats_no_match_rank_and_medians():
    """A query with no relevant target gets rank 1e4; medians of even and
    odd counts."""
    ctx = torch.eye(3, 4)
    tgt = torch.eye(4)[:2]           # 2 targets, 1 video: query 1, 2 unmatched
    out = tr.retrieval_rank_stats(ctx, tgt, compute_ap=True, positive_size=2,
                                  negative_size=0)
    assert float(out["median_rank"]) == 1e4
    assert float(tr._median_rank(torch.tensor([4.0, 1.0, 3.0, 2.0]))) == 2.5
    assert float(tr._median_rank(torch.tensor([5.0, 1.0, 3.0]))) == 3.0


@pytest.mark.parametrize("b", [4, 9])
def test_rank_stats_report_csv_equals_jax(tmp_path, b):
    """Exact inputs (so the distance columns print the same digits): the
    csv byte for byte, top-5 slots beyond min(batch, 5) left 0 at b=4."""
    rng = np.random.RandomState(b)
    ctx = rng.randint(-2, 3, size=(b, 5)).astype(np.float32) * 0.5
    tgt = ctx.copy()
    tgt[1] = tgt[0]                      # a tie decided by index
    for kw in (dict(), dict(compute_ap=True, positive_size=1,
                            negative_size=0)):
        ref = jr.retrieval_rank_stats_report(ctx, tgt, str(tmp_path / "j"),
                                             **kw)
        got = tr.retrieval_rank_stats_report(ctx, tgt, str(tmp_path / "t"),
                                             device="cpu", **kw)
        _close(got, ref, RANK)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_fixed_ref_matches_jax(tmp_path):
    """tests/test_metrics.py::test_rank_stats_fixed_ref's inputs (global
    negatives of id -1), and its csv with the unnamed video_id column."""
    rng = np.random.RandomState(1701)
    feats = rng.randn(8, 4).astype(np.float32)
    gallery = rng.randn(20, 4).astype(np.float32)
    vids = rng.randint(0, 4, size=(8,))
    ref_vids = np.concatenate([rng.randint(0, 4, size=(10,)),
                               -np.ones(10, dtype=int)])
    ref = jr.retrieval_rank_stats_fixed_ref(*map(jnp.asarray, (
        feats, vids, gallery, ref_vids)))
    got = tr.retrieval_rank_stats_fixed_ref(*map(_t, (feats, vids, gallery,
                                                      ref_vids)))
    _close(got, ref, RANK)
    # exact inputs for the csv
    q = rng.randint(-2, 3, size=(7, 4)).astype(np.float32)
    g = rng.randint(-2, 3, size=(12, 4)).astype(np.float32)
    qv, gv = rng.randint(0, 3, size=7), np.r_[rng.randint(0, 3, 8), [-1] * 4]
    jr.retrieval_rank_stats_fixed_ref_report(q, qv, g, gv, str(tmp_path / "j"))
    got = tr.retrieval_rank_stats_fixed_ref_report(q, qv, g, gv,
                                                   str(tmp_path / "t"),
                                                   device="cpu")
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    _close(got, jr.retrieval_rank_stats_fixed_ref(*map(jnp.asarray, (
        q, qv, g, gv))), RANK)


# -- classification, id map, video-level average ---------------------------

@pytest.mark.parametrize("bad_label", [None, -1, 5])
def test_classification_stats_matches_jax(bad_label):
    """tests/test_metrics.py::test_classification_stats' inputs, plus ties
    in the scores and a label outside [0, C) (JAX's one_hot zero row)."""
    rng = np.random.RandomState(1701)
    n, c = 30, 5
    scores = rng.rand(n, c).astype(np.float32) + 0.01
    labels = rng.randint(0, c, size=(n,))
    scores[3] = scores[4]                # tied rows: the stable AP order
    scores[7, :2] = scores[7].max()      # a tied argmax: the first wins
    if bad_label is not None:
        labels[[0, 11]] = bad_label
    ref = jcls.classification_stats(jnp.asarray(scores), jnp.asarray(labels),
                                    num_classes=c)
    got = tcls.classification_stats(_t(scores), _t(labels), num_classes=c)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_id_to_class_map_matches_jax(tmp_path):
    """Unknown ids give class 0 (the reference's std::map default);
    from_csv skips comments and blank lines."""
    path = tmp_path / "ids.csv"
    path.write_text("# video_id,class_id\n30,3\n\n10,1\n20,2\n-4,9\n")
    jm = jr.IdToClassMap.from_csv(str(path))
    tm = tr.IdToClassMap.from_csv(str(path))
    q = np.array([[10, 20], [30, 99], [-4, 0]])
    got = tm.lookup(_t(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.lookup(
        jnp.asarray(q))))
    np.testing.assert_array_equal(tr.IdToClassMap([30, 10, 20], [3, 1, 2])
                                  .lookup([10, 20, 30, 99]).numpy(),
                                  [1, 2, 3, 0])


@pytest.mark.parametrize("num_videos", [3, 5, 2])
def test_video_level_average_matches_jax(num_videos):
    """Interleaved ids in first-occurrence order; 5 segments for 3 videos
    pad with zero features and int32-min ids; 2 drop the third video."""
    rng = np.random.RandomState(1701)
    feats = rng.randn(8, 5).astype(np.float32)
    vids = np.array([9, 3, 9, 3, 1, 9, 1, 3])
    jf, ju = jr.video_level_average(feats, vids, num_videos)
    tf, tu = tr.video_level_average(_t(feats), _t(vids), num_videos)
    assert tu.dtype == torch.int32 and tf.shape == (num_videos, 5)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-7)
    if num_videos == 5:
        assert (tu.numpy()[3:] == np.iinfo(np.int32).min).all()
        assert (tf.numpy()[3:] == 0).all()


def test_check_num_videos():
    tr.check_num_videos(np.array([5, 5, 7, 9]), 3)
    tr.check_num_videos(torch.tensor([5, 5, 7, 9]), 3)
    for bad in (2, 4):
        with pytest.raises(ValueError, match="distinct video ids"):
            tr.check_num_videos(np.array([5, 5, 7, 9]), bad)


# -- errors and devices ---------------------------------------------------

def test_id_range_and_unported_options_raise():
    feats, vids, cls = _gallery(n=40)
    big = vids.astype(np.int64) + 2**31
    with pytest.raises(ValueError, match="exceed int32 range"):
        tr.retrieval_stats_chunked(feats, big, cls, device="cpu")
    with pytest.raises(ValueError, match="class_ids exceed int32 range"):
        tr.retrieval_stats_report(feats, vids, -big, "unused.csv",
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tr.retrieval_stats_chunked(feats, vids, cls, method="search",
                                   device="cpu")
    # the mesh engines run since item 11 (tests/test_torch_parallel_
    # retrieval.py); shard_gallery without a mesh is JAX's ValueError
    with pytest.raises(ValueError, match="requires mesh"):
        tr.retrieval_stats_chunked(feats, vids, cls, device="cpu",
                                   shard_gallery=True)
    with pytest.raises(ValueError, match="requires mesh"):
        tr.retrieval_stats_report(feats, vids, cls, "unused.csv",
                                  device="cpu", shard_gallery=True)
    with pytest.raises(ValueError, match="unknown method"):
        tr.retrieval_stats_chunked(feats, vids, cls, method="fast",
                                   device="cpu")
    with pytest.raises(ValueError, match="report engines"):
        tr.retrieval_stats_report(feats, vids, cls, "unused.csv",
                                  method="search", device="cpu")


def test_gallery_functions_run_on_the_card_unless_asked(monkeypatch,
                                                        tmp_path):
    """The host-array entry points default to the card and raise without
    one; nothing goes on on the CPU in its place."""
    for fn in (tr.retrieval_stats_chunked, tr.retrieval_stats_report,
               tr.retrieval_rank_stats_report,
               tr.retrieval_rank_stats_fixed_ref_report):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats, vids, cls = _gallery(n=20)
    path = str(tmp_path / "r.csv")
    calls = [lambda **kw: tr.retrieval_stats_chunked(feats, vids, cls, **kw),
             lambda **kw: tr.retrieval_stats_report(feats, vids, cls, path,
                                                    **kw),
             lambda **kw: tr.retrieval_rank_stats_report(feats, feats, path,
                                                         **kw),
             lambda **kw: tr.retrieval_rank_stats_fixed_ref_report(
                 feats, vids, feats, vids, path, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
        call(device="cpu")


def test_metrics_package_exports_jax_names():
    from videovector_tpu import metrics as jmetrics
    names = {n for n in dir(jmetrics) if not n.startswith("_")
             and n not in ("retrieval", "classification")}
    assert names <= set(dir(tmetrics))
