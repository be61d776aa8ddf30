"""The port's spans and counters (videovector_tpu_torch/utils/timer.py) on
the CPU: nothing is recorded and no profiler range entered while no
profiler records; under torch.profiler a query of a small pipeline and a
few training steps on every path of the loop give every span with its
parent and request id, on the profiler's clock and among its events; a
second profiled stretch starts with an empty table; `vvtpu.cast_bytes`
counts the serving path's weight casts; an exported program holds no
profiler node. The kernels' `.launch` spans run only on the card
(tests/test_torch_cuda_kernels.py)."""

import itertools
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videovector_tpu_torch.models import embedding as temb
from videovector_tpu_torch.models import mednet as tmed
from videovector_tpu_torch.models import retrieval_pipeline as trp
from videovector_tpu_torch.ops.hopper import conv_gemm
from videovector_tpu_torch.solver import solvers as tsol
from videovector_tpu_torch.solver import train as ttrain
from videovector_tpu_torch.utils import timer

torch.set_num_threads(1)

QUERY_CHILDREN = ("vvtpu.query.transform", "vvtpu.query.mednet",
                  "vvtpu.query.tower", "vvtpu.query.scores",
                  "vvtpu.query.topk")


def _pipeline(compute_dtype="bfloat16"):
    """A small CaffeNet-shaped pipeline on the CPU: two convs (the second
    grouped), fc6, fc7 and the tower."""
    p = trp.RetrievalPipeline(trp.RetrievalPipelineConfig(
        image_hw=(36, 36), crop=32, embed_dim=16, top_k=3,
        compute_dtype=compute_dtype), device="cpu")
    p.mednet = tmed.MedNet(tmed.MedNetConfig(
        convs=(tmed.ConvSpec("conv1", 8, 5, stride=2, pool=True, lrn=True),
               tmed.ConvSpec("conv2", 8, 3, pad=1, group=2)),
        fc6=32, fc7=64, input_hw=(32, 32), compute_dtype=compute_dtype))
    p.embedder = temb.VideoEmbeddingModel(temb.VideoEmbeddingConfig(
        feature_dim=64, embed_dim=16, dropout_rate=0.0,
        compute_dtype=compute_dtype))
    gen = torch.Generator().manual_seed(0)
    params = {"mednet": p.mednet.init(gen),
              "tower": p.embedder.init(gen)["tower"]}
    return p, params


def _query(pipe, params, n=3):
    g = torch.Generator().manual_seed(1)
    pix = torch.randint(0, 256, (n, 36, 36, 3), generator=g,
                        dtype=torch.uint8)
    off = torch.randint(0, 5, (2, n), generator=g)
    mirror = torch.randint(0, 2, (n,), generator=g) > 0
    gallery = torch.nn.functional.normalize(torch.randn(20, 16, generator=g),
                                            dim=1)
    return pipe.query(params, pix, off[0], off[1], mirror, gallery,
                      torch.arange(20, dtype=torch.int32))


def _weights(params) -> int:
    return sum(leaf["w"].numel() for group in (params["mednet"],
                                               {"tower": params["tower"]})
               for leaf in group.values())


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _unprofiled_span_first():
    """Each test starts as a program's profiled stretch does, after a span
    that found no profiler on: the table's next stretch starts afresh."""
    with timer.span("vvtpu.between"):
        pass


def _by_name(spans):
    out = defaultdict(list)
    for i, s in enumerate(spans):
        out[s.name].append(i)
    return out


def test_without_a_profiler_nothing_is_recorded_or_entered(monkeypatch):
    """The ranges a span could enter (timer._Range, record_function)
    raise if entered: with no profiler, queries and training steps run."""
    pipe, params = _pipeline()
    with _cpu_profile():
        with timer.span("vvtpu.mark"):
            timer.count("vvtpu.marks", 1)
    before = timer.recorded()

    def boom(*a, **k):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(timer, "_Range", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with timer.span("vvtpu.off", req=5):
        timer.count("vvtpu.off", 3)
    assert timer.span("vvtpu.off") is timer.span("vvtpu.other")  # shared
    _query(pipe, params)
    _train(*_toy(), max_iter=2)
    after = timer.recorded()
    assert after == before
    assert [s.name for s in after.spans] == ["vvtpu.mark"]
    assert after.counters == {"vvtpu.marks": 1}


def test_query_spans_nest_under_the_query_with_its_request_id():
    pipe, params = _pipeline()
    _query(pipe, params)                          # not profiled
    with _cpu_profile() as prof:
        _query(pipe, params)
    rec = timer.recorded()
    spans, idx = rec.spans, _by_name(rec.spans)
    (top,) = idx["vvtpu.query"]
    assert spans[top].parent is None and spans[top].req == 2 == pipe.queries
    for name in QUERY_CHILDREN:
        (i,) = idx[name]
        assert spans[i].parent == top
    parent_of = {i: spans[spans[i].parent].name for n in ("vvtpu.k1",
                                                          "vvtpu.k2")
                 for i in idx[n]}
    assert sorted(parent_of.values()) == sorted(
        ["vvtpu.query.mednet"] * 4 + ["vvtpu.query.tower"])
    assert all(s.req == 2 and s.start_ns <= s.end_ns for s in spans)
    names = {e.name for e in prof.events()}
    assert {"vvtpu.query", *QUERY_CHILDREN, "vvtpu.k1",
            "vvtpu.k2"} <= names


def test_space_to_depth_is_a_span_of_its_own():
    x, w = torch.randn(1, 19, 19, 3), torch.randn(11, 11, 3, 4)
    with _cpu_profile() as prof:
        xs, _ = conv_gemm.space_to_depth(x, w, 4)
    assert xs.shape == (1, 5, 5, 48)
    assert [s.name for s in timer.recorded().spans] == ["vvtpu.s2d"]
    assert "vvtpu.s2d" in {e.name for e in prof.events()}


def test_spans_share_the_profilers_clock():
    """Each span's start within 0.1 ms of its profiler event's, both in
    Unix-epoch ns: trace_start_ns() plus the event's offset (us)."""
    pipe, params = _pipeline()
    with _cpu_profile() as prof:
        with timer.span("vvtpu.warmup"):
            pass
        _query(pipe, params)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = defaultdict(list)
    for e in prof.events():
        if e.name.startswith("vvtpu."):
            events[e.name].append(t0 + e.time_range.start * 1e3)
    spans = defaultdict(list)
    for s in timer.recorded().spans[1:]:
        spans[s.name].append(s.start_ns)
    assert len(spans) == 8
    for name, starts in spans.items():
        got = sorted(events[name])
        assert len(got) == len(starts), name
        for a, b in zip(sorted(starts), got):
            assert abs(a - b) < 1e5, (name, a - b)


def test_a_second_profiled_stretch_starts_with_an_empty_table():
    pipe, params = _pipeline()
    with _cpu_profile():
        _query(pipe, params)
    first = timer.recorded()
    assert first.spans and first.counters
    _query(pipe, params)                          # between the stretches
    with _cpu_profile():
        with timer.span("vvtpu.second"):
            timer.count("vvtpu.second", 2)
    second = timer.recorded()
    assert [s.name for s in second.spans] == ["vvtpu.second"]
    assert second.spans[0].parent is None
    assert second.counters == {"vvtpu.second": 2}


@pytest.mark.parametrize("dtype,bytes_per_weight", [("bfloat16", 2),
                                                    ("float32", 0)])
def test_cast_bytes_count_the_weights_cast_to_the_compute_dtype(
        dtype, bytes_per_weight):
    pipe, params = _pipeline(dtype)
    with _cpu_profile():
        _query(pipe, params)
    got = timer.recorded().counters.get("vvtpu.cast_bytes", 0)
    assert got == bytes_per_weight * _weights(params)


def test_an_exported_program_holds_no_profiler_node():
    from videovector_tpu_torch.tools.export_model import export
    pipe, params = _pipeline()

    def embed(x):
        fc7 = pipe.mednet.forward(params["mednet"], x)
        return pipe.embedder.embed({"tower": params["tower"]}, fc7)
    program = export(embed, (torch.randn(2, 32, 32, 3),))
    targets = [str(n.target) for n in program.graph.nodes]
    assert any("matmul" in t or "mm" in t for t in targets), targets
    assert not [t for t in targets if "profiler" in t
                or "record_function" in t]


# -- the training loop -----------------------------------------------------

def _toy():
    """A linear model's squared output, and its test eval."""
    params = {"fc": {"w": torch.randn(4, 3, generator=torch.Generator()
                                      .manual_seed(0)),
                     "b": torch.zeros(3)}}

    def loss_fn(p, batch, generator):
        y = batch["data"] @ p["fc"]["w"] + p["fc"]["b"]
        return (y * y).mean(), {}

    def eval_fn(p, batch):
        return {"out": (batch["data"] @ p["fc"]["w"]).mean().reshape(1)}
    g = torch.Generator().manual_seed(1)
    batches = [{"data": torch.randn(4, 4, generator=g)} for _ in range(3)]
    return params, loss_fn, eval_fn, batches


def _train(params, loss_fn, eval_fn, batches, *, max_iter=3, hooks=None,
           prefix="", fused_accum=True, **kw):
    cfg = tsol.SolverConfig(base_lr=0.1, momentum=0.9, max_iter=max_iter,
                            display=1, test_interval=2, test_iter=(1,),
                            snapshot=2 if prefix else 0,
                            snapshot_prefix=prefix, **kw)
    return ttrain.train(loss_fn, params, itertools.cycle(batches), cfg,
                        device="cpu", eval_fn=eval_fn,
                        test_data=itertools.cycle(batches[:1]),
                        hooks=hooks or [], batch_axes={"data": 0},
                        fused_accum=fused_accum)


PATHS = {"plain": ({}, True), "host_accumulation": ({"iter_size": 2}, False),
         "fused": ({"iter_size": 2}, True)}


@pytest.mark.parametrize("path", list(PATHS))
def test_train_spans_on_every_path_of_the_loop(tmp_path, path):
    kw, fused = PATHS[path]
    seen = []
    with _cpu_profile() as prof:
        _train(*_toy(), prefix=str(tmp_path / "snap"),
               hooks=[(1, lambda p, it: seen.append(it))], fused_accum=fused,
               **kw)
    assert seen == [0, 1, 2]
    rec = timer.recorded()
    spans, idx = rec.spans, _by_name(rec.spans)
    steps = idx["vvtpu.train.step"]
    assert [spans[i].req for i in steps] == [0, 1, 2]
    assert all(spans[i].parent is None for i in steps)
    n_grads = kw.get("iter_size", 1)
    for child in ("forward", "backward", "update"):
        found = idx[f"vvtpu.train.step.{child}"]
        want = n_grads if child != "update" else 1
        assert len(found) == 3 * want, child
        for i in found:
            assert spans[spans[i].parent].name == "vvtpu.train.step"
            assert spans[i].req == spans[spans[i].parent].req
    feeds = idx["vvtpu.train.feed"]
    if path == "host_accumulation":
        assert len(feeds) == 6
        assert {spans[spans[i].parent].name for i in feeds} == {
            "vvtpu.train.step"}
    else:
        assert len(feeds) == 3 * (2 if path == "fused" else 1)
        assert all(spans[i].parent is None for i in feeds)
    # tests at 0 and 2 (and the final one at 3 is not due: 3 % 2), a
    # snapshot at 2 and after training, a display and the hooks each step
    assert len(idx["vvtpu.train.test"]) == 2
    assert len(idx["vvtpu.train.snapshot"]) == 2
    assert len(idx["vvtpu.train.display"]) == 3
    assert len(idx["vvtpu.train.hooks"]) == 3
    names = {e.name for e in prof.events()}
    assert set(idx) <= names


def test_tally_collects_counts_with_or_without_a_profiler():
    """`tally` collects what `count` adds in its block, profiled or not;
    a tally inside it takes its own block's counts; the profiled table
    gets its counts as before, and nothing while no profiler records."""
    before = timer.recorded()
    with timer.tally() as outer:
        timer.count("vvtpu.a", 2)
        with timer.tally() as inner:
            timer.count("vvtpu.a", 3)
        timer.count("vvtpu.b", 1)
    timer.count("vvtpu.a", 5)
    assert outer == {"vvtpu.a": 2, "vvtpu.b": 1}
    assert inner == {"vvtpu.a": 3}
    assert timer.recorded() == before
    with _cpu_profile(), timer.tally() as profiled:
        with timer.span("vvtpu.mark"):
            timer.count("vvtpu.a", 4)
    assert profiled == {"vvtpu.a": 4}
    assert timer.recorded().counters == {"vvtpu.a": 4}
