"""Closed-loop retrieval queries of whole clips through
`RetrievalPipeline.query` with the I3D backbone (`backbone="i3d"`).

One client sends a query of one clip, `frames_per_query` consecutive
uint8 frames of a pool of `clip_pool` seeded clips on the device, with one
seeded crop offset pair and mirror flag for the whole clip, waits until
its top-k ids and scores are on the host, and sends the next; the gallery
is `gallery_rows` seeded unit rows with seeded ids. The weights and
BatchNorm's statistics are drawn from the seed (`make_params`); the
program serves them folded (`I3D.fold_batch_norm`, once, at set-up), the
reference reads them as drawn. After the window, a seeded sample of the
window's queries is served again through `query` (on the card a replay of
the graph the window replayed), and both answers of each, and the
features the second call left in the pipeline's `features` (the head's
1,024 a 2-frame window of the last map, 31 windows at 250 frames, whose
mean the tower reads), are checked against the plain f32 reference
(vvbench/reference/i3d.py): `pick_gap` as `serve_query.compare` defines
it, the worse of the two answers', and `feature_gap`, the worst relative
L2 gap of a window's features. A window, and not only the mean over the
clip's 31, is compared because bf16's gap is systematic (the same in each
window) where a fault's differs from window to window and partly averages
out of the mean.

Mix keys: those of `serve_query`, with `frames_per_query` the frames of
one clip (the configuration's `clip_frames`) and `clip_pool` counted in
clips.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vvbench.drivers import serve_googlenet
from vvbench.drivers.serve_query import (
    compare, make_clips, make_gallery, make_schedule,
)
from vvbench.flops_i3d import layers
from vvbench.harness import Outcome
from vvbench.reference import i3d as ref
from vvbench.trace import TracedWindow, span


def make_params(gen: torch.Generator, cfg: dict, device) -> dict:
    """The configuration's draws, on the device in two calls: gaussian
    conv weights at std sqrt(2 / fan_in) (DHWIO), BatchNorm's moving means
    gaussian, moving variances log-uniform, offsets gaussian about their
    mean; the tower (feature_dim, embed_dim) gaussian of tower_std with a
    gaussian bias of tower_bias_std."""
    w_cfg = cfg["weights"]
    shapes = [(name, (k, k, k, c_in, c_out))
              for name, k, _, c_in, c_out, _, _ in layers(cfg)[0]]
    sizes = [int(np.prod(s)) for _, s in shapes]
    n_out = sum(s[-1] for _, s in shapes)
    uni = torch.rand(n_out, generator=gen, device=device)
    d, e = cfg["feature_dim"], cfg["embed_dim"]
    nrm = torch.randn(sum(sizes) + 2 * n_out + d * e + e, generator=gen,
                      device=device)
    params: dict = {"i3d": {}}
    pos, opos = 0, 0
    for (name, shape), size in zip(shapes, sizes):
        o = shape[-1]
        fan_in = shape[0] * shape[1] * shape[2] * shape[3]
        w = nrm[pos:pos + size] * (2.0 / fan_in) ** 0.5
        pos += size
        params["i3d"][name] = {
            "w": w.view(shape),
            "moving_mean": nrm[pos:pos + o] * w_cfg["moving_mean_std"],
            "moving_variance": torch.exp(
                (uni[opos:opos + o] * 2 - 1)
                * w_cfg["moving_variance_log_range"]),
            "beta": w_cfg["beta_mean"] + nrm[pos + o:pos + 2 * o]
            * w_cfg["beta_std"]}
        pos, opos = pos + 2 * o, opos + o
    params["tower"] = {
        "w": (nrm[pos:pos + d * e] * w_cfg["tower_std"]).view(d, e),
        "b": nrm[pos + d * e:] * w_cfg["tower_bias_std"]}
    return params


def feature_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst, over clips and windows, of ||got - want|| / ||want||, a
    window's features (N, windows, D) a row."""
    return serve_googlenet.feature_gap(got.reshape(-1, got.shape[-1]),
                                       want.reshape(-1, want.shape[-1]))


def run(r) -> Outcome:
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    cfg, mix, dev = r.config, r.mix, r.device
    frames = mix["frames_per_query"]
    r.phase("imports")
    pipe = RetrievalPipeline(RetrievalPipelineConfig(
        image_hw=tuple(cfg["image_hw"]), crop=cfg["crop"],
        embed_dim=cfg["embed_dim"], top_k=cfg["top_k"],
        compute_dtype=cfg["compute_dtype"], backbone="i3d"), device=dev)
    r.phase("pipeline built")
    drawn = make_params(r.generator("weights"), cfg, dev)
    params = {"i3d": pipe.i3d.fold_batch_norm(drawn["i3d"]),
              "tower": drawn["tower"]}
    clips = make_clips(r.generator("clips"), mix["clip_pool"] * frames,
                       cfg["image_hw"], dev)
    gallery, gallery_ids = make_gallery(r.generator("gallery"),
                                        mix["gallery_rows"], cfg["embed_dim"],
                                        dev)
    # one crop and mirror a clip
    sched = make_schedule(np.random.default_rng(r.seed_for("schedule")),
                          mix["schedule_pool"], 1, mix["clip_pool"],
                          cfg["image_hw"], cfg["crop"], dev)
    r.sync()
    r.phase("inputs made")

    def inputs(i):
        j = i % mix["schedule_pool"]
        c = int(sched["clip"][j])
        return (clips[c * frames:(c + 1) * frames], sched["h"][j],
                sched["w"][j], sched["mirror"][j])

    def query(i):
        return pipe.query(params, *inputs(i), gallery, gallery_ids)

    for i in range(mix["warmup_queries"]):
        query(i)[0].cpu()
    r.sync()

    served, latency = [], []
    r.window_starts()
    t_start = time.perf_counter()
    deadline = t_start + r.seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        ids, scores = query(i)
        ids, scores = ids.cpu(), scores.cpu()
        t1 = time.perf_counter()
        served.append((ids, scores))
        latency.append(t1 - t0)
        i += 1
        if t1 >= deadline:
            break
    wall = t1 - t_start
    n = len(served)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    trace, enqueue = None, []
    if r.trace:
        tw = TracedWindow(dev)
        tw.start()
        for k in range(mix["traced_queries"]):
            t0 = time.perf_counter()
            with span("query"):
                ids, scores = query(n + k)
            enqueue.append(time.perf_counter() - t0)
            with span("fetch"):
                ids.cpu(), scores.cpu()
        trace = tw.stop({"queries": mix["traced_queries"]})

    # the check, once the window has closed: a seeded sample of the window's
    # queries, the last one among them, served again for their features,
    # through the plain reference
    rng = np.random.default_rng(r.seed_for("check"))
    sample = sorted(set(rng.choice(n, size=min(n, mix["check_queries"]) - 1,
                                   replace=False).tolist()) | {n - 1})
    again = []
    for i in sample:
        ids, scores = query(i)
        again.append((ids, scores, pipe.features.clone()))
    del pipe
    row_of_id = torch.full((gallery.shape[0],), -1, dtype=torch.long,
                           device=dev)
    row_of_id[gallery_ids.long()] = torch.arange(gallery.shape[0], device=dev)
    worst = {"pick_gap": 0.0, "feature_gap": 0.0}
    control = dict(worst)
    for i, (ids, scores, got) in zip(sample, again):
        args = (drawn, *inputs(i), cfg)
        feats: list = []
        s = ref.scores(ref.embed(*args, feats_out=feats), gallery)
        nums = {"pick_gap": max(
            compare(*served[i], s, row_of_id, cfg["top_k"])["pick_gap"],
            compare(ids, scores, s, row_of_id, cfg["top_k"])["pick_gap"]),
            "feature_gap": feature_gap(got, feats[0])}
        worst = {k: max(worst[k], v) for k, v in nums.items()}
        if r.control:
            # the control: the reference with fp8 operands in the program's
            # place, served as the pipeline serves
            q_feats: list = []
            vals, idx = ref.top_k(ref.scores(ref.embed(
                *args, quant="fp8", feats_out=q_feats), gallery),
                cfg["top_k"])
            nums = compare(gallery_ids[idx], vals, s, row_of_id,
                           cfg["top_k"])
            nums["feature_gap"] = feature_gap(q_feats[0], feats[0])
            control = {k: max(control[k], v) for k, v in nums.items()}
        del s
    r.readings = {"fp8": control}
    lim = r.limits
    return Outcome(
        end_to_end={"query_frames_per_s": n * frames / wall,
                    "query_p95_ms": float(np.percentile(latency, 95)) * 1e3},
        attempted=n, failed=0, memory_peak_bytes=peak,
        checks={k: (v, lim[k]) for k, v in worst.items()},
        trace=trace,
        layer={"enqueue_ms": float(np.mean(enqueue)) * 1e3 if enqueue
               else None, "gallery_rows": mix["gallery_rows"],
               "frames_per_query": frames, "clips_per_query": 1},
        window={"queries": n, "wall_s": wall, "frames": n * frames})
