"""Closed-loop retrieval queries through `RetrievalPipeline.query` with the
GoogLeNet backbone (`backbone="googlenet"`).

As `serve_query`: one client sends a query of `frames_per_query` uint8
frames of one clip from a pool of seeded clips on the device, each frame
with its own seeded crop offsets and mirror flag, waits until its top-k
ids and scores are on the host, and sends the next; the gallery is
`gallery_rows` seeded unit rows with seeded ids. The weights are drawn at
BVLC's fillers (`make_params`). After the window, a seeded sample of the
window's queries is served again through `query` (on the card a replay
of the graph the window replayed), and both answers of each, and the
pool5 features the second call left in the pipeline's `features`, are
checked against the plain f32 reference (vvbench/reference/googlenet.py):
`pick_gap` as `serve_query.compare` defines it, the worse of the two
answers', and `feature_gap`, the worst relative L2 gap of a frame's pool5
features.

Mix keys: those of `serve_query`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vvbench.drivers.serve_query import (
    compare, make_clips, make_gallery, make_schedule,
)
from vvbench.flops_googlenet import conv_layers
from vvbench.harness import Outcome
from vvbench.reference import googlenet as ref
from vvbench.trace import TracedWindow, span


def make_params(gen: torch.Generator, cfg: dict, device) -> dict:
    """BVLC's fillers, drawn on the device in two calls: xavier conv
    weights (uniform within sqrt(3 / fan_in), fan_in = k k C_in), biases
    bias_mean plus a gaussian of bias_std; the tower (feature_dim,
    embed_dim) gaussian of tower_std with a gaussian bias of
    tower_bias_std."""
    w_cfg = cfg["weights"]
    shapes = [(name, (k, k, c_in, c_out))
              for name, k, _, _, c_in, c_out, _ in conv_layers(cfg)]
    sizes = [int(np.prod(s)) for _, s in shapes]
    uni = torch.rand(sum(sizes), generator=gen, device=device)
    n_bias = sum(s[-1] for _, s in shapes)
    d, e = cfg["feature_dim"], cfg["embed_dim"]
    nrm = torch.randn(n_bias + d * e + e, generator=gen, device=device)
    params: dict = {"googlenet": {}}
    pos = bpos = 0
    for (name, shape), size in zip(shapes, sizes):
        scale = (3.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
        o = shape[-1]
        params["googlenet"][name] = {
            "w": ((uni[pos:pos + size] * 2 - 1) * scale).view(shape),
            "b": w_cfg["bias_mean"] + nrm[bpos:bpos + o] * w_cfg["bias_std"]}
        pos, bpos = pos + size, bpos + o
    params["tower"] = {
        "w": (nrm[bpos:bpos + d * e] * w_cfg["tower_std"]).view(d, e),
        "b": nrm[bpos + d * e:] * w_cfg["tower_bias_std"]}
    return params


def feature_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst, over frames, of ||got - want|| / ||want|| (rows)."""
    num = torch.linalg.vector_norm(got.float() - want, dim=1)
    den = torch.linalg.vector_norm(want, dim=1).clamp(min=1e-30)
    return float((num / den).max())


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
        compute_dtype=cfg["compute_dtype"], backbone="googlenet"),
        device=dev)
    r.phase("pipeline built")
    params = make_params(r.generator("weights"), cfg, dev)
    clips = make_clips(r.generator("clips"), mix["clip_pool"] * frames,
                       cfg["image_hw"], dev)
    gallery, gallery_ids = make_gallery(r.generator("gallery"),
                                        mix["gallery_rows"], cfg["embed_dim"],
                                        dev)
    sched = make_schedule(np.random.default_rng(r.seed_for("schedule")),
                          mix["schedule_pool"], frames, mix["clip_pool"],
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
        args = (params, *inputs(i), cfg)
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
               "frames_per_query": frames},
        window={"queries": n, "wall_s": wall, "frames": n * frames})
