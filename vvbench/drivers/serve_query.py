"""Closed-loop retrieval queries through `RetrievalPipeline.query`.

One client sends a query, waits until its top-k ids and scores are on the
host, and sends the next. A query is `frames_per_query` uint8 frames of one
clip from a pool of seeded clips held on the device, each frame with its
own seeded crop offsets and mirror flag; the gallery is `gallery_rows`
seeded unit rows on the device with seeded ids. Every seed gets the same
sizes; only the contents and the order differ.

Mix keys: frames_per_query, clip_pool, gallery_rows, schedule_pool (the
queries drawn at set-up, sent in turn), warmup_queries, traced_queries,
check_queries (queries of the window compared with the reference).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from vvbench.flops import caffenet_fc_shapes
from vvbench.harness import Outcome
from vvbench.reference import caffenet as ref
from vvbench.trace import TracedWindow, span


def make_params(gen: torch.Generator, cfg: dict, device) -> dict:
    """Gaussian weights (BVLC's fillers' standard deviations, from the
    configuration) and small gaussian biases, drawn on the device in one
    call and cut into the program's layouts: HWIO convs, (in, out) fcs,
    fc6's rows in (H, W, C) order."""
    w_std = cfg["weights"]
    shapes, c_in = [], 3
    for spec in cfg["convs"]:
        k, o, g = spec["kernel"], spec["num_output"], spec["group"]
        shapes.append(("mednet", spec["name"], (k, k, c_in // g, o),
                       w_std["conv_std"]))
        c_in = o
    fcs = caffenet_fc_shapes(cfg)
    for name, (k, n) in zip(("fc6", "fc7"), fcs):
        shapes.append(("mednet", name, (k, n), w_std["fc_std"]))
    shapes.append(("tower", None, fcs[2], w_std["tower_std"]))
    sizes = [int(np.prod(s)) + s[-1] for _, _, s, _ in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    params: dict = {"mednet": {}}
    pos = 0
    for (group, name, shape, std), size in zip(shapes, sizes):
        n_w = size - shape[-1]
        leaf = {"w": (flat[pos:pos + n_w] * std).view(shape),
                "b": flat[pos + n_w:pos + size] * w_std["bias_std"]}
        pos += size
        if name is None:
            params[group] = leaf
        else:
            params[group][name] = leaf
    return params


def make_clips(gen: torch.Generator, n_frames: int, image_hw, device,
               chunk: int = 256) -> torch.Tensor:
    """(n_frames, H, W, 3) uint8: seeded 32 x 32 colour noise, scaled up
    bilinearly, so that frames have smooth structure as pictures do."""
    h, w = image_hw
    out = torch.empty((n_frames, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n_frames, chunk):
        n = min(chunk, n_frames - s)
        low = torch.rand((n, 3, 32, 32), generator=gen, device=device) * 255
        big = F.interpolate(low, size=(h, w), mode="bilinear",
                            align_corners=False)
        out[s:s + n] = big.round().clamp(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1)
    return out


def make_gallery(gen: torch.Generator, rows: int, dim: int, device,
                 chunk: int = 250_000):
    """(rows, dim) f32 unit rows and (rows,) int32 ids (a seeded
    permutation of 0..rows-1)."""
    g = torch.randn((rows, dim), generator=gen, device=device)
    for s in range(0, rows, chunk):
        g[s:s + chunk] /= torch.linalg.vector_norm(g[s:s + chunk], dim=1,
                                                   keepdim=True)
    ids = torch.randperm(rows, generator=gen, device=device).to(torch.int32)
    return g, ids


def make_schedule(rng: np.random.Generator, n: int, frames: int, clips: int,
                  image_hw, crop: int, device) -> dict:
    return {"clip": rng.integers(0, clips, n),
            "h": torch.as_tensor(rng.integers(0, image_hw[0] - crop + 1,
                                              (n, frames)), device=device),
            "w": torch.as_tensor(rng.integers(0, image_hw[1] - crop + 1,
                                              (n, frames)), device=device),
            "mirror": torch.as_tensor(rng.integers(0, 2, (n, frames)) > 0,
                                      device=device)}


def compare(ids: torch.Tensor, scores: torch.Tensor, ref_scores: torch.Tensor,
            row_of_id: torch.Tensor, k: int) -> dict:
    """The served (ids, scores) of one query against the reference's f32
    scores (N, G): `pick_gap`, over every served pick, the widest sum of
    the gap between its served score and the reference's score of the same
    gallery row and the gap by which that reference score lies below the
    reference's score at the pick's rank. A served id that is no gallery
    row, or twice among a row's picks, reads inf."""
    g = ref_scores.shape[1]
    ids = ids.to(ref_scores.device).long()
    if ids.shape != (ref_scores.shape[0], k) or bool(
            ((ids < 0) | (ids >= g)).any()):
        return {"pick_gap": float("inf")}
    rows = row_of_id[ids]
    if bool((rows < 0).any()) or any(len(set(r)) != k for r in rows.tolist()):
        return {"pick_gap": float("inf")}
    at = torch.gather(ref_scores, 1, rows)
    best, _ = ref.top_k(ref_scores, k)
    gap = (scores.to(at.device) - at).abs() + torch.clamp(best - at, min=0.0)
    return {"pick_gap": float(gap.max())}


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
        compute_dtype=cfg["compute_dtype"]), device=dev)
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

    def query(i):
        j = i % mix["schedule_pool"]
        c = int(sched["clip"][j])
        return pipe.query(params, clips[c * frames:(c + 1) * frames],
                          sched["h"][j], sched["w"][j], sched["mirror"][j],
                          gallery, gallery_ids)

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
    # queries, the last one among them, through the plain reference
    del pipe
    rng = np.random.default_rng(r.seed_for("check"))
    sample = sorted(set(rng.choice(n, size=min(n, mix["check_queries"]) - 1,
                                   replace=False).tolist()) | {n - 1})
    row_of_id = torch.full((gallery.shape[0],), -1, dtype=torch.long,
                           device=dev)
    row_of_id[gallery_ids.long()] = torch.arange(gallery.shape[0], device=dev)
    worst = {"pick_gap": 0.0}
    control = dict(worst)
    for i in sample:
        j = i % mix["schedule_pool"]
        c = int(sched["clip"][j])
        args = (params, clips[c * frames:(c + 1) * frames], sched["h"][j],
                sched["w"][j], sched["mirror"][j], cfg)
        s = ref.scores(ref.embed(*args), gallery)
        got = compare(*served[i], s, row_of_id, cfg["top_k"])
        worst = {k: max(worst[k], v) for k, v in got.items()}
        if r.control:
            # the control: the reference with fp8 operands in the program's
            # place, served as the pipeline serves
            vals, idx = ref.top_k(ref.scores(ref.embed(*args, quant="fp8"),
                                             gallery), cfg["top_k"])
            got = compare(gallery_ids[idx], vals, s, row_of_id, cfg["top_k"])
            control = {k: max(control[k], v) for k, v in got.items()}
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
