#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videovector_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It
1. builds the Hopper kernels from videovector_tpu_torch/csrc with nvcc;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at the JAX package's kernel-test
   shapes (tolerances below), and times both kernels' sm90 routes by
   CUDA-graph replay beside their bounds (computed from the shapes and the
   H100's published peaks) and, as yardsticks that are never on the path,
   one PyTorch call computing the same function: K1 at fc6, fc7 and the
   tower (batch 50 and 256) and at the training tower (1920 rows, for
   information) against its plain version and torch.matmul (cuBLAS); K2 at
   CaffeNet's five convs (batch 50 and 256) against its plain version, its
   core route and F.conv2d (cuDNN), checking that two runs give the same
   bits;
3. drives RetrievalPipeline at full width (the default config: 256x256 uint8
   frames, 227 crop, CaffeNet conv1..fc7, 4096-d tower, bf16) with random
   weights from a seeded torch.Generator: a 4-video gallery padded to 20,000
   rows, then 3 queries of 50 frames, counting kernel launches (every K1
   and K2 launch must take its sm90 route);
4. compares embed_frames through the kernels with the plain versions, and
   times both at batch 50 and 256 with CUDA events, then profiles a window
   of calls (device time by kernel, idle share, no cuBLAS or cuDNN GEMM or
   conv on the path);
5. drives the training slice through solver.train.train at bench.py's
   width (B = 128 windows of 15 roles, D = E = 4096, bf16 tower, SGD with
   momentum, weight decay and the inv policy, dropout 0.9): 3 steps with K1
   against 3 with the plain tower (dropout off), then the counted main path
   (one K1 launch per step, all sm90), timed with CUDA events and profiled
   (idle share, top kernels, no library GEMM on the tower forward), two
   remat_tower steps, the weight-gradient product's time, and the B = 1024
   (gm 1 and 8) and B = 8192 (gm 64) points;
6. runs the flagship's test-interval eval through train (B = 128, 10 steps,
   test_interval 5): extract on (673, 4, 4096) test batches (one sm90 K1
   launch each, held against the plain tower), then the dense
   retrieval_stats with class = video id, its Test net output lines
   checked, one eval timed and split into K1 and retrieval_stats; then the
   gallery-scale eval: retrieval_stats_chunked at 20,000 x 4096 with the
   count and the sort engine (equal results, timed, the faster profiled, a
   4,096-row subsample against the CPU), the same in bf16, the csv report
   at 20,000 rows, and one pass at 100,000 x 4096;
7. trains the flagship from its host plane (host_fed_training): the port's
   writers make a 640-video x 12-shot training store and a 673-window test
   store at 4096 dims; the port parses the repo's solver prototxt and
   generate_net.py's net, builds the sampler (WINDOW, 10 negatives from a
   5,000-shot reservoir) and the test source from the stores as the JAX
   package's data factory does, and train runs 31 steps (test every 10),
   snapshots, resumes and runs 5 more: K1 launches one per step and per
   test batch, all sm90; then the host-fed step, the sampler, the H2D copy
   and the test batch's assembly are timed beside the device-resident step.

Exits non-zero, with no result line, without a CUDA card or outside a
checkout. The last line of stdout is {"ok": true, "device": {...}}; the line
before it is the per-kernel JSON summary.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# max |kernel - plain| allowed, relative to max |plain|, by output dtype: f32
# outputs differ only by summation order; a bf16 output can differ by one
# rounding step (2**-8 relative) where the f32 sums straddle a bf16 boundary
REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
BATCH = 50
GALLERY_ROWS = 20_000
N_QUERIES = 3
K1_PER_EMBED = 3          # fc6, fc7, tower
K2_PER_EMBED = 5          # conv1..conv5, one sm90 launch each
# CaffeNet's convs: name, input hw, C, O, kernel, stride, pad, groups
CAFFENET_CONVS = (("conv1", 227, 3, 96, 11, 4, 0, 1),
                  ("conv2", 27, 96, 256, 5, 1, 2, 2),
                  ("conv3", 13, 256, 384, 3, 1, 1, 1),
                  ("conv4", 13, 384, 384, 3, 1, 1, 2),
                  ("conv5", 13, 384, 256, 3, 1, 1, 2))
# the H100 SXM's published peaks (dense bf16 tensor cores, HBM3)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# (rows, name, K, N) of K1's calls: the serving path's at batch 50 and 256
# (bias + ReLU epilogue), and the training tower's (bench.py's B = 128 x 15
# roles; bias epilogue only, the ReLU runs after it)
K1_FC = (("fc6", 9216, 4096), ("fc7", 4096, 4096), ("tower", 4096, 4096))
TRAIN_TOWER = "train tower"
TEST_TOWER = "test tower"
# the flagship's test eval (projects/videovec_embedding/generate_net.py's
# TEST branch): batches of 673 windows of 4 raw context frames, video ids
# over about 100 videos, class = video id
TEST_BATCH = 673
TEST_FRAMES = 4
TEST_VIDEOS = 100
K1_CASES = tuple((m, *fc) for m in (BATCH, 256) for fc in K1_FC) + \
    ((1920, TRAIN_TOWER, 4096, 4096), (TEST_BATCH, TEST_TOWER, 4096, 4096))
# K1 calls timed apart from the serving path's sums: their stats keys
K1_APART = {TRAIN_TOWER: "K1 train", TEST_TOWER: "K1 test"}
# the retrieval eval's gallery cells (f32 rows x 4096; GALLERY_ROWS also in
# bf16 and through the csv report)
BIG_GALLERY_ROWS = 100_000
# the training slice's workload, bench.py's: B = 128 windows of 15 roles
# (target, 4 context, 10 negatives), D = E = 4096, bf16 tower, SGD with
# momentum 0.9, weight decay 5e-4 and the inv lr policy
TRAIN_BATCH = 128
TRAIN_NEG = 10
# 5 warm-up steps, 20 timed, 5 profiled and the one that closes the window
TRAIN_MAIN_STEPS = 31
TRAIN_SOLVER = dict(base_lr=0.001, momentum=0.9, weight_decay=5e-4,
                    lr_policy="inv", gamma=0.001, power=0.75)
# the flagship's host plane (projects/videovec_embedding): a training store
# like make_synthetic_data.py's at 640 videos x 12 shots (7,680 distinct
# shots: the flagship's reservoir holds 5,000) and a test store of 673
# windows x 4 context shots over 100 videos, 4096 dims; the repo's solver
# prototxt and generate_net.py's net, parsed by the port
HOST_VIDEOS = 640
HOST_SHOTS = 12
HOST_DIM = 4096
SOLVER_PROTOTXT = ROOT / "projects/videovec_embedding/mednet_embedding_train_solver.prototxt"
GENERATE_NET = ROOT / "projects/videovec_embedding/generate_net.py"
# 31 steps (tests at 0, 10, 20, 30), a snapshot at the end, then 5 resumed
HOST_STEPS = 31
HOST_INTERVAL = 10
HOST_RESUMED = 5
# steps timed (their tests excluded) and steps profiled, in the first run
HOST_TIMED = range(1, 21)
HOST_PROFILED = range(21, 26)
# K1's timings cycle through copies of w that together exceed the H100's
# 50 MB L2 by this factor, so that each call reads its weights from HBM as
# it does on the path (fc6, fc7 and the tower evict each other there)
L2_BYTES = 50 * 2**20
L2_EXCESS = 2.5


def log(*args) -> None:
    print(*args, flush=True)


def gpu_name_and_power_limit() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, args: list, iters: int = 10) -> float:
    """Mean device time of one fn(a) in ms: a CUDA graph holds one call for
    each a in `args` and is replayed `iters` times, so the host's cost of a
    call (measured apart) stays out of the number."""
    for a in args:
        fn(a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in args:
            fn(a)
    return time_ms(graph.replay, iters=iters, warmup=2) / len(args)


def conv_bound_ms(n, hw, c, o, k, s, p, g) -> tuple[float, str]:
    """The least time the card could take for one bf16 conv with bias
    (NHWC in, bf16 out): the larger of its bytes (input, weights, bias and
    output, each once) over HBM bandwidth and its FLOPs over the bf16 peak.
    """
    ohw = (hw + 2 * p - k) // s + 1
    m = n * ohw * ohw
    flops = 2 * m * k * k * (c // g) * o
    nbytes = n * hw * hw * c * 2 + k * k * (c // g) * o * 2 + o * 4 + m * o * 2
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error of got vs ref; raises past the dtype's tolerance."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    tol = REL_TOL[ref.dtype] * scale
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}, max|ref| {scale:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {tol}")
    return err


def kernel_phases(dev, gen):
    from videovector_tpu_torch.ops.hopper import conv_gemm as k2
    from videovector_tpu_torch.ops.hopper import matmul as k1

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "library_ms": 0.0} for k in ("K1", "K2")}
    bf = torch.bfloat16

    log("K1 at the JAX kernel-test shapes (f32):")
    for (m, k, n), bias, relu in (((256, 512, 256), False, False),
                                  ((128, 256, 128), True, True),
                                  ((100, 300, 70), False, False)):
        x, w = randn(m, k), randn(k, n)
        b = randn(n) if bias else None
        err = compare(f"K1 {m}x{k}x{n} bias={bias} relu={relu}",
                      k1.matmul(x, w, b, fuse_relu=relu),
                      k1.matmul_plain(x, w, b, fuse_relu=relu))
        stats["K1"]["err"] = max(stats["K1"]["err"], err)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("K1 sm90 route at the serving path's shapes (bias + ReLU) and the "
        "training tower's (bias only) (bf16 -> f32; device time per call "
        "from CUDA graphs over copies of w beyond L2; cuBLAS = torch.matmul "
        "on the same bf16 operands, a yardstick only):")
    for m, name, k, n in K1_CASES:
        x, b = randn(m, k, dtype=bf), randn(n)
        relu = name != TRAIN_TOWER
        ws = [randn(k, n, dtype=bf, std=0.02)
              for _ in range(max(2, math.ceil(L2_EXCESS * L2_BYTES / (k * n * 2))))]
        if k1.k1_route(x, ws[0], torch.float32) != "sm90":
            raise AssertionError(f"K1 {name}: not on the sm90 route")
        run = lambda w: k1.matmul(x, w, b, fuse_relu=relu)
        plain = lambda w: k1.matmul_plain(x, w, b, fuse_relu=relu)
        cublas = lambda w: torch.matmul(x, w)
        before = k1.matmul.launches_sm90
        err = compare(f"K1 {name} {m}x{k}x{n}", run(ws[0]), plain(ws[0]))
        if k1.matmul.launches_sm90 != before + 1:
            raise AssertionError(f"K1 {name}: the sm90 route did not launch")
        if m == BATCH and name == "fc6":
            got = [k1.matmul(x, ws[0], b, fuse_relu=True, out_dtype=bf)
                   for _ in range(2)]
            compare(f"K1 {name} {m}x{k}x{n} bf16 out", got[0],
                    k1.matmul_plain(x, ws[0], b, fuse_relu=True, out_dtype=bf))
            if not torch.equal(got[0], got[1]):
                raise AssertionError("K1: two runs of the split-K route differ")
        order = (plain, run, cublas, cublas, run, plain)
        t = [time_graph_ms(fn, ws) for fn in order]
        ms, ms_plain, ms_cublas = (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, (t[2] + t[3]) / 2
        _, splits = k1.k1_split_plan(m, n, k, sms)
        gbytes = (m * k * 2 + k * n * 2 + m * n * 4) / 1e9
        log(f"  K1 {name} {m}x{k}x{n}: kernel {ms:.4f} ms ({splits} splits, "
            f"{gbytes / ms * 1e3:.0f} GB/s, {2 * m * k * n / ms / 1e9:.1f} "
            f"TFLOP/s), plain {ms_plain:.4f} ms, cuBLAS {ms_cublas:.4f} ms")
        t_bytes, t_ops = gbytes * 1e9 / PEAK_BYTES, 2 * m * k * n / PEAK_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        if name in K1_APART:
            stats[K1_APART[name]] = {
                "err": err, "ms": ms, "plain_ms": ms_plain,
                "library_ms": ms_cublas, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        else:
            stats["K1"]["err"] = max(stats["K1"]["err"], err)
        if m == BATCH:
            stats["K1"]["ms"] += ms
            stats["K1"]["plain_ms"] += ms_plain
            stats["K1"]["library_ms"] += ms_cublas
            stats["K1"]["bound_ms"] += bound
        if name == "fc7" and m == BATCH:
            # the host's cost of one call (checks, allocations, two tensor
            # maps encoded, the ctypes call) against its device time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(200):
                run(ws[i % len(ws)])
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            log(f"  K1 {name} host time per call (enqueue, unsynchronised): "
                f"{host_us:.1f} us against {ms * 1e3:.1f} us on the device")

    log("K2 at the JAX kernel-test shape (2x3x9x9, 8 filters 3x3, stride 2, "
        "pad 1, f32):")
    x, w, b = randn(2, 3, 9, 9), randn(8, 3, 3, 3), randn(8)
    err = compare("K2 2x3x9x9 s2 p1",
                  k2.conv2d_im2col_gemm(x, w, b, stride=(2, 2), pad=(1, 1)),
                  k2.conv2d_im2col_gemm_plain(x, w, b, stride=(2, 2),
                                              pad=(1, 1)))
    stats["K2"]["err"] = max(stats["K2"]["err"], err)
    log("K2 sm90 route at CaffeNet's convs (NHWC bf16, bias + ReLU, bf16 "
        "out): against the plain version and the core route (x one element "
        "past an aligned address) at batch 50 and 256, two runs bit for bit; "
        "device time per "
        "call from CUDA graphs, in turns, beside cuDNN (F.conv2d on "
        "channels-last bf16 with the bias, a yardstick only) and the bound "
        f"({sms} SMs; bf16 {PEAK_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{PEAK_BYTES / 1e12:.2f} TB/s):")
    for batch in (BATCH, 256):
        for name, hw, c, o, ksz, s, p, g in CAFFENET_CONVS:
            x = randn(batch, hw, hw, c, dtype=bf)
            w = randn(ksz, ksz, c // g, o, dtype=bf,
                      std=(2.0 / (ksz * ksz * c // g)) ** 0.5)
            b = randn(o, std=0.1)
            # the same values one element past an aligned address: the
            # operands the core took on the path before the sm90 route
            x_core = torch.empty(x.numel() + 8, dtype=bf, device=dev)[
                1:1 + x.numel()].view(x.shape).copy_(x)
            kw = dict(stride=(s, s), pad=(p, p), groups=g, fuse_relu=True,
                      out_dtype=bf)
            if (k2.k2_route(x, w, bf, stride=(s, s), pad=(p, p)) != "sm90"
                    or k2.k2_route(x_core, w, bf, stride=(s, s),
                                   pad=(p, p)) != "core"):
                raise AssertionError(f"K2 {name}: routes not sm90 / core")
            run = lambda _=None: k2.conv2d_gemm_nhwc(x, w, b, **kw)
            core = lambda _=None: k2.conv2d_gemm_nhwc(x_core, w, b, **kw)
            plain = lambda _=None: k2.conv2d_gemm_nhwc_plain(x, w, b, **kw)
            before = (k2.conv2d_im2col_gemm.launches,
                      k2.conv2d_im2col_gemm.launches_sm90)
            got = run()
            if (k2.conv2d_im2col_gemm.launches,
                    k2.conv2d_im2col_gemm.launches_sm90) != \
                    (before[0] + 1, before[1] + 1):
                raise AssertionError(f"K2 {name}: not one sm90 launch")
            err = compare(f"K2 {name} b{batch} g={g} sm90 vs plain", got,
                          plain())
            compare(f"K2 {name} b{batch} sm90 vs core", got, core())
            if not torch.equal(got, run()):
                raise AssertionError(f"K2 {name} b{batch}: two runs differ")
            stats["K2"]["err"] = max(stats["K2"]["err"], err)
            xc = x.permute(0, 3, 1, 2)             # channels-last NCHW view
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bc = b.to(bf)
            cudnn = lambda _=None: torch.nn.functional.conv2d(
                xc, wc, bc, stride=s, padding=p, groups=g)
            calls = [0, 1, 2, 3]
            order = ((run, core, plain, cudnn, cudnn, plain, core, run)
                     if batch == BATCH else (run, cudnn, cudnn, run))
            t = [time_graph_ms(fn, calls) for fn in order]
            ms, ms_cudnn = (t[0] + t[-1]) / 2, (t[len(t) // 2 - 1]
                                                + t[len(t) // 2]) / 2
            bound, bound_by = conv_bound_ms(batch, hw, c, o, ksz, s, p, g)
            line = (f"  K2 {name} b{batch}: sm90 {ms:.4f} ms, cuDNN "
                    f"{ms_cudnn:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
                    f"{bound / ms:.3f} of it)")
            if batch == BATCH:
                ms_core, ms_plain = (t[1] + t[6]) / 2, (t[2] + t[5]) / 2
                line += f", core {ms_core:.4f} ms, plain {ms_plain:.4f} ms"
                stats["K2"]["ms"] += ms
                stats["K2"]["plain_ms"] += ms_plain
                stats["K2"]["library_ms"] += ms_cudnn
                stats["K2"]["bound_ms"] += bound
                if name == "conv1":
                    line += "; " + repack_phase(k2, x, w, s, stats)
            log(line + f" (turns: {', '.join(f'{v:.4f}' for v in t)})")
    return stats


def repack_phase(k2, x, w, s, stats) -> str:
    """conv1's space-to-depth repack kernel (part of K2's sm90 route) against
    its plain version, bit for bit, and its time beside its bound (each
    byte of x, w and their repacks moved once)."""
    got, ref = k2.space_to_depth(x, w, s), k2.space_to_depth_plain(x, w, s)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("K2 space_to_depth: kernel differs from plain")
    order = (k2.space_to_depth, k2.space_to_depth_plain,
             k2.space_to_depth_plain, k2.space_to_depth)
    t = [time_graph_ms(lambda _, fn=fn: fn(x, w, s), [0, 1, 2, 3])
         for fn in order]
    nbytes = sum(a.numel() * a.element_size() for a in (x, w, *got))
    stats["repack"] = {"err": 0.0, "ms": (t[0] + t[3]) / 2,
                       "plain_ms": (t[1] + t[2]) / 2,
                       "bound_ms": nbytes / PEAK_BYTES * 1e3}
    return (f"of sm90's time, the space-to-depth repack kernel "
            f"{stats['repack']['ms']:.4f} ms (plain {stats['repack']['plain_ms']:.4f}"
            f" ms, bound {stats['repack']['bound_ms']:.4f} ms, equal bits)")


def frames(rng, n):
    return rng.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)


def slice_phase(dev):
    from videovector_tpu_torch.data.transformer import (
        TransformConfig, sample_transform_params,
    )
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    from videovector_tpu_torch.ops.hopper.conv_gemm import (
        conv2d_im2col_gemm, space_to_depth,
    )
    from videovector_tpu_torch.ops.hopper.matmul import matmul

    cfg = RetrievalPipelineConfig()
    mean = np.full((3, 256, 256), 110, np.float32)
    pipe = RetrievalPipeline(cfg, mean=mean, device=dev)
    plain = RetrievalPipeline(cfg, mean=mean, device=dev, plain=True)
    params = pipe.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.RandomState(0)
    videos = [torch.as_tensor(frames(rng, BATCH), device=dev) for _ in range(4)]
    h, w, m = sample_transform_params(BATCH, cfg.image_hw,
                                      TransformConfig(crop_size=cfg.crop),
                                      train=False, rng=rng)
    pad = rng.randn(GALLERY_ROWS - len(videos), cfg.embed_dim).astype(np.float32)
    pad /= np.linalg.norm(pad, axis=1, keepdims=True)
    pad_ids = np.arange(1000, 1000 + len(pad), dtype=np.int32)
    torch.cuda.synchronize()

    # the main path, counted: gallery build, then the queries
    matmul.launches = matmul.launches_sm90 = 0
    conv2d_im2col_gemm.launches = conv2d_im2col_gemm.launches_sm90 = 0
    space_to_depth.launches = 0
    t0 = time.perf_counter()
    gal, ids = pipe.build_gallery(params, [(v, h, w, m) for v in videos],
                                  [np.full(BATCH, i) for i in range(len(videos))])
    gallery = torch.cat([gal, torch.as_tensor(pad, device=dev)])
    gallery_ids = torch.cat([ids, torch.as_tensor(pad_ids, device=dev)])
    results = [pipe.query(params, videos[q], h, w, m, gallery, gallery_ids)
               for q in range(N_QUERIES)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"K1": matmul.launches, "K2": conv2d_im2col_gemm.launches,
                "repack": space_to_depth.launches}
    k2_sm90 = conv2d_im2col_gemm.launches_sm90
    n_embed = len(videos) + N_QUERIES
    log(f"main path: {len(videos)} gallery batches + {N_QUERIES} queries of "
        f"{BATCH} frames in {seconds:.3f} s (host clock, first calls "
        f"included); launches {launches}, on the sm90 routes: K1 "
        f"{matmul.launches_sm90}, K2 {k2_sm90}")
    expect = {"K1": K1_PER_EMBED * n_embed, "K2": K2_PER_EMBED * n_embed,
              "repack": n_embed}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if matmul.launches_sm90 != matmul.launches:
        raise AssertionError(f"{matmul.launches - matmul.launches_sm90} K1 "
                             "launches of the path left the sm90 route")
    if k2_sm90 != launches["K2"]:
        raise AssertionError(f"{launches['K2'] - k2_sm90} K2 launches of the "
                             "path left the sm90 route")

    if gallery.shape != (GALLERY_ROWS, cfg.embed_dim):
        raise AssertionError(f"gallery shape {tuple(gallery.shape)}")
    for q, (top_ids, top_scores) in enumerate(results):
        if top_ids.shape != (BATCH, cfg.top_k) or top_scores.shape != (BATCH, cfg.top_k):
            raise AssertionError(f"query {q}: shapes {tuple(top_ids.shape)}, "
                                 f"{tuple(top_scores.shape)}")
        if not torch.isfinite(top_scores).all():
            raise AssertionError(f"query {q}: non-finite scores")
        if (top_scores[:, 1:] > top_scores[:, :-1]).any():
            raise AssertionError(f"query {q}: top-k scores not descending")
        if not (top_ids[:, 0] < len(videos)).all():
            raise AssertionError(f"query {q}: a random padding row outranked "
                                 "every real video")
        hit = (top_ids[:, 0] == q).float().mean().item()
        log(f"  query {q}: top-1 is the query's own video for {hit:.2f} of "
            f"frames; top-1 score {top_scores[:, 0].mean().item():.4f}")

    # kernels vs plain versions through the whole path (bf16 bound)
    emb = pipe.embed_frames(params, videos[0], h, w, m)
    ref = plain.embed_frames(params, videos[0], h, w, m)
    norms = emb.norm(dim=1)
    if not torch.isfinite(emb).all() or (norms - 1).abs().max().item() > 1e-4:
        raise AssertionError(f"embeddings not finite unit rows: {norms}")
    err = (emb - ref).abs().max().item()
    tol = REL_TOL[torch.bfloat16] * ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(emb, ref).min().item()
    log(f"embed_frames kernels vs plain: max_abs_err {err:.3e} (tol {tol:.3e}),"
        f" min cosine {cos:.6f}")
    if not err <= tol:
        raise AssertionError(f"embed_frames kernels vs plain: {err} > {tol}")

    inputs = {}
    for batch in (BATCH, 256):
        pix = torch.as_tensor(frames(rng, batch), device=dev)
        hb, wb, mb = sample_transform_params(
            batch, cfg.image_hw, TransformConfig(crop_size=cfg.crop),
            train=False, rng=rng)
        inputs[batch] = (pix, (hb, wb, mb))
        run = lambda: pipe.embed_frames(params, pix, hb, wb, mb)
        ref_run = lambda: plain.embed_frames(params, pix, hb, wb, mb)
        iters = 30 if batch == BATCH else 6
        t = [time_ms(ref_run, iters), time_ms(run, iters),
             time_ms(run, iters), time_ms(ref_run, iters)]
        ms, ms_plain = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        log(f"embed_frames batch {batch}: kernels {ms:.3f} ms = "
            f"{batch / ms * 1e3:.1f} frames/s; plain {ms_plain:.3f} ms = "
            f"{batch / ms_plain * 1e3:.1f} frames/s (plain, kernel, kernel, "
            f"plain: {', '.join(f'{v:.3f}' for v in t)} ms)")
    return launches, pipe, params, inputs


def device_breakdown(pipe, params, pix, hwm, calls: int = 5) -> None:
    """Profiles a window of `calls` back-to-back embed_frames (after
    warm-up): device time by kernel per call, the device's idle share over
    an unprofiled window of the same calls, and a failure if a cuBLAS or
    cuDNN GEMM/conv ran there. Reports "not measured" if the profiler sees
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    def window():
        for _ in range(calls):
            pipe.embed_frames(params, pix, *hwm)
    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()           # unprofiled window, host clock
    window()
    enqueue_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / calls)
    if not by_name:
        log("profiler: no device events (breakdown and library-kernel check "
            "not measured)")
        return
    library = sorted(n for n in by_name
                     if any(s in n.lower() for s in ("cudnn", "cublas", "xmma",
                                                     "cutlass", "gemv", "sm90_"))
                     or ("gemm" in n.lower() and "vv::" not in n))
    busy = sum(by_name.values())

    def share(*keys):
        return sum(v for n, v in by_name.items() if any(s in n for s in keys))
    # K1: the sm90 route's GEMM and split-K reduction, or the core (MatGeom)
    k1_gemm, k1_reduce = share("gemm_tma_wgmma", "vv::MatGeom"), share("splitk_reduce")
    # K2: the sm90 route's conv, or the core (ConvGeom)
    k1, k2 = k1_gemm + k1_reduce, share("conv_wgmma", "vv::ConvGeom",
                                        "space_to_depth")
    repack = share("space_to_depth")
    casts = share("copy_kernel")
    log(f"profile of {calls} back-to-back embed_frames (batch "
        f"{pix.shape[0]}), per call: device busy {busy:.1f} us (profiled "
        f"window) vs {wall_us:.1f} us host wall of an unprofiled window "
        f"({enqueue_us:.1f} us for the host to enqueue), idle share "
        f"{1 - busy / wall_us:.3f}; K1 "
        f"{k1:.1f} us (GEMM {k1_gemm:.1f}, split-K reduction "
        f"{k1_reduce:.1f}), K2 {k2:.1f} us (conv1's repack {repack:.1f}), "
        f"other {busy - k1 - k2:.1f} us "
        f"(of which dtype casts and copies {casts:.1f}) over {len(by_name)} "
        "distinct kernels; top 12:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us:9.1f} us  {name[:110]}")
    if library:
        raise AssertionError(f"library GEMM/conv kernels on the path: {library}")


def _train_setup(dev, batch: int, **model_kw):
    """bench.py's training workload at `batch` windows: the config, params
    from a seeded generator, and (15, batch, 4096) f32 role-major data drawn
    on the card."""
    from videovector_tpu_torch.models.embedding import (
        VideoEmbeddingConfig, VideoEmbeddingModel,
    )
    cfg = VideoEmbeddingConfig(**{"num_negatives": TRAIN_NEG, **model_kw})
    gen = torch.Generator(device=dev).manual_seed(0)
    params = VideoEmbeddingModel(cfg).init(gen)
    data = torch.randn((cfg.num_roles, batch, cfg.feature_dim), generator=gen,
                       device=dev)
    return cfg, params, {"data": data}


def _train(cfg, params, batch, steps, *, gm=1, plain=False, hooks=None,
           display=0, data=None, test_interval=0, eval_fn=None,
           test_data=None):
    """`steps` iterations of solver.train.train on the card through the
    entry point a user calls, bench.py's solver, role-major data; with
    eval_fn, one test batch every `test_interval` iterations."""
    from videovector_tpu_torch.models.embedding import VideoEmbeddingModel
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train
    model = VideoEmbeddingModel(cfg, plain=plain)

    def loss_fn(p, b, generator):
        return model.loss(p, b, generator=generator, train=True,
                          role_major=True)
    solver = SolverConfig(**TRAIN_SOLVER, max_iter=steps, display=display,
                          grad_microbatch=gm, random_seed=1,
                          test_interval=test_interval, test_iter=(1,))
    if data is None:
        data = itertools.repeat(batch)
    return train(loss_fn, params, data, solver, device="cuda",
                 batch_axes={"data": 1}, hooks=hooks, eval_fn=eval_fn,
                 test_data=test_data)


class _StepTimer:
    """Hooks for train(): CUDA events and host clocks around iterations
    [start, stop), and a profiler window over [stop, stop + profiled)."""

    def __init__(self, start: int, stop: int, profiled: int = 0):
        from torch.profiler import ProfilerActivity, profile
        self.start, self.stop, self.profiled = start, stop, profiled
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=True) if profiled else None

    def hook(self, params, it):
        if it == self.start:
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            self.events[0].record()
        elif it == self.stop:
            self.events[1].record()
            self.enqueue_s = time.perf_counter() - self.t0
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
            if self.prof is not None:
                self.prof.start()
        elif self.prof is not None and it == self.stop + self.profiled:
            torch.cuda.synchronize()
            self.prof.stop()

    def ms_per_step(self) -> float:
        return self.events[0].elapsed_time(self.events[1]) / (self.stop - self.start)


def training_parity(dev) -> None:
    """Three steps through train() with K1 and with the plain tower, from the
    same params, dropout off: losses within 1e-3 relative and updated
    params within 2e-2 of the largest update."""
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH, dropout_rate=0.0)
    runs = {}
    for plain in (False, True):
        res = _train(cfg, params, batch, 3, plain=plain, display=1,
                     data=iter([batch] * 3))
        runs[plain] = (res, [m["loss"] for _, m in res.metrics_history])
    (rk, lk), (rp, lp) = runs[False], runs[True]
    w0 = params["tower"]["w"]
    dw = (rp.params["tower"]["w"] - w0).abs().max().item()
    errs = {k: (rk.params["tower"][k] - rp.params["tower"][k]).abs().max().item()
            for k in ("w", "b")}
    db = (rp.params["tower"]["b"] - params["tower"]["b"]).abs().max().item()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"training, 3 steps at B={TRAIN_BATCH} (dropout off), K1 vs plain "
        f"tower: losses {lk} vs {lp} (max rel err {loss_err:.2e}, tol 1e-3); "
        f"max|w_K1 - w_plain| {errs['w']:.3e} against max|dw| {dw:.3e} (tol "
        f"2e-2 of it); max|b_K1 - b_plain| {errs['b']:.3e} against max|db| "
        f"{db:.3e}")
    if not all(math.isfinite(v) for v in lk) or len(lk) != 3:
        raise AssertionError(f"training losses {lk}")
    if not loss_err <= 1e-3:
        raise AssertionError(f"training loss K1 vs plain: {loss_err} > 1e-3")
    if not (errs["w"] <= 2e-2 * dw and errs["b"] <= 2e-2 * db):
        raise AssertionError(f"training params K1 vs plain: {errs}, "
                             f"updates {dw}, {db}")


def training_main_path(dev) -> tuple[int, float]:
    """bench.py's step at B=128 (dropout 0.9) through train(), counted: K1's
    launches must be one per step, all on the sm90 route; the step timed by
    CUDA events over 20 steps after 5 of warm-up, then profiled over 5 more
    (device busy against host wall, top kernels, and no library GEMM on the
    tower forward's shapes). Then one remat_tower step pair (two K1 launches
    a step). Returns the K1 launches and the step's ms."""
    from videovector_tpu_torch.ops.hopper.matmul import matmul
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH)
    timer = _StepTimer(5, 25, profiled=5)
    steps = TRAIN_MAIN_STEPS
    torch.cuda.synchronize()
    matmul.launches = matmul.launches_sm90 = 0
    res = _train(cfg, params, batch, steps, hooks=[(1, timer.hook)])
    torch.cuda.synchronize()
    launches = {"K1": matmul.launches, "K1 sm90": matmul.launches_sm90}
    if launches != {"K1": steps, "K1 sm90": steps}:
        raise AssertionError(f"training K1 launches {launches}, expected "
                             f"{steps} (one per step), all sm90")
    w = res.params["tower"]["w"]
    if not (torch.isfinite(w).all() and res.state["iter"] == steps):
        raise AssertionError("training params not finite after the run")
    ms = timer.ms_per_step()
    wall = timer.wall_s / (timer.stop - timer.start) * 1e3
    enqueue = timer.enqueue_s / (timer.stop - timer.start) * 1e3
    log(f"training main path: {steps} steps at B={TRAIN_BATCH} (dropout "
        f"{cfg.dropout_rate}), K1 launches {launches}; step {ms:.4f} ms (CUDA "
        f"events over {timer.stop - timer.start} steps) = "
        f"{TRAIN_BATCH * TRAIN_NEG / ms * 1e3:,.0f} triplets/s; host wall "
        f"{wall:.4f} ms a step, {enqueue:.4f} ms to enqueue it")
    training_profile(timer.prof, timer.profiled, wall)

    cfg_r, params_r, batch_r = _train_setup(dev, TRAIN_BATCH, remat_tower=True)
    matmul.launches = matmul.launches_sm90 = 0
    _train(cfg_r, params_r, batch_r, 2)
    torch.cuda.synchronize()
    if (matmul.launches, matmul.launches_sm90) != (4, 4):
        raise AssertionError(f"remat_tower: K1 launches {matmul.launches} "
                             f"({matmul.launches_sm90} sm90), expected 4")
    log("remat_tower: 2 steps, 4 K1 launches (the forward recomputed in "
        "backward), all sm90")
    return launches["K1"] + 4, ms


def training_profile(prof, steps: int, wall_ms: float) -> None:
    """Device time by kernel per step over the profiled steps, the idle
    share against the unprofiled host wall, and the check that the tower
    forward's (1920 x 4096) . (4096 x 4096) product never went to a library
    GEMM: the only cuBLAS products are the weight gradient's and the
    scoring block's."""
    by_name: dict[str, float] = {}
    n_device_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_device_ops += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / steps)
    if not by_name:
        log("training profile: no device events (breakdown not measured)")
        return
    rows = TRAIN_BATCH * (1 + 4 + TRAIN_NEG)
    fwd_shapes = [[rows, 4096], [4096, 4096]]
    products = {}
    for e in prof.events():
        if e.name in ("aten::mm", "aten::addmm", "aten::bmm"):
            shapes = [s for s in e.input_shapes if s]
            products.setdefault(str(shapes), 0)
            products[str(shapes)] += 1
            if shapes[-2:] == fwd_shapes:
                raise AssertionError("the tower forward went to a library "
                                     f"GEMM: {e.name} {shapes}")
    busy = sum(by_name.values()) / 1e3
    # a host-fed step's batch copy runs on a copy engine: busy, but no kernel
    h2d = sum(v for n, v in by_name.items() if n.startswith("Memcpy HtoD")) / 1e3
    k1 = sum(v for n, v in by_name.items()
             if "gemm_tma_wgmma" in n or "splitk_reduce" in n) / 1e3
    library = sum(v for n, v in by_name.items()
                  if any(s in n.lower() for s in ("cublas", "xmma", "cutlass",
                                                  "gemm", "sm90_"))
                  and "vv::" not in n and "gemm_tma_wgmma" not in n) / 1e3
    log(f"training profile over {steps} steps at B={TRAIN_BATCH}, per step: "
        f"device busy {busy:.4f} ms against {wall_ms:.4f} ms host wall "
        f"(unprofiled), idle share {1 - busy / wall_ms:.3f} ({h2d:.4f} ms "
        f"of the busy time H2D copies; without them "
        f"{1 - (busy - h2d) / wall_ms:.3f}); "
        f"{n_device_ops / steps:.1f} device operations (kernels, copies, "
        f"fills) a step; K1 {k1:.4f} ms, "
        f"library GEMMs {library:.4f} ms, other {busy - k1 - library:.4f} ms; "
        f"aten products (input shapes: calls in {steps} steps): {products}; "
        "top 12 kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us:9.1f} us  {name[:110]}")


def step_part_times(dev) -> None:
    """Parts of the B=128 step timed alone by CUDA-graph replay: the tower's
    weight-gradient product as the backward runs it (f32 x^T . dY, TF32
    off) and, for information only (never on the path: it changes results
    against the CPU reference), with dY rounded to bf16; and one
    solver_update of the tower's params (bench.py's solver)."""
    from videovector_tpu_torch.solver import (
        SolverConfig, init_solver_state, solver_update,
    )
    rows = TRAIN_BATCH * (1 + 4 + TRAIN_NEG)
    gen = torch.Generator(device=dev).manual_seed(3)
    xc = torch.randn((rows, 4096), generator=gen, device=dev).bfloat16()
    dy = torch.randn((rows, 4096), generator=gen, device=dev)
    f32 = lambda _: xc.float().T @ dy
    bf16 = lambda _: xc.T @ dy.bfloat16()
    t = [time_graph_ms(fn, [0, 1]) for fn in (f32, bf16, bf16, f32)]
    ms, ms_bf = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    flops = 2 * rows * 4096 * 4096
    log(f"tower wgrad (4096 x {rows}) . ({rows} x 4096): f32 as on the path "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; bound at 67 TFLOP/s "
        f"f32 {flops / 67e12 * 1e3:.4f} ms); with dY in bf16 (information "
        f"only, not on the path) {ms_bf:.4f} ms")
    cfg = SolverConfig(**TRAIN_SOLVER)
    params = {"tower": {"w": torch.randn((4096, 4096), generator=gen,
                                         device=dev),
                        "b": torch.randn(4096, generator=gen, device=dev)}}
    grads = {"tower": {k: torch.randn(v.shape, generator=gen, device=dev)
                       for k, v in params["tower"].items()}}
    state = init_solver_state(cfg, params)
    ms_opt = time_graph_ms(
        lambda _: solver_update(cfg, params, grads, state), [0, 1])
    nbytes = 5 * 4 * sum(v.numel() for v in params["tower"].values())
    log(f"solver_update of the tower's {nbytes // 20:,} params: "
        f"{ms_opt:.4f} ms (bound {nbytes / PEAK_BYTES * 1e3:.4f} ms: w, h "
        "and g read, w and h written)")


def training_cells(dev) -> None:
    """The large-batch points for the auto-microbatch rule: B=1024 with gm 1
    and 8, B=8192 with gm 64; CUDA events over 2 steps after 1. K1 launches
    once per microbatch, on the sm90 route."""
    from videovector_tpu_torch.ops.hopper.matmul import matmul
    steps = 4
    for batch, gm in ((1024, 1), (1024, 8), (8192, 64)):
        cfg, params, data = _train_setup(dev, batch)
        timer = _StepTimer(1, 3)
        matmul.launches = matmul.launches_sm90 = 0
        _train(cfg, params, data, steps, gm=gm, hooks=[(1, timer.hook)])
        torch.cuda.synchronize()
        if (matmul.launches, matmul.launches_sm90) != (steps * gm,) * 2:
            raise AssertionError(
                f"training B={batch} gm={gm}: K1 launches {matmul.launches} "
                f"({matmul.launches_sm90} sm90), expected {steps * gm}")
        ms = timer.ms_per_step()
        log(f"training B={batch} gm={gm}: {ms:.3f} ms a step = "
            f"{batch * TRAIN_NEG / ms * 1e3:,.0f} triplets/s (host wall "
            f"{timer.wall_s / 2 * 1e3:.3f} ms a step)")
        del params, data
        torch.cuda.empty_cache()


def _device_profile(fn, wall_ms: float, top: int = 8) -> str:
    """One profiled call of fn(): device busy time, the idle share against
    `wall_ms` (the host wall of an unprofiled call) and the `top` device
    operations by time, as a log line; "not measured" if the profiler sees
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
    if not by_name:
        return "profile: no device events (busy time not measured)"
    busy = sum(t for t, _ in by_name.values())
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (f"device busy {busy:.3f} ms against {wall_ms:.3f} ms host wall, "
            f"idle share {max(0.0, 1 - busy / wall_ms):.3f}; "
            f"{sum(n for _, n in by_name.values())} device operations; top: "
            + "; ".join(f"{t:.3f} ms x{n} {name[:70]}"
                        for name, (t, n) in ops))


def _test_windows(dev, gen, n: int):
    """n flagship test batches drawn on the card: (673, 4, 4096) f32 raw
    context frames near their video's center, and (673,) video ids."""
    centers = torch.randn((TEST_VIDEOS, 4096), generator=gen, device=dev)
    out = []
    for _ in range(n):
        vids = torch.randint(0, TEST_VIDEOS, (TEST_BATCH,), generator=gen,
                             device=dev, dtype=torch.int32)
        data = centers[vids][:, None, :] + torch.randn(
            (TEST_BATCH, TEST_FRAMES, 4096), generator=gen, device=dev)
        out.append({"data": data, "video_ids": vids})
    return out


def _flagship_eval_fn(model):
    """The TEST branch as an eval_fn for train: extract (frames averaged,
    tower + ReLU on K1, L2 normalize), then RETRIEVAL_STATS with class =
    video id and exclude_same_video_shots false, under the TEST branch's
    top names."""
    from videovector_tpu_torch.metrics import retrieval_stats

    def eval_fn(p, batch):
        vids = batch["video_ids"]
        out = retrieval_stats(model.extract(p, batch["data"]), vids, vids,
                              exclude_same_video_shots=False)
        return {"test_map": out["mean_ap"], "test_hit1": out["hit_at_1"],
                "test_hit5": out["hit_at_5"]}
    return eval_fn


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def eval_through_train(dev) -> int:
    """The flagship's test-interval eval through train() at B=128: 10 steps,
    test_interval 5, test_iter 1 (evals at 0, 5 and 10). Checks the Test
    net output lines, one sm90 K1 launch per test batch and outputs in
    [0, 1]; then, on the trained params, the eval with K1 against the plain
    tower, and one eval timed with CUDA events and split into K1 and the
    dense retrieval_stats. Returns the eval's K1 launches."""
    from videovector_tpu_torch.metrics import retrieval_stats
    from videovector_tpu_torch.models.embedding import VideoEmbeddingModel
    from videovector_tpu_torch.ops.hopper.matmul import matmul
    steps, interval = 10, 5
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH)
    windows = _test_windows(dev, torch.Generator(device=dev).manual_seed(5), 2)
    model, plain = VideoEmbeddingModel(cfg), VideoEmbeddingModel(cfg, plain=True)
    inner = _flagship_eval_fn(model)
    per_eval = []

    def eval_fn(p, b):
        before = (matmul.launches, matmul.launches_sm90)
        out = inner(p, b)
        per_eval.append((matmul.launches - before[0],
                         matmul.launches_sm90 - before[1]))
        return out
    lines = _Collect()
    logging.getLogger("videovector_tpu_torch.solver.train").addHandler(lines)
    try:
        res = _train(cfg, params, batch, steps, test_interval=interval,
                     eval_fn=eval_fn, test_data=itertools.cycle(windows))
    finally:
        logging.getLogger("videovector_tpu_torch.solver.train") \
            .removeHandler(lines)
    torch.cuda.synchronize()
    tests = [l for l in lines.lines if l.startswith("    Test net output #")]
    for line in tests:
        log(line)
    n_evals = steps // interval + 1
    if len(tests) != 3 * n_evals or [i for i, _ in res.test_history] != \
            list(range(0, steps + 1, interval)):
        raise AssertionError(f"test lines {tests}, history {res.test_history}")
    if per_eval != [(1, 1)] * n_evals:
        raise AssertionError(f"K1 launches per test batch (all, sm90): "
                             f"{per_eval}, expected one sm90 launch each")
    values = [v for _, m in res.test_history for v in m.values()]
    if not all(0.0 <= v <= 1.0 for v in values):
        raise AssertionError(f"test outputs outside [0, 1]: {res.test_history}")
    log(f"test eval through train: {steps} steps at B={TRAIN_BATCH}, "
        f"{n_evals} evals of {TEST_BATCH} windows, K1 launches per eval "
        f"{per_eval} (all, sm90)")

    p, w = res.params, windows[0]
    vids = w["video_ids"]
    with torch.no_grad():
        emb = model.extract(p, w["data"])
        ref = plain.extract(p, w["data"])
        compare(f"test eval embeddings {TEST_BATCH}x4096, K1 vs plain", emb,
                ref)
        outs = [retrieval_stats(e, vids, vids) for e in (emb, ref)]
        top1 = []
        for e in (emb, ref):
            d = -2.0 * (e @ e.T)
            d.fill_diagonal_(float("inf"))
            top1.append(torch.argmin(d, dim=1))
        differ = int((top1[0] != top1[1]).sum())
        log(f"  test_map K1 {float(outs[0]['mean_ap']):.6f}, plain "
            f"{float(outs[1]['mean_ap']):.6f}; test_hit1 "
            f"{float(outs[0]['hit_at_1']):.6f} / "
            f"{float(outs[1]['hit_at_1']):.6f}; queries whose top-1 differs: "
            f"{differ} of {TEST_BATCH}")

        x = torch.mean(w["data"], dim=1).bfloat16()
        wt, bt = p["tower"]["w"].bfloat16(), p["tower"]["b"]
        parts = {
            "eval": lambda: inner(p, w),
            "extract": lambda: model.extract(p, w["data"]),
            "K1": lambda: matmul(x, wt, bt, fuse_relu=True),
            "retrieval_stats": lambda: retrieval_stats(emb, vids, vids),
        }
        ms = {k: time_ms(fn, iters=20) for k, fn in parts.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            out = inner(p, w)
            float(out["test_map"])        # train reads each output back
        wall = (time.perf_counter() - t0) / 10 * 1e3
        log(f"  one eval: {ms['eval']:.4f} ms (CUDA events over 20), of it "
            f"extract {ms['extract']:.4f} (K1 alone {ms['K1']:.4f}), dense "
            f"retrieval_stats at N={TEST_BATCH} {ms['retrieval_stats']:.4f}; "
            f"host wall with the outputs read back {wall:.4f} ms; "
            + _device_profile(lambda: float(inner(p, w)["test_map"]), wall))
    return sum(n for n, _ in per_eval)


def _class_gallery(dev, gen, n: int, d: int = 4096, classes: int = 50):
    """(n, d) f32 L2-normalized rows, center of their class + noise, as
    scripts/bench_gallery_eval.py and tests/test_metrics.py make them, and
    n // 10 videos, drawn on the card in blocks of rows. The centers are
    scaled by 0.2, not 2.0: at 4096 dims 2.0 separates the classes fully
    (mAP 1.0, every engine's answer trivial); 0.2 leaves them overlapping
    (mAP ≈ 0.57 at 4,000 rows on the CPU)."""
    cls = torch.randint(0, classes, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    vids = torch.randint(0, n // 10, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    centers = torch.randn((classes, d), generator=gen, device=dev)
    feats = torch.empty((n, d), device=dev)
    for s in range(0, n, 8192):
        f = centers[cls[s:s + 8192]] * 0.2 + torch.randn(
            (min(8192, n - s), d), generator=gen, device=dev)
        feats[s:s + 8192] = f / f.norm(dim=1, keepdim=True)
    return feats, vids, cls


def _engine_ulps(a: dict, b: dict) -> dict:
    """count - sort per output, in f32 ulps. hit@1 and hit@5 must be equal:
    each query's acc@1 and acc@5 are the same values and sum alike. mean_ap
    may differ by one ulp and no more: each query's ap adds the same terms,
    but over its M class members in one engine and its N ranked positions
    in the other, an order no reduction of PyTorch's shares."""
    ulps = {k: (float(a[k]) - float(b[k])) / float(np.spacing(np.float32(b[k])))
            for k in a}
    if ulps["hit_at_1"] or ulps["hit_at_5"] or abs(ulps["mean_ap"]) > 1:
        raise AssertionError(f"count {a} vs sort {b}: {ulps} ulps")
    return ulps


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def gallery_eval(dev) -> None:
    """retrieval_stats_chunked and retrieval_stats_report on the card at
    gallery scale: 20,000 x 4096 f32 with both engines (equal results, both
    timed, the faster profiled, a 4,096-row subsample against the CPU), the
    same gallery in bf16, the csv report, then 100,000 x 4096 in one timed
    pass."""
    import tempfile

    from videovector_tpu_torch.metrics import retrieval as R
    gen = torch.Generator(device=dev).manual_seed(11)
    n = GALLERY_ROWS
    feats, vids, cls = _class_gallery(dev, gen, n)
    members = R._class_member_table(cls.cpu().numpy())[0].shape[1]
    auto = "count" if R._auto_uses_count(dev, members, n) else "sort"
    R.retrieval_stats_chunked(feats[:512], vids[:512], cls[:512])  # warm-up
    outs, secs = {}, {}
    for dtype in ("float32", "bfloat16"):
        for m in ("count", "sort"):
            outs[dtype, m], secs[dtype, m] = _timed(
                lambda: R.retrieval_stats_chunked(feats, vids, cls, method=m,
                                                  gallery_dtype=dtype))
        ulps = _engine_ulps(outs[dtype, "count"], outs[dtype, "sort"])
        log(f"gallery {n}x4096 {dtype}, 50 classes (largest {members} rows), "
            f"{n // 10} videos: count {secs[dtype, 'count']:.3f} s, sort "
            f"{secs[dtype, 'sort']:.3f} s (host clock, one pass each); "
            + ", ".join(f"{k} {float(v):.7f}"
                        for k, v in outs[dtype, "count"].items())
            + f", count - sort in f32 ulps {ulps}; 'auto' picks {auto}")
    # the faster engine first; the other's profile says where its time goes
    # (the count engine's compare cube is a hand-kernel candidate)
    for m in sorted(("count", "sort"), key=lambda m: secs["float32", m]):
        log(f"  profile of one f32 pass of the {m} engine: "
            + _device_profile(lambda: R.retrieval_stats_chunked(
                feats, vids, cls, method=m), secs["float32", m] * 1e3))

    # the subsample's rows rounded to multiples of 2**-10, so that every
    # distance is exact in any summation order (|x.y| <= 1 in units of
    # 2**-20 needs 21 bits): the card and the CPU then rank alike, and only
    # the f32 sums of the ap terms differ in order
    sub = 4096
    q = torch.round(feats[:sub] * 1024) / 1024
    card = R.retrieval_stats_chunked(q, vids[:sub], cls[:sub])
    cpu = R.retrieval_stats_chunked(q.cpu(), vids[:sub].cpu(),
                                    cls[:sub].cpu(), device="cpu")
    log(f"  {sub}-row subsample on a 2**-10 grid, card ('auto') vs CPU "
        "('auto'): "
        + ", ".join(f"{k} {float(card[k]):.7f} / {float(cpu[k]):.7f}"
                    for k in card))
    for k in card:
        if not math.isclose(float(card[k]), float(cpu[k]), rel_tol=1e-6):
            raise AssertionError(f"subsample {k}: card {card} vs CPU {cpu}")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "report.csv")
        agg, sec = _timed(lambda: R.retrieval_stats_report(feats, vids, cls,
                                                           path))
        rows = [l.split(",") for l in
                Path(path).read_text().splitlines()[1:]]
    v = vids.cpu().numpy()
    top5 = np.array([[int(x) for x in r[5:10]] for r in rows])
    if len(rows) != n or (v[top5] == v[:, None]).any():
        raise AssertionError(f"report: {len(rows)} rows, or a top-5 id from "
                             "the query's own video")
    log(f"  retrieval_stats_report at {n} rows: {sec:.3f} s (host clock, csv "
        f"written), {len(rows)} rows, every top-5 id from another video; "
        + ", ".join(f"{k} {val:.6f}" for k, val in agg.items()))

    t20 = secs["float32", auto]
    del feats, vids, cls
    torch.cuda.empty_cache()
    big = BIG_GALLERY_ROWS
    feats, vids, cls = _class_gallery(dev, gen, big)
    members_big = R._class_member_table(cls.cpu().numpy())[0].shape[1]
    pick = "count" if R._auto_uses_count(dev, members_big, big) else "sort"
    projected = t20 * (big / n) ** 2 * (members_big / members)
    why = f"'auto' picks {pick}"
    if pick == "count" and projected > 60:
        pick = "sort"
        why += (f", but its 20k time projects to {projected:.0f} s here, past "
                "60 s: running sort")
    out, sec = _timed(lambda: R.retrieval_stats_chunked(feats, vids, cls,
                                                        method=pick))
    if not all(0.0 <= float(x) <= 1.0 for x in out.values()):
        raise AssertionError(f"100k: {out}")
    log(f"gallery {big}x4096 f32 (largest class {members_big} rows; {why}): "
        f"{pick} {sec:.3f} s, one pass (host clock); "
        + ", ".join(f"{k} {float(x):.6f}" for k, x in out.items()))
    del feats, vids, cls
    torch.cuda.empty_cache()


def _emit():
    """generate_net.py's emit, loaded from its file (the module imports
    argparse only; its main, which imports the JAX package, is not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("generate_net", GENERATE_NET)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.emit


def _write_host_stores(tmp: Path) -> tuple[str, str]:
    """The training and test stores, written by the port's writers:
    make_synthetic_data.py's statistics (per video, |center + 0.4 randn|)
    from a seed, HOST_VIDEOS x HOST_SHOTS shots, and TEST_BATCH windows of
    TEST_FRAMES context shots over TEST_VIDEOS videos."""
    from videovector_tpu_torch.data.records import RecordWriter
    from videovector_tpu_torch.data.shots import ShotDataset, ShotVideo
    from videovector_tpu_torch.data.wire import Datum, TestVideoShotWindows
    rng = np.random.RandomState(0)
    videos = []
    for v in range(HOST_VIDEOS):
        center = rng.randn(HOST_DIM).astype(np.float32)
        feats = np.abs(center + 0.4 * rng.randn(HOST_SHOTS, HOST_DIM)
                       .astype(np.float32))
        videos.append(ShotVideo(v + 1, np.arange(HOST_SHOTS, dtype=np.int32),
                                feats))
    train_path, test_path = tmp / "train_shots.vvr", tmp / "test_windows.vvr"
    t0 = time.perf_counter()
    ShotDataset(videos).to_records(str(train_path))
    t1 = time.perf_counter()
    with RecordWriter(str(test_path)) as w:
        for i in range(TEST_BATCH):
            video = videos[i % TEST_VIDEOS]
            ids = rng.choice(HOST_SHOTS, size=TEST_FRAMES, replace=False)
            w.append(str(i), TestVideoShotWindows(
                video_id=int(video.video_id), context_shot_words=[
                    Datum(float_data=video.features[j]) for j in ids]).encode())
    t2 = time.perf_counter()
    log(f"host stores written by the port: {train_path.name} "
        f"{HOST_VIDEOS} videos x {HOST_SHOTS} shots x {HOST_DIM}, "
        f"{train_path.stat().st_size / 1e6:.1f} MB in {t1 - t0:.3f} s; "
        f"{test_path.name} {TEST_BATCH} windows x {TEST_FRAMES} shots, "
        f"{test_path.stat().st_size / 1e6:.1f} MB in {t2 - t1:.3f} s")
    return str(train_path), str(test_path)


class _HostFedTimer:
    """Marks (a CUDA event and the host clock) at the top of each iteration
    (a train hook, which runs after that iteration's test) and where each
    test batch is asked for, so that a step runs from its mark to the next
    one and a test, its batch's assembly included, stays out of it; and the
    profiler over the iterations `profiled`."""

    def __init__(self, timed: range, profiled: range):
        from torch.profiler import ProfilerActivity, profile
        self.timed, self.profiled = timed, profiled
        self.marks: list[tuple] = []          # (iteration or None, event, s)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=True)

    def _mark(self, it):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((it, ev, time.perf_counter()))

    def hook(self, params, it):
        self._mark(it)
        if it == self.profiled.start:
            torch.cuda.synchronize()
            self.prof.start()
        elif it == self.profiled.stop:
            torch.cuda.synchronize()
            self.prof.stop()

    def tests(self, source):
        while True:
            self._mark(None)
            yield source.next_batch()

    def per_step(self) -> tuple[float, float]:
        """Mean ms of the timed steps: by CUDA events, and by host clock."""
        torch.cuda.synchronize()
        dev_ms = host_ms = 0.0
        for (it, ev, t), (_, ev2, t2) in zip(self.marks, self.marks[1:]):
            if it in self.timed:
                dev_ms += ev.elapsed_time(ev2)
                host_ms += (t2 - t) * 1e3
        n = len(self.timed)
        return dev_ms / n, host_ms / n


def host_fed_training(dev, resident_ms: float) -> dict:
    """The flagship trained from its host plane through the port's entry
    points: stores written and read by the port, the net and solver parsed
    by it, the sources built from them as the JAX package's data factory
    builds them (graph/data_factory.py), and train run on the card, with a
    snapshot and a resume. Returns the K1 launches of its training steps
    and of its test batches."""
    import dataclasses
    import tempfile

    from videovector_tpu_torch.config import parse, parse_file
    from videovector_tpu_torch.data.records import convert_dir_or_file
    from videovector_tpu_torch.data.shots import (
        SampledShotsConfig, ShotDataset, TestWindowDataset,
        VideoSampledShotsSource, VideoShotWindowTestSource,
    )
    from videovector_tpu_torch.models.embedding import (
        VideoEmbeddingConfig, VideoEmbeddingModel,
    )
    from videovector_tpu_torch.ops.hopper.matmul import matmul
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train

    card = gpu_name_and_power_limit()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        train_path, test_path = _write_host_stores(tmp)

        # the net, as generate_net.py writes it, and its two data layers
        net = parse(_emit()(train_path, test_path, buffer_size=5000))
        layers = {(l.get("type"), l.get_msg("include").get("phase")): l
                  for l in net.get_list("layers")}
        train_layer = layers["VIDEO_SAMPLED_SHOTS_DATA", "TRAIN"]
        test_layer = layers["VIDEO_SHOT_WINDOW_TEST_DATA", "TEST"]
        solver = SolverConfig.from_message(parse_file(str(SOLVER_PROTOTXT)))
        overrides = dict(max_iter=HOST_STEPS, test_interval=HOST_INTERVAL,
                         snapshot=HOST_STEPS,
                         snapshot_prefix=str(tmp / "flagship"))
        for k, v in overrides.items():
            log(f"  solver override: {k} {getattr(solver, k)!r} -> {v!r}")
        solver = dataclasses.replace(solver, **overrides)
        log(f"  solver from {SOLVER_PROTOTXT.relative_to(ROOT)}: {solver}")

        # graph/data_factory.py's VIDEO_SAMPLED_SHOTS_DATA and
        # VIDEO_SHOT_WINDOW_TEST_DATA branches (the Python sampler)
        p = train_layer.get_msg("video_sampled_shots_data_param")
        scfg = SampledShotsConfig.from_message(p)
        scfg.seed = solver.random_seed if solver.random_seed >= 0 else 1234
        scfg.output_video_ids = len(train_layer.get_list("top")) > 1
        t0 = time.perf_counter()
        dataset = ShotDataset.from_records(convert_dir_or_file(p.get("source")))
        t1 = time.perf_counter()
        sampler = VideoSampledShotsSource(dataset, scfg)
        t2 = time.perf_counter()
        tp = test_layer.get_msg("video_shot_window_test_data_param")
        test_set = TestWindowDataset.from_records(
            convert_dir_or_file(tp.get("source")))
        t3 = time.perf_counter()
        test_source = VideoShotWindowTestSource(
            test_set, int(tp.get("batch_size", 1)),
            include_positives=bool(tp.get("include_positives", True)),
            include_negatives=bool(tp.get("include_negatives", True)),
            display_all_ids=bool(tp.get("display_all_ids", False)))
        log(f"  stores read by the port: training {t1 - t0:.3f} s "
            f"({len(dataset)} videos, {sum(v.num_shots for v in dataset.videos)}"
            f" shots), reservoir filled in {t2 - t1:.3f} s "
            f"({sampler.reservoir.max_size} shots), test {t3 - t2:.3f} s "
            f"({len(test_set.windows)} windows); sampler {scfg}")

        # the model from the net's own numbers (the flagship's defaults)
        fc7 = next(l for l in net.get_list("layers") if l.get("name") == "fc7")
        drop = next(l for l in net.get_list("layers") if l.get("name") == "drop7")
        loss_layer = next(l for l in net.get_list("layers")
                          if l.get("type") == "MAX_MARGIN_LOSS")
        ipp = fc7.get_msg("inner_product_param")
        cfg = VideoEmbeddingConfig(
            feature_dim=dataset.feature_dim, embed_dim=ipp.get("num_output"),
            num_context=scfg.context_size - 1,
            num_negatives=scfg.num_negative_samples,
            margin=loss_layer.get_msg("max_margin_loss_param").get("margin"),
            dropout_rate=drop.get_msg("dropout_param").get("dropout_ratio"),
            weight_std=ipp.get_msg("weight_filler").get("std"))
        if cfg != VideoEmbeddingConfig():
            raise AssertionError(f"the net's model {cfg} is not the flagship's")
        model = VideoEmbeddingModel(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        batch_size = scfg.batch_size
        inner = _flagship_eval_fn(model)
        per_eval = []

        def eval_fn(p, b):
            # the RETRIEVAL_STATS layer casts the float video ids to int32
            before = (matmul.launches, matmul.launches_sm90)
            out = inner(p, {**b, "video_ids": b["video_ids"].to(torch.int32)})
            per_eval.append((matmul.launches - before[0],
                             matmul.launches_sm90 - before[1]))
            return out

        def loss_fn(p, b, generator):
            return model.loss(p, b, generator=generator, train=True)

        timer = _HostFedTimer(HOST_TIMED, HOST_PROFILED)
        data, tests = iter(sampler), timer.tests(test_source)
        torch.cuda.synchronize()
        matmul.launches = matmul.launches_sm90 = 0
        first = train(loss_fn, params, data, solver, device="cuda",
                      batch_axes={"data": 0}, eval_fn=eval_fn,
                      test_data=tests, hooks=[(1, timer.hook)])
        state = tmp / f"flagship_iter_{HOST_STEPS}.vvstate"
        resumed = train(loss_fn, params, data, dataclasses.replace(
            solver, max_iter=HOST_STEPS + HOST_RESUMED), device="cuda",
            batch_axes={"data": 0}, eval_fn=eval_fn, test_data=tests,
            resume_state_path=str(state))
        torch.cuda.synchronize()
        launches = (matmul.launches, matmul.launches_sm90)

    steps = HOST_STEPS + HOST_RESUMED
    n_tests = len(range(0, HOST_STEPS, HOST_INTERVAL))
    losses = [m["loss"] for r in (first, resumed) for _, m in r.metrics_history]
    values = [v for r in (first, resumed) for _, m in r.test_history
              for v in m.values()]
    log(f"  host-fed training: {HOST_STEPS} steps, snapshot {state.name}, "
        f"resumed for {HOST_RESUMED}; iter {first.state['iter']} then "
        f"{resumed.state['iter']}; K1 launches {launches[0]} ({launches[1]} "
        f"sm90) for {steps} steps + {n_tests} test batches; per test batch "
        f"{per_eval}; losses {losses}; test history "
        f"{first.test_history + resumed.test_history}")
    if (first.state["iter"], resumed.state["iter"]) != (HOST_STEPS, steps):
        raise AssertionError("host-fed training: iterations "
                             f"{first.state['iter']}, {resumed.state['iter']}")
    if launches != (steps + n_tests,) * 2 or per_eval != [(1, 1)] * n_tests:
        raise AssertionError(f"host-fed K1 launches {launches}, per eval "
                             f"{per_eval}: expected {steps} + {n_tests}, all sm90")
    w = resumed.params["tower"]["w"]
    if not (losses and all(math.isfinite(v) for v in losses)
            and torch.isfinite(w).all()):
        raise AssertionError(f"host-fed training: losses {losses}, or params "
                             "not finite")
    if len(values) != 3 * n_tests or not all(0.0 <= v <= 1.0 for v in values):
        raise AssertionError(f"host-fed test outputs {values}")

    step_ms, wall_ms = timer.per_step()
    training_profile(timer.prof, len(HOST_PROFILED), wall_ms)
    t0 = time.perf_counter()
    batches = [sampler.next_batch() for _ in range(20)]
    sampler_ms = (time.perf_counter() - t0) / 20 * 1e3
    nbytes = batches[0]["data"].nbytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:10]:
        torch.as_tensor(b["data"], device=dev)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) / 10 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        test_source.next_batch()
    test_ms = (time.perf_counter() - t0) / 5 * 1e3
    neg = cfg.num_negatives
    for line in (
            f"host-fed step at B={batch_size}: {step_ms:.4f} ms (CUDA events "
            f"over {len(HOST_TIMED)} steps, tests excluded) = "
            f"{batch_size * neg / step_ms * 1e3:,.0f} triplets/s",
            f"host-fed step host wall: {wall_ms:.4f} ms",
            f"device-resident step at B={TRAIN_BATCH} (training main path, "
            f"this run): {resident_ms:.4f} ms = "
            f"{TRAIN_BATCH * TRAIN_NEG / resident_ms * 1e3:,.0f} triplets/s",
            f"sampler next_batch: {sampler_ms:.3f} ms a batch (host clock "
            "over 20)",
            f"H2D of one {nbytes / 1e6:.1f} MB batch from pageable memory: "
            f"{h2d_ms:.3f} ms ({nbytes / h2d_ms / 1e6:.2f} GB/s; host clock "
            "over 10)",
            f"test batch host assembly ({TEST_BATCH} windows): {test_ms:.3f} "
            "ms (host clock over 5)"):
        log(f"  {line} [{card}]")
    return {"train": steps, "test": n_tests}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "videovector_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no videovector_tpu_torch/csrc beside {__file__}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from videovector_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    log(f"gpu: {gpu_name_and_power_limit()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    with torch.no_grad():
        stats = kernel_phases(dev, torch.Generator(device=dev).manual_seed(1))
        launches, pipe, params, inputs = slice_phase(dev)
        for pix, hwm in inputs.values():
            device_breakdown(pipe, params, pix, hwm)
    del pipe, params, inputs
    torch.cuda.empty_cache()

    training_parity(dev)
    step_part_times(dev)
    train_launches, resident_ms = training_main_path(dev)
    training_cells(dev)
    eval_launches = eval_through_train(dev)
    torch.cuda.empty_cache()
    host_launches = host_fed_training(dev, resident_ms)
    train_launches += host_launches["train"]
    eval_launches += host_launches["test"]
    torch.cuda.empty_cache()
    with torch.no_grad():
        gallery_eval(dev)

    kernels = [
        {"name": "K1 matmul (TMA + wgmma GEMM, split-K, bias + ReLU "
                 "epilogue)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": launches["K1"], "max_abs_err": stats["K1"]["err"],
         "ms": stats["K1"]["ms"], "plain_ms": stats["K1"]["plain_ms"],
         "bound_ms": stats["K1"]["bound_ms"], "bound_by": "bytes",
         "library_ms": stats["K1"]["library_ms"]},
        {"name": "K1 matmul, the training tower's call (TMA + wgmma GEMM, "
                 "split-K, bias epilogue, f32 out)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": train_launches,
         **{k: stats["K1 train"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
         "max_abs_err": stats["K1 train"]["err"]},
        {"name": "K1 matmul, the test eval's tower call (673 x 4096 x 4096, "
                 "bf16 in, f32 out, bias + ReLU)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": eval_launches,
         **{k: stats["K1 test"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
         "max_abs_err": stats["K1 test"]["err"]},
        {"name": "K2 conv2d_im2col_gemm (implicit-GEMM conv: cp.async "
                 "gathers + TMA + wgmma, one launch per conv)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/conv_gemm_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/conv_gemm.py:18",
         "launches": launches["K2"], "max_abs_err": stats["K2"]["err"],
         "ms": stats["K2"]["ms"], "plain_ms": stats["K2"]["plain_ms"],
         "bound_ms": stats["K2"]["bound_ms"], "bound_by": "operations",
         "library_ms": stats["K2"]["library_ms"]},
        {"name": "K2 space_to_depth (conv1's operands repacked for the sm90 "
                 "route; its time is inside K2's conv1)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/conv_gemm_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/conv_gemm.py:18",
         "launches": launches["repack"], "max_abs_err": stats["repack"]["err"],
         "ms": stats["repack"]["ms"], "plain_ms": stats["repack"]["plain_ms"],
         "bound_ms": stats["repack"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    log("(ms, plain_ms, bound_ms, library_ms: summed over the serving "
        f"path's shapes at batch {BATCH}: K1 fc6 + fc7 + tower with w cycled "
        "beyond L2, library cuBLAS torch.matmul; K2 conv1..conv5, library "
        "cuDNN F.conv2d. K1's training entry: one (1920 x 4096) . (4096 x "
        "4096) call, bf16 in, f32 out, its launches those of the training "
        f"main path, {TRAIN_MAIN_STEPS} steps + 2 remat_tower steps, and of "
        f"the host-fed run, {HOST_STEPS} + {HOST_RESUMED} steps. K1's "
        f"test-eval entry: one ({TEST_BATCH} x 4096) . (4096 x 4096) call "
        "with bias + ReLU, its launches the test evals' in train, drawn on "
        "the card and read from the test store)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - report any failed phase, exit non-zero
        traceback.print_exc()
        sys.exit(1)
