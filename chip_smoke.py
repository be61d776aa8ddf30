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
   bits; and the NHWC max-pool kernel at GoogLeNet's 13 and CaffeNet's 3
   pools (bf16, batch 50), bit-equal to its plain version, against it and
   F.max_pool2d (ceil_mode, the yardstick) and its bytes bound; and the
   NHWC LRN kernel at GoogLeNet's 2 and CaffeNet's 2 LRNs (bf16, batch
   50), within one bf16 step of its plain version run in f32, against its
   plain version, F.local_response_norm (the yardstick) and its bytes
   bound;
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
   and the test batch's assembly are timed beside the device-resident step;
8. trains the same prototxt through the port's graph engine (net_training):
   the port's Net for TRAIN and TEST, the sources from its data factory (the
   C++ sampler it builds from native/vvdata.cpp), train with the Net's
   lr/decay multipliers, 31 steps (test every 10), a snapshot and 5 resumed
   steps, every INNER_PRODUCT one K1 launch on the f32 route; then the
   Net with K1 against its plain version (3 steps each), the bf16 Net
   against the hand-written model's loss and gradients, one step's bias
   update against solver_update with the multipliers, the device-resident
   step in f32 and bf16 and the native-fed one, each profiled, and K1's
   f32 route and its core route on the Net's two shapes, in turns with the
   plain version and torch.matmul, beside the bound, the SM clock sampled
   around each timing;
9. drives the product path's front door (cli_training): generate_net.py's
   net and a copy of the repo's solver prototxt (max_iter 60, a test every
   10, a snapshot at 30) through tools.cli.main: train (the native sampler
   through the prefetcher's pinned copies, every K1 launch on the f32
   route, the step timed and profiled), train --snapshot from iteration 30,
   test on the final weights, time (segmented, then --backward) and
   device_query; then the TRAIN Net with and without the scoring fusion on
   one batch (loss and gradients compared, each device-resident step timed
   and profiled) and the fused Net fed through the prefetcher;
10. extracts features (extraction): generate_extraction_net.py's CaffeNet
   extraction net at batch 50 and a 227 crop (conv1..pool5, fc6 9216 ->
   4096, fc7 4096 -> 4096; f32, as the prototxt states), its IMAGE_DATA
   layer swapped for a DATA layer over a store of 200 seeded 3 x 256 x 256
   frames with a mean file, weights from a .caffemodel of seeded params, all
   written by the port, through tools/extract_features.main (blobs ip2 and
   pool5, 12 batches, vvr): 5 K2 launches a batch on the f32 route with
   conv1's repack and 2 K1 launches on the f32 route, the channels_last
   copies the convs' inputs cost, the stores and text files read back, the
   features against the same Net on the plain versions on the card, the
   bf16 Net (K2 sm90 5 + repack, K1 sm90 2) against them, images/s, the
   forward's time, the host's batch, one profiled window of 2 batches (no
   library GEMM or conv); then K2 at conv1..conv5 at batch 50 on the Net's
   entry, each held against its plain version and run twice for equal
   bits, timed in turns on the f32 route (from NCHW, the channels_last copy
   inside), the core route the Net ran on before the f32 route, the plain
   version and cuDNN f32, beside the bound; and K1's f32 route at fc6 +
   fc7, in turns with its plain version and cuBLAS f32;
11. trains the paper's exhaustive-shots configuration and runs its
   fixed-gallery rank eval (exhaustive_rank_eval) through tools.cli.main:
   generate_net.py's net at B = 128 with its TRAIN data layer swapped for
   VIDEO_SHOTS_DATA (WINDOW, 4 context shots beside the target, 10
   negatives: the same 15 x 4096 roles) and a RETRIEVAL_RANK_STATS added,
   its TEST phase given a FIXED_VIDEO_SHOT_TEST_DATA gallery of 20,000 x
   4096 (written by the port from the host training store), queries and
   gallery through one fc7 (one K1 f32-route launch at 20,673 rows),
   RETRIEVAL_RANK_STATS_FIXED_REF with its csv, an HDF5_OUTPUT and a
   WRITE_TO_FILE; train (40 steps, a test every 20, a snapshot), then test
   on the snapshot: the sinks' files and the rank scalars checked, the
   step, the eval (fc7, the distance product, the argsort) and the host
   feed timed, the card's TRAIN and TEST Nets against the same Nets on the
   CPU on one batch each;
12. puts the rest of the slice's layer types on the card at a classifier's
   width (layer_zoo): fc8 4096 -> 1000 over 256 fc7 rows into the Caffe
   loss zoo, ACCURACY, ARGMAX, CLASSIFICATION_STATS, CONTRASTIVE_LOSS, MVN
   on a 256 x 96 x 27 x 27 blob, ID_TO_WEIGHT_MAPPING and DUMMY_DATA,
   forward and backward on the card and on the CPU (values and gradients
   compared); then, with TF32 on in the process, the regularized
   INNER_PRODUCT, RetrievalPipeline.query and the rank stats' distances
   against their TF32-off runs (tf32_checks), with the LSTM's and the
   trajectory model's products among them;
13. trains ROADMAP item 9's workloads (trajectory): projects/trajectory_forecast
   through tools.cli.main (stores of 400 + 40 windows of 4 tracks written
   by the port's tools/make_tracking_data, generate_net.py's net at its
   defaults: LSTM_ENC_DEC at hidden 32, batch 16, T 8 + 4, the readout on
   K1's core route; a copy of trajectory_solver.prototxt with max_iter 200,
   a test and a snapshot every 100): train (the displayed loss must fall,
   the step timed and profiled), test on the snapshot (equal to train's
   last test) and time; the card against the CPU on the project's Net, on
   a net of the six item-9 types over a TRACKING_WINDOWS_SOCIAL_DATA batch
   and on train over 4 carried batches (values and losses within 1e-4,
   gradients and params within 1e-3 of their largest magnitude); then the
   LSTM enc-dec training step at scripts/bench_lstm_train.py's widths (I =
   H = 512, T = 20 + 10, a 512 -> 512 readout on K1's f32 route, that
   script's solver) at B = 64, 256 and 1024: ms a step, tokens/s, the
   bound, busy and idle share and device operations a step, and the
   readout held against K1's plain version;
14. runs ROADMAP item 1b's stores and Caffe interop (caffe_interop): the
   host stores of step 7 written again by the port's LMDB and LevelDB
   writers and read back bit for bit (seconds and MB/s of each); the
   flagship sampler built by the data factory with one seed over the
   training store in each backend (the VVR one on the Python sampler), its
   first 5 batches bit-equal; generate_net.py's net through tools.cli.main
   with its TRAIN source on the LMDB store and its TEST source on the
   LevelDB store, a copy of the repo's solver with snapshot_format "caffe"
   (40 steps, a test and a snapshot every 20; every INNER_PRODUCT one K1
   launch on the f32 route, the step timed and profiled), then train
   --snapshot from the iteration-20 .solverstate and from the .vvstate
   (equal losses), the .caffemodel's blobs against the .vvmodel's, and test
   on the .caffemodel; VIDEO_SHOT_WINDOW_DATA, the reference's window
   trainer, 10 steps over a LevelDB window store; extraction (as step 10)
   from an LMDB copy of the frame store into vvr, lmdb and leveldb stores
   (the launch counts of each run, the features of the databases bit-equal
   to the vvr run's, images/s); one batch each of HDF5_DATA, FLEXIBLE_DATA
   over LMDB and MEMORY_DATA.

15. runs ROADMAP item 7 (device_negatives): generate_net.py's net with
   `device_negatives: true` (B = 128, 10 negatives from a 5,000 x 4096 f32
   reservoir on the card, swap 50%) over the host training store through
   tools.cli.main (40 steps, a test every 20): the seed buffer bit-equal to
   a host NegativeReservoir fill from the same seed, the host batch (128,
   5, 4096), the first step's negatives distinct reservoir rows per item,
   the accepted offers and the share of rows replaced over 40 steps within
   4 sigma of the swap rate's binomial, one K1 f32-route launch per
   INNER_PRODUCT call; the step (CUDA events) and its profile, the host
   source, the H2D bytes and the sampler's own time, beside the
   Python-sampler-fed step it replaces; then 10 native-fed steps with
   debug_info, display and snapshot_vis every 5 (the [debug_info] lines and
   the vis_iter_*.json files checked);
16. runs ROADMAP item 10's serving path (serving_artifact): the extraction
   net of step 10 frozen by `vvtpu-torch-serve export` as f32, bf16
   (--compute bfloat16), int8 (--quantize int8 --calib_batches 4) and
   symbolic-batch artifacts, `info` on each, each loaded and run: f32
   against the live Net (within 1e-5), bf16 within 2e-2, the int8 fc6 and
   fc7 int32 accumulators against an int64 CPU product (exact), int8
   retrieval mAP / hit@1 / hit@5 within 0.02 of f32's on a class-structured
   batch, the symbolic artifact at 50 and 256 rows; the launches in one call
   of each (f32: K2 f32 5, repack 1, K1 f32 2; bf16: K2 sm90 5, repack 1, K1
   sm90 2; int8: K2 sm90 5, repack 1, no K1), frames/s, bytes and load
   time, and the int8 fc6 + fc7 on torch._int_mm against K1's sm90 route.
17. runs ROADMAP item 11's parallel path (parallel, after device_negatives,
   same stores): a one-rank NCCL mesh (make_mesh(1, 1) starts the group
   from an in-memory store; destroyed after): bench.py's B = 128 step
   through parallel.make_train_step and make_dp_train_step (f32 and bf16
   gradient wire), 3 steps each, the f32 paths bit-equal to the unsharded
   step and the bf16 wire within JAX's bounds, the DP step timed against
   the unsharded one in turns, `vvtpu-torch train --mesh 1` (20 steps on
   the host store) logging the losses of the run without --mesh, the mesh
   and gallery-sharded retrieval engines at 20,000 x 4096 bit-equal to the
   one-device engines; K1 at the ranks' shard shapes (960 x 4096 x 4096 and
   1920 x 4096 x 2048) against its plain version, timed beside cuBLAS and
   the bound; then two spawned gloo ranks sharing the card (joined with a
   timeout): DP 2 x 1 through make_train_step (each step's gradient against
   the unsharded one at the same params and masks; at dropout 0 the params
   against one device's grad_microbatch 2), TP 1 x 2 through
   make_tp_loss_fn, the enc-dec pipeline 1 x 2 at I = H = 512, T = 20 + 10,
   B = 64, 4 microbatches against reference_encdec_loss (3 steps each), and
   the mesh engines; their times are the card time-shared by two
   processes, no scaling numbers.
18. runs ROADMAP item 11b's multi-device serving artifact
   (mesh_serving_artifact, after serving_artifact, same net, .caffemodel
   and artifacts): `vvtpu-torch-serve export --mesh 1x1` on a one-rank
   NCCL mesh, its ip2 bit-equal to the one-device f32 artifact's; then two
   spawned gloo ranks sharing the card each export (`export --mesh`) and
   serve (load_serving, mesh_serving) a 1 x 2 f32 and a 1 x 2 bf16
   artifact (fc6 9216 -> 2048 and fc7 4096 -> 2048 a rank on K1, conv1..5
   whole on K2) and a 2 x 1 --symbolic_batch one (25 rows a rank; at 50
   and 256 global rows), each held against the one-device artifact of its
   kind: the f32 ones within 1e-5 of max|ip2|; the bf16 one within 2e-2
   at the one-device K1 plans and within 1e-5 when the one-device artifact
   runs at the shards' K1 plans (the order of fc6's sums), the launches of one call (f32: K1 f32 2, K2 f32
   5, repack 1; bf16: K1 sm90 2, K2 sm90 5, repack 1), no library GEMM or
   conv in a profiled call, ms a call and frames/s (time-shared, no
   scaling number); then K1 at the shard shapes 50 x 9216 x 2048 and 50 x
   4096 x 2048 in f32 and bf16 against its plain version, timed beside
   torch.mm and the bound.

Exits non-zero, with no result line, without a CUDA card or outside a
checkout. The last line of stdout is {"ok": true, "device": {...}}; the line
before it is the per-kernel JSON summary.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import re
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
POOL_PER_EMBED = 3        # CaffeNet's max pools, one launch each
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
# the prototxt through the graph engine (net_training): 31 steps with tests
# every 10, a snapshot, 5 resumed; the device-resident steps timed over
# iterations 5..24 and profiled over 25..29 (_StepTimer(5, 25, 5))
NET_STEPS = 31
NET_INTERVAL = 10
NET_RESUMED = 5
# the CLI on the flagship solver (cli_training): CLI_STEPS iterations with
# a test every CLI_INTERVAL and a snapshot every CLI_SNAPSHOT, then a resume
# from that snapshot for CLI_RESUMED; the steps timed and profiled in the
# first run; `test` over CLI_TEST_ITERS batches; `time` over CLI_TIME_ITERS
CLI_STEPS = 60
CLI_INTERVAL = 10
CLI_SNAPSHOT = 30
CLI_RESUMED = 5
CLI_TIMED = range(1, 21)
CLI_PROFILED = range(21, 26)
CLI_TEST_ITERS = 4
CLI_TIME_ITERS = 10
# the H100 SXM's published f32 peak outside the tensor cores (K1's f32
# route and its core route at f32 run on FFMA)
PEAK_FLOPS_F32 = 67e12
# the TRAIN net's INNER_PRODUCT rows: B x (1 target + 4 context + 10 negatives)
NET_ROWS = TRAIN_BATCH * (1 + 4 + TRAIN_NEG)
# the extraction cell (extraction): generate_extraction_net.py's CaffeNet
# extraction net at batch BATCH and a 227 crop, its IMAGE_DATA layer swapped
# for a DATA layer over a store of EXTRACT_ITEMS seeded 3 x 256 x 256 uint8
# frames, f32 as the prototxt states, EXTRACT_BATCHES batches of the blobs
# EXTRACT_BLOBS through tools/extract_features.main
GENERATE_EXTRACTION_NET = (ROOT / "projects/videovec_embedding/"
                           "generate_extraction_net.py")
EXTRACT_ITEMS = 200
EXTRACT_SIDE = 256
EXTRACT_CROP = 227
EXTRACT_BATCHES = 12
EXTRACT_BLOBS = ("ip2", "pool5")
# launches per f32 batch: K2 on its f32 route, one per conv, and conv1's
# space-to-depth repack, K1 on its f32 route (fc6, fc7); per bf16 batch,
# (all, sm90, repack, f32) of K2 and (all, sm90, f32) of K1: K2 sm90 5 +
# conv1's repack, K1 sm90 2
K2_F32_PER_BATCH = 5
K2_REPACK_PER_BATCH = 1
K1_PER_EXTRACT_BATCH = 2
EXTRACT_BF16_K2 = (5, 5, 1, 0)
EXTRACT_BF16_K1 = (2, 2, 0)
EXTRACT_FC = ((9216, 4096), (4096, 4096))     # fc6, fc7: (K, N)
# the exhaustive-shots cell (exhaustive_rank_eval): _exhaustive_net's
# prototxt (VIDEO_SHOTS_DATA over the host training store, the fixed
# gallery beside the test windows) through the CLI, EXH_STEPS steps with a
# test every EXH_INTERVAL, timed over EXH_TIMED and profiled over
# EXH_PROFILED; the gallery holds EXH_GALLERY_PER_VIDEO rows for each of
# the TEST_VIDEOS videos of the test windows
EXH_STEPS = 40
EXH_INTERVAL = 20
EXH_TIMED = range(1, 16)
EXH_PROFILED = range(16, 19)
EXH_GALLERY_PER_VIDEO = 200
EXH_GALLERY_ROWS = TEST_VIDEOS * EXH_GALLERY_PER_VIDEO
# the layer-zoo cell (layer_zoo): CaffeNet's classifier width, fc8 over
# ZOO_BATCH fc7 rows into ZOO_CLASSES, MVN on CaffeNet's pool1 at ZOO_BATCH
ZOO_BATCH = 256
ZOO_CLASSES = 1000
ZOO_POOL1 = (ZOO_BATCH, 96, 27, 27)
# card vs CPU, relative to the largest magnitude, for the zoo's values and
# gradients: the H100 run reads at most 1.8e-7 and 1.5e-6 (PERF.md), and
# TF32 rounding (~5e-4) lies far past it
ZOO_TOL = 1e-5
# the trajectory cells (trajectory): projects/trajectory_forecast through
# the CLI at generate_net.emit's defaults (hidden 32, batch 16, T 8 + 4)
# over 400 + 40 windows of 4 tracks, and the LSTM enc-dec step at
# scripts/bench_lstm_train.py's widths (I = H = 512, T = 20 + 10)
TRAJ_PROJECT = ROOT / "projects/trajectory_forecast"
TRAJ_WINDOWS = (400, 40)
TRAJ_STEPS = 200
TRAJ_INTERVAL = 100
TRAJ_TEST_ITERS = 5        # the project's solver's test_iter
TRAJ_TIMED = range(1, 81)
TRAJ_PROFILED = range(81, 91)
ENCDEC_WIDTH = 512
ENCDEC_T = (20, 10)
ENCDEC_BATCHES = (64, 256, 1024)
ENCDEC_WARMUP, ENCDEC_TIMED, ENCDEC_PROFILED = 5, 20, 3
ENCDEC_SOLVER = dict(base_lr=0.001, momentum=0.9, weight_decay=5e-4,
                     lr_policy="fixed")
# card vs CPU for item 9's nets: values and losses relative to their
# largest magnitude, gradients and trained params too
TRAJ_VALUE_TOL = 1e-4
TRAJ_GRAD_TOL = 1e-3
# the Caffe-interop cell (caffe_interop): the host stores written again as
# LMDB and LevelDB; INTEROP_SAMPLER_BATCHES batches of the flagship sampler
# from each backend; generate_net.py's net trained through the CLI from the
# LMDB store, INTEROP_STEPS steps, a test every INTEROP_INTERVAL and a
# snapshot_format "caffe" snapshot every INTEROP_SNAPSHOT, timed over
# INTEROP_TIMED and profiled over INTEROP_PROFILED, then resumed from the
# .solverstate and from the .vvstate; the window trainer
# (VIDEO_SHOT_WINDOW_DATA) WINDOW_STEPS steps over a LevelDB window store of
# TEST_BATCH windows with a reservoir of WINDOW_RESERVOIR shots; extraction
# from an LMDB copy of the frame store into each backend
INTEROP_SAMPLER_BATCHES = 5
INTEROP_STEPS = 40
INTEROP_INTERVAL = 20
INTEROP_SNAPSHOT = 20
INTEROP_TIMED = range(1, 16)
INTEROP_PROFILED = range(16, 19)
WINDOW_STEPS = 10
WINDOW_RESERVOIR = 500
# K1's timings cycle through copies of w that together exceed the H100's
# 50 MB L2 by this factor, so that each call reads its weights from HBM as
# it does on the path (fc6, fc7 and the tower evict each other there)
L2_BYTES = 50 * 2**20
L2_EXCESS = 2.5


# the on-device negative sampler through the CLI (device_negatives)
DN_STEPS = 40
DN_INTERVAL = 20
DN_TIMED = range(1, 16)
DN_PROFILED = range(16, 19)
DN_PY_STEPS = 12           # the Python-sampler-fed run it replaces
DN_PY_TIMED = range(2, 10)
DN_SWAP = 50.0
DN_BUFFER = 5000
DN_CONTEXT = 5             # target + 4 context shots, the host's channels
DEBUG_STEPS = 10
DEBUG_EVERY = 5
# the serving artifacts (serving_artifact)
SERVE_VARIANTS = (("f32", []), ("bf16", ["--compute", "bfloat16"]),
                  ("int8", ["--quantize", "int8", "--calib_batches", "4"]),
                  ("symbolic", ["--symbolic_batch"]))
SERVE_SYMBOLIC_BATCHES = (BATCH, 256)
SERVE_CLASSES = 10
SERVE_TIMED = 10
QUANT_METRIC_TOL = 0.02    # JAX's contract, tests/test_quantize.py
PEAK_OPS_INT8 = 1979e12




def _tally():
    """`timer.tally()`: collects what `count` adds in its block (the
    kernels' launch counters among it)."""
    from videovector_tpu_torch.utils import timer
    return timer.tally()


def _got(counts, *names) -> tuple:
    """The counters `vvtpu.<name>` of a tally, 0 where absent."""
    return tuple(counts.get("vvtpu." + n, 0) for n in names)


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


def time_in_turns(fns: dict, args: list) -> tuple[dict, list]:
    """Each of three fns timed by `time_graph_ms` over `args` in turns (the
    first, second, third, then back), against drift: the mean of each
    one's two turns, and the six turns."""
    order = (*fns, *reversed(fns))
    t = [time_graph_ms(fns[k], args, iters=20) for k in order]
    return {k: (t[i] + t[len(order) - 1 - i]) / 2
            for i, k in enumerate(fns)}, t


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


def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
            rel: float | None = None) -> float:
    """Max abs error of got vs ref; raises past `rel` x max|ref| (by default
    the dtype's tolerance)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    tol = (REL_TOL[ref.dtype] if rel is None else rel) * scale
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
        with _tally() as counts:
            got = run(ws[0])
        err = compare(f"K1 {name} {m}x{k}x{n}", got, plain(ws[0]))
        if _got(counts, "k1.sm90_launches") != (1,):
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
            with _tally() as counts:
                got = run()
            if _got(counts, "k2.launches", "k2.sm90_launches") != (1, 1):
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


def _pool_cases():
    """tests/torch_pool_cases.py (the serving path's 16 max pools and the
    bit comparison), loaded from its file."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_pool_cases", ROOT / "tests" / "torch_pool_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pool_phase(dev, gen) -> dict:
    """The NHWC max-pool kernel (csrc/max_pool_nhwc.cu) at the serving
    path's 16 pools, bf16 at batch 50: bit-equal to its plain version (a
    -inf F.pad + aten's max_pool2d) and from one call to the next, then
    timed by CUDA-graph replay in turns with the plain version and
    F.max_pool2d with ceil_mode (aten alone, timed only as the yardstick),
    beside its bound (input read and output written once at HBM's rate).
    Then one GoogLeNet forward at batch 50 (random weights, bf16), whose
    pool launches are counted and checked to be its 13. Returns the sums
    over GoogLeNet's 13 pools and over CaffeNet's 3, the largest
    |kernel - plain| over each net's pools, and the forward's launches."""
    from videovector_tpu_torch.models.googlenet import GoogLeNet
    from videovector_tpu_torch.ops import pooling
    cases = _pool_cases()
    out = {net: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "library_ms": 0.0} for net in ("googlenet", "caffenet")}
    log(f"max-pool kernel at the serving path's pools (NHWC bf16, batch "
        f"{BATCH}; device time a call from CUDA graphs over two inputs, in "
        "turns: kernel, plain, F.max_pool2d(ceil_mode), twice; bound: input "
        f"and output bytes once at {PEAK_BYTES / 1e12:.2f} TB/s):")
    for case in cases.GEOMETRIES:
        hwc, kernel, stride, pad = cases.pool_args(case)
        xs = [torch.randn((BATCH, *hwc), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        with _tally() as counts:
            got = pooling.max_pool_nhwc(xs[0], kernel, stride, pad)
        if _got(counts, "max_pool.launches") != (1,):
            raise AssertionError(f"max pool {case[0]}: not one launch")
        want = pooling.max_pool_nhwc_plain(xs[0], kernel, stride, pad)
        aten = torch.nn.functional.max_pool2d(
            xs[0].permute(0, 3, 1, 2), kernel, stride, pad,
            ceil_mode=True).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if not (cases.same_bits(got, want) and cases.same_bits(
                pooling.max_pool_nhwc(xs[0], kernel, stride, pad), got)):
            raise AssertionError(f"max pool {case[0]}: kernel differs from "
                                 "plain, or between two calls")
        net = case[0].split("-")[0]
        out[net]["err"] = max(out[net]["err"], (got.float() - want.float())
                              .abs().max().item())
        fns = {"kernel": lambda x: pooling.max_pool_nhwc(x, kernel, stride,
                                                         pad),
               "plain": lambda x: pooling.max_pool_nhwc_plain(
                   x, kernel, stride, pad),
               "aten": lambda x: torch.nn.functional.max_pool2d(
                   x.permute(0, 3, 1, 2), kernel, stride, pad,
                   ceil_mode=True)}
        ms, t = time_in_turns(fns, xs)
        nbytes = (xs[0].numel() + got.numel()) * 2
        bound = nbytes / PEAK_BYTES * 1e3
        for key, v in (("ms", ms["kernel"]), ("plain_ms", ms["plain"]),
                       ("library_ms", ms["aten"]), ("bound_ms", bound)):
            out[net][key] += v
        log(f"  {case[0]} {hwc} k{kernel[0]} s{stride[0]} p{pad[0]}: kernel "
            f"{ms['kernel']:.4f} ms ({nbytes / ms['kernel'] / 1e6:.0f} GB/s, "
            f"{bound / ms['kernel']:.3f} of the bound {bound:.4f}), plain "
            f"{ms['plain']:.4f}, F.max_pool2d {ms['aten']:.4f} (same shape "
            f"{tuple(aten.shape) == tuple(got.shape)}; equal bits, turns "
            f"{', '.join(f'{v:.4f}' for v in t)})")
    for net, v in out.items():
        log(f"  {net}'s pools together: kernel {v['ms']:.4f} ms, bound "
            f"{v['bound_ms']:.4f} ({v['bound_ms'] / v['ms']:.3f} of it), "
            f"plain {v['plain_ms']:.4f}, F.max_pool2d {v['library_ms']:.4f}, "
            f"max_abs_err {v['err']:.3e}")
    net = GoogLeNet()
    params = net.init(torch.Generator(device=dev).manual_seed(3))
    images = torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
    with _tally() as counts:
        net.forward(params, images)
    torch.cuda.synchronize()
    (out["googlenet"]["launches"],) = _got(counts, "max_pool.launches")
    log(f"  a GoogLeNet forward at batch {BATCH}: "
        f"{out['googlenet']['launches']} pool launches")
    if out["googlenet"]["launches"] != 13:
        raise AssertionError("a GoogLeNet forward launched the pool kernel "
                             f"{out['googlenet']['launches']} times, not 13")
    return out


# the serving path's LRNs (size 5, alpha 1e-4, beta 0.75) at a 224 and a
# 227 crop: net, name, (H, W, C)
LRN_SHAPES = (("googlenet", "norm1", (56, 56, 64)),
              ("googlenet", "norm2", (56, 56, 192)),
              ("caffenet", "norm1", (27, 27, 96)),
              ("caffenet", "norm2", (13, 13, 256)))
LRN_PER_EMBED = 2         # CaffeNet's LRNs, one launch each
# the query's top-k selection: (rows, gallery rows) of the f32 scores, the
# serve cells' (the 1M gallery's and the 20k one's), and k
TOPK_SHAPES = ((BATCH, 1_000_000), (BATCH, GALLERY_ROWS))
TOP_K = 5


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in bf16 steps (signed
    zeros equal)."""
    def key(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max().item())


def lrn_phase(dev, gen) -> dict:
    """The NHWC LRN kernel (csrc/lrn_nhwc.cu) at the serving path's four
    LRNs, bf16 at batch 50: within one bf16 step of the plain version run
    in f32 and rounded once, within bf16's tolerance of the plain version
    in bf16 (the chain the kernel replaced) and the same bits from one call
    to the next; then timed by CUDA-graph replay in turns with the plain
    version and F.local_response_norm on the NCHW view (aten alone, timed
    only as the yardstick), beside its bound (x read and y written once at
    HBM's rate). Then one GoogLeNet forward at batch 50, whose LRN calls and
    launches are counted and checked to be its 2 (CaffeNet's, 2 an embed,
    are checked on the main path). Returns the sums over each net's two
    LRNs, their largest step from the f32 version and |kernel - plain|, and
    GoogLeNet's launches."""
    import torch.nn.functional as F

    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.models.googlenet import GoogLeNet
    from videovector_tpu_torch.ops import lrn
    out = {net: {"err": 0.0, "steps": 0, "ms": 0.0, "plain_ms": 0.0,
                 "bound_ms": 0.0, "library_ms": 0.0}
           for net in ("googlenet", "caffenet")}
    log(f"LRN kernel at the serving path's LRNs (NHWC bf16, batch {BATCH}, "
        "size 5, alpha 1e-4, beta 0.75; device time a call from CUDA graphs "
        "over two inputs, in turns: kernel, plain, F.local_response_norm, "
        "twice; bound: input and output bytes once at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s):")
    for net, name, hwc in LRN_SHAPES:
        xs = [(torch.randn((BATCH, *hwc), generator=gen, device=dev) * 40)
              .to(torch.bfloat16) for _ in range(2)]
        with _tally() as counts:
            got = lrn.lrn_nhwc(xs[0])
        if _got(counts, "lrn.calls", "lrn.launches") != (1, 1):
            raise AssertionError(f"lrn {net} {name}: not one launch")
        once = lrn.lrn_nhwc_plain(xs[0].float()).to(torch.bfloat16)
        with plain_versions():
            plain = lrn.lrn_nhwc(xs[0])
        steps = bf16_steps(got, once)
        if steps > 1 or not torch.equal(lrn.lrn_nhwc(xs[0]), got):
            raise AssertionError(f"lrn {net} {name}: {steps} bf16 steps from "
                                 "the f32 version, or two calls differ")
        err = compare(f"lrn {net} {name} against the bf16 chain", got, plain)
        out[net]["err"] = max(out[net]["err"], err)
        out[net]["steps"] = max(out[net]["steps"], steps)
        fns = {"kernel": lrn.lrn_nhwc, "plain": lrn.lrn_nhwc_plain,
               "library": lambda x: F.local_response_norm(
                   x.permute(0, 3, 1, 2), 5, alpha=1e-4, beta=0.75)}
        ms, t = time_in_turns(fns, xs)
        nbytes = 2 * xs[0].numel() * 2
        bound = nbytes / PEAK_BYTES * 1e3
        for key, v in (("ms", ms["kernel"]), ("plain_ms", ms["plain"]),
                       ("library_ms", ms["library"]), ("bound_ms", bound)):
            out[net][key] += v
        log(f"  {net} {name} {hwc}: kernel {ms['kernel']:.4f} ms "
            f"({nbytes / ms['kernel'] / 1e6:.0f} GB/s, "
            f"{bound / ms['kernel']:.3f} of the bound {bound:.4f}), plain "
            f"{ms['plain']:.4f}, F.local_response_norm {ms['library']:.4f}; "
            f"{steps} bf16 steps from the f32 version (turns "
            f"{', '.join(f'{v:.4f}' for v in t)})")
    for net, v in out.items():
        log(f"  {net}'s two LRNs together: kernel {v['ms']:.4f} ms, bound "
            f"{v['bound_ms']:.4f} ({v['bound_ms'] / v['ms']:.3f} of it), "
            f"plain {v['plain_ms']:.4f}, F.local_response_norm "
            f"{v['library_ms']:.4f}, max_abs_err against the bf16 chain "
            f"{v['err']:.3e}")
    net = GoogLeNet()
    params = net.init(torch.Generator(device=dev).manual_seed(3))
    images = torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
    with _tally() as counts:
        net.forward(params, images)
    torch.cuda.synchronize()
    calls, out["googlenet"]["launches"] = _got(counts, "lrn.calls",
                                               "lrn.launches")
    log(f"  a GoogLeNet forward at batch {BATCH}: {calls} LRN calls, "
        f"{out['googlenet']['launches']} launches")
    if (calls, out["googlenet"]["launches"]) != (2, 2):
        raise AssertionError(f"a GoogLeNet forward made {calls} LRN calls "
                             f"and {out['googlenet']['launches']} launches, "
                             "not 2 and 2")
    return out


def topk_phase(dev, gen) -> dict:
    """The per-row top-k selection kernel (csrc/top_k_rows.cu) at the
    serving query's f32 scores, k 5: 50 x 1,000,000 (the 1M gallery) and
    50 x 20,000: values and indices against the stable sort
    (`top_k_stable_plain`, the plain version), one launch a call, then
    timed by CUDA-graph replay in turns with the sort and torch.topk (the
    library's yardstick only: the port never calls it, as it promises no
    order at ties), beside its bound (the scores read once at HBM's rate).
    Returns, by shape, the times, the largest |kernel - sort| of a value
    and the indices that differ."""
    from videovector_tpu_torch.models import retrieval_pipeline as rp
    out = {}
    log(f"top-k selection at the query's scores (f32, k {TOP_K}; device "
        "time a call from CUDA graphs over two inputs, in turns: kernel, "
        "stable sort, torch.topk, twice; bound: the scores read once at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s):")
    for rows, cols in TOPK_SHAPES:
        xs = [torch.randn((rows, cols), generator=gen, device=dev)
              for _ in range(2)]
        with _tally() as counts:
            got = rp.top_k_stable(xs[0], TOP_K)
        if _got(counts, "topk.calls", "topk.launches") != (1, 1):
            raise AssertionError(f"top-k {rows} x {cols}: not one launch")
        want = rp.top_k_stable_plain(xs[0], TOP_K)
        torch.cuda.synchronize()
        mismatches = int((got[1] != want[1]).sum())
        err = float((got[0] - want[0]).abs().max())
        if mismatches or err:
            raise AssertionError(f"top-k {rows} x {cols}: {mismatches} "
                                 f"indices differ, values by {err}")
        fns = {"kernel": lambda x: rp.top_k_stable(x, TOP_K),
               "plain": lambda x: rp.top_k_stable_plain(x, TOP_K),
               "library": lambda x: torch.topk(x, TOP_K, dim=-1)}
        ms, t = time_in_turns(fns, xs)
        nbytes = rows * cols * 4
        bound = nbytes / PEAK_BYTES * 1e3
        out[(rows, cols)] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                             "library_ms": ms["library"], "bound_ms": bound,
                             "err": err, "mismatches": mismatches}
        log(f"  {rows} x {cols}: kernel {ms['kernel']:.4f} ms "
            f"({nbytes / ms['kernel'] / 1e6:.0f} GB/s, "
            f"{bound / ms['kernel']:.3f} of the bound {bound:.4f}), stable "
            f"sort {ms['plain']:.4f}, torch.topk {ms['library']:.4f}; "
            f"max_abs_err {err:.1e}, {mismatches} indices differ (turns "
            f"{', '.join(f'{v:.4f}' for v in t)})")
        del xs
    return out


I3D_FRAMES = 250          # one whole clip, as the benchmark's I3D cell


def _i3d_calls(dev):
    """One 250-frame clip (uint8, 256 x 256, one crop and mirror) served
    through RetrievalPipeline(backbone="i3d").query at 224 (random weights,
    BatchNorm folded, bf16) against a 20,000-row gallery, three times with
    the same inputs: eagerly with its convs and pools recorded, then
    captured and replayed, then replayed. Returns (the eager call's
    features, [(conv args, kwargs)], [(pool args, kwargs)], the counters of
    the eager call and of the last replay)."""
    from videovector_tpu_torch.models import i3d
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    convs, pools = [], []
    conv, pool = i3d.conv3d_gemm_ndhwc, i3d.max_pool

    def conv_rec(x, w, b=None, **kw):
        convs.append(((x.shape, w, b), kw))
        return conv(x, w, b, **kw)

    def pool_rec(x, **kw):
        pools.append((x.shape, kw))
        return pool(x, **kw)
    gen = torch.Generator(device=dev).manual_seed(6)
    pipe = RetrievalPipeline(RetrievalPipelineConfig(
        backbone="i3d", crop=224, embed_dim=1024), device=dev)
    params = pipe.init(gen)
    gallery = torch.nn.functional.normalize(
        torch.randn((GALLERY_ROWS, 1024), generator=gen, device=dev), dim=1)
    ids = torch.arange(GALLERY_ROWS, dtype=torch.int32, device=dev)
    clip = (torch.randint(0, 256, (I3D_FRAMES, 256, 256, 3), generator=gen,
                          device=dev, dtype=torch.uint8),
            torch.tensor([13], device=dev), torch.tensor([21], device=dev),
            torch.tensor([True], device=dev))
    answers, counts = [], []
    for turn in range(3):
        if turn == 0:
            i3d.conv3d_gemm_ndhwc, i3d.max_pool = conv_rec, pool_rec
        try:
            with _tally() as c:
                answers.append(pipe.query(params, *clip, gallery, ids))
            torch.cuda.synchronize()
        finally:
            i3d.conv3d_gemm_ndhwc, i3d.max_pool = conv, pool
        counts.append(c)
        if turn == 0:
            feats = pipe.features.clone()
    replays = [c.get("vvtpu.query.graph_replays", 0) for c in counts]
    if replays != [0, 1, 1] or not all(
            torch.equal(a, b) for a, b in zip(answers[0], answers[2])):
        raise AssertionError(f"I3D's query replays {replays}, or a replay's "
                             "answer differs from the eager one")
    return feats, convs, pools, counts[0], counts[2]


def i3d_phase(dev, gen) -> dict:
    """I3D's kernels at one 250-frame clip (bf16): the launches of one
    query through RetrievalPipeline, eager and replayed (57 K2 on the sm90
    route, 20 of them deep, one 3D repack, none on the core; 13 pools, 11
    deep); then each conv's K2 call, on inputs of its shape, against its
    plain version (within one bf16 step; the depth route's 20 and the 2D
    route's 37 apart) and each pool's against its plain version (equal
    bits), timed by CUDA-graph replay in turns with the plain version and
    one PyTorch call (cuDNN's F.conv3d, F.max_pool3d) beside its bound
    (the larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s, each
    input, weight and output byte once). Returns the sums by kind, each
    with its launches a query."""
    from videovector_tpu_torch.ops import pooling
    from videovector_tpu_torch.ops.hopper import conv_gemm as k2
    import torch.nn.functional as F
    feats, convs, pools, eager, replay = _i3d_calls(dev)
    names = ("k2.launches", "k2.sm90_launches", "k2.f32_launches",
             "k2.depth_launches", "s2d.launches", "max_pool.launches",
             "max_pool.depth_launches")
    launches = _got(eager, *names)
    log(f"I3D query at {I3D_FRAMES} frames, eager: K2 {launches[0]} "
        f"launches ({launches[1]} sm90, {launches[2]} f32, {launches[3]} "
        f"deep), repack {launches[4]}, pools {launches[5]} ({launches[6]} "
        f"deep); a replay counts {_got(replay, *names)}; features "
        f"{tuple(feats.shape)} finite {bool(torch.isfinite(feats).all())}")
    if launches != (57, 57, 0, 20, 1, 13, 11) or (
            _got(replay, *names) != launches):
        raise AssertionError(f"I3D query launches {launches}, a replay's "
                             f"{_got(replay, *names)}")
    k2_all, _, _, deep, _, pool_all, pool_deep = _got(replay, *names)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    out = {kind: dict.fromkeys(keys, 0.0) | {"err": 0.0, "n": 0,
                                             "launches": n}
           for kind, n in (("depth", deep), ("flat", k2_all - deep),
                           ("pool_deep", pool_deep),
                           ("pool_flat", pool_all - pool_deep))}
    log("I3D's convs (kernel, plain, cuDNN F.conv3d on the padded NCDHW "
        "view; device ms a call by CUDA-graph replay in turns):")
    for (shape, w, b), kw in convs:
        stride, pad = kw["stride"], kw["pad"]
        xs = [torch.randn(shape, generator=gen, device=dev).abs()
              .to(torch.bfloat16) for _ in range(2)]
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        flat = [v for p in reversed(pad) for v in p]
        fns = {"kernel": lambda x: k2.conv3d_gemm_ndhwc(x, w, b, **kw),
               "plain": lambda x: k2.conv3d_gemm_ndhwc_plain(x, w, b, **kw),
               "library": lambda x: F.conv3d(
                   F.pad(x.permute(0, 4, 1, 2, 3), flat), wt, b.to(w.dtype),
                   stride=stride)}
        got = fns["kernel"](xs[0])
        err = compare(f"  conv {tuple(w.shape)} over {tuple(shape)}", got,
                      fns["plain"](xs[0]))
        ms, _ = time_in_turns(fns, xs)
        oshape = got.shape
        taps = w.shape[0] * w.shape[1] * w.shape[2]
        ops = 2.0 * got.numel() * taps * w.shape[3]
        nbytes = (xs[0].numel() + w.numel() + got.numel()) * 2 + b.numel() * 4
        bound = max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        kind = "depth" if w.shape[0] > 1 else "flat"
        for key, v in (("ms", ms["kernel"]), ("plain_ms", ms["plain"]),
                       ("library_ms", ms["library"]), ("bound_ms", bound)):
            out[kind][key] += v
        out[kind]["err"] = max(out[kind]["err"], err)
        out[kind]["n"] += 1
        log(f"    -> {tuple(oshape)}: kernel {ms['kernel']:.4f} ms, "
            f"{bound / ms['kernel']:.3f} of its bound {bound:.4f}, plain "
            f"{ms['plain']:.4f}, F.conv3d {ms['library']:.4f}")
    log("I3D's pools (kernel, plain, F.max_pool3d on the -inf padded NCDHW "
        "view):")
    for shape, kw in pools:
        window, stride, pad = kw["kernel"], kw["stride"], kw["pad"]
        xs = [torch.randn(shape, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        flat = [v for p in reversed(pad) for v in p]
        fns = {"kernel": lambda x: pooling.max_pool(x, **kw),
               "plain": lambda x: pooling.max_pool_ndhwc_plain(
                   x, window, stride, pad),
               "library": lambda x: F.max_pool3d(F.pad(
                   x.permute(0, 4, 1, 2, 3), flat, value=-math.inf),
                   tuple(window), tuple(stride))}
        got = fns["kernel"](xs[0])
        torch.cuda.synchronize()
        if not torch.equal(got, fns["plain"](xs[0])):
            raise AssertionError(f"I3D pool {window} over {tuple(shape)}: "
                                 "kernel differs from plain")
        ms, _ = time_in_turns(fns, xs)
        bound = (xs[0].numel() + got.numel()) * 2 / PEAK_BYTES * 1e3
        kind = "pool_deep" if window[0] > 1 else "pool_flat"
        for key, v in (("ms", ms["kernel"]), ("plain_ms", ms["plain"]),
                       ("library_ms", ms["library"]), ("bound_ms", bound)):
            out[kind][key] += v
        out[kind]["n"] += 1
        log(f"  pool {tuple(window)}/{tuple(stride)} over {tuple(shape)}: "
            f"kernel {ms['kernel']:.4f} ms, {bound / ms['kernel']:.3f} of "
            f"its bound {bound:.4f}, plain {ms['plain']:.4f}, F.max_pool3d "
            f"{ms['library']:.4f} (equal bits)")
    for kind, v in out.items():
        log(f"  I3D's {v['n']} {kind} together ({v['launches']} launches a "
            f"query): kernel {v['ms']:.4f} ms, "
            f"bound {v['bound_ms']:.4f} ({v['bound_ms'] / v['ms']:.3f} of "
            f"it), plain {v['plain_ms']:.4f}, library {v['library_ms']:.4f}, "
            f"max_abs_err {v['err']:.3e}")
    return out


TIMESFORMER_FRAMES = 96   # one whole clip, as the benchmark's TimeSformer cell


def _timesformer_calls(dev, gen):
    """One 96-frame clip (uint8, 256 x 256, one crop and mirror) served
    through RetrievalPipeline(backbone="timesformer").query at 224 (the
    benchmark's draws, linear weights cast to bf16 once) against a
    20,000-row gallery, three times with the same inputs: eager, captured
    and replayed, replayed. Returns (pipe, params, clip, the eager call's
    counters, the last replay's)."""
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    from vvbench.drivers import serve_timesformer
    cfg = json.loads((ROOT / "vvbench" / "configs"
                      / "timesformer-l-retrieval.json").read_text())
    pipe = RetrievalPipeline(RetrievalPipelineConfig(
        backbone="timesformer", crop=224, embed_dim=768), device=dev)
    drawn = serve_timesformer.make_params(gen, cfg, dev)
    params = {"timesformer": pipe.timesformer.cast_weights(
        drawn["timesformer"]), "tower": drawn["tower"]}
    del drawn
    gallery = torch.nn.functional.normalize(
        torch.randn((GALLERY_ROWS, 768), generator=gen, device=dev), dim=1)
    ids = torch.arange(GALLERY_ROWS, dtype=torch.int32, device=dev)
    clip = (torch.randint(0, 256, (TIMESFORMER_FRAMES, 256, 256, 3),
                          generator=gen, device=dev, dtype=torch.uint8),
            torch.tensor([13], device=dev), torch.tensor([21], device=dev),
            torch.tensor([True], device=dev))
    answers, counts = [], []
    for _ in range(3):
        with _tally() as c:
            answers.append(pipe.query(params, *clip, gallery, ids))
        torch.cuda.synchronize()
        counts.append(c)
    replays = [c.get("vvtpu.query.graph_replays", 0) for c in counts]
    if replays != [0, 1, 1] or not all(
            torch.equal(a, b) for a, b in zip(answers[0], answers[2])):
        raise AssertionError(f"TimeSformer's query replays {replays}, or a "
                             "replay's answer differs from the eager one")
    return pipe, params, (clip, gallery, ids), counts[0], counts[2]


def _device_time_by_name(fn, calls: int = 5, top: int = 14) -> list:
    """fn() `calls` times under torch.profiler: the device ms a call of each
    kernel name (the `top` largest), and the whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            sec = (e.time_range.end - e.time_range.start) / 1e3 / calls
            by_name[e.name] = by_name.get(e.name, 0.0) + sec
    total = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [("all", total)] + rows


def timesformer_phase(dev, gen) -> dict:
    """TimeSformer-L's kernels at one 96-frame clip (bf16): the launches of
    one query through RetrievalPipeline, eager and replayed (86 K1 on the
    sm90 route, 12 of them with GELU, 24 attention launches, 12 a kind, no
    byte copied to lay out the attention's sequences); the attention
    kernel for each kind at the published shapes against its plain version
    (the token rows and, for the spatial kind, the class query's f32
    outputs that the class mean reads) and timed by CUDA-graph replay in
    turns with the plain version and F.scaled_dot_product_attention (the
    library's yardstick only, on q, k and v already laid out as (sequence,
    head, token, 64): the port never calls it), beside its bound (q, k and
    v read once and the output written once at 3.35 TB/s); K1's GELU at
    fc1's 18,816 x 768 x 3,072 likewise beside torch.mm + F.gelu; the whole
    backbone's forward by CUDA-graph replay; and a replayed query's device
    time by kernel name (where a clip's time goes). Returns the times and
    the eager query's launches of each kind and of K1 with GELU."""
    import torch.nn.functional as F

    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.ops import attention as ta
    from videovector_tpu_torch.ops.hopper import matmul as k1
    pipe, params, (clip, gallery, ids), eager, replay = _timesformer_calls(
        dev, gen)
    names = ("k1.launches", "k1.sm90_launches", "k1.gelu_launches",
             "attn.launches", "attn.temporal_launches",
             "attn.spatial_launches", "attn.layout_bytes")
    launches = _got(eager, *names)
    log(f"TimeSformer query at {TIMESFORMER_FRAMES} frames, eager: K1 "
        f"{launches[0]} launches ({launches[1]} sm90, {launches[2]} GELU), "
        f"attention {launches[3]} ({launches[4]} temporal, {launches[5]} "
        f"spatial), attention layout bytes {launches[6]}; a replay counts "
        f"{_got(replay, *names)}; features "
        f"{tuple(pipe.features.shape)} finite "
        f"{bool(torch.isfinite(pipe.features).all())}")
    if launches != (86, 86, 12, 24, 12, 12, 0) or (
            _got(replay, *names) != launches):
        raise AssertionError(f"TimeSformer query launches {launches}, a "
                             f"replay's {_got(replay, *names)}")
    out = {}
    log("TimeSformer's attention (kernel, plain, F.scaled_dot_product_"
        "attention on pre-laid q, k, v; device ms a call by CUDA-graph "
        "replay in turns; bound: q, k, v read and the output written once "
        f"at {PEAK_BYTES / 1e12:.2f} TB/s):")
    for kind, rows, seqs in (
            ("temporal", 196 * 96, ta.Sequences.temporal(1, 196, 96)),
            ("spatial", 196 * 96 + 1, ta.Sequences.spatial(1, 196, 96))):
        xs = [torch.randn((rows, 3 * 768), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        idx = seqs.token_rows(dev)
        if seqs.extra:
            idx = torch.cat([seqs.extra_rows(dev)[:, None], idx], dim=1)

        def laid(x, idx=idx):
            q, k, v = x[idx].view(idx.shape[0], idx.shape[1], 3, 12,
                                  64).permute(2, 0, 3, 1, 4)
            return q.contiguous(), k.contiguous(), v.contiguous()
        lib_in = [laid(x) for x in xs]
        got = ta.attention(xs[0], 12, seqs)
        with plain_versions():
            want = ta.attention(xs[0], 12, seqs)
        held = seqs.token_rows(dev).reshape(-1)
        err = compare(f"  {kind}: {seqs.sequences} x 12 sequences of "
                      f"{idx.shape[1]}", got[0][held], want[0][held])
        if seqs.extra:
            # the class query's f32 outputs, whose mean over the frames the
            # served class row reads: bf16 operands and probabilities
            compare(f"  {kind}: the class query's {seqs.sequences} x 12 "
                    "outputs (f32)", got[1], want[1], rel=1e-2)
        fns = {"kernel": lambda i: ta.attention(xs[i], 12, seqs),
               "plain": lambda i: ta.attention_plain(xs[i], 12, seqs,
                                                     0.125),
               "library": lambda i: F.scaled_dot_product_attention(
                   *lib_in[i])}
        ms, t = time_in_turns(fns, [0, 1])
        nbytes = rows * 3 * 768 * 2 + 196 * 96 * 768 * 2
        bound = nbytes / PEAK_BYTES * 1e3
        out[kind] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                     "library_ms": ms["library"], "bound_ms": bound,
                     "err": err, "launches": launches[4 if kind ==
                                                      "temporal" else 5]}
        rate = nbytes / ms["kernel"] / 1e6
        log(f"    kernel {ms['kernel']:.4f} ms ({rate:.0f} GB/s, "
            f"{bound / ms['kernel']:.3f} of the bound "
            f"{bound:.4f}), plain {ms['plain']:.4f}, sdpa "
            f"{ms['library']:.4f} (turns {', '.join(f'{v:.4f}' for v in t)})")
        del xs, lib_in
    m, k, n = 196 * 96, 768, 3072
    xs = [torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(2)]
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(
        torch.bfloat16)
    b = torch.randn(n, generator=gen, device=dev) * 0.05
    got = k1.matmul(xs[0], w, b, fuse_gelu=True, out_dtype=torch.bfloat16)
    with plain_versions():
        want = k1.matmul(xs[0], w, b, fuse_gelu=True,
                         out_dtype=torch.bfloat16)
    err = compare(f"  K1 GELU {m} x {k} x {n}", got, want)
    fns = {"kernel": lambda x: k1.matmul(x, w, b, fuse_gelu=True,
                                         out_dtype=torch.bfloat16),
           "plain": lambda x: k1.matmul_plain(x, w, b, fuse_gelu=True,
                                              out_dtype=torch.bfloat16),
           "library": lambda x: F.gelu(torch.addmm(b.to(x.dtype), x, w))}
    ms, t = time_in_turns(fns, xs)
    ops, nbytes = 2.0 * m * k * n, (m * k + k * n + m * n) * 2 + n * 4
    bound = max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    out["k1_gelu"] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                      "library_ms": ms["library"], "bound_ms": bound,
                      "err": err, "launches": launches[2]}
    log(f"  K1 GELU (fc1): kernel {ms['kernel']:.4f} ms, "
        f"{bound / ms['kernel']:.3f} of its bound {bound:.4f} (operations), "
        f"plain {ms['plain']:.4f}, torch.addmm + F.gelu {ms['library']:.4f}")
    del xs
    x = pipe.transform(clip[0], clip[1].expand(96), clip[2].expand(96),
                       clip[3].expand(96)).reshape(1, 96, 224, 224, 3)
    fwd = time_graph_ms(lambda a: pipe.timesformer.forward(
        params["timesformer"], a), [x], iters=5)
    out["backbone_ms"] = fwd
    log(f"  TimeSformer-L's forward at one 96-frame clip: {fwd:.3f} ms a "
        "clip (CUDA-graph replay)")
    rows = _device_time_by_name(
        lambda: pipe.query(params, *clip, gallery, ids))
    out["by_name"] = rows
    log("  a replayed query's device time by kernel name (ms a query):")
    for name, ms_ in rows:
        log(f"    {ms_:.4f}  {name[:110]}")
    return out


def frames(rng, n):
    return rng.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)


def slice_phase(dev):
    from videovector_tpu_torch.data.transformer import (
        TransformConfig, sample_transform_params,
    )
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )

    cfg = RetrievalPipelineConfig()
    mean = np.full((3, 256, 256), 110, np.float32)
    pipe = RetrievalPipeline(cfg, mean=mean, device=dev)
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

    # the main path, counted: gallery build, then the queries (the offsets
    # are host arrays, so every query runs eagerly)
    t0 = time.perf_counter()
    with _tally() as counts:
        gal, ids = pipe.build_gallery(
            params, [(v, h, w, m) for v in videos],
            [np.full(BATCH, i) for i in range(len(videos))])
        gallery = torch.cat([gal, torch.as_tensor(pad, device=dev)])
        gallery_ids = torch.cat([ids, torch.as_tensor(pad_ids, device=dev)])
        results = [pipe.query(params, videos[q], h, w, m, gallery,
                              gallery_ids) for q in range(N_QUERIES)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(zip(("K1", "K2", "repack", "pool", "lrn", "topk"), _got(
        counts, "k1.launches", "k2.launches", "s2d.launches",
        "max_pool.launches", "lrn.launches", "topk.launches")))
    k1_sm90, k2_sm90 = _got(counts, "k1.sm90_launches", "k2.sm90_launches")
    n_embed = len(videos) + N_QUERIES
    log(f"main path: {len(videos)} gallery batches + {N_QUERIES} queries of "
        f"{BATCH} frames in {seconds:.3f} s (host clock, first calls "
        f"included); launches {launches}, on the sm90 routes: K1 "
        f"{k1_sm90}, K2 {k2_sm90}")
    expect = {"K1": K1_PER_EMBED * n_embed, "K2": K2_PER_EMBED * n_embed,
              "repack": n_embed, "pool": POOL_PER_EMBED * n_embed,
              "lrn": LRN_PER_EMBED * n_embed, "topk": N_QUERIES}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if k1_sm90 != launches["K1"]:
        raise AssertionError(f"{launches['K1'] - k1_sm90} K1 "
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
    with plain_versions():
        ref = pipe.embed_frames(params, videos[0], h, w, m)
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

        def ref_run():
            with plain_versions():
                return pipe.embed_frames(params, pix, hb, wb, mb)
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
    library = sorted(n for n in by_name if _is_library_kernel(n))
    busy = sum(by_name.values())

    def share(*keys):
        return sum(v for n, v in by_name.items() if any(s in n for s in keys))
    # K1: the sm90 or f32 route's GEMM and split-K reduction, or the core
    # (MatGeom)
    k1_gemm = share("gemm_tma_wgmma", "f32sm90::gemm_f32", "vv::MatGeom")
    k1_reduce = share("splitk_reduce")
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


def _train(cfg, params, batch, steps, *, gm=1, hooks=None,
           display=0, data=None, test_interval=0, eval_fn=None,
           test_data=None):
    """`steps` iterations of solver.train.train on the card through the
    entry point a user calls, bench.py's solver, role-major data; with
    eval_fn, one test batch every `test_interval` iterations."""
    from videovector_tpu_torch.models.embedding import VideoEmbeddingModel
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train
    model = VideoEmbeddingModel(cfg)

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
    from videovector_tpu_torch.device import plain_versions
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH, dropout_rate=0.0)
    runs = {}
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            res = _train(cfg, params, batch, 3, display=1,
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
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH)
    timer = _StepTimer(5, 25, profiled=5)
    steps = TRAIN_MAIN_STEPS
    torch.cuda.synchronize()
    with _tally() as counts:
        res = _train(cfg, params, batch, steps, hooks=[(1, timer.hook)])
    torch.cuda.synchronize()
    launches = dict(zip(("K1", "K1 sm90"), _got(counts, "k1.launches",
                                                 "k1.sm90_launches")))
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
    with _tally() as counts:
        _train(cfg_r, params_r, batch_r, 2)
    torch.cuda.synchronize()
    remat = _got(counts, "k1.launches", "k1.sm90_launches")
    if remat != (4, 4):
        raise AssertionError(f"remat_tower: K1 launches {remat[0]} "
                             f"({remat[1]} sm90), expected 4")
    log("remat_tower: 2 steps, 4 K1 launches (the forward recomputed in "
        "backward), all sm90")
    return launches["K1"] + 4, ms


def training_profile(prof, steps: int, wall_ms: float,
                     label: str = f"B={TRAIN_BATCH}") -> dict:
    """Device time by kernel per step over the profiled steps, the idle
    share against the unprofiled host wall, and the check that the tower
    forward's (1920 x 4096) . (4096 x 4096) product never went to a library
    GEMM: the only cuBLAS products are the weight gradient's and the
    scoring block's. Returns the per-step device busy ms, H2D ms and
    device operations ({} if the profiler saw no device events)."""
    by_name: dict[str, float] = {}
    n_device_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_device_ops += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / steps)
    if not by_name:
        log("training profile: no device events (breakdown not measured)")
        return {}
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
             if any(s in n for s in ("gemm_tma_wgmma", "f32sm90::gemm_f32",
                                     "splitk_reduce", "vv::MatGeom"))) / 1e3
    library = sum(v for n, v in by_name.items()
                  if any(s in n.lower() for s in ("cublas", "xmma", "cutlass",
                                                  "gemm", "sm90_"))
                  and "vv::" not in n and "gemm_tma_wgmma" not in n) / 1e3
    log(f"training profile over {steps} steps at {label}, per step: "
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
    return {"busy_ms": busy, "h2d_ms": h2d, "ops": n_device_ops / steps}


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
    steps = 4
    for batch, gm in ((1024, 1), (1024, 8), (8192, 64)):
        cfg, params, data = _train_setup(dev, batch)
        timer = _StepTimer(1, 3)
        with _tally() as counts:
            _train(cfg, params, data, steps, gm=gm, hooks=[(1, timer.hook)])
        torch.cuda.synchronize()
        launched = _got(counts, "k1.launches", "k1.sm90_launches")
        if launched != (steps * gm,) * 2:
            raise AssertionError(
                f"training B={batch} gm={gm}: K1 launches {launched[0]} "
                f"({launched[1]} sm90), expected {steps * gm}")
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
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.metrics import retrieval_stats
    from videovector_tpu_torch.models.embedding import VideoEmbeddingModel
    from videovector_tpu_torch.ops.hopper.matmul import matmul
    steps, interval = 10, 5
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH)
    windows = _test_windows(dev, torch.Generator(device=dev).manual_seed(5), 2)
    model = VideoEmbeddingModel(cfg)
    inner = _flagship_eval_fn(model)
    per_eval = []

    def eval_fn(p, b):
        with _tally() as counts:
            out = inner(p, b)
        per_eval.append(_got(counts, "k1.launches", "k1.sm90_launches"))
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
        with plain_versions():
            ref = model.extract(p, w["data"])
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


def _emit(path: Path = GENERATE_NET):
    """A project's generate_net.py's emit (by default the embedding
    project's), loaded from its file (the module imports argparse only; the
    embedding one's main, which imports the JAX package, is not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("generate_net", path)
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
        if not self.profiled:
            return
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

    def marked(self, batches):
        """The batches of an iterator, a mark where each is asked for."""
        while True:
            self._mark(None)
            yield next(batches)

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


def host_fed_training(dev, resident_ms: float, stores: tuple) -> dict:
    """The flagship trained from its host plane through the port's entry
    points: stores written (`stores`, _write_host_stores) and read by the
    port, the net and solver parsed by it, the sources built from them as the JAX package's data factory
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
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train

    card = gpu_name_and_power_limit()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        train_path, test_path = stores

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
            names = ("k1.launches", "k1.sm90_launches")
            before = _got(counts, *names)
            out = inner(p, {**b, "video_ids": b["video_ids"].to(torch.int32)})
            per_eval.append(tuple(
                a - b for a, b in zip(_got(counts, *names), before)))
            return out

        def loss_fn(p, b, generator):
            return model.loss(p, b, generator=generator, train=True)

        timer = _HostFedTimer(HOST_TIMED, HOST_PROFILED)
        data, tests = iter(sampler), timer.tests(test_source)
        torch.cuda.synchronize()
        with _tally() as counts:
            first = train(loss_fn, params, data, solver, device="cuda",
                          batch_axes={"data": 0}, eval_fn=eval_fn,
                          test_data=tests, hooks=[(1, timer.hook)])
            state = tmp / f"flagship_iter_{HOST_STEPS}.vvstate"
            resumed = train(loss_fn, params, data, dataclasses.replace(
                solver, max_iter=HOST_STEPS + HOST_RESUMED), device="cuda",
                batch_axes={"data": 0}, eval_fn=eval_fn, test_data=tests,
                resume_state_path=str(state))
        torch.cuda.synchronize()
        launches = _got(counts, "k1.launches", "k1.sm90_launches")

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


def _net_message(train_path: str, test_path: str, *, dropout=None):
    """generate_net.py's net for the two stores, parsed by the port; with
    `dropout`, every DROPOUT layer's ratio rewritten (as JAX's
    tests/test_embedding_model.py does for its engine-vs-model check)."""
    from videovector_tpu_torch.config import parse
    msg = parse(_emit()(train_path, test_path, buffer_size=5000))
    if dropout is not None:
        for layer in msg.get_list("layers"):
            if layer.get("type") == "DROPOUT":
                layer.get_msg("dropout_param").fields["dropout_ratio"] = [dropout]
    return msg


def _net_loss_fn(net):
    """The TRAIN net as train's loss_fn: the loss, and every element of
    every net output as a train metric (the JAX SolverDriver's aux)."""
    def loss_fn(p, b, generator):
        loss, outs = net.apply(p, b, generator=generator)
        return loss, {k: v.reshape(-1) for k, v in outs.items()}
    return loss_fn


def _smi_clocks() -> str:
    """nvidia-smi's reading of the SM clock, its maximum, the temperature
    and the power draw."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def _k1_f32_times(dev) -> dict:
    """K1 with f32 operands at the Net's two INNER_PRODUCT shapes, (1920 x
    4096) . (4096 x 4096) for TRAIN and (673 x 4096) . (4096 x 4096) for
    TEST, bias epilogue, f32 out: the f32 route and the core route (the
    same x copied 4 bytes past 16-byte alignment, which TMA cannot
    address) held against the plain version, then timed by CUDA-graph
    replay over copies of w beyond L2, in turns with the plain version and
    torch.matmul (cuBLAS f32, TF32 off, a yardstick only), beside the bound
    (operations at the f32 FMA peak); nvidia-smi's SM clock, temperature
    and power draw read before and after each timing."""
    from videovector_tpu_torch.ops.hopper import matmul as k1
    card = gpu_name_and_power_limit()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for rows in (NET_ROWS, TEST_BATCH):
        k = n = 4096
        x = torch.randn((rows, k), generator=gen, device=dev)
        x_core = torch.empty(x.numel() + 4, device=dev)[1:1 + x.numel()] \
            .view(rows, k).copy_(x)
        b = torch.randn(n, generator=gen, device=dev)
        ws = [torch.randn((k, n), generator=gen, device=dev) * 0.02
              for _ in range(max(2, math.ceil(L2_EXCESS * L2_BYTES / (k * n * 4))))]
        routes = (k1.k1_route(x, ws[0], torch.float32),
                  k1.k1_route(x_core, ws[0], torch.float32))
        if routes != ("f32", "core"):
            raise AssertionError(f"K1 {rows}x{k}x{n} f32: routes {routes}")
        ref = k1.matmul_plain(x, ws[0], b)
        err = compare(f"K1 f32 route {rows}x{k}x{n}", k1.matmul(x, ws[0], b), ref)
        core_err = compare(f"K1 core route f32 {rows}x{k}x{n}",
                           k1.matmul(x_core, ws[0], b), ref)
        fns = {"f32": lambda w: k1.matmul(x, w, b),
               "core": lambda w: k1.matmul(x_core, w, b),
               "plain": lambda w: k1.matmul_plain(x, w, b),
               "cublas": lambda w: torch.matmul(x, w)}
        times = {name: [] for name in fns}
        clocks = []
        for name in ("plain", "f32", "core", "cublas", "cublas", "core",
                     "f32", "plain"):
            before = _smi_clocks()
            times[name].append(time_graph_ms(fns[name], ws))
            clocks.append(f"{name} {times[name][-1]:.4f} ms: {before} -> "
                          f"{_smi_clocks()}")
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        flops = 2 * rows * k * n
        nbytes = (rows * k + k * n + n + rows * n) * 4
        t_ops, t_bytes = flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES
        bound = max(t_ops, t_bytes) * 1e3
        out[rows] = {"err": err, "core_err": core_err, "ms": ms["f32"],
                     "core_ms": ms["core"], "plain_ms": ms["plain"],
                     "library_ms": ms["cublas"], "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"  K1 f32 {rows}x{k}x{n} [{card}]: f32 route {ms['f32']:.4f} ms "
            f"({flops / ms['f32'] / 1e9:.1f} TFLOP/s, {bound / ms['f32']:.3f} "
            f"of the bound; plan {k1.k1_f32_plan(rows, n, k, sms)}), core "
            f"route {ms['core']:.4f} ms ({bound / ms['core']:.3f}), plain "
            f"{ms['plain']:.4f} ms, cuBLAS f32 (TF32 off) {ms['cublas']:.4f} "
            f"ms, bound {bound:.4f} ms ({out[rows]['bound_by']}, "
            f"{PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s f32); in turns, with "
            "nvidia-smi's clocks.sm, clocks.max.sm, temperature.gpu, "
            "power.draw before -> after each:")
        for line in clocks:
            log(f"    {line}")
    return out


def net_training(dev, resident_ms: float, stores: tuple) -> dict:
    """generate_net.py's prototxt through the port's graph engine: the Net
    for TRAIN and TEST, the sources from the port's data factory (the C++
    sampler for the VVR WINDOW store), train with the Net's lr/decay
    multipliers (a snapshot and a resume), every INNER_PRODUCT one K1
    launch on the f32 route. Then the checks against the plain version,
    the hand-written model and solver_update, and the timings. Returns the
    main path's K1 launches and K1's f32 and core-route stats."""
    import dataclasses

    from videovector_tpu_torch.config import parse_file
    from videovector_tpu_torch.data.native import NativeSampledShotsSource
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.graph.data_factory import (
        MergedSource, make_data_source,
    )
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    from videovector_tpu_torch.solver import (
        SolverConfig, init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import (
        iteration_seed, train, value_and_grad,
    )

    card = gpu_name_and_power_limit()
    msg = _net_message(*stores)
    solver = SolverConfig.from_message(parse_file(str(SOLVER_PROTOTXT)))
    # the seed the JAX SolverDriver gives the sources and the fillers
    seed = solver.random_seed if solver.random_seed >= 0 else 1234
    t0 = time.perf_counter()
    train_net, test_net = Net(msg, "TRAIN"), Net(msg, "TEST")

    def sources(net, phase, s):
        return MergedSource([make_data_source(l, phase=phase, seed=s)
                             for l in net.layers
                             if l.get("type") in DATA_LAYER_TYPES])
    train_src = sources(train_net, "TRAIN", seed)
    test_src = sources(test_net, "TEST", seed + 1)
    sampler = train_src.sources[0].source
    t1 = time.perf_counter()
    try:
        if not isinstance(sampler, NativeSampledShotsSource):
            raise AssertionError(f"the TRAIN source is {type(sampler).__name__}, "
                                 "not the native sampler")
        batch0, test0 = train_src.next_batch(), test_src.next_batch()
        params, _ = train_net.init(torch.Generator(device=dev).manual_seed(seed),
                                   batch0)
        test_net.init(torch.Generator(device=dev).manual_seed(seed), test0)
        lr, decay = train_net.param_multipliers()
        t2 = time.perf_counter()
        if (lr, decay) != ({"fc7": {"w": 1.0, "b": 2.0}},
                           {"fc7": {"w": 1.0, "b": 0.0}}):
            raise AssertionError(f"the Net's multipliers {lr}, {decay}")
        log(f"  the Net: TRAIN {len(train_net.layers)} layers, TEST "
            f"{len(test_net.layers)}; sources from the data factory in "
            f"{t1 - t0:.3f} s (TRAIN {type(sampler).__name__}, seed {seed}), "
            f"first batches and init on the card {t2 - t1:.3f} s; params "
            f"{ {k: {n: tuple(v.shape) for n, v in d.items()} for k, d in params.items()} }, "
            f"lr_mults {lr}, decay_mults {decay}")
        out = _net_main_path(dev, train_net, test_net, params, lr, decay, solver,
                             itertools.chain([batch0], train_src), test_src,
                             card)
        t0 = time.perf_counter()
        for _ in range(20):
            sampler.next_batch()
        native_ms = (time.perf_counter() - t0) / 20 * 1e3
    finally:
        sampler.close()
    log(f"  native sampler next_batch: {native_ms:.3f} ms a batch (host "
        f"clock over 20) [{card}]")

    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch0.items()}
    quiet = dataclasses.replace(solver, test_interval=0, snapshot=0,
                                snapshot_prefix="")
    loss_fn = _net_loss_fn(train_net)

    # the multipliers act: one step's update of fc7/b through train equals
    # solver_update's with lr_mult 2 and decay_mult 0
    one = dataclasses.replace(quiet, max_iter=1, display=0)
    stepped = train(loss_fn, params, iter([batch]), one, lr_mults=lr,
                    decay_mults=decay, device="cuda")
    g = torch.Generator(device=dev).manual_seed(
        iteration_seed(max(solver.random_seed, 0), 0))
    _, grads = value_and_grad(loss_fn)(params, batch, g)
    fresh = init_solver_state(one, params)
    want, _ = solver_update(one, params, grads, fresh,
                            lr_mults={"fc7": {"w": 1.0, "b": 2.0}},
                            decay_mults={"fc7": {"w": 1.0, "b": 0.0}})
    unit, _ = solver_update(one, params, grads, fresh)
    b0 = params["fc7"]["b"]
    err = (stepped.params["fc7"]["b"] - want["fc7"]["b"]).abs().max().item()
    upd = (want["fc7"]["b"] - b0).abs().max().item()
    off = (unit["fc7"]["b"] - want["fc7"]["b"]).abs().max().item()
    log(f"  multipliers: one step's fc7/b update through train vs "
        f"solver_update(lr_mult 2, decay_mult 0): max|diff| {err:.3e} against "
        f"max|update| {upd:.3e}; without multipliers it would differ by "
        f"{off:.3e}")
    if not (err <= 1e-6 * upd and off > 1e-3 * upd):
        raise AssertionError(f"multipliers: {err}, {upd}, {off}")

    net_parity(dev, msg, params, batch, quiet)
    net_vs_hand_model(dev, stores, out["params"], batch)

    for dtype in ("float32", "bfloat16"):
        net = train_net if dtype == "float32" else Net(
            msg, "TRAIN", compute_dtype=dtype)
        if dtype == "bfloat16":
            net.init(torch.Generator(device=dev).manual_seed(seed), batch0)
        timer = _StepTimer(5, 25, profiled=5)
        torch.cuda.synchronize()
        with _tally() as tallied:
            res = train(_net_loss_fn(net), params, itertools.repeat(batch),
                        dataclasses.replace(quiet, max_iter=TRAIN_MAIN_STEPS),
                        lr_mults=lr, decay_mults=decay, device="cuda",
                        batch_axes={"data": 0}, hooks=[(1, timer.hook)])
        torch.cuda.synchronize()
        sm90 = TRAIN_MAIN_STEPS if dtype == "bfloat16" else 0
        counts = _got(tallied, "k1.launches", "k1.sm90_launches", "k1.f32_launches")
        if counts != (TRAIN_MAIN_STEPS, sm90, TRAIN_MAIN_STEPS - sm90):
            raise AssertionError(f"resident Net {dtype}: K1 launches (all, "
                                 f"sm90, f32) {counts}")
        if not torch.isfinite(res.params["fc7"]["w"]).all():
            raise AssertionError(f"resident Net {dtype}: params not finite")
        ms = timer.ms_per_step()
        wall = timer.wall_s / (timer.stop - timer.start) * 1e3
        enqueue = timer.enqueue_s / (timer.stop - timer.start) * 1e3
        log(f"  Net device-resident step at B={TRAIN_BATCH}, {dtype} "
            f"operands (K1 {'sm90' if sm90 else 'f32'} route): {ms:.4f} ms "
            f"(CUDA events over {timer.stop - timer.start} steps) = "
            f"{TRAIN_BATCH * TRAIN_NEG / ms * 1e3:,.0f} triplets/s; host wall "
            f"{wall:.4f} ms a step, {enqueue:.4f} ms to enqueue it [{card}]")
        training_profile(timer.prof, timer.profiled, wall)
    log(f"  hand-written model's device-resident step at B={TRAIN_BATCH} "
        f"(bf16, training main path, this run): {resident_ms:.4f} ms = "
        f"{TRAIN_BATCH * TRAIN_NEG / resident_ms * 1e3:,.0f} triplets/s "
        f"[{card}]")
    out["k1"] = _k1_f32_times(dev)
    return out


def _net_main_path(dev, train_net, test_net, params, lr, decay, solver, data,
                   test_src, card) -> dict:
    """The counted main path: NET_STEPS steps fed by the native sampler,
    tests every NET_INTERVAL, a snapshot, NET_RESUMED resumed steps."""
    import dataclasses
    import tempfile

    from videovector_tpu_torch.solver.train import train
    per_eval = []
    names = ("k1.launches", "k1.sm90_launches", "k1.f32_launches")

    def eval_fn(p, b):
        before = _got(counts, *names)
        _, outs = test_net.apply(p, b)
        per_eval.append(tuple(
            a - b for a, b in zip(_got(counts, *names), before)))
        return outs
    loss_fn = _net_loss_fn(train_net)
    timer = _HostFedTimer(HOST_TIMED, HOST_PROFILED)
    tests = timer.tests(test_src)
    with tempfile.TemporaryDirectory() as tmp_name:
        cfg = dataclasses.replace(
            solver, max_iter=NET_STEPS, test_interval=NET_INTERVAL,
            snapshot=NET_STEPS, snapshot_prefix=str(Path(tmp_name) / "net"))
        kw = dict(lr_mults=lr, decay_mults=decay, device="cuda",
                  batch_axes={"data": 0}, eval_fn=eval_fn, test_data=tests)
        torch.cuda.synchronize()
        with _tally() as counts:
            first = train(loss_fn, params, data, cfg,
                          hooks=[(1, timer.hook)], **kw)
            state = Path(tmp_name) / f"net_iter_{NET_STEPS}.vvstate"
            resumed = train(loss_fn, params, data, dataclasses.replace(
                cfg, max_iter=NET_STEPS + NET_RESUMED),
                resume_state_path=str(state), **kw)
        torch.cuda.synchronize()
        launches = _got(counts, *names)

    steps = NET_STEPS + NET_RESUMED
    n_tests = len(range(0, NET_STEPS, NET_INTERVAL))
    losses = [m["loss"] for r in (first, resumed) for _, m in r.metrics_history]
    values = [v for r in (first, resumed) for _, m in r.test_history
              for v in m.values()]
    log(f"  Net training: {NET_STEPS} steps, snapshot {state.name}, resumed "
        f"for {NET_RESUMED}; iter {first.state['iter']} then "
        f"{resumed.state['iter']}; K1 launches {launches[0]} ({launches[1]} "
        f"sm90, {launches[2]} f32) for {steps} steps + {n_tests} test "
        f"batches; per test batch (all, sm90, f32) {per_eval}; losses "
        f"{losses}; test history "
        f"{first.test_history + resumed.test_history}")
    if (first.state["iter"], resumed.state["iter"]) != (NET_STEPS, steps):
        raise AssertionError("Net training: iterations "
                             f"{first.state['iter']}, {resumed.state['iter']}")
    if launches != (steps + n_tests, 0, steps + n_tests) or \
            per_eval != [(1, 0, 1)] * n_tests:
        raise AssertionError(f"Net K1 launches {launches}, per eval "
                             f"{per_eval}: expected {steps} + {n_tests}, all "
                             "on the f32 route")
    w = resumed.params["fc7"]["w"]
    if not (losses and all(math.isfinite(v) for v in losses)
            and torch.isfinite(w).all()):
        raise AssertionError(f"Net training: losses {losses}, or params "
                             "not finite")
    if len(values) != 3 * n_tests or not all(0.0 <= v <= 1.0 for v in values):
        raise AssertionError(f"Net test outputs {values}")
    step_ms, wall_ms = timer.per_step()
    log(f"  Net native-fed step at B={TRAIN_BATCH} (f32, K1 f32 route): "
        f"{step_ms:.4f} ms (CUDA events over {len(HOST_TIMED)} steps, tests "
        f"excluded) = {TRAIN_BATCH * TRAIN_NEG / step_ms * 1e3:,.0f} "
        f"triplets/s; host wall {wall_ms:.4f} ms a step [{card}]")
    training_profile(timer.prof, len(HOST_PROFILED), wall_ms)
    return {"launches": launches[0], "f32": launches[2],
            "params": resumed.params}


def net_parity(dev, msg, params, batch, quiet) -> None:
    """Three steps of the f32 Net with K1 and three with K1's plain version
    (inside `plain_versions()`), the same params, batch and dropout masks:
    losses within 1e-3 relative, params within 2e-2 of the largest update
    (the tolerances of the hand-written step's K1-vs-plain check)."""
    import dataclasses

    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.solver.train import train
    runs = {}
    for plain in (False, True):
        net = Net(msg, "TRAIN")
        net.init(torch.Generator(device=dev).manual_seed(0), batch)
        lr, decay = net.param_multipliers()
        with plain_versions() if plain else contextlib.nullcontext():
            res = train(_net_loss_fn(net), params, iter([batch] * 3),
                        dataclasses.replace(quiet, max_iter=3, display=1),
                        lr_mults=lr, decay_mults=decay, device="cuda")
        runs[plain] = (res.params["fc7"], [m["loss"] for _, m in
                                           res.metrics_history])
    (pk, lk), (pp, lp) = runs[False], runs[True]
    dw = (pp["w"] - params["fc7"]["w"]).abs().max().item()
    db = (pp["b"] - params["fc7"]["b"]).abs().max().item()
    errs = {k: (pk[k] - pp[k]).abs().max().item() for k in ("w", "b")}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"  Net, 3 steps at B={TRAIN_BATCH} (f32, dropout 0.9, the same "
        f"masks), K1 vs plain: losses {lk} vs {lp} (max rel err "
        f"{loss_err:.2e}, tol 1e-3); max|w_K1 - w_plain| {errs['w']:.3e} "
        f"against max|dw| {dw:.3e}, max|b_K1 - b_plain| {errs['b']:.3e} "
        f"against max|db| {db:.3e} (tol 2e-2 of each)")
    if len(lk) != 3 or not all(math.isfinite(v) for v in lk):
        raise AssertionError(f"Net parity losses {lk}")
    if not loss_err <= 1e-3:
        raise AssertionError(f"Net loss K1 vs plain: {loss_err} > 1e-3")
    if not (errs["w"] <= 2e-2 * dw and errs["b"] <= 2e-2 * db):
        raise AssertionError(f"Net params K1 vs plain: {errs}, updates "
                             f"{dw}, {db}")


def net_vs_hand_model(dev, stores, params, batch) -> None:
    """The Net with bf16 operands (K1's sm90 route) against the hand-written
    VideoEmbeddingModel.loss, dropout rewritten to 0, on the same params and
    batch: loss within 1e-4 relative (JAX's bound for the same check,
    tests/test_embedding_model.py) and fc7's gradients within 1e-4 of their
    largest magnitude, where the weight gradient may also differ by one
    bf16 step (2**-7 of its value at most): both round an f32 sum to bf16,
    and the two f32 sums, taken through differently written scoring heads,
    can straddle a rounding boundary."""
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.models.embedding import (
        VideoEmbeddingConfig, VideoEmbeddingModel,
    )
    net = Net(_net_message(*stores, dropout=0.0), "TRAIN",
              compute_dtype="bfloat16")
    net.init(torch.Generator(device=dev).manual_seed(0), batch)
    model = VideoEmbeddingModel(VideoEmbeddingConfig(
        feature_dim=batch["data"].shape[-1],
        embed_dim=params["fc7"]["w"].shape[1], dropout_rate=0.0))
    p_net = {"fc7": {k: v.detach().clone().requires_grad_()
                     for k, v in params["fc7"].items()}}
    p_hand = {"tower": {k: v.detach().clone().requires_grad_()
                        for k, v in params["fc7"].items()}}
    with torch.enable_grad(), _tally() as counts:
        l_net = net.loss_fn(p_net, batch)
        l_hand, _ = model.loss(p_hand, batch, train=True)
        l_net.backward()
        l_hand.backward()
    torch.cuda.synchronize()
    if _got(counts, "k1.sm90_launches") != (2,):
        raise AssertionError("Net vs hand model: not one sm90 K1 launch each")
    loss_err = abs(l_net.item() - l_hand.item()) / abs(l_hand.item())
    gw, rw = p_net["fc7"]["w"].grad, p_hand["tower"]["w"].grad
    gb, rb = p_net["fc7"]["b"].grad, p_hand["tower"]["b"].grad
    w_scale, b_scale = rw.abs().max().item(), rb.abs().max().item()
    dw = (gw - rw).abs()
    w_excess = (dw - 1e-4 * w_scale - 2.0**-7 * rw.abs()).max().item()
    b_err = (gb - rb).abs().max().item()
    log(f"  Net (bf16, sm90) vs VideoEmbeddingModel.loss, dropout 0: loss "
        f"{l_net.item():.7f} vs {l_hand.item():.7f} (rel err {loss_err:.2e}, "
        f"tol 1e-4); fc7 dW max|diff| {dw.max().item():.3e} against max|dW| "
        f"{w_scale:.3e}, {int((dw > 1e-4 * w_scale).sum())} of {dw.numel()} "
        f"elements past 1e-4 of it (each within one bf16 step: "
        f"{w_excess <= 0}), relative L2 {dw.norm().item() / rw.norm().item():.2e}; "
        f"db max|diff| {b_err:.3e} against max|db| {b_scale:.3e}")
    if not (loss_err <= 1e-4 and w_excess <= 0 and b_err <= 1e-4 * b_scale):
        raise AssertionError(f"Net vs hand model: loss {loss_err}, dW excess "
                             f"{w_excess}, db {b_err} (scale {b_scale})")


class _CliCapture(logging.Handler):
    """The port's log records while a CLI command runs."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __enter__(self):
        logging.getLogger("videovector_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("videovector_tpu_torch").removeHandler(self)

    def emit(self, record):
        self.records.append(record)

    def lines(self, *prefixes) -> list[str]:
        out = [r.getMessage() for r in self.records]
        return [l for l in out if l.startswith(prefixes)] if prefixes else out


def _cli_solver(path: Path, net_path: Path, prefix: Path, *,
                template: Path = SOLVER_PROTOTXT, **fields) -> Path:
    """A copy of a solver prototxt of the repo (by default the embedding
    project's) with `net` pointed at net_path, `snapshot_prefix` at prefix
    and `fields` set; every other line as it is."""
    fields = {"net": f'"{net_path}"', "snapshot_prefix": f'"{prefix}"',
              **{k: str(v) for k, v in fields.items()}}
    lines = []
    for line in template.read_text().splitlines():
        key = line.split(":")[0].strip()
        lines.append(f"{key}: {fields.pop(key)}" if key in fields else line)
    lines += [f"{k}: {v}" for k, v in fields.items()]
    path.write_text("\n".join(lines) + "\n")
    return path


@contextlib.contextmanager
def _driver_marks(timer):
    """SolverDriver.build and the driver's train wrapped while the CLI runs
    (the CLI has no hook of its own): every built driver is kept in the
    list yielded, and the first train gets `timer`'s marks, one at the top
    of each iteration and one where each test batch is asked for."""
    from videovector_tpu_torch.solver import driver as drv
    built = []
    orig_build, orig_train = drv.SolverDriver.build, drv.train

    def build(self, **kw):
        built.append(orig_build(self, **kw))
        return built[-1]

    def timed_train(*args, **kw):
        if not timer.marks:
            kw["hooks"] = list(kw.get("hooks") or []) + [(1, timer.hook)]
            kw["test_data"] = [timer.marked(t) for t in kw["test_data"]]
        return orig_train(*args, **kw)

    drv.SolverDriver.build, drv.train = build, timed_train
    try:
        yield built
    finally:
        drv.SolverDriver.build, drv.train = orig_build, orig_train


def _counted(fn):
    """fn() and K1's launches while it ran: (fn's value, (launches, sm90
    launches, f32 launches))."""
    torch.cuda.synchronize()
    with _tally() as counts:
        out = fn()
    torch.cuda.synchronize()
    return out, _got(counts, "k1.launches", "k1.sm90_launches",
                     "k1.f32_launches")


def cli_training(dev, stores: tuple) -> dict:
    """The product path's front door: generate_net.py's net and a copy of
    the repo's solver prototxt (net, max_iter CLI_STEPS, test_interval
    CLI_INTERVAL, snapshot CLI_SNAPSHOT and snapshot_prefix changed) through
    `tools.cli.main` in-process: train (the native sampler through the
    prefetcher, every K1 launch on the f32 route), a resume from the
    iteration-CLI_SNAPSHOT snapshot, test on the final weights, time
    (segmented, then with --backward) and device_query; then the fused
    and unfused TRAIN Net against each other on the card. Returns the K1
    launches of the CLI commands."""
    import tempfile

    from videovector_tpu_torch.data.native import NativeSampledShotsSource
    from videovector_tpu_torch.tools import cli

    card = gpu_name_and_power_limit()
    launches = {}
    timer = _HostFedTimer(CLI_TIMED, CLI_PROFILED)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        net_path = tmp / "net.prototxt"
        net_path.write_text(_emit()(*stores, buffer_size=5000))
        prefix = tmp / "cli"
        solver = _cli_solver(tmp / "solver.prototxt", net_path, prefix,
                             max_iter=CLI_STEPS, test_interval=CLI_INTERVAL,
                             snapshot=CLI_SNAPSHOT)
        resume = _cli_solver(tmp / "resume.prototxt", net_path, prefix,
                             max_iter=CLI_SNAPSHOT + CLI_RESUMED,
                             test_interval=CLI_INTERVAL, snapshot=CLI_SNAPSHOT)
        log(f"  cli_training: {solver.name}: " + "; ".join(
            l for l in solver.read_text().splitlines()
            if l and not l.startswith("#")))
        t0 = time.perf_counter()
        with _driver_marks(timer) as built, _CliCapture() as out:
            _, launches["train"] = _counted(lambda: cli.main(
                ["train", "--solver", str(solver)]))
        train_s = time.perf_counter() - t0
        driver = built[0]
        sampler = driver.train_source.sources[0].source
        if not isinstance(sampler, NativeSampledShotsSource):
            raise AssertionError(f"cli train: the TRAIN source is "
                                 f"{type(sampler).__name__}, not native")
        steps, n_tests = CLI_STEPS + 1, len(range(0, CLI_STEPS + 1,
                                                  CLI_INTERVAL))
        losses = [float(r.args[1]) for r in out.records
                  if r.msg == "Iteration %d, loss = %g"]
        tests = out.lines("    Test net output")
        log(f"  cli train: {train_s:.1f} s in-process (build included); the "
            f"TRAIN source {type(sampler).__name__}; K1 launches "
            f"{launches['train'][0]} ({launches['train'][1]} sm90, "
            f"{launches['train'][2]} f32) for "
            f"{CLI_STEPS} steps + the final display forward + {n_tests} test "
            f"batches; losses {losses}; the last test lines {tests[-3:]}; "
            f"{out.lines('Optimization Done.')}")
        if launches["train"] != (steps + n_tests, 0, steps + n_tests):
            raise AssertionError(f"cli train K1 launches {launches['train']}:"
                                 f" expected {steps} + {n_tests}, all f32")
        if not (losses and all(math.isfinite(v) for v in losses)) or \
                len(tests) != 3 * n_tests:
            raise AssertionError(f"cli train: losses {losses}, tests {tests}")
        for name in (f"cli_iter_{CLI_SNAPSHOT}.vvstate",
                     f"cli_iter_{CLI_STEPS}.vvmodel"):
            if not (tmp / name).is_file():
                raise AssertionError(f"cli train wrote no {name}")
        step_ms, wall_ms = timer.per_step()
        log(f"  cli train step at B={TRAIN_BATCH} (f32, native sampler "
            f"through the prefetcher, fused scoring): {step_ms:.4f} ms (CUDA "
            f"events over {len(CLI_TIMED)} steps, tests excluded) = "
            f"{TRAIN_BATCH * TRAIN_NEG / step_ms * 1e3:,.0f} triplets/s; host "
            f"wall {wall_ms:.4f} ms a step [{card}]")
        cli_prof = training_profile(timer.prof, len(CLI_PROFILED), wall_ms)
        feed_breakdown(sampler, card)

        with _CliCapture() as out:
            _, launches["resume"] = _counted(lambda: cli.main(
                ["train", "--solver", str(resume), "--snapshot",
                 str(prefix) + f"_iter_{CLI_SNAPSHOT}.vvstate"]))
        its = [r.args[0] for r in out.records
               if r.msg == "Iteration %d, loss = %g"]
        log(f"  cli train --snapshot: {out.lines('Restoring')}; displayed "
            f"iterations {its}; K1 launches {launches['resume']}")
        # the resumed steps, and the test at the resumed iteration
        # (test_initialization, the proto default, as in JAX's loop)
        if not (out.lines("Restoring previous solver status")
                and f"(iter {CLI_SNAPSHOT})" in out.lines("Restoring")[0]
                and its and its[0] == CLI_SNAPSHOT
                and launches["resume"] == (CLI_RESUMED + 1, 0, CLI_RESUMED + 1)):
            raise AssertionError("cli resume did not start at iteration "
                                 f"{CLI_SNAPSHOT}: {its}, {launches['resume']}")

        with _CliCapture() as out:
            _, launches["test"] = _counted(lambda: cli.main(
                ["test", "--model", str(net_path), "--weights",
                 str(prefix) + f"_iter_{CLI_STEPS}.vvmodel", "--iterations",
                 str(CLI_TEST_ITERS)]))
        for line in out.lines("Batch", "Loss", "test_"):
            log(f"    cli test: {line}")
        means = {r.args[0]: float(r.args[1]) for r in out.records
                 if r.msg == "%s = %g%s"}
        if sorted(means) != ["test_hit1", "test_hit5", "test_map"] or \
                not all(0.0 <= v <= 1.0 for v in means.values()) or \
                launches["test"] != (CLI_TEST_ITERS, 0, CLI_TEST_ITERS):
            raise AssertionError(f"cli test: {means}, K1 {launches['test']}")

        for extra in ([], ["--backward"]):
            with _CliCapture() as out:
                _, launches["time" + "".join(extra)] = _counted(
                    lambda: cli.main(["time", "--model", str(net_path),
                                      "--iterations", str(CLI_TIME_ITERS)]
                                     + extra))
            marg = out.lines()
            for line in marg:
                if "(marginal)" in line or line.startswith(
                        ("Total", "Fused")):
                    log(f"    cli time{' '.join([''] + extra)}: {line} "
                        f"[{card}]")
            n_marg = sum("(marginal)" in l for l in marg)
            if n_marg != len(driver.train_net.layers) - 1:
                raise AssertionError(f"cli time: {n_marg} layer lines")

        with _CliCapture() as out:
            cli.main(["device_query"])
        for line in out.lines():
            log(f"    cli device_query: {line}")
    log(f"  cli_training K1 launches by command (all, sm90, f32): {launches}")
    if any(v[0] < 1 or v[1:] != (0, v[0]) for v in launches.values()):
        raise AssertionError(f"cli K1 launches off the f32 route: {launches}")

    fused_vs_unfused(dev, stores, driver, card)
    return {"launches": sum(v[0] for v in launches.values()),
            "sm90": sum(v[1] for v in launches.values()),
            "f32": sum(v[2] for v in launches.values()),
            "step_ms": step_ms, "profile": cli_prof}


def feed_breakdown(sampler, card) -> None:
    """The CLI's feed taken apart, host clock over 20 each: the native
    sampler's next_batch (into fresh numpy arrays, as the data factory
    calls it, and into a reused pinned buffer), the prefetcher's copy into
    pinned memory, and the prefetcher alone over the sampler with an idle
    consumer (a batch waited for on the card each time)."""
    import ctypes

    from videovector_tpu_torch.data.prefetch import DevicePrefetcher

    def clock(fn, n=20):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    batch = sampler.next_batch()
    data = torch.empty(batch["data"].shape, pin_memory=True)
    vids = torch.empty(batch["video_id"].shape, pin_memory=True)
    f32p = ctypes.POINTER(ctypes.c_float)

    def into_pinned():
        if sampler._lib.vv_sampler_next(
                sampler._h, ctypes.cast(data.data_ptr(), f32p),
                ctypes.cast(vids.data_ptr(), f32p)) != 0:
            raise AssertionError("native sampler stopped")
    fresh = clock(sampler.next_batch)
    pinned = clock(into_pinned)
    copy = clock(lambda: data.copy_(torch.from_numpy(batch["data"])))
    pf = DevicePrefetcher(iter(sampler), device="cuda")

    def consume():
        next(pf)
        torch.cuda.current_stream().synchronize()
    try:
        consume()
        alone = clock(consume)
    finally:
        pf.close()
    log(f"  the CLI's feed, host clock over 20 [{card}]: native next_batch "
        f"{fresh:.3f} ms a batch into fresh arrays, {pinned:.3f} ms into a "
        f"reused pinned buffer; the prefetcher's pinned copy of "
        f"{batch['data'].nbytes / 1e6:.1f} MB {copy:.3f} ms; the prefetcher "
        f"over the sampler with an idle consumer {alone:.3f} ms a batch")


def fused_vs_unfused(dev, stores, driver, card) -> None:
    """The TRAIN Net with the scoring fusion and without it on the card, the
    same params and one batch of the native sampler: the loss within 1e-5
    relative and the params' gradients within 1e-4 of their largest
    magnitude; then each one's device-resident step (CUDA events over 20,
    the host's enqueue, device busy, idle share, device operations over 5
    profiled), and the fused Net fed through the prefetcher from host
    memory (pinned copies on a side stream)."""
    import dataclasses

    from videovector_tpu_torch.data.prefetch import DevicePrefetcher
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.solver.train import train
    msg = _net_message(*stores)
    host = driver._first_batch
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    params = {k: {n: v.detach().clone() for n, v in d.items()}
              for k, d in driver.params.items()}
    nets = {}
    for fuse in (True, False):
        net = nets[fuse] = Net(msg, "TRAIN", fuse_scoring=fuse)
        net.init(torch.Generator(device=dev).manual_seed(0), batch)
    res = {}
    for fuse, net in nets.items():
        p = {k: {n: v.clone().requires_grad_() for n, v in d.items()}
             for k, d in params.items()}
        with torch.enable_grad():
            loss = net.loss_fn(p, batch, torch.Generator(device=dev)
                               .manual_seed(1))
            loss.backward()
        res[fuse] = (loss.item(), {k: {n: v.grad for n, v in d.items()}
                                   for k, d in p.items()})
    (lf, gf), (lu, gu) = res[True], res[False]
    loss_err = abs(lf - lu) / abs(lu)
    grad_err = max((gf[k][n] - gu[k][n]).abs().max().item()
                   / gu[k][n].abs().max().item() for k in gu for n in gu[k])
    log(f"  fused vs unfused Net on the card (f32, dropout 0.9, the same "
        f"masks): loss {lf:.7f} vs {lu:.7f} (rel err {loss_err:.2e}, tol "
        f"1e-5); params' gradients max|diff| / max|g| {grad_err:.2e} (tol "
        f"1e-4); absorbed layers {nets[True]._last_absorbed} / "
        f"{nets[False]._last_absorbed}")
    if not (loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError(f"fused vs unfused: {loss_err}, {grad_err}")

    lr, decay = nets[True].param_multipliers()
    quiet = dataclasses.replace(driver.cfg, test_interval=0, snapshot=0,
                                snapshot_prefix="", display=0,
                                max_iter=TRAIN_MAIN_STEPS)
    rows = {}
    for name, net, data in (
            ("fused, resident", nets[True], lambda: itertools.repeat(batch)),
            ("unfused, resident", nets[False],
             lambda: itertools.repeat(batch)),
            ("fused, prefetcher-fed", nets[True],
             lambda: DevicePrefetcher(itertools.repeat(host), device=dev))):
        timer = _StepTimer(5, 25, profiled=5)
        it = data()
        try:
            train(_net_loss_fn(net), params, it, quiet, lr_mults=lr,
                  decay_mults=decay, device="cuda", batch_axes={"data": 0},
                  hooks=[(1, timer.hook)])
        finally:
            if isinstance(it, DevicePrefetcher):
                it.close()
        n = timer.stop - timer.start
        ms, wall = timer.ms_per_step(), timer.wall_s / n * 1e3
        enqueue = timer.enqueue_s / n * 1e3
        log(f"  Net step at B={TRAIN_BATCH}, {name}: {ms:.4f} ms (CUDA "
            f"events over {n} steps) = "
            f"{TRAIN_BATCH * TRAIN_NEG / ms * 1e3:,.0f} triplets/s; host "
            f"wall {wall:.4f} ms, enqueue {enqueue:.4f} ms a step [{card}]")
        prof = training_profile(timer.prof, timer.profiled, wall)
        rows[name] = (ms, enqueue, prof)
    log("  fused / unfused / prefetcher-fed step summary [" + card + "]: "
        + "; ".join(f"{k}: {ms:.4f} ms, enqueue {e:.4f} ms, busy "
                    f"{p.get('busy_ms', float('nan')):.4f} ms, idle "
                    f"{1 - p.get('busy_ms', float('nan')) / ms:.3f}, "
                    f"{p.get('ops', float('nan')):.1f} device operations"
                    for k, (ms, e, p) in rows.items()))


def _is_library_kernel(name: str) -> bool:
    """A cuBLAS, cuDNN or CUTLASS kernel (none of the port's is one)."""
    low = name.lower()
    return (any(s in low for s in ("cudnn", "cublas", "xmma", "cutlass",
                                   "gemv", "sm90_"))
            or ("gemm" in low and "vv::" not in name))


def _k2_counts(counts) -> tuple:
    """K2's launches in a tally: (all, sm90, repack, f32)."""
    return _got(counts, "k2.launches", "k2.sm90_launches", "s2d.launches",
                "k2.f32_launches")


def _k1_counts(counts) -> tuple:
    """K1's launches in a tally: (all, sm90, f32)."""
    return _got(counts, "k1.launches", "k1.sm90_launches", "k1.f32_launches")


def _extraction_net(store: str, mean_file: str) -> str:
    """generate_extraction_net.py's emit at batch BATCH (227 crop, the mean
    file, no mirror, CaffeNet's widths), its IMAGE_DATA layer swapped for a
    DATA layer over `store` with the same transform_param: the card's
    machine is not known to have an image decoder, and DATA needs none."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("generate_extraction_net",
                                                  GENERATE_EXTRACTION_NET)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    txt = mod.emit("unused_list.txt", mean_file, batch=BATCH,
                   crop_size=EXTRACT_CROP, new_dim=EXTRACT_SIDE)
    head, rest = txt.split("  image_data_param {\n", 1)
    _, rest = rest.split("  }\n", 1)
    return (head.replace("type: IMAGE_DATA", "type: DATA")
            + f'  data_param {{\n    source: "{store}"\n'
            f"    batch_size: {BATCH}\n  }}\n" + rest)


def _write_extraction_inputs(tmp: Path, dev) -> dict:
    """The store, the mean BlobProto, the prototxt and a .caffemodel of
    seeded params (randn scaled by fan-in^-1/2, biases 0.1 randn), each
    written by the port."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.records import RecordWriter
    from videovector_tpu_torch.data.weights import params_to_weights
    from videovector_tpu_torch.data.wire import BlobProto, Datum
    from videovector_tpu_torch.graph import Net
    rng = np.random.RandomState(7)
    t0 = time.perf_counter()
    store = tmp / "frames.vvr"
    with RecordWriter(str(store)) as w:
        for i in range(EXTRACT_ITEMS):
            pix = rng.randint(0, 256, (3, EXTRACT_SIDE, EXTRACT_SIDE),
                              dtype=np.uint8)
            w.append(f"{i:08d}", Datum(channels=3, height=EXTRACT_SIDE,
                                       width=EXTRACT_SIDE, data=pix.tobytes(),
                                       label=i).encode())
    mean = tmp / "mean.binaryproto"
    mean.write_bytes(BlobProto.from_array(
        (rng.rand(1, 3, EXTRACT_SIDE, EXTRACT_SIDE) * 40 + 100)
        .astype(np.float32)).encode())
    net = tmp / "extraction.prototxt"
    net.write_text(_extraction_net(str(store), str(mean)))
    gen = torch.Generator(device=dev).manual_seed(11)
    params, _ = Net(parse(net.read_text()), "TEST").init(gen, {
        "data": torch.empty((BATCH, 3, EXTRACT_CROP, EXTRACT_CROP),
                            device="meta"),
        "label": torch.empty((BATCH,), device="meta")})
    for lp in params.values():
        for name, t in lp.items():
            fan_in = t.shape[0] if t.dim() == 2 else t[0].numel()
            t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                    * (fan_in ** -0.5 if name == "w" else 0.1))
    weights = tmp / "extraction.caffemodel"
    params_to_weights(params, name="med_c5_euclid_d4096").save(str(weights))
    log(f"extraction inputs written by the port in "
        f"{time.perf_counter() - t0:.3f} s: {store.name} {EXTRACT_ITEMS} x 3 x "
        f"{EXTRACT_SIDE} x {EXTRACT_SIDE} uint8 ({store.stat().st_size / 1e6:.1f}"
        f" MB), {mean.name}, {weights.name} "
        f"({weights.stat().st_size / 1e6:.1f} MB: "
        + ", ".join(f"{ln} {tuple(lp['w'].shape)}" for ln, lp in params.items())
        + ")")
    return {"net": str(net), "weights": str(weights), "store": str(store),
            "params": params}


class _BatchMarks(logging.Handler):
    """Host-clock marks at each of extract_features' per-batch log lines;
    with `prof`, starts the profiler at mark `start` and stops it at mark
    `stop` (each after a device fence), so that it sees batches
    start + 1 .. stop of the loop; `window` is then the host clock from
    just after the start to just before the stop."""

    def __init__(self, prof=None, start: int = 1, stop: int = 3):
        super().__init__()
        self.marks: list[float] = []
        self.window = (0.0, 0.0)
        self.prof, self.start, self.stop = prof, start, stop

    def __enter__(self):
        logging.getLogger("videovector_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("videovector_tpu_torch").removeHandler(self)

    def emit(self, record):
        if not str(record.msg).startswith("Extracted features"):
            return
        mark = len(self.marks) + 1
        if self.prof is not None and mark == self.start:
            torch.cuda.synchronize()
            self.prof.start()
            self.window = (time.perf_counter(), 0.0)
        elif self.prof is not None and mark == self.stop:
            torch.cuda.synchronize()
            self.window = (self.window[0], time.perf_counter())
            self.prof.stop()
        self.marks.append(time.perf_counter())


def _read_features(prefix: str, name: str) -> np.ndarray:
    """The rows extract wrote for blob `name`, after checking the keys, the
    Datums' shapes (one width, the first row's) and the text file against
    them."""
    from videovector_tpu_torch.data.records import RecordReader
    from videovector_tpu_torch.data.wire import Datum
    n = EXTRACT_BATCHES * BATCH
    r = RecordReader(f"{prefix}_{name}.vvr")
    if len(r) != n or [r.key(i).decode() for i in range(n)] != \
            [f"{i:010d}" for i in range(n)]:
        raise AssertionError(f"{name}: {len(r)} records or keys not "
                             f"0..{n - 1} zero-padded")
    rows = []
    dim = Datum.decode(bytes(r.value(0))).channels
    for i in range(n):
        d = Datum.decode(bytes(r.value(i)))
        if (d.channels, d.height, d.width, len(d.float_data)) != (dim, 1, 1, dim):
            raise AssertionError(f"{name} row {i}: Datum {d.channels} x "
                                 f"{d.height} x {d.width}, "
                                 f"{len(d.float_data)} floats")
        rows.append(d.float_data)
    r.close()
    feats = np.stack(rows)
    text = Path(f"{prefix}_{name}.txt").read_text().splitlines()
    if len(text) != n or any(len(t.split(",")) != dim for t in text):
        raise AssertionError(f"{name}: text file rows or columns wrong")
    first = np.array([float(v) for v in text[0].split(",")], np.float32)
    if np.abs(first - feats[0]).max() > 5e-7 + 1e-6 * np.abs(feats[0]).max():
        raise AssertionError(f"{name}: text row 0 disagrees with its Datum")
    return feats


def _k2_f32_times(dev, gen) -> dict:
    """K2 at the Net's CONVOLUTION entry (conv2d_nchw) at CaffeNet's
    conv1..conv5 at batch BATCH, on NCHW inputs as the DATA layer gives
    conv1 and as cuDNN takes them: the f32 route (one launch, conv1's
    repack, the channels_last copy of x inside its time) held against the
    plain version and run twice for equal bits; then, by CUDA-graph replay
    in turns, the f32 route, the core route the Net ran on before the f32
    route (one launch per group, NCHW views), the plain version and cuDNN
    F.conv2d f32 (TF32 off), beside the bound (operations at the f32 FMA
    peak, or bytes); the copy alone, and the f32 route on a channels_last x
    (as the Net feeds conv2..conv5), apart."""
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.ops.hopper import conv_gemm as k2
    card = gpu_name_and_power_limit()
    out = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0} for k in ("f32", "core")}
    flops_all = bytes_all = copy_all = direct_all = 0.0
    log(f"K2 at the Net's CONVOLUTION entry at batch {BATCH} [{card}]: "
        "CUDA-graph replay, in turns: the f32 route, the core route, plain, "
        "cuDNN f32 (TF32 off):")
    cl = torch.channels_last
    for name, hw, c, o, k, s, p, g in CAFFENET_CONVS:
        x = torch.randn((BATCH, c, hw, hw), generator=gen, device=dev)
        w = torch.randn((o, c // g, k, k), generator=gen, device=dev) \
            * (c // g * k * k) ** -0.5
        b = torch.randn(o, generator=gen, device=dev) * 0.1
        kw = dict(stride=(s, s), pad=(p, p), groups=g)
        ohw = (hw + 2 * p - k) // s + 1
        with _tally() as counts:
            got = k2.conv2d_nchw(x, w, b, **kw)
        want = (1, 0, int(name == "conv1"), 1)
        if _k2_counts(counts) != want:
            raise AssertionError(f"K2 f32 {name}: launches (all, sm90, "
                                 f"repack, f32) {_k2_counts(counts)}, not "
                                 f"{want}")

        def plain(_=None):
            with plain_versions():
                return k2.conv2d_nchw(x, w, b, **kw)
        ref = plain()
        out["f32"]["err"] = max(out["f32"]["err"], compare(
            f"K2 f32 route {name} b{BATCH}", got, ref))
        if not torch.equal(got, k2.conv2d_nchw(x, w, b, **kw)):
            raise AssertionError(f"K2 f32 route {name}: two runs differ")

        def core(_):
            y = torch.empty((BATCH, o, ohw, ohw), device=dev)
            return k2._conv_kernel(x, w, b, y, (s, s), (p, p), g, False)
        out["core"]["err"] = max(out["core"]["err"], compare(
            f"K2 core route {name} b{BATCH}", core(0), ref))
        fns = {"f32": lambda _: k2.conv2d_nchw(x, w, b, **kw), "core": core,
               "plain": plain,
               "cudnn": lambda _: torch.nn.functional.conv2d(
                   x, w, b, stride=s, padding=p, groups=g)}
        compare(f"  cuDNN f32 {name} (a yardstick)", fns["cudnn"](0), ref)
        times = {n: [] for n in fns}
        for n in ("f32", "core", "plain", "cudnn", "cudnn", "plain", "core",
                  "f32"):
            times[n].append(time_graph_ms(fns[n], [0, 1]))
        ms = {n: sum(t) / len(t) for n, t in times.items()}
        x_cl = x.contiguous(memory_format=cl)
        copy_ms = time_graph_ms(lambda _: x.contiguous(memory_format=cl), [0, 1])
        direct_ms = time_graph_ms(lambda _: k2.conv2d_nchw(x_cl, w, b, **kw),
                                  [0, 1])
        repack = ""
        if name == "conv1":
            xh, wh = x_cl.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0).contiguous()
            repack = (f", the f32 space-to-depth repack "
                      f"{time_graph_ms(lambda _: k2.space_to_depth(xh, wh, s), [0, 1]):.4f}"
                      " ms")
        flops = 2 * BATCH * ohw * ohw * o * (c // g) * k * k
        nbytes = 4 * (x.numel() + w.numel() + o + BATCH * o * ohw * ohw)
        bound = max(flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES) * 1e3
        for route in ("f32", "core"):
            for key, v in (("ms", ms[route]), ("plain_ms", ms["plain"]),
                           ("library_ms", ms["cudnn"]), ("bound_ms", bound)):
                out[route][key] += v
        flops_all += flops
        bytes_all += nbytes
        copy_all += copy_ms
        direct_all += direct_ms
        log(f"  K2 {name}: f32 route {ms['f32']:.4f} ms ({bound / ms['f32']:.3f}"
            f" of the {bound:.4f} ms bound, {flops / ms['f32'] / 1e9:.1f} "
            f"TFLOP/s; {ms['cudnn'] / ms['f32']:.2f}x cuDNN's speed), of it "
            f"the channels_last copy of x {copy_ms:.4f} ms (the route on a "
            f"channels_last x {direct_ms:.4f} ms{repack}); core "
            f"{ms['core']:.4f} ms "
            f"({g} launch{'es' if g > 1 else ''}), plain {ms['plain']:.4f} ms,"
            f" cuDNN f32 {ms['cudnn']:.4f} ms (turns: "
            + ", ".join(f"{n} {v:.4f}" for n, t in times.items() for v in t)
            + ")")
    t_ops, t_bytes = flops_all / PEAK_FLOPS_F32, bytes_all / PEAK_BYTES
    for route in ("f32", "core"):
        out[route]["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    f, c_ = out["f32"], out["core"]
    log(f"  K2 conv1..conv5 at batch {BATCH} [{card}]: f32 route "
        f"{f['ms']:.4f} ms ({flops_all / 1e9:.1f} GFLOP, "
        f"{flops_all / f['ms'] / 1e9:.1f} TFLOP/s; the bound "
        f"{f['bound_ms']:.4f} ms, {f['bound_by']}, "
        f"{PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s f32: {f['bound_ms'] / f['ms']:.3f}"
        f" of it; five channels_last copies {copy_all:.4f} ms inside it, the "
        f"route on channels_last inputs {direct_all:.4f} ms), core "
        f"{c_['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, cuDNN f32 "
        f"{f['library_ms']:.4f} ms (the f32 route at "
        f"{f['ms'] / f['library_ms']:.2f}x cuDNN's time, the core at "
        f"{c_['ms'] / c_['library_ms']:.2f}x)")
    if not f["ms"] < f["library_ms"]:
        log("  the f32 route's sum is not below cuDNN f32's (PERF.md says "
            "what holds it back)")
    return out


def _k1_fc_f32_times(dev, gen) -> dict:
    """K1's f32 route at the extraction net's fc6 + fc7 at BATCH rows (50 x
    9216 x 4096, 50 x 4096 x 4096; bias, f32 out), against the plain
    version and cuBLAS f32 (TF32 off), in turns, beside the bound. fc6's
    and fc7's weights (218 MB) exceed L2 together, as on the path."""
    from videovector_tpu_torch.ops.hopper import matmul as k1
    card = gpu_name_and_power_limit()
    ops = []
    for k, n in EXTRACT_FC:
        x = torch.randn((BATCH, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        b = torch.randn(n, generator=gen, device=dev) * 0.1
        if k1.k1_route(x, w, torch.float32) != "f32":
            raise AssertionError(f"K1 {BATCH}x{k}x{n}: not the f32 route")
        ops.append((x, w, b))
    err = max(compare(f"K1 f32 route {BATCH}x{x.shape[1]}x{w.shape[1]}",
                      k1.matmul(x, w, b), k1.matmul_plain(x, w, b))
              for x, w, b in ops)
    fns = {"f32": lambda _: [k1.matmul(*o) for o in ops],
           "plain": lambda _: [k1.matmul_plain(*o) for o in ops],
           "cublas": lambda _: [torch.addmm(b, x, w) for x, w, b in ops]}
    times = {n: [] for n in fns}
    for n in ("f32", "plain", "cublas", "cublas", "plain", "f32"):
        times[n].append(time_graph_ms(fns[n], [0]))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    flops = sum(2 * BATCH * x.shape[1] * w.shape[1] for x, w, _ in ops)
    nbytes = sum(4 * (x.numel() + w.numel() + b.numel() + BATCH * w.shape[1])
                 for x, w, b in ops)
    t_ops, t_bytes = flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    log(f"K1 f32 route, fc6 + fc7 at {BATCH} rows [{card}]: {ms['f32']:.4f} ms "
        f"({bound / ms['f32']:.3f} of the {bound:.4f} ms bound, "
        f"{'operations' if t_ops >= t_bytes else 'bytes'}: {flops / 1e9:.2f} "
        f"GFLOP, {nbytes / 1e6:.0f} MB), plain {ms['plain']:.4f} ms, cuBLAS "
        f"f32 (TF32 off) {ms['cublas']:.4f} ms (turns: "
        + ", ".join(f"{n} {v:.4f}" for n, t in times.items() for v in t) + ")")
    return {"err": err, **ms, "bound_ms": bound}


def extraction(dev) -> dict:
    """Feature extraction on the card: tools/extract_features.main over the
    CaffeNet extraction net at batch BATCH (f32), EXTRACT_BATCHES batches of
    EXTRACT_BLOBS from a DATA store, weights from a .caffemodel; the launch
    counts of that run; the stores read back; the features against the
    same Net on the plain versions on the card; the bf16 Net against the
    f32 one; images/s, the forward's time, the host's batch, a profiled
    window of 2 batches; then K2 (the f32 route beside the core) and K1's
    f32 route at the Net's shapes in turns with their plain versions and
    library calls."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from videovector_tpu_torch.config import parse_file
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.data.records import RecordWriter
    from videovector_tpu_torch.data.weights import NetWeights, load_into_params
    from videovector_tpu_torch.data.wire import Datum
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.graph.data_factory import make_data_source
    from videovector_tpu_torch.tools import extract_features
    import importlib
    from videovector_tpu_torch.data import native
    card = gpu_name_and_power_limit()
    log(f"extraction [{card}]:")
    decoders = [f"native libjpeg {'built' if native.jpeg_available() else 'absent'}"]
    for mod in ("cv2", "PIL"):
        try:
            decoders.append(f"{mod} {importlib.import_module(mod).__version__}")
        except ImportError:
            decoders.append(f"{mod} absent")
    log("  IMAGE_DATA's decoders on this machine, in its order: "
        + ", ".join(decoders))
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        inp = _write_extraction_inputs(tmp, dev)
        argv = [f"--model={inp['net']}", f"--weights={inp['weights']}",
                f"--blobs={','.join(EXTRACT_BLOBS)}", "--backend=vvr"]
        out = str(tmp / "features")
        # the main path, counted
        torch.cuda.synchronize()
        with _BatchMarks() as marks, _tally() as counts:
            t0 = time.perf_counter()
            rc = extract_features.main(
                argv + [f"--out={out}", f"--num_batches={EXTRACT_BATCHES}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k2c, k1c = _k2_counts(counts), _k1_counts(counts)
        (copies,) = _got(counts, "k2.layout_copies")
        want_k2 = (K2_F32_PER_BATCH * EXTRACT_BATCHES, 0,
                   K2_REPACK_PER_BATCH * EXTRACT_BATCHES,
                   K2_F32_PER_BATCH * EXTRACT_BATCHES)
        want_k1 = (K1_PER_EXTRACT_BATCH * EXTRACT_BATCHES, 0,
                   K1_PER_EXTRACT_BATCH * EXTRACT_BATCHES)
        log(f"  extract_features.main: rc {rc}; K2 launches (all, sm90, "
            f"repack, f32) {k2c}, want {want_k2}; K1 (all, sm90, f32) {k1c}, "
            f"want {want_k1}; channels_last copies of conv inputs "
            f"{copies} ({copies / EXTRACT_BATCHES:g} a batch)")
        if rc != 0 or k2c != want_k2 or k1c != want_k1 \
                or len(marks.marks) != EXTRACT_BATCHES:
            raise AssertionError("extraction: wrong exit code, launch counts "
                                 "or batch count")
        n = EXTRACT_BATCHES * BATCH
        steady = BATCH * (EXTRACT_BATCHES - 1) / (marks.marks[-1]
                                                  - marks.marks[0])
        log(f"  {n} images in {wall:.3f} s end to end ({n / wall:.1f} "
            f"images/s, with set-up: parse, init, {Path(inp['weights']).name} "
            f"read); batches 2..{EXTRACT_BATCHES} {steady:.1f} images/s "
            f"(read, transform, H2D, forward, store and text writes; host "
            f"clock between the per-batch log lines, "
            + ", ".join(f"{b - a:.3f}" for a, b in zip(marks.marks,
                                                          marks.marks[1:]))
            + " s)")
        feats = {name: _read_features(out, name) for name in EXTRACT_BLOBS}
        log(f"  stores read back: {n} rows each, "
            + ", ".join(f"{k} x {v.shape[1]}" for k, v in feats.items())
            + f", keys 0..{n - 1}, text files {n} rows")

        # the same Net on the plain versions, on the card, the same batches
        msg = parse_file(inp["net"])
        source_layer = next(l for l in Net(msg, "TEST").layers
                            if l.get("type") == "DATA")
        params = load_into_params(NetWeights.load(inp["weights"]),
                                  inp["params"])
        plain = Net(msg, "TEST")
        src = make_data_source(source_layer, phase="TEST")
        with plain_versions(), _tally() as counts, torch.inference_mode():
            for i in range(EXTRACT_BATCHES):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in src.next_batch().items()}
                _, blobs = plain.apply(params, batch, return_blobs=True)
                for name in EXTRACT_BLOBS:
                    got = torch.as_tensor(feats[name][i * BATCH:(i + 1) * BATCH],
                                          device=dev)
                    ref = blobs[name].reshape(BATCH, -1)
                    compare(f"extracted {name} batch {i} vs the Net's "
                            "plain versions", got, ref)
        if _k2_counts(counts) != (0, 0, 0, 0) or \
                _k1_counts(counts) != (0, 0, 0):
            raise AssertionError("the Net's plain versions launched a kernel")

        # the bf16 Net against the f32 one, batch 0, counted apart
        batch0 = {k: torch.as_tensor(v, device=dev) for k, v in
                  make_data_source(source_layer, phase="TEST")
                  .next_batch().items()}
        net16 = Net(msg, "TEST", compute_dtype="bfloat16")
        with _tally() as counts, torch.inference_mode():
            _, b16 = net16.apply(params, batch0, return_blobs=True)
        k2c16, k1c16 = _k2_counts(counts), _k1_counts(counts)
        log(f"  bf16 Net, batch 0: K2 launches (all, sm90, repack, f32) "
            f"{k2c16}, "
            f"want {EXTRACT_BF16_K2}; K1 (all, sm90, f32) {k1c16}, want "
            f"{EXTRACT_BF16_K1}")
        if k2c16 != EXTRACT_BF16_K2 or k1c16 != EXTRACT_BF16_K1:
            raise AssertionError("bf16 Net: wrong launch counts")
        for name in EXTRACT_BLOBS:
            compare(f"bf16 Net {name} vs the f32 kernels' rows",
                    b16[name].reshape(BATCH, -1).float(),
                    torch.as_tensor(feats[name][:BATCH], device=dev),
                    rel=REL_TOL[torch.bfloat16])

        # the forward alone, resident batch, CUDA events
        net32 = Net(msg, "TEST")
        fwd = {}
        with torch.inference_mode():
            for label, net in (("f32", net32), ("bf16", net16)):
                fwd[label] = time_ms(lambda: net.apply(params, batch0),
                                     iters=10, warmup=2)
        host = make_data_source(source_layer, phase="TEST")
        t0 = time.perf_counter()
        for _ in range(3):
            host.next_batch()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        # extract's per-row output work for one batch of both blobs: the
        # Datum's encoding and store append, the "%.6f" text row
        t0 = time.perf_counter()
        with RecordWriter(str(tmp / "w.vvr")) as w, \
                open(tmp / "w.txt", "w") as text:
            for name in EXTRACT_BLOBS:
                for i, row in enumerate(feats[name][:BATCH]):
                    w.put(f"{i:010d}", Datum(channels=len(row), height=1,
                                             width=1, float_data=row).encode())
                    text.write(",".join(f"{v:.6f}" for v in row) + "\n")
        write_ms = (time.perf_counter() - t0) * 1e3
        log(f"  Net forward at batch {BATCH}, resident (CUDA events, 10 "
            f"calls) [{card}]: f32 {fwd['f32']:.3f} ms, bf16 "
            f"{fwd['bf16']:.3f} ms; host clock: the DATA source's batch "
            f"(read + transform, 3 batches) {host_ms:.3f} ms, one batch's "
            f"store and text writes ({' + '.join(EXTRACT_BLOBS)}) "
            f"{write_ms:.3f} ms")

        # one profiled window of 2 batches of the loop
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with _BatchMarks(prof, start=1, stop=3) as pmarks:
            extract_features.main(argv + [f"--out={tmp / 'profiled'}",
                                          "--num_batches=3"])
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = by_name.setdefault(e.name, [0.0, 0])
                t[0] += e.time_range.elapsed_us() / 1e3
                t[1] += 1
        window_ms = (pmarks.window[1] - pmarks.window[0]) * 1e3
        if not by_name:
            log("  profile: no device events (busy time not measured)")
        else:
            busy = sum(t for t, _ in by_name.values())
            library = [n for n in by_name if _is_library_kernel(n)]
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            log(f"  profiled window of 2 batches [{card}]: device busy "
                f"{busy:.3f} ms against {window_ms:.3f} ms host wall of the "
                f"same window (batches 2-3 of the profiled run; the counted "
                f"run's batches 2-3 took "
                f"{(marks.marks[2] - marks.marks[0]) * 1e3:.3f} ms), idle "
                f"share {max(0.0, 1 - busy / window_ms):.3f}; top: "
                + "; ".join(f"{t:.3f} ms x{c} {nm[:60]}"
                            for nm, (t, c) in top))
            if library:
                raise AssertionError(f"library kernels on the extraction "
                                     f"forward: {library}")
            log("  no cuBLAS/cuDNN/CUTLASS kernel in the window")
        del params, plain, net16, net32, batch0
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(17)
    k2_stats = _k2_f32_times(dev, gen)
    k1_stats = _k1_fc_f32_times(dev, gen)
    return {"k2_f32": k2c[3], "k2_core": k2c[0] - k2c[1] - k2c[3],
            "repack": k2c[2], "k1_f32": k1c[2], "k2": k2_stats,
            "k1": k1_stats, "images_s": steady, "fwd": fwd,
            "copies": copies}


# ---------------------------------------------------------------------------
# The exhaustive-shots training and the fixed-gallery rank eval
# ---------------------------------------------------------------------------

def _write_gallery(tmp: Path, train_path: str) -> str:
    """The fixed gallery, EXH_GALLERY_ROWS rows of HOST_DIM f32, as
    TestVideoShotWindows records written by the port: one record for each
    of the TEST_VIDEOS videos the test windows come from, its HOST_SHOTS
    shots as positives (labelled by its video id) and the rest of its
    EXH_GALLERY_PER_VIDEO rows drawn from the other training videos' shots
    as negatives (labelled -1)."""
    from videovector_tpu_torch.data.records import RecordWriter
    from videovector_tpu_torch.data.shots import ShotDataset
    from videovector_tpu_torch.data.wire import Datum, TestVideoShotWindows
    rng = np.random.RandomState(2)
    ds = ShotDataset.from_records(train_path)
    pool = np.concatenate([ds[i].features for i in range(TEST_VIDEOS, len(ds))])
    path = tmp / "gallery.vvr"
    with RecordWriter(str(path)) as w:
        for v in range(TEST_VIDEOS):
            video = ds[v]
            negs = pool[rng.choice(len(pool), EXH_GALLERY_PER_VIDEO
                                   - video.num_shots, replace=False)]
            w.append(str(v), TestVideoShotWindows(
                video_id=int(video.video_id),
                positive_shot_words=[Datum(float_data=f)
                                     for f in video.features],
                negative_shot_words=[Datum(float_data=f) for f in negs])
                .encode())
    return str(path)


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"{old!r} is not in the net exactly once")
    return text.replace(old, new)


def _exhaustive_net(train: str, test: str, gallery: str, out: Path) -> str:
    """generate_net.py's emit(batch=TRAIN_BATCH) text, with:
    - TRAIN: the data layer swapped for VIDEO_SHOTS_DATA (WINDOW, 4 context
      shots beside the target, 10 negatives: [target | 4 context | 10
      negatives], the flagship's 15 roles, so its SLICE, fc7, context mean
      and MAX_MARGIN_LOSS stand unchanged), and a RETRIEVAL_RANK_STATS of
      the normalized context mean (B rows) against the CONCAT of the
      normalized target and negative embeddings (11 B rows, role-major:
      bucket 0 holds the positives);
    - TEST: the FIXED_VIDEO_SHOT_TEST_DATA gallery beside the test windows,
      queries (the context mean, flattened) and gallery through one fc7
      (CONCAT, INNER_PRODUCT, SLICE),
      RETRIEVAL_RANK_STATS_FIXED_REF with its csv, an HDF5_OUTPUT of the
      query embeddings and ids and a WRITE_TO_FILE of the embeddings."""
    txt = _emit()(train, test, buffer_size=5000)
    txt, n = re.subn(
        r'type: VIDEO_SAMPLED_SHOTS_DATA\n  top: "data"\n'
        r'  video_sampled_shots_data_param \{.*?\n  \}',
        'type: VIDEO_SHOTS_DATA\n  top: "data"\n'
        f'  video_shots_data_param {{ source: "{train}"\n'
        f'    batch_size: {TRAIN_BATCH} context_type: WINDOW context_size: 4\n'
        f'    num_negative_samples: {TRAIN_NEG} max_buffer_size: 5000\n'
        '    negative_swap_percentage: 50 max_same_video_negs: 6 }',
        txt, flags=re.S)
    if n != 1:
        raise AssertionError("no VIDEO_SAMPLED_SHOTS_DATA layer to swap")
    txt = _replace_once(txt, '  top: "tower_in"\n  eltwise_param',
                        '  top: "query_in"\n  eltwise_param')
    txt = _replace_once(txt, 'layers {\n  name: "fc7"', f"""layers {{
  name: "gallery" type: FIXED_VIDEO_SHOT_TEST_DATA
  top: "ref_feats" top: "ref_vids"
  fixed_video_shot_test_data_param {{ source: "{gallery}" }}
  include: {{ phase: TEST }}
}}
layers {{
  name: "query_flat" type: FLATTEN bottom: "query_in" top: "query_flat"
  include: {{ phase: TEST }}
}}
layers {{
  name: "eval_concat" type: CONCAT bottom: "query_flat" bottom: "ref_feats"
  top: "tower_in" concat_param {{ concat_dim: 0 }} include: {{ phase: TEST }}
}}
layers {{
  name: "fc7\"""")
    relu7 = 'layers { name: "relu7" type: RELU bottom: "emb" top: "emb" }\n'
    txt = _replace_once(txt, relu7, relu7 + f"""layers {{
  name: "eval_split" type: SLICE bottom: "emb" top: "q_emb" top: "g_emb"
  slice_param {{ slice_dim: 0 slice_point: {TEST_BATCH} }}
  include: {{ phase: TEST }}
}}
""")
    txt = _replace_once(txt, 'bottom: "emb" top: "ctxn"',
                        'bottom: "q_emb" top: "ctxn"')
    cands = " ".join(f'bottom: "en{i}x"' for i in range(1, TRAIN_NEG + 1))
    return txt + f"""
layers {{ name: "cand_concat" type: CONCAT bottom: "etn" {cands}
  top: "cands" concat_param {{ concat_dim: 0 }} include: {{ phase: TRAIN }} }}
layers {{ name: "train_rank" type: RETRIEVAL_RANK_STATS bottom: "ctxn"
  bottom: "cands" top: "train_median_rank" top: "train_r1" top: "train_r5"
  top: "train_r10" top: "train_map"
  retrieval_rank_stats_param {{ compute_ap: true positive_size: 1
    negative_size: {TRAIN_NEG} }} include: {{ phase: TRAIN }} }}
layers {{ name: "gallery_norm" type: NORMALIZATION bottom: "g_emb" top: "gn"
  include: {{ phase: TEST }} }}
layers {{ name: "fixed_rank" type: RETRIEVAL_RANK_STATS_FIXED_REF
  bottom: "ctxn" bottom: "video_ids" bottom: "gn" bottom: "ref_vids"
  top: "fixed_median_rank" top: "fixed_r1" top: "fixed_r5" top: "fixed_r10"
  top: "fixed_map"
  retrieval_rank_stats_fixed_ref_param {{
    stats_output_file: "{out / 'fixed_rank.csv'}" }}
  include: {{ phase: TEST }} }}
layers {{ name: "dump_h5" type: HDF5_OUTPUT bottom: "ctxn" bottom: "video_ids"
  hdf5_output_param {{ file_name: "{out / 'queries.h5'}" }}
  include: {{ phase: TEST }} }}
layers {{ name: "dump_ctx" type: WRITE_TO_FILE bottom: "ctxn"
  write_to_file_param {{ output_file: "{out / 'queries.csv'}" }}
  include: {{ phase: TEST }} }}
"""


RANK_TOPS = ("median_rank", "r1", "r5", "r10", "map")
SINK_HEADS = {"fixed_rank.csv": "#item_id,rank,rec@1,rec@5,ret_id_1,ret_id_2,"
                                "ret_id_3,ret_id_4,ret_id_5",
              "queries.csv": "#batch_id,channel_id,features(1..1)"}


def _check_sinks(out: Path, vids: np.ndarray, when: str) -> None:
    """Each sink's file exists with the reference's header: the csvs' first
    lines, and the .h5 file's signature with the ids' bytes in it (the card's
    machine has no h5py; the CPU tests read the port's files with it)."""
    for name, head in SINK_HEADS.items():
        with open(out / name) as f:
            first = f.readline().rstrip("\n")
        if first != head:
            raise AssertionError(f"{when}: {name} starts {first!r}")
    h5 = (out / "queries.h5").read_bytes()
    if not (h5.startswith(b"\x89HDF\r\n\x1a\n")
            and vids.astype(np.float32).tobytes() in h5
            and len(h5) > TEST_BATCH * HOST_DIM * 4):
        raise AssertionError(f"{when}: queries.h5 is not the ids' HDF5 file")
    def rows(name):
        with open(out / name) as f:
            return sum(1 for _ in f) - 1
    n = rows("queries.csv")
    log(f"    {when}: sinks written: fixed_rank.csv "
        f"({rows('fixed_rank.csv')} rows), queries.csv ({n:,} rows), "
        f"queries.h5 ({len(h5):,} bytes)")
    if n != TEST_BATCH * HOST_DIM:
        raise AssertionError(f"{when}: queries.csv has {n} rows")
    for name in (*SINK_HEADS, "queries.h5"):
        (out / name).unlink()


def _rank_values(values: dict, prefix: str, when: str) -> dict:
    """The five rank scalars under `prefix`, checked finite and in range."""
    got = {k: values[prefix + k] for k in RANK_TOPS}
    ok = all(math.isfinite(v) for v in got.values()) and \
        1.0 <= got["median_rank"] <= 1e4 and \
        all(0.0 <= got[k] <= 1.0 for k in RANK_TOPS[1:])
    if not ok:
        raise AssertionError(f"{when}: rank scalars {got}")
    return got


def exhaustive_rank_eval(dev, stores: tuple) -> dict:
    """The paper's exhaustive-shots training and fixed-gallery rank eval
    through `vvtpu-torch` (tools.cli.main in-process) on _exhaustive_net's
    prototxt and a copy of the repo's solver (max_iter EXH_STEPS,
    test_interval EXH_INTERVAL, one snapshot): train, with the
    VIDEO_SHOTS_DATA source through the prefetcher and every fc7 on K1's
    f32 route (the TEST one at TEST_BATCH + EXH_GALLERY_ROWS rows), then
    test on the snapshot; the sinks' files and the rank scalars checked;
    the step, the eval (fc7, the distance product, the argsort) and the
    host feed timed; the card's Nets held against the same Nets on the
    CPU. Returns the K1 launches."""
    import tempfile

    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.shots import FixedVideoShotGallery
    from videovector_tpu_torch.solver.checkpoint import load_model
    from videovector_tpu_torch.tools import cli

    card = gpu_name_and_power_limit()
    timer = _HostFedTimer(EXH_TIMED, EXH_PROFILED)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        t0 = time.perf_counter()
        gallery = _write_gallery(tmp, stores[0])
        t1 = time.perf_counter()
        FixedVideoShotGallery.from_records(gallery)
        t2 = time.perf_counter()
        log(f"  exhaustive_rank_eval: the gallery written by the port in "
            f"{t1 - t0:.3f} s ({Path(gallery).stat().st_size / 1e6:.1f} MB, "
            f"{EXH_GALLERY_ROWS:,} rows x {HOST_DIM}); its host read "
            f"(FixedVideoShotGallery.from_records) {t2 - t1:.3f} s")
        text = _exhaustive_net(*stores, gallery, tmp)
        net_path = tmp / "exhaustive.prototxt"
        net_path.write_text(text)
        prefix = tmp / "exh"
        solver = _cli_solver(tmp / "solver.prototxt", net_path, prefix,
                             max_iter=EXH_STEPS, test_interval=EXH_INTERVAL,
                             snapshot=EXH_STEPS)
        t0 = time.perf_counter()
        with _driver_marks(timer) as built, _CliCapture() as out:
            _, k1_train = _counted(lambda: cli.main(
                ["train", "--solver", str(solver)]))
        train_s = time.perf_counter() - t0
        driver = built[0]
        source = driver.train_source.sources[0].source
        n_tests = len(range(0, EXH_STEPS + 1, EXH_INTERVAL))
        losses = [float(r.args[1]) for r in out.records
                  if r.msg == "Iteration %d, loss = %g"]
        tests = {r.args[1]: float(r.args[2]) for r in out.records
                 if r.msg == "    Test net output #%d: %s = %g%s"}
        trains = {r.args[1]: float(r.args[2]) for r in out.records
                  if r.msg == "    Train net output #%d: %s = %g%s"}
        log(f"  exhaustive train: {train_s:.1f} s in-process (build "
            f"included); the TRAIN source {type(source).__name__}; K1 "
            f"launches (all, sm90, f32) {k1_train} for {EXH_STEPS} steps + "
            f"the final display forward + {n_tests} tests; losses {losses}; "
            f"the last Train net outputs {trains}; the last Test net outputs "
            f"{tests}")
        if type(source).__name__ != "VideoShotsSource":
            raise AssertionError(f"exhaustive train: the TRAIN source is "
                                 f"{type(source).__name__}")
        want = EXH_STEPS + 1 + n_tests
        if k1_train != (want, 0, want):
            raise AssertionError(f"exhaustive train: K1 launches {k1_train}, "
                                 f"expected {want}, all f32")
        if not (losses and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"exhaustive train: losses {losses}")
        test_vids = driver.test_sources[0].next_batch()["video_ids"]
        _check_sinks(tmp, test_vids, "train's last test")
        fixed = _rank_values(tests, "fixed_", "train's last test")
        _rank_values(trains, "train_", "train's last display")
        step_ms, wall_ms = timer.per_step()
        log(f"  exhaustive train step at B={TRAIN_BATCH} (15 x {HOST_DIM}, "
            f"f32, VIDEO_SHOTS_DATA through the prefetcher, "
            f"RETRIEVAL_RANK_STATS on {TRAIN_BATCH} x {TRAIN_BATCH * 11}): "
            f"{step_ms:.4f} ms (CUDA events over {len(EXH_TIMED)} steps, "
            f"tests excluded) = {TRAIN_BATCH * TRAIN_NEG / step_ms * 1e3:,.0f} "
            f"triplets/s; host wall {wall_ms:.4f} ms a step [{card}]")
        training_profile(timer.prof, len(EXH_PROFILED), wall_ms)

        model = str(prefix) + f"_iter_{EXH_STEPS}.vvmodel"
        with _CliCapture() as out:
            _, k1_test = _counted(lambda: cli.main(
                ["test", "--model", str(net_path), "--weights", model,
                 "--iterations", "1"]))
        means = {r.args[0]: float(r.args[1]) for r in out.records
                 if r.msg == "%s = %g%s"}
        log(f"  exhaustive test (1 iteration, the snapshot): {means}; K1 "
            f"launches {k1_test}")
        if k1_test != (1, 0, 1):
            raise AssertionError(f"exhaustive test: K1 launches {k1_test}")
        _check_sinks(tmp, test_vids, "test")
        fixed_test = _rank_values(means, "fixed_", "test")
        if fixed_test != fixed:
            raise AssertionError(f"test {fixed_test} vs train's last test "
                                 f"{fixed}: the same weights and batch")

        msg = parse(text)
        params = load_model(model)
        feed_ms = _exhaustive_feed_ms(source, driver.test_sources[0], card)
        test_batch = driver.test_sources[0].next_batch()
        eval_parts = _eval_split(dev, msg, params, test_batch, card)
        witness = _card_vs_cpu(dev, msg, params, {
            "TRAIN (the store's)": {"data": source.next_batch()["data"]},
            "TRAIN (separated)": _separated_windows(13),
            "TEST": test_batch})
    return {"launches": k1_train[0] + k1_test[0],
            "f32": k1_train[2] + k1_test[2], "step_ms": step_ms,
            "eval": eval_parts, "feed_ms": feed_ms, "witness": witness}


def _exhaustive_feed_ms(source, test_source, card) -> dict:
    """The host feed, host clock: VIDEO_SHOTS_DATA's next_batch (the Python
    source; the C++ sampler serves VIDEO_SAMPLED_SHOTS_DATA only) over 20,
    and the TEST batch (the 673 windows and the constant gallery) over 5."""
    t0 = time.perf_counter()
    for _ in range(20):
        source.next_batch()
    t1 = time.perf_counter()
    for _ in range(5):
        test_source.next_batch()
    t2 = time.perf_counter()
    out = {"train_ms": (t1 - t0) / 20 * 1e3, "test_ms": (t2 - t1) / 5 * 1e3}
    log(f"  exhaustive host feed: VIDEO_SHOTS_DATA next_batch "
        f"{out['train_ms']:.3f} ms a batch of {TRAIN_BATCH} x 15 x {HOST_DIM} "
        f"(host clock over 20); the TEST batch (windows + gallery) "
        f"{out['test_ms']:.3f} ms (over 5) [{card}]")
    return out


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else
            torch.as_tensor(v, device=dev) for k, v in tree.items()}


def _eval_split(dev, msg, params, test_batch, card) -> dict:
    """One fixed-gallery eval on the card, CUDA events: the TEST Net's
    forward, and apart its fc7 (one K1 f32-route call at TEST_BATCH +
    EXH_GALLERY_ROWS rows, held first against its plain version on the same
    operands), the distance product (-2 q.g^T, TEST_BATCH x
    EXH_GALLERY_ROWS x HOST_DIM, f32 with TF32 off) and the stable argsort
    of its rows."""
    from videovector_tpu_torch.device import plain_versions
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.metrics.retrieval import _neg2_dot
    from videovector_tpu_torch.ops.linear import no_tf32, tower_matmul
    net = Net(msg, "TEST")
    p, b = _to(params, dev), _to(test_batch, dev)
    w, bias = p["fc7"]["w"], p["fc7"]["b"]
    with torch.no_grad(), no_tf32():
        _, blobs = net.apply(p, b, return_blobs=True)
        x = blobs["tower_in"]
        q, g = blobs["ctxn"], blobs["gn"]
        dist = _neg2_dot(q, g)
        m, k = x.shape
        got = tower_matmul(x, w, bias, compute_dtype=torch.float32)
        with plain_versions():
            ref = tower_matmul(x, w, bias, compute_dtype=torch.float32)
        err = compare(f"K1 f32 route {m}x{k}x{w.shape[1]} (the TEST fc7)",
                      got, ref)
        ms = {"forward": time_ms(lambda: net.apply(p, b), iters=5, warmup=1),
              "fc7": time_ms(lambda: tower_matmul(
                  x, w, bias, compute_dtype=torch.float32), iters=5,
                  warmup=1),
              "fc7_cublas": time_ms(lambda: torch.addmm(bias, x, w), iters=5,
                                    warmup=1),
              "distance": time_ms(lambda: _neg2_dot(q, g), iters=5, warmup=1),
              "argsort": time_ms(lambda: torch.argsort(dist, dim=1,
                                                       stable=True),
                                 iters=5, warmup=1)}
    ms["fc7_err"] = err
    ms["fc7_bound"] = 2 * m * k * w.shape[1] / PEAK_FLOPS_F32 * 1e3
    log(f"  fixed-gallery eval on the card ({TEST_BATCH} queries, "
        f"{EXH_GALLERY_ROWS:,} gallery rows, {HOST_DIM} dims): the TEST "
        f"Net's forward {ms['forward']:.4f} ms; fc7 at {tuple(x.shape)} on "
        f"K1's f32 route {ms['fc7']:.4f} ms (cuBLAS f32, TF32 off, "
        f"{ms['fc7_cublas']:.4f}; bound {ms['fc7_bound']:.4f} at the f32 "
        f"FMA peak), the distance product {ms['distance']:.4f} ms, the "
        f"stable argsort of {tuple(dist.shape)} {ms['argsort']:.4f} ms "
        f"(CUDA events over 5) [{card}]")
    return ms


F32_UNIT = 2.0 ** -24     # f32's unit roundoff


def _dist_bound(cpu_q, cpu_g, card_q, card_g):
    """dist = -2 q.g^T in f64 from the CPU's embeddings, and per row the
    most that either device's f32 dist can lie from it: a K-long f32 dot of
    a and b rounds by at most ~K u |a||b| whatever the order of its sum,
    and the card's a and b are the CPU's plus their measured difference,
    which is held within 1e-4 of the largest magnitude first."""
    q, g = cpu_q.double(), cpu_g.double()
    for name, c, h in (("queries", card_q, q), ("gallery", card_g, g)):
        gap = (c.cpu().double() - h).abs().max() / h.abs().max()
        if not gap <= 1e-4:
            raise AssertionError(f"the card's {name} embeddings lie "
                                 f"{gap.item():.3e} from the CPU's")
    dq = (card_q.cpu().double() - q).norm(dim=1)
    dg = (card_g.cpu().double() - g).norm(dim=1).max()
    qn, gn = q.norm(dim=1), g.norm(dim=1).max()
    k = q.shape[1]
    err = 2.0 * (1.01 * k * F32_UNIT * (qn + dq) * (gn + dg)
                 + dq * gn + qn * dg + dq * dg)
    return (-2.0 * (q @ g.T)).numpy(), err.numpy()


def _rank_witness(name, d64, err, orders, ranks, relevant) -> dict:
    """Both devices' stable orders and first-match ranks held against the
    f64 dist: no pair of items in an order is inverted by more than the
    two-sided bound 2 err, and each rank lies where some f32 rounding
    within err can put it: behind every irrelevant item that is closer by
    more than 2 err than the nearest relevant one, and ahead of every one
    that is farther by more. Ranks may differ between the devices only in
    rows where that range holds more than one rank (near ties). Raises
    otherwise; returns the counts."""
    e = err[:, None]
    worst = 0.0
    for dev_name, o in orders.items():
        s = np.take_along_axis(d64, o, 1)
        inv = np.maximum.accumulate(s, 1)[:, :-1] - s[:, 1:]
        ratio = (inv / (2 * e)).max()
        worst = max(worst, float(ratio))
        if ratio > 1.0:
            rows = np.flatnonzero((inv > 2 * e).any(1))
            raise AssertionError(f"{name}: the {dev_name}'s order inverts "
                                 f"items past the f32 bound in rows "
                                 f"{rows[:10]}")
    has = relevant.any(1)
    d_rel = np.where(relevant, d64, np.inf).min(1)[:, None]
    other = ~relevant
    lo = 1 + (other & (d64 + e < d_rel - e)).sum(1)
    hi = 1 + (other & (d64 - e <= d_rel + e)).sum(1)
    for dev_name, r in ranks.items():
        bad = has & ((r < lo) | (r > hi)) | ~has & (r != 1e4)
        if bad.any():
            i = np.flatnonzero(bad)[:10]
            raise AssertionError(f"{name}: {dev_name} ranks {r[i]} outside "
                                 f"[{lo[i]}, {hi[i]}] in rows {i}")
    near = has & (hi > lo)
    diff = ranks["card"] != ranks["cpu"]
    out = {"rows": len(diff), "differ": int(diff.sum()),
           "near_ties": int(near.sum()),
           "exact": int((has & (hi == lo)).sum()),
           "median_bound": float(np.median(err)),
           "worst_inversion": worst}
    log(f"    {name}: per-item ranks differ in {out['differ']} of "
        f"{out['rows']} rows; the f64 dist with the f32 bound (median "
        f"{out['median_bound']:.3e}) fixes the rank in {out['exact']} rows "
        f"and leaves a near tie in {out['near_ties']}; the worst inversion "
        f"in either order is {worst:.3f} of the bound")
    if (diff & ~near).any():
        raise AssertionError(f"{name}: ranks differ outside near ties in "
                             f"rows {np.flatnonzero(diff & ~near)[:10]}")
    return out


def _separated_windows(seed: int) -> dict:
    """A fixed TRAIN batch from `seed`: TRAIN_BATCH windows of 15 roles,
    the target and the 4 context shots of each near one center of their
    own (0.3 randn apart), the 10 negatives drawn apart."""
    rs = np.random.RandomState(seed)
    data = rs.randn(TRAIN_BATCH, 1 + 4 + TRAIN_NEG, HOST_DIM)
    data[:, :5] = rs.randn(TRAIN_BATCH, 1, HOST_DIM) \
        + 0.3 * rs.randn(TRAIN_BATCH, 5, HOST_DIM)
    return {"data": data.astype(np.float32)}


def _rank_check(phase, runs) -> tuple[dict, dict]:
    """The per-item rank stats of both runs of one phase, recomputed on
    each device from the Net's blobs: the f64 witness over both orders,
    and on the host, from each device's own order, the five rank scalars
    its Net must give. Returns the witness's counts and the scalars by
    device."""
    from videovector_tpu_torch.metrics import retrieval as tr
    if phase == "TRAIN":
        q_key, g_key, prefix = "ctxn", "cands", "train_"
        per = [tr._rank_stats_peritem(b["ctxn"], b["cands"], True, 1,
                                      TRAIN_NEG) for _, b in runs]
        videos = runs[1][1]["cands"].shape[0] // (1 + TRAIN_NEG)

        def match(order):
            rows = torch.arange(order.shape[0])[:, None]
            return tr._bucket_video_id(order, videos, 1) == rows
    else:
        q_key, g_key, prefix = "ctxn", "gn", "fixed_"
        per = [tr._fixed_ref_peritem(
            b["ctxn"], b["video_ids"].reshape(-1).to(torch.int32), b["gn"],
            b["ref_vids"].reshape(-1).to(torch.int32)) for _, b in runs]
        vids = runs[1][1]["video_ids"].reshape(-1).to(torch.int32)
        ref_vids = runs[1][1]["ref_vids"].reshape(-1).to(torch.int32)

        def match(order):
            return ref_vids[order] == vids[:, None]
    (_, bc), (_, bh) = runs
    d64, err = _dist_bound(bh[q_key], bh[g_key], bc[q_key], bc[g_key])
    orders = {d: p[1].cpu() for d, p in zip(("card", "cpu"), per)}
    f = d64.shape[1]
    witness = _rank_witness(
        f"{phase} rank stats", d64, err,
        {d: o.numpy() for d, o in orders.items()},
        {d: p[2].cpu().numpy() for d, p in zip(("card", "cpu"), per)},
        match(torch.arange(f).expand(d64.shape[0], f)).numpy())
    scalars = {}
    for d, o in orders.items():
        first, rec1, rec5, rec10, ap = tr._ranked_stats(match(o).float())
        got = tr._rank_means(first, rec1, rec5, rec10, torch.mean(ap))
        scalars[d] = {prefix + t: float(got[k]) for t, k in zip(
            RANK_TOPS, ("median_rank", "recall_at_1", "recall_at_5",
                        "recall_at_10", "mean_ap"))}
    return witness, scalars


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref| (ref on the CPU)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{tuple(got.shape)} vs {tuple(ref.shape)}, or "
                             "non-finite values on the card")
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


def _held(what: str, errs: dict, tol: float) -> float:
    worst = max(errs.values())
    log(f"    {what}: worst relative error {worst:.3e} (tol {tol:g}); "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not worst <= tol:
        raise AssertionError(f"{what}: {worst} > {tol}")
    return worst


def _card_vs_cpu(dev, msg, params, batches) -> dict:
    """The exhaustive TRAIN Net (dropout rewritten to 0, so that both
    devices draw nothing) and the TEST Net on the card and on the CPU, on
    fixed batches: the store's TRAIN batch, _separated_windows' TRAIN
    batch and the TEST batch. Every output but the rank scalars within
    1e-4 relative. The rank scalars: each device's within 1e-6 relative
    of those the host computes from that device's own order, both orders
    and ranks held by _rank_witness against the f64 dist, and the card's
    within 1e-4 relative of the CPU's where the two orders rank the
    matches alike in every row. (After EXH_STEPS steps the store's windows
    rank near randomly, every embedding of their |center + noise| shots
    points nearly one way, and their distances crowd within the f32
    rounding; _separated_windows' ranks separate.) Returns the witness's
    counts by batch."""
    from videovector_tpu_torch.graph import Net
    for layer in msg.get_list("layers"):
        if layer.get("type") == "DROPOUT":
            layer.get_msg("dropout_param").fields["dropout_ratio"] = [0.0]
    counts = {}
    for label, b in batches.items():
        phase = label.split()[0]
        runs = []
        for d in (dev, torch.device("cpu")):
            with torch.no_grad():
                runs.append(Net(msg, phase).apply(_to(params, d), _to(b, d),
                                                  return_blobs=True))
        witness, scalars = _rank_check(phase, runs)
        (lc, bc), (lh, bh) = runs
        outs = ["loss"] + [k for k in bh if bh[k].dim() == 0
                           or k in ("train_violations",)]
        worst = {}
        for k in outs:
            c = (lc if k == "loss" else bc[k]).float().cpu()
            h = (lh if k == "loss" else bh[k]).float()
            err = _rel_err(c, h)
            worst[k] = err
            if k in scalars["cpu"]:
                for d, v in (("card", c), ("cpu", h)):
                    own = scalars[d][k]
                    if not abs(v.item() - own) <= 1e-6 * max(abs(own), 1e-30):
                        raise AssertionError(
                            f"{label} {k}: the {d}'s Net gives {v.item()}, "
                            f"its own order {own}")
                if witness["differ"]:
                    continue
            if not err <= 1e-4:
                raise AssertionError(f"{label} {k}: card {c} vs CPU {h}")
        log(f"  exhaustive {label} batch, card vs CPU: relative error by "
            f"output {worst}")
        counts[label] = witness
    return counts


# ---------------------------------------------------------------------------
# The layer zoo at a classifier's width
# ---------------------------------------------------------------------------

def _zoo_net(infogain: str) -> str:
    """Every other type of this slice at CaffeNet's classifier width: fc7
    features (ZOO_BATCH x 4096) through fc8 (INNER_PRODUCT 4096 -> 1000)
    into the loss zoo, ACCURACY (top 5), ARGMAX (top 5, out_max_val) and
    CLASSIFICATION_STATS, CONTRASTIVE_LOSS on ZOO_BATCH / 2 pairs of fc8
    rows, MVN on a pool1 blob, ID_TO_WEIGHT_MAPPING and DUMMY_DATA."""
    half = ZOO_BATCH // 2
    return f"""
name: "layer_zoo"
layers {{ name: "d" type: MEMORY_DATA top: "fc7" top: "label" top: "t"
  top: "sim" top: "ids" top: "emb_t" top: "pool1" top: "pool1_t" }}
layers {{ name: "fc8" type: INNER_PRODUCT bottom: "fc7" top: "fc8"
  inner_product_param {{ num_output: {ZOO_CLASSES}
    weight_filler {{ type: "gaussian" std: 0.01 }}
    bias_filler {{ type: "constant" value: 0.1 }} }} }}
layers {{ name: "sm_loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "softmax_loss" }}
layers {{ name: "acc" type: ACCURACY bottom: "fc8" bottom: "label"
  top: "accuracy" accuracy_param {{ top_k: 5 }} }}
layers {{ name: "hinge" type: HINGE_LOSS bottom: "fc8" bottom: "label"
  top: "hinge_loss" hinge_loss_param {{ norm: L2 }} loss_weight: 0.01 }}
layers {{ name: "prob" type: SOFTMAX bottom: "fc8" top: "prob" }}
layers {{ name: "mll" type: MULTINOMIAL_LOGISTIC_LOSS bottom: "prob"
  bottom: "label" top: "multinomial_loss" }}
layers {{ name: "ig" type: INFOGAIN_LOSS bottom: "prob" bottom: "label"
  top: "infogain_loss" infogain_loss_param {{ source: "{infogain}" }} }}
layers {{ name: "sce" type: SIGMOID_CROSS_ENTROPY_LOSS bottom: "fc8"
  bottom: "t" top: "sigmoid_loss" }}
layers {{ name: "euc" type: EUCLIDEAN_LOSS bottom: "fc8" bottom: "t"
  top: "euclidean_loss" }}
layers {{ name: "pairs" type: SLICE bottom: "fc8" top: "a" top: "b"
  slice_param {{ slice_dim: 0 slice_point: {half} }} }}
layers {{ name: "con" type: CONTRASTIVE_LOSS bottom: "a" bottom: "b"
  bottom: "sim" top: "contrastive_loss"
  contrastive_loss_param {{ margin: 50.0 }} }}
layers {{ name: "am" type: ARGMAX bottom: "fc8" top: "argmax"
  argmax_param {{ top_k: 5 out_max_val: true }} }}
layers {{ name: "cs" type: CLASSIFICATION_STATS bottom: "fc8"
  bottom: "label" top: "per_class_accuracy" top: "per_class_ap"
  top: "class_accuracy"
  classification_stats_param {{ num_classes: {ZOO_CLASSES} }} }}
layers {{ name: "mvn" type: MVN bottom: "pool1" top: "mvn" }}
layers {{ name: "dummy" type: DUMMY_DATA top: "constant" top: "noise"
  dummy_data_param {{ num: {ZOO_POOL1[0]} channels: {ZOO_POOL1[1]}
    height: {ZOO_POOL1[2]} width: {ZOO_POOL1[3]}
    num: {ZOO_BATCH} channels: 64 height: 1 width: 1
    data_filler {{ type: "constant" value: 0.25 }}
    data_filler {{ type: "gaussian" std: 1.0 }} }} }}
layers {{ name: "mvn_loss" type: EUCLIDEAN_LOSS bottom: "mvn"
  bottom: "pool1_t" top: "mvn_loss" }}
layers {{ name: "emb" type: ID_TO_WEIGHT_MAPPING bottom: "ids" top: "w"
  id_to_weight_mapping_param {{ max_ids: {ZOO_CLASSES} num_output: 64
    weight_filler {{ type: "gaussian" std: 1.0 }} }} }}
layers {{ name: "emb_loss" type: EUCLIDEAN_LOSS bottom: "w" bottom: "emb_t"
  top: "embedding_loss" loss_weight: 0.1 }}
"""


ZOO_TYPES = {   # output or param -> the type it checks
    "softmax_loss": "SOFTMAX_LOSS", "accuracy": "ACCURACY",
    "hinge_loss": "HINGE_LOSS", "multinomial_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "infogain_loss": "INFOGAIN_LOSS", "sigmoid_loss": "SIGMOID_CROSS_ENTROPY_LOSS",
    "euclidean_loss": "EUCLIDEAN_LOSS", "contrastive_loss": "CONTRASTIVE_LOSS",
    "argmax": "ARGMAX", "per_class_accuracy": "CLASSIFICATION_STATS",
    "per_class_ap": "CLASSIFICATION_STATS",
    "class_accuracy": "CLASSIFICATION_STATS", "mvn": "MVN",
    "constant": "DUMMY_DATA (constant)", "w": "ID_TO_WEIGHT_MAPPING",
    "embedding_loss": "EUCLIDEAN_LOSS", "mvn_loss": "EUCLIDEAN_LOSS",
    "loss": "all losses, weighted"}
# tops that rank fc8's exact values: equal on both devices, ties included
ZOO_EXACT = ("accuracy", "argmax", "per_class_accuracy", "class_accuracy")


def layer_zoo(dev) -> dict:
    """_zoo_net's TRAIN Net forward and backward on the card and on the CPU
    with the same params and inputs. The fc7 features are integers 0..3 and
    fc8's weights and bias integers over 1024, so that fc8's sums are exact
    on both devices and its rows hold exact ties: ARGMAX, ACCURACY and
    CLASSIFICATION_STATS then rank the same values, and must break their
    ties alike (their tops equal). Every other output is held within
    ZOO_TOL of its largest magnitude, and so is every gradient (fc8's, the
    table's, the fc7 features' and pool1's); the gaussian DUMMY_DATA top, drawn
    from each device's own generator, by its shape and moments. fc8 is one
    K1 launch on the f32 route. Returns the counted K1 launches and the
    worst errors."""
    import tempfile

    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.wire import BlobProto
    from videovector_tpu_torch.graph import Net
    card = gpu_name_and_power_limit()
    rs = np.random.RandomState(7)
    inputs = {
        "fc7": rs.randint(0, 4, (ZOO_BATCH, 4096)).astype(np.float32),
        "label": rs.randint(0, ZOO_CLASSES, ZOO_BATCH).astype(np.float32),
        "t": rs.rand(ZOO_BATCH, ZOO_CLASSES).astype(np.float32),
        "sim": rs.randint(0, 2, ZOO_BATCH // 2).astype(np.float32),
        "ids": rs.randint(0, ZOO_CLASSES, ZOO_BATCH).astype(np.float32),
        "emb_t": rs.randn(ZOO_BATCH, 64).astype(np.float32),
        "pool1": rs.randn(*ZOO_POOL1).astype(np.float32),
        "pool1_t": rs.randn(*ZOO_POOL1).astype(np.float32)}
    weights = {"fc8": {"w": rs.randint(-2, 3, (4096, ZOO_CLASSES)) / 1024,
                       "b": rs.randint(-8, 9, ZOO_CLASSES) / 1024},
               "emb": {"table": rs.randn(ZOO_CLASSES, 64)}}
    with tempfile.TemporaryDirectory() as tmp_name:
        infogain = Path(tmp_name) / "infogain.binaryproto"
        h = rs.rand(1, 1, ZOO_CLASSES, ZOO_CLASSES).astype(np.float32)
        infogain.write_bytes(BlobProto.from_array(h).encode())
        msg = parse(_zoo_net(str(infogain)))
        runs, launches = [], None
        for d in (dev, torch.device("cpu")):
            net = Net(msg, "TRAIN")
            shapes, _ = net.init(torch.Generator(device=d).manual_seed(3),
                                 inputs)
            p = {k: {n: torch.as_tensor(v, dtype=torch.float32, device=d)
                     .requires_grad_() for n, v in lp.items()}
                 for k, lp in weights.items()}
            if {k: {n: v.shape for n, v in lp.items()} for k, lp in p.items()
                } != {k: {n: v.shape for n, v in lp.items()}
                      for k, lp in shapes.items()}:
                raise AssertionError(f"layer zoo params {shapes}")
            b = _to(inputs, d)
            for k in ("fc7", "pool1"):
                b[k].requires_grad_()
            gen = torch.Generator(device=d).manual_seed(11)

            def step():
                loss, blobs = net.apply(p, b, generator=gen,
                                        return_blobs=True)
                loss.backward()
                return loss, blobs
            if d == dev:
                (loss, blobs), launches = _counted(step)
            else:
                loss, blobs = step()
            grads = {f"d{k}/{n}": v.grad for k, lp in p.items()
                     for n, v in lp.items()}
            grads.update({f"d{k}": b[k].grad for k in ("fc7", "pool1")})
            runs.append(({"loss": loss.detach(), **{
                k: v.detach() for k, v in blobs.items()}}, grads))
    if launches != (1, 0, 1):
        raise AssertionError(f"layer zoo: K1 launches {launches}, expected "
                             "fc8 once on the f32 route")
    (oc, gc), (oh, gh) = runs
    if not torch.equal(oc["fc8"].cpu(), oh["fc8"]):
        raise AssertionError("layer zoo: fc8's exact sums differ")
    for k in ZOO_EXACT:
        if not torch.equal(oc[k].cpu(), oh[k]):
            raise AssertionError(f"layer zoo {ZOO_TYPES[k]} ({k}): the card's "
                                 "top differs from the CPU's")
    worst = {f"{name}: {k}": _rel_err(oc[k], oh[k])
             for k, name in ZOO_TYPES.items() if k not in ZOO_EXACT}
    _held("layer zoo, card vs CPU, the other tops", worst, ZOO_TOL)
    grads = {f"gradient {k}": _rel_err(gc[k], gh[k]) for k in gh}
    _held("layer zoo, card vs CPU, gradients", grads, ZOO_TOL)
    worst.update(grads)
    ties = sum(int((row[:-1] == row[1:]).sum()) for row in
               torch.sort(oh["fc8"], dim=1).values[:, -6:])
    for d, (o, _) in zip(("card", "cpu"), runs):
        noise = o["noise"]
        if noise.shape != (ZOO_BATCH, 64, 1, 1) or \
                abs(noise.mean().item()) > 0.05 or \
                abs(noise.std().item() - 1.0) > 0.05:
            raise AssertionError(f"DUMMY_DATA gaussian on {d}: "
                                 f"{tuple(noise.shape)}, mean "
                                 f"{noise.mean().item()}, std "
                                 f"{noise.std().item()}")
    log(f"  layer_zoo (TRAIN Net at B={ZOO_BATCH}, fc8 4096 -> "
        f"{ZOO_CLASSES}, pool1 {ZOO_POOL1}; {ties} exact ties among the "
        f"rows' top 6 fc8 values), card vs CPU: {', '.join(ZOO_EXACT)} "
        f"equal, the other tops and the gradients as held above; the losses "
        f"on the card "
        f"{ {k: round(oc[k].item(), 6) for k in ZOO_TYPES if k.endswith('loss')} } "
        f"[{card}]")
    return {"launches": launches[0], "f32": launches[2], "worst": worst}


# ---------------------------------------------------------------------------
# Item 9: the trajectory project and the LSTM enc-dec step
# ---------------------------------------------------------------------------

ENCDEC_NET = """
name: "lstm_encdec"
layers {{ name: "d" type: MEMORY_DATA top: "observed" top: "cont_obs"
  top: "predicted" top: "cont_pred" top: "gt" }}
layers {{ name: "encdec" type: LSTM_ENC_DEC
  bottom: "observed" bottom: "cont_obs" bottom: "predicted" bottom: "cont_pred"
  top: "enc_h" top: "dec_h"
  inner_product_param {{ num_output: {w}
    weight_filler {{ type: "gaussian" std: 0.1 }} }}
  lstm_param {{ clipping_threshold: 5.0 }} }}
layers {{ name: "silence_enc" type: SILENCE bottom: "enc_h" }}
layers {{ name: "fb" type: FLATTEN_BATCH bottom: "dec_h" top: "dec_flat" }}
layers {{ name: "readout" type: INNER_PRODUCT bottom: "dec_flat" top: "pred"
  inner_product_param {{ num_output: {w}
    weight_filler {{ type: "gaussian" std: 0.01 }} }} }}
layers {{ name: "gt_fb" type: FLATTEN_BATCH bottom: "gt" top: "gt_flat" }}
layers {{ name: "loss" type: EUCLIDEAN_LOSS bottom: "pred" bottom: "gt_flat"
  top: "displacement_loss" }}
"""

# the six item-9 types on one TRACKING_WINDOWS_SOCIAL_DATA batch (16 agents,
# T 8 + 4): LSTM and LSTM_LINEAR carried from a first forward
SIX_TYPES_NET = """
name: "item9_types"
layers { name: "d" type: MEMORY_DATA top: "observed" top: "cont_observed"
  top: "predicted" top: "cont_predicted" top: "first" top: "last"
  top: "c0" top: "h0" top: "feats" top: "relations" top: "mean_pos" }
layers { name: "rnn" type: LSTM bottom: "observed" bottom: "cont_observed"
  top: "h_lstm" inner_product_param { num_output: 64
    weight_filler { type: "gaussian" std: 0.2 } } }
layers { name: "rnn_lin" type: LSTM_LINEAR bottom: "observed"
  bottom: "cont_observed" top: "h_lin"
  inner_product_param { num_output: 32 } lstm_param { clipping_threshold: 0.05 } }
layers { name: "encdec" type: LSTM_ENC_DEC bottom: "observed"
  bottom: "cont_observed" bottom: "predicted" bottom: "cont_predicted"
  top: "enc_h" top: "dec_h" inner_product_param { num_output: 64
    weight_filler { type: "gaussian" std: 0.15 } } }
layers { name: "cond" type: LSTM_CONDITIONAL bottom: "predicted"
  bottom: "cont_predicted" bottom: "first" top: "cond_out"
  inner_product_param { num_output: 64
    weight_filler { type: "gaussian" std: 0.2 } }
  lstm_param { final_output_size: 2 } }
layers { name: "single" type: LSTM_SINGLE_STEP bottom: "last" bottom: "c0"
  bottom: "h0" top: "h_one" top: "c_one"
  inner_product_param { num_output: 64
    weight_filler { type: "gaussian" std: 0.2 } } }
layers { name: "social" type: SOCIAL_POOLING bottom: "feats"
  bottom: "relations" bottom: "mean_pos" top: "pooled"
  social_pooling_param { pool_feat_size: 32 } }
"""
SIX_TYPES_TOPS = ("h_lstm", "h_lin", "enc_h", "dec_h", "cond_out", "h_one",
                  "c_one", "pooled")


def _values_and_grads(net, params, batch, dev, tops=None, state=None):
    """One forward and backward of `net` on `dev`: (values, grads, carry),
    the scalar being the loss, or with `tops` the sum of each top times a
    seeded cotangent (made on the host, the same on both devices)."""
    p = {ln: {pn: t.detach().to(dev).requires_grad_() for pn, t in lp.items()}
         for ln, lp in params.items()}
    feed = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    st = None if state is None else {
        k: type(v)(*(t.to(dev) for t in v)) for k, v in state.items()}
    loss, blobs, carry = net.apply(p, feed, state=st, return_blobs=True,
                                   return_state=True)
    values = {"loss": loss}
    if tops:
        cr = np.random.RandomState(17)
        loss = sum((blobs[k] * torch.as_tensor(cr.randn(*blobs[k].shape)
                                               .astype(np.float32)).to(dev))
                   .sum() for k in tops)
        values = {k: blobs[k] for k in tops}
    loss.backward()
    grads = {f"{ln}/{pn}": t.grad for ln, lp in p.items()
             for pn, t in lp.items() if t.grad is not None}
    return values, grads, carry


def _card_vs_cpu_nets(dev, cases: dict) -> dict:
    """Each (net, params, batch, tops, state) on the card and on the CPU:
    values within TRAJ_VALUE_TOL and gradients within TRAJ_GRAD_TOL of
    their largest magnitude. Returns the worst errors by case."""
    out = {}
    for name, (net, params, batch, tops, state) in cases.items():
        card = _values_and_grads(net, params, batch, dev, tops, state)
        cpu = _values_and_grads(net, params, batch, "cpu", tops, state)
        if sorted(card[1]) != sorted(cpu[1]):
            raise AssertionError(f"{name}: gradients of {sorted(card[1])} "
                                 f"vs {sorted(cpu[1])}")
        out[name] = (
            _held(f"{name}, card vs CPU, values", {
                k: _rel_err(card[0][k], cpu[0][k]) for k in cpu[0]},
                TRAJ_VALUE_TOL),
            _held(f"{name}, card vs CPU, gradients", {
                k: _rel_err(card[1][k], cpu[1][k]) for k in cpu[1]},
                TRAJ_GRAD_TOL))
    return out


def _carried_train(dev, net, params, batches) -> dict:
    """train over the batches on `dev`, the LSTM carry threaded (detached)
    from batch to batch, a display every step."""
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train

    def loss_fn(p, batch, generator):
        feed = {k: v for k, v in batch.items() if k != "__carry__"}
        loss, _, carry = net.apply(p, feed, state=batch.get("__carry__"),
                                   return_state=True)
        return loss, {"__carry__": carry}
    res = train(loss_fn, params, iter(batches), SolverConfig(
        base_lr=0.05, momentum=0.9, max_iter=len(batches), display=1),
        device=dev, fused_accum=False)
    return {"loss": torch.tensor([m["loss"] for _, m in res.metrics_history]),
            **{f"param {ln}/{pn}": t for ln, lp in res.params.items()
               for pn, t in lp.items()},
            **{f"carry {k}.{f}": getattr(v, f)
               for k, v in res.final_carry.items() for f in ("c", "h")}}


def _trajectory_card_vs_cpu(dev, project_text: str, train_store: str) -> dict:
    """The card against the CPU, on the same params (drawn on the CPU) and
    the same batches: the project's TRAIN Net (the loss and every
    gradient), SIX_TYPES_NET on a TRACKING_WINDOWS_SOCIAL_DATA batch of the
    project's store (every top and gradient, LSTM and LSTM_LINEAR from a
    carried state), and train over 4 carried batches of a stateful net (the
    displayed losses, the params, the final carry)."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.tracking import (
        TrackingConfig, TrackingWindowDataset, TrackingWindowsSocialSource,
    )
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.graph.data_factory import make_data_source

    gen = torch.Generator().manual_seed(21)
    proj = Net(parse(project_text), "TRAIN")
    layer = next(l for l in proj.layers
                 if l.get("type") == "TRACKING_WINDOWS_DATA")
    proj_batch = make_data_source(layer).next_batch()
    proj_params, _ = proj.init(gen, _to(proj_batch, "cpu"))

    social = TrackingWindowsSocialSource(
        TrackingWindowDataset.from_records(train_store),
        TrackingConfig(batch_size=16, temporal_observed_size=8,
                       temporal_predicted_size=4)).next_batch()
    rng = np.random.RandomState(5)
    six_batch = {k: social[k] for k in ("observed", "cont_observed",
                                        "predicted", "cont_predicted",
                                        "relations", "mean_pos")}
    six_batch.update(
        first=np.zeros((16, 2), np.float32), last=social["observed"][-1],
        c0=rng.randn(16, 64).astype(np.float32),
        h0=rng.randn(16, 64).astype(np.float32),
        feats=social["observed"][-1][None], relations=social["relations"][None],
        mean_pos=social["mean_pos"][None])
    six = Net(parse(SIX_TYPES_NET), "TRAIN")
    six_params, _ = six.init(gen, _to(six_batch, "cpu"))
    with torch.no_grad():
        _, _, carry = six.apply(six_params, _to(six_batch, "cpu"),
                                return_state=True)
    if sorted(carry) != ["rnn", "rnn_lin"]:
        raise AssertionError(f"SIX_TYPES_NET's carry: {sorted(carry)}")
    errs = _card_vs_cpu_nets(dev, {
        "the project's TRAIN Net": (proj, proj_params, proj_batch, None, None),
        "the six item-9 types": (six, six_params, six_batch, SIX_TYPES_TOPS,
                                 carry)})

    carry_net = Net(parse("""
    layers { name: "d" type: MEMORY_DATA top: "x" top: "cont" top: "y" }
    layers { name: "rnn" type: LSTM bottom: "x" bottom: "cont" top: "h"
      inner_product_param { num_output: 64
        weight_filler { type: "gaussian" std: 0.2 } } }
    layers { name: "fb" type: FLATTEN_BATCH bottom: "h" top: "hf" }
    layers { name: "yf" type: FLATTEN_BATCH bottom: "y" top: "yf" }
    layers { name: "loss" type: EUCLIDEAN_LOSS bottom: "hf" bottom: "yf"
      top: "l" }
    """), "TRAIN")
    batches = []
    for j in range(4):
        cont = np.ones((10, 32), np.float32)
        cont[0, :16 if j else 32] = 0   # half the sequences run on
        batches.append({"x": rng.randn(10, 32, 16).astype(np.float32),
                        "cont": cont,
                        "y": rng.randn(10, 32, 64).astype(np.float32) * 0.5})
    c_params, _ = carry_net.init(gen, _to(batches[0], "cpu"))
    card = _carried_train(dev, carry_net, c_params,
                          [_to(b, dev) for b in batches])
    cpu = _carried_train("cpu", carry_net, c_params, batches)
    errs["train over 4 carried batches"] = (
        _held("train over 4 carried batches, card vs CPU, losses",
              {"loss": _rel_err(card["loss"], cpu["loss"])}, TRAJ_VALUE_TOL),
        _held("train over 4 carried batches, card vs CPU, params and carry",
              {k: _rel_err(card[k], cpu[k]) for k in cpu if k != "loss"},
              TRAJ_GRAD_TOL))
    return errs


def _trajectory_cli(dev, tmp: Path, card: str) -> dict:
    """projects/trajectory_forecast through `vvtpu-torch` (tools.cli.main
    in-process): its stores written by the port (tools/make_tracking_data,
    the project's make_synthetic_data draws), generate_net.emit's net at its
    defaults, a copy of trajectory_solver.prototxt (net, max_iter
    TRAJ_STEPS, test_interval and snapshot TRAJ_INTERVAL changed); train,
    then test and time on the snapshot. The step timed between iteration
    marks and profiled. Returns K1's launches by route and the numbers."""
    from videovector_tpu_torch.ops.hopper.matmul import matmul, matmul_plain
    from videovector_tpu_torch.solver.checkpoint import load_model
    from videovector_tpu_torch.tools import cli
    from videovector_tpu_torch.tools.make_tracking_data import write_windows

    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    stores = [write_windows(str(tmp / f"tracks_{n}.vvr"), rng, w)
              for n, w in zip(("train", "test"), TRAJ_WINDOWS)]
    write_s = time.perf_counter() - t0
    text = _emit(TRAJ_PROJECT / "generate_net.py")(*stores)
    net_path = tmp / "trajectory_train.prototxt"
    net_path.write_text(text)
    prefix = tmp / "trajectory"
    solver = _cli_solver(tmp / "trajectory_solver.prototxt", net_path, prefix,
                         template=TRAJ_PROJECT / "trajectory_solver.prototxt",
                         max_iter=TRAJ_STEPS, test_interval=TRAJ_INTERVAL,
                         snapshot=TRAJ_INTERVAL)
    log(f"  trajectory: stores of {TRAJ_WINDOWS[0]} + {TRAJ_WINDOWS[1]} "
        f"windows of 4 tracks written by the port in {write_s:.3f} s; "
        f"{solver.name}: " + "; ".join(
            l for l in solver.read_text().splitlines()
            if l and not l.startswith("#")))
    timer = _HostFedTimer(TRAJ_TIMED, TRAJ_PROFILED)
    launches = {}
    t0 = time.perf_counter()
    with _driver_marks(timer) as built, _CliCapture() as out:
        _, launches["train"] = _counted(lambda: cli.main(
            ["train", "--solver", str(solver)]))
    train_s = time.perf_counter() - t0
    driver = built[0]
    displays = [(r.args[0], float(r.args[1])) for r in out.records
                if r.msg == "Iteration %d, loss = %g"]
    tests = [(r.args[1], float(r.args[2])) for r in out.records
             if r.msg == "    Test net output #%d: %s = %g%s"]
    n_tests = len(range(0, TRAJ_STEPS + 1, TRAJ_INTERVAL))
    want = TRAJ_STEPS + 1 + n_tests * TRAJ_TEST_ITERS
    log(f"  trajectory train: {train_s:.1f} s in-process (build included); "
        f"the TRAIN source {type(driver.train_source.sources[0].source).__name__}"
        f", batch axes {driver.train_source.batch_axes()}; K1 launches (all, "
        f"sm90, f32) {launches['train']} for {TRAJ_STEPS} steps + the final "
        f"display forward + {n_tests} tests of {TRAJ_TEST_ITERS} batches; "
        f"displayed losses {displays}; test outputs {tests}")
    if launches["train"][0] != want:
        raise AssertionError(f"trajectory train: K1 launches "
                             f"{launches['train']}, expected {want}")
    if not (len(displays) == TRAJ_STEPS // 20 + 1
            and all(math.isfinite(v) for _, v in displays)
            and displays[-1][1] < displays[0][1]):
        raise AssertionError(f"trajectory train: the displayed loss did not "
                             f"fall: {displays}")
    if [k for k, _ in tests] != ["displacement_loss"] * n_tests:
        raise AssertionError(f"trajectory train: test lines {tests}")
    for name in (f"trajectory_iter_{TRAJ_INTERVAL}.vvstate",
                 f"trajectory_iter_{TRAJ_STEPS}.vvmodel"):
        if not (tmp / name).is_file():
            raise AssertionError(f"trajectory train wrote no {name}")
    step_ms, wall_ms = timer.per_step()
    log(f"  trajectory train step (hidden 32, batch 16, T 8 + 4, "
        f"TRACKING_WINDOWS_DATA through the prefetcher): {step_ms:.4f} ms "
        f"(CUDA events over {len(TRAJ_TIMED)} steps, tests excluded), host "
        f"wall {wall_ms:.4f} ms a step = {16 * 12 / step_ms * 1e3:,.0f} "
        f"tokens/s (B x (T_obs + T_pred)) [{card}]")
    prof = training_profile(timer.prof, len(TRAJ_PROFILED), wall_ms,
                            label="the trajectory project's CLI step")

    model = str(prefix) + f"_iter_{TRAJ_STEPS}.vvmodel"
    # the readout's K1 launch (core route) against its plain version, at
    # the shape train gives it, on the trained weights
    with torch.no_grad():
        blobs = driver.train_net.apply(
            _to(load_model(model), dev),
            _to(driver.train_source.next_batch(), dev), return_blobs=True)[1]
        x, p = blobs["dec_flat"], _to(load_model(model), dev)["readout"]
        readout_err = compare(
            f"K1 readout ({x.shape[0]} x {x.shape[1]}) . ({p['w'].shape[0]} "
            f"x {p['w'].shape[1]}) core route", matmul(x, p["w"], p["b"]),
            matmul_plain(x, p["w"], p["b"]), rel=1e-3)
        readout = _k1_readout_times(x, p["w"], p["b"], card)
    with _CliCapture() as out:
        _, launches["test"] = _counted(lambda: cli.main(
            ["test", "--model", str(net_path), "--weights", model,
             "--iterations", str(TRAJ_TEST_ITERS)]))
    means = {r.args[0]: float(r.args[1]) for r in out.records
             if r.msg == "%s = %g%s"}
    log(f"  trajectory test ({TRAJ_TEST_ITERS} iterations, the snapshot): "
        f"{means}; train's last test {tests[-1]}; K1 launches "
        f"{launches['test']}")
    # the test store's 160 tracks are 10 batches of 16: the tests at 0 and
    # TRAJ_INTERVAL read batches 0-4 and 5-9, the last one 0-4 again, as a
    # fresh `test` does
    if sorted(means) != ["displacement_loss"] or not (
            abs(means["displacement_loss"] - tests[-1][1])
            <= 1e-5 * abs(tests[-1][1])) or launches["test"][0] != TRAJ_TEST_ITERS:
        raise AssertionError(f"trajectory test: {means} vs train's last test "
                             f"{tests[-1]}, K1 {launches['test']}")
    with _CliCapture() as out:
        _, launches["time"] = _counted(lambda: cli.main(
            ["time", "--model", str(net_path), "--iterations", "10"]))
    for line in out.lines():
        if "(marginal)" in line or line.startswith(("Total", "Fused")):
            log(f"    trajectory time: {line} [{card}]")
    if not out.lines("Fused forward-backward"):
        raise AssertionError("trajectory time printed no fused line")
    log(f"  trajectory K1 launches by command (all, sm90, f32): {launches}")
    # the readout's (32, 2) f32 weight has 8-byte rows, which TMA cannot
    # address: every launch of the project takes K1's core route
    if any(v[1:] != (0, 0) for v in launches.values()):
        raise AssertionError(f"trajectory K1 launches off the core route: "
                             f"{launches}")
    return {"launches": launches, "step_ms": step_ms, "wall_ms": wall_ms,
            "readout_err": readout_err, "readout": readout,
            "profile": prof, "displays": displays, "text": text,
            "train_store": stores[0]}


def _encdec_bound(b: int, chain_ms: float) -> tuple[float, str, float]:
    """The least time of one enc-dec training step at batch b: the larger
    of its FLOPs at the f32 FFMA peak, 3 (forward + backward) x
    (2 B T (I + H) 4H, the gate products, + 2 B T_dec H I, the readout),
    and the recurrent chain's floor `chain_ms`."""
    i = h = ENCDEC_WIDTH
    te, td = ENCDEC_T
    flops = (3 * (2 * b * (te + td) * (i + h) * 4 * h)
             + 3 * (2 * b * td * h * i))
    ops_ms = flops / PEAK_FLOPS_F32 * 1e3
    if ops_ms >= chain_ms:
        return ops_ms, "operations", flops
    return chain_ms, "the recurrent chain", flops


def _encdec_cells(dev, card: str) -> dict:
    """The LSTM enc-dec training step at scripts/bench_lstm_train.py's
    widths (I = H = ENCDEC_WIDTH, T = 20 + 10, a 512 -> 512 readout) as a
    prototxt of the trajectory project's structure (ENCDEC_NET: the
    decoder seeded with the encoder's cell, its hidden state zero), through
    solver.train.train with that script's solver (lr 0.001 fixed, momentum
    0.9, weight decay 5e-4), on a seeded batch held on the card, at each of
    ENCDEC_BATCHES: ENCDEC_TIMED steps timed by CUDA events after
    ENCDEC_WARMUP, ENCDEC_PROFILED profiled; the readout's K1 launch (f32
    route) held against its plain version. Returns K1's launches and the
    numbers by batch."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.ops.hopper.matmul import matmul, matmul_plain
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.train import train

    w, (te, td) = ENCDEC_WIDTH, ENCDEC_T
    net = Net(parse(ENCDEC_NET.format(w=w)), "TRAIN")
    one = torch.zeros(1, device=dev)
    kernel_ms = time_graph_ms(lambda a: a.add_(1.0), [one] * 200)
    # forward and backward each walk the T steps in order, and each step
    # needs at least one kernel of its own
    chain_ms = 2 * (te + td) * kernel_ms
    steps = ENCDEC_WARMUP + ENCDEC_TIMED + ENCDEC_PROFILED + 1
    out = {"launches": (0, 0, 0), "err": 0.0, "cells": {}}
    for b in ENCDEC_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(b)
        cont_obs = torch.ones((te, b), device=dev)
        cont_obs[0] = 0.0
        batch = {"observed": torch.randn((te, b, w), generator=gen, device=dev),
                 "cont_obs": cont_obs,
                 "predicted": torch.randn((td, b, w), generator=gen,
                                          device=dev),
                 "cont_pred": torch.ones((td, b), device=dev),
                 "gt": torch.randn((td, b, w), generator=gen, device=dev)}
        params, _ = net.init(gen, batch)
        timer = _StepTimer(ENCDEC_WARMUP, ENCDEC_WARMUP + ENCDEC_TIMED,
                           ENCDEC_PROFILED)
        res, k1 = _counted(lambda: train(
            _net_loss_fn(net), params, itertools.repeat(batch),
            SolverConfig(**ENCDEC_SOLVER, max_iter=steps), device=dev,
            hooks=[(1, timer.hook)]))
        if k1 != (steps, 0, steps):
            raise AssertionError(f"enc-dec B={b}: K1 launches {k1}, expected "
                                 f"{steps} on the f32 route")
        out["launches"] = tuple(a + c for a, c in zip(out["launches"], k1))
        ms = timer.ms_per_step()
        wall_ms = timer.wall_s * 1e3 / ENCDEC_TIMED
        enqueue_ms = timer.enqueue_s * 1e3 / ENCDEC_TIMED
        bound_ms, bound_by, flops = _encdec_bound(b, chain_ms)
        log(f"  enc-dec step at B={b} (I = H = {w}, T = {te} + {td}, f32): "
            f"{ms:.4f} ms (CUDA events over {ENCDEC_TIMED} steps after "
            f"{ENCDEC_WARMUP}) = {b * (te + td) / ms * 1e3:,.0f} tokens/s "
            f"(B x {te + td} / step); host wall {wall_ms:.4f} ms, enqueue "
            f"{enqueue_ms:.4f} ms a step; bound {bound_ms:.4f} ms by "
            f"{bound_by} ({flops / 1e9:.2f} GFLOP at "
            f"{PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s: "
            f"{flops / PEAK_FLOPS_F32 * 1e3:.4f} ms; the chain {chain_ms:.4f} "
            f"ms = 2 x {te + td} steps x {kernel_ms * 1e3:.2f} us, one "
            f"kernel's least time by CUDA-graph replay), {bound_ms / ms:.1%} "
            f"of it [{card}]")
        prof = training_profile(timer.prof, ENCDEC_PROFILED, wall_ms,
                                label=f"the enc-dec step at B={b}")
        with torch.no_grad():
            blobs = net.apply(res.params, batch, return_blobs=True)[1]
            x, p = blobs["dec_flat"], res.params["readout"]
            err = compare(f"K1 readout ({td * b} x {w}) . ({w} x {w}) f32 "
                          f"route at B={b}", matmul(x, p["w"], p["b"]),
                          matmul_plain(x, p["w"], p["b"]), rel=1e-3)
        out["err"] = max(out["err"], err)
        out["cells"][b] = {"ms": ms, "wall_ms": wall_ms,
                           "tokens_s": b * (te + td) / ms * 1e3,
                           "bound_ms": bound_ms, "profile": prof}
        del res, batch, params, timer
        torch.cuda.empty_cache()
    return out


def _k1_readout_times(x, w, b, card: str) -> dict:
    """K1's core route at the trajectory readout's shape (x . w + b, f32;
    the (32, 2) weight's 8-byte rows are not TMA-addressable), by CUDA-graph
    replay in turns with its plain version and cuBLAS f32 (torch.addmm, TF32
    off), beside the bound (the larger of its bytes over HBM's rate and its
    operations over the f32 FMA peak)."""
    from videovector_tpu_torch.ops.hopper.matmul import (k1_route, matmul,
                                                         matmul_plain)
    if k1_route(x, w, torch.float32) != "core":
        raise AssertionError("trajectory readout: not K1's core route")
    fns = {"core": lambda _: matmul(x, w, b),
           "plain": lambda _: matmul_plain(x, w, b),
           "cublas": lambda _: torch.addmm(b, x, w)}
    times = {n: [] for n in fns}
    for n in ("core", "plain", "cublas", "cublas", "plain", "core"):
        times[n].append(time_graph_ms(fns[n], [0, 1, 2, 3]))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    (m, k), n_ = x.shape, w.shape[1]
    t_ops = 2 * m * k * n_ / PEAK_FLOPS_F32
    t_bytes = 4 * (m * k + k * n_ + n_ + m * n_) / PEAK_BYTES
    out = {"ms": ms["core"], "plain_ms": ms["plain"],
           "library_ms": ms["cublas"], "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"  K1 core route, the trajectory readout ({m} x {k}) . ({k} x {n_}) "
        f"+ b [{card}]: {out['ms']:.4f} ms (the bound {out['bound_ms']:.6f} "
        f"ms, {out['bound_by']}: {out['bound_ms'] / out['ms']:.4f} of it), "
        f"plain {out['plain_ms']:.4f} ms, cuBLAS f32 (TF32 off) "
        f"{out['library_ms']:.4f} ms (turns: "
        + ", ".join(f"{n} {v:.4f}" for n, t in times.items() for v in t) + ")")
    return out


def trajectory(dev) -> dict:
    """Item 9 on the card: projects/trajectory_forecast through the CLI
    (_trajectory_cli), the card against the CPU on its net, the six types
    and a carried train (_trajectory_card_vs_cpu), and the enc-dec step at
    full width (_encdec_cells). Returns K1's launches by route and the
    readout's error against its plain version."""
    import tempfile
    card = gpu_name_and_power_limit()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_name:
        cli_run = _trajectory_cli(dev, Path(tmp_name), card)
        errs = _trajectory_card_vs_cpu(dev, cli_run["text"],
                                       cli_run["train_store"])
    encdec = _encdec_cells(dev, card)
    by_route = [sum(v[i] for v in cli_run["launches"].values())
                + encdec["launches"][i] for i in range(3)]
    log(f"  trajectory phase: {time.perf_counter() - t0:.1f} s; card vs CPU "
        f"worst (values, gradients) by case {errs}; K1 launches (all, sm90, "
        f"f32) {tuple(by_route)}")
    return {"launches": by_route[0], "sm90": by_route[1], "f32": by_route[2],
            "core": by_route[0] - by_route[1] - by_route[2],
            "readout_err": encdec["err"], "core_err": cli_run["readout_err"],
            "core_times": cli_run["readout"], "cli": cli_run, "encdec": encdec}


def tf32_checks(dev) -> None:
    """With torch's global TF32 flag on, the f32 products that the port
    keeps in full f32 give what they give with it off, bit for bit: the
    Net's INNER_PRODUCT with regularization > 0 (forward and both
    gradients), RetrievalPipeline.query's scores and top-k ids, the rank
    stats' -2 q.g^T, and (item 9) the LSTM's input projection and
    recurrent products with the conditional decoder's h2o/o2h products
    (values and every gradient, at the enc-dec cell's widths) and the
    trajectory model's social projection; the flag itself does change an
    unscoped product."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.metrics import retrieval as tr
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline,
    )
    from videovector_tpu_torch.models.trajectory import (
        TrajectoryConfig, TrajectoryModel,
    )
    from videovector_tpu_torch.ops import recurrent

    def both(fn):
        outs = []
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            try:
                outs.append(fn())
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        return outs

    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((TRAIN_BATCH, 4096), generator=gen, device=dev)
    on, off = both(lambda: x @ x.T)
    if torch.equal(on, off):
        raise AssertionError("the TF32 flag changed nothing: no check")
    net = Net(parse("""
    layers { name: "d" type: MEMORY_DATA top: "x" }
    layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "y"
      inner_product_param { num_output: 4096 regularization: 0.5
        weight_filler { type: "gaussian" std: 0.01 } } }
    """), "TRAIN")
    params, _ = net.init(gen, {"x": x})

    def reg_ip():
        p = {"ip": {k: v.clone().requires_grad_()
                    for k, v in params["ip"].items()}}
        xi = x.clone().requires_grad_()
        y = net.apply(p, {"x": xi})[1]["y"]
        y.backward(torch.ones_like(y))
        return [y.detach(), xi.grad, p["ip"]["w"].grad, p["ip"]["b"].grad]

    pipe = RetrievalPipeline(device=dev)
    pp = pipe.init(gen)
    pix = torch.randint(0, 256, (8, 256, 256, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    off14 = torch.full((8,), 14, dtype=torch.int32, device=dev)
    gallery = torch.nn.functional.normalize(
        torch.randn((GALLERY_ROWS, 4096), generator=gen, device=dev), dim=1)
    gids = torch.arange(GALLERY_ROWS, dtype=torch.int32, device=dev)
    q = torch.randn((TEST_BATCH, 4096), generator=gen, device=dev)
    qv = torch.randint(0, 100, (TEST_BATCH,), generator=gen, device=dev)
    gv = torch.randint(-1, 100, (GALLERY_ROWS,), generator=gen, device=dev)
    w, t = ENCDEC_WIDTH, sum(ENCDEC_T)
    lstm_p = recurrent.init_lstm_params(gen, w, w, conditional=True,
                                        output_dim=2)
    xs = torch.randn((t, TRAIN_BATCH, w), generator=gen, device=dev)
    conts = torch.ones((t, TRAIN_BATCH), device=dev)
    first = torch.zeros((TRAIN_BATCH, 2), device=dev)

    def lstm_products():
        p = {k: v.clone().requires_grad_() for k, v in lstm_p.items()}
        h, fin = recurrent.lstm(p, xs, conts, clip_threshold=1.0)
        out, _ = recurrent.lstm_conditional(p, xs, first, conts)
        (h.sum() + fin.c.sum() + out.sum()).backward()
        return [h.detach(), out.detach()] + [p[k].grad for k in sorted(p)]

    traj = TrajectoryModel(TrajectoryConfig(hidden=w, pool_feat_size=256))
    traj_p = traj.init(gen)
    agents = 64
    traj_batch = {
        "observed": torch.randn((8, agents, 3), generator=gen, device=dev),
        "cont_observed": torch.ones((8, agents), device=dev),
        "predicted": torch.randn((4, agents, 3), generator=gen, device=dev),
        "cont_predicted": torch.ones((4, agents), device=dev),
        "mean_pos": torch.randn((agents, 2), generator=gen, device=dev),
        "relations": 1 - torch.eye(agents, device=dev),
        "is_valid": torch.ones((agents,), device=dev),
        "labels": torch.randn((4, agents, 2), generator=gen, device=dev)}

    def social_projection():
        sp = traj_p["social_proj"]["w"].clone().requires_grad_()
        loss, _ = traj.loss({**traj_p, "social_proj": {"w": sp}}, traj_batch)
        loss.backward()
        return [loss.detach(), sp.grad]

    checks = {
        "INNER_PRODUCT regularization 0.5 (y, dx, dw, db)": reg_ip,
        f"lstm and lstm_conditional at I = H = {w}, T = {t} (h, outputs, "
        "every gradient)": lstm_products,
        "TrajectoryModel's social projection (loss, gradient)":
            social_projection,
        "RetrievalPipeline.query (ids, scores)": lambda: list(pipe.query(
            pp, pix, off14, off14, off14.bool(), gallery, gids)),
        "retrieval_rank_stats_fixed_ref (dist, order, ranks)": lambda: list(
            tr._fixed_ref_peritem(q, qv, gallery, gv)[:3])}
    for name, fn in checks.items():
        on, off = both(fn)
        if not all(torch.equal(a, b) for a, b in zip(on, off)):
            raise AssertionError(f"{name}: TF32 on differs from off")
    log(f"  tf32_checks: with allow_tf32 = True in the process, "
        f"{', '.join(checks)} equal their TF32-off runs bit for bit (an "
        f"unscoped f32 product differs)")


# ---------------------------------------------------------------------------
# Caffe interop: LMDB and LevelDB stores, the .caffemodel/.solverstate pair
# ---------------------------------------------------------------------------

def _copy_store(src: str, dst: str, backend: str) -> tuple[float, int]:
    """Every record of the store at `src` written by the port's `backend`
    writer to `dst`: (seconds, value bytes)."""
    from videovector_tpu_torch.data.records import open_store, open_store_writer
    reader = open_store(src)
    t0 = time.perf_counter()
    nbytes = 0
    with open_store_writer(dst, backend) as w:
        for key, value in reader:
            w.put(key, bytes(value))
            nbytes += len(value)
    seconds = time.perf_counter() - t0
    reader.close()
    return seconds, nbytes


def _read_back(src: str, copy: str) -> float:
    """Every record of `copy` read through open_store and held bit for bit
    against the VVR store `src` (LMDB and LevelDB iterate in key order, VVR
    in insertion order); the read's seconds."""
    from videovector_tpu_torch.data.records import open_store
    t0 = time.perf_counter()
    reader = open_store(copy)
    got = [(bytes(k), bytes(v)) for k, v in reader]
    seconds = time.perf_counter() - t0
    kind = type(reader).__name__
    reader.close()
    ref = open_store(src)
    want = sorted((bytes(k), bytes(v)) for k, v in ref)
    ref.close()
    if (got if kind != "RecordReader" else sorted(got)) != want:
        raise AssertionError(f"{copy} ({kind}) does not read back the "
                             f"records of {src}")
    return seconds


def _interop_stores(tmp: Path, stores: tuple) -> dict:
    """The host stores written again by the port's LMDB and LevelDB
    writers, every record read back bit for bit; each writer's and
    reader's seconds and MB/s (host clock)."""
    out = {"vvr": stores}
    rates = {}
    for backend in ("lmdb", "leveldb"):
        paths = []
        for src in stores:
            dst = str(tmp / f"{Path(src).stem}_{backend}")
            w_s, nbytes = _copy_store(src, dst, backend)
            r_s = _read_back(src, dst)
            rates[(backend, Path(src).stem)] = (w_s, r_s, nbytes)
            paths.append(dst)
        out[backend] = tuple(paths)
    for src in stores:
        nbytes = rates[("lmdb", Path(src).stem)][2]
        rates[("vvr", Path(src).stem)] = (None, _read_back(src, src), nbytes)
    card = gpu_name_and_power_limit()
    for (backend, name), (w_s, r_s, nbytes) in rates.items():
        wrote = ("" if w_s is None else f"written in {w_s:.3f} s "
                 f"({nbytes / 1e6 / w_s:.1f} MB/s), ")
        same = ("" if w_s is None else
                ", every record bit-equal to the VVR store's")
        log(f"  {backend} {name}: {nbytes / 1e6:.1f} MB of values; {wrote}"
            f"read through open_store in {r_s:.3f} s "
            f"({nbytes / 1e6 / r_s:.1f} MB/s){same} [host clock; {card}]")
    return out


def _sampler_layer(path: str, backend: str | None) -> str:
    """generate_net.py's TRAIN data layer over `path`."""
    field = f" backend: {backend}" if backend else ""
    return (f'layers {{ name: "shot_windows" type: VIDEO_SAMPLED_SHOTS_DATA '
            f'top: "data" video_sampled_shots_data_param {{ source: "{path}" '
            f"batch_size: {TRAIN_BATCH}{field} num_negative_samples: "
            f"{TRAIN_NEG} max_buffer_size: 5000 negative_swap_percentage: 50 "
            "max_same_video_negs: 6 context_type: WINDOW context_size: 5 } }")


def _sampler_batches(paths: dict) -> None:
    """VIDEO_SAMPLED_SHOTS_DATA built by make_data_source with one seed over
    the training store in each backend (the VVR one with the native
    sampler turned off): the Python sampler each time, and the same first
    INTEROP_SAMPLER_BATCHES batches bit for bit."""
    import os
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.shots import VideoSampledShotsSource
    from videovector_tpu_torch.graph.data_factory import make_data_source
    card = gpu_name_and_power_limit()
    batches = {}
    for backend, enum in (("vvr", None), ("lmdb", "LMDB"),
                          ("leveldb", "LEVELDB")):
        layer = parse(_sampler_layer(paths[backend][0], enum)) \
            .get_list("layers")[0]
        old = os.environ.get("VVTPU_NATIVE_DATA")
        os.environ["VVTPU_NATIVE_DATA"] = "0"
        try:
            t0 = time.perf_counter()
            src = make_data_source(layer, seed=1234)
            setup = time.perf_counter() - t0
        finally:
            if old is None:
                del os.environ["VVTPU_NATIVE_DATA"]
            else:
                os.environ["VVTPU_NATIVE_DATA"] = old
        if not isinstance(src.source, VideoSampledShotsSource):
            raise AssertionError(f"{backend}: the sampler is "
                                 f"{type(src.source).__name__}")
        t0 = time.perf_counter()
        batches[backend] = [src.next_batch()["data"]
                            for _ in range(INTEROP_SAMPLER_BATCHES)]
        ms = (time.perf_counter() - t0) / INTEROP_SAMPLER_BATCHES * 1e3
        log(f"  sampler from {backend}: set-up (store read, reservoir fill) "
            f"{setup:.3f} s, {ms:.3f} ms a batch of {TRAIN_BATCH} x "
            f"{1 + 4 + TRAIN_NEG} x {HOST_DIM} (host clock, "
            f"{INTEROP_SAMPLER_BATCHES} batches) [{card}]")
    for backend in ("lmdb", "leveldb"):
        for i, (a, b) in enumerate(zip(batches[backend], batches["vvr"])):
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"sampler batch {i} from {backend} "
                                     "differs from the VVR store's")
    log(f"  the first {INTEROP_SAMPLER_BATCHES} sampler batches are bit-equal "
        "from LMDB, LevelDB and VVR")


def _interop_net(paths: dict) -> str:
    """generate_net.py's net, its TRAIN source on the LMDB training store
    and its TEST source on the LevelDB test store, each naming its
    backend."""
    text = _emit()(paths["lmdb"][0], paths["leveldb"][1], buffer_size=5000)
    text = _replace_once(text, "    context_size: 5\n",
                         "    context_size: 5\n    backend: LMDB\n")
    return _replace_once(text, f"    batch_size: {TEST_BATCH}\n",
                         f"    batch_size: {TEST_BATCH}\n    backend: LEVELDB\n")


def _iteration_losses(out) -> list:
    return [(r.args[0], float(r.args[1])) for r in out.records
            if r.msg == "Iteration %d, loss = %g"]


def _interop_training(tmp: Path, paths: dict) -> dict:
    """`vvtpu-torch train` from the LMDB store with snapshot_format "caffe",
    the two resumes, the .caffemodel against the .vvmodel, and `test` on
    the .caffemodel over the LevelDB test store."""
    from videovector_tpu_torch.data.netproto import load_net
    from videovector_tpu_torch.data.records import open_store
    from videovector_tpu_torch.data.shots import VideoSampledShotsSource
    from videovector_tpu_torch.data.weights import params_to_weights
    from videovector_tpu_torch.solver.checkpoint import load_model
    from videovector_tpu_torch.tools import cli
    card = gpu_name_and_power_limit()
    if type(open_store(paths["leveldb"][1])).__name__ != "LevelDbReader":
        raise AssertionError("the test store is not read as LevelDB")
    net_path = tmp / "interop_net.prototxt"
    net_path.write_text(_interop_net(paths))
    prefix = tmp / "interop"
    solver = _cli_solver(tmp / "interop_solver.prototxt", net_path, prefix,
                         max_iter=INTEROP_STEPS, test_interval=INTEROP_INTERVAL,
                         snapshot=INTEROP_SNAPSHOT, display=1,
                         snapshot_format='"caffe"')
    launches = {}
    timer = _HostFedTimer(INTEROP_TIMED, INTEROP_PROFILED)
    t0 = time.perf_counter()
    with _driver_marks(timer) as built, _CliCapture() as out:
        _, launches["train"] = _counted(lambda: cli.main(
            ["train", "--solver", str(solver)]))
    train_s = time.perf_counter() - t0
    sampler = built[0].train_source.sources[0].source
    if not isinstance(sampler, VideoSampledShotsSource):
        raise AssertionError(f"interop train: the TRAIN source is "
                             f"{type(sampler).__name__}, not the Python one")
    n_tests = len(range(0, INTEROP_STEPS + 1, INTEROP_INTERVAL))
    want = INTEROP_STEPS + 1 + n_tests
    losses = _iteration_losses(out)
    log(f"  interop train (LMDB TRAIN store, LevelDB TEST store, "
        f"snapshot_format caffe): {train_s:.1f} s in-process; K1 launches "
        f"(all, sm90, f32) {launches['train']}, want ({want}, 0, {want}) for "
        f"{INTEROP_STEPS} steps + the final display forward + {n_tests} "
        f"tests; last loss {losses[-1] if losses else None}; the last test "
        f"lines {out.lines('    Test net output')[-3:]}")
    if launches["train"] != (want, 0, want) or \
            not all(math.isfinite(v) for _, v in losses):
        raise AssertionError("interop train: K1 launches or losses off")
    for it in (INTEROP_SNAPSHOT, INTEROP_STEPS):
        for ext in ("vvmodel", "vvstate", "caffemodel", "solverstate"):
            if not Path(f"{prefix}_iter_{it}.{ext}").is_file():
                raise AssertionError(f"no {prefix.name}_iter_{it}.{ext}")
    step_ms, wall_ms = timer.per_step()
    log(f"  interop CLI step at B={TRAIN_BATCH} (f32 Net, Python sampler "
        f"over LMDB through the prefetcher): {step_ms:.4f} ms (CUDA events "
        f"over {len(INTEROP_TIMED)} steps, tests excluded), host wall "
        f"{wall_ms:.4f} ms a step [{card}]")
    prof = training_profile(timer.prof, len(INTEROP_PROFILED), wall_ms,
                            label=f"B={TRAIN_BATCH}, LMDB-fed CLI")
    t0 = time.perf_counter()
    for _ in range(10):
        sampler.next_batch()
    sampler_ms = (time.perf_counter() - t0) / 10 * 1e3
    log(f"  the Python sampler over the LMDB store: {sampler_ms:.3f} ms a "
        f"batch (host clock, 10 batches) [{card}]")

    # the two resumes from iteration INTEROP_SNAPSHOT
    resumed = {}
    for ext in ("solverstate", "vvstate"):
        rsolver = _cli_solver(tmp / f"resume_{ext}.prototxt", net_path,
                              tmp / f"resumed_{ext}", max_iter=INTEROP_STEPS,
                              test_interval=INTEROP_INTERVAL, snapshot=0,
                              display=1)
        with _CliCapture() as out:
            _, launches[ext] = _counted(lambda: cli.main(
                ["train", "--solver", str(rsolver), "--snapshot",
                 f"{prefix}_iter_{INTEROP_SNAPSHOT}.{ext}"]))
        resumed[ext] = _iteration_losses(out)
        log(f"  train --snapshot {prefix.name}_iter_{INTEROP_SNAPSHOT}.{ext}:"
            f" {out.lines('Restoring')}; K1 launches {launches[ext]}")
    n_resumed = INTEROP_STEPS - INTEROP_SNAPSHOT + 1
    want_r = n_resumed + len(range(INTEROP_SNAPSHOT, INTEROP_STEPS + 1,
                                   INTEROP_INTERVAL))
    its = [i for i, _ in resumed["solverstate"]]
    if its != list(range(INTEROP_SNAPSHOT, INTEROP_STEPS + 1)) or \
            [i for i, _ in resumed["vvstate"]] != its or \
            any(launches[e] != (want_r, 0, want_r) for e in resumed):
        raise AssertionError(f"resumes: iterations {its}, K1 "
                             f"{launches['solverstate']} / "
                             f"{launches['vvstate']}, want {want_r}")
    a = np.array([v for _, v in resumed["solverstate"]])
    b = np.array([v for _, v in resumed["vvstate"]])
    if a.tobytes() == b.tobytes():
        log(f"  the .solverstate and .vvstate resumes: losses of iterations "
            f"{its[0]}..{its[-1]} bit-equal")
    else:
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        log(f"  the .solverstate and .vvstate resumes differ at iterations "
            f"{[i for i, r in zip(its, rel) if r > 0]}: largest relative "
            f"difference {rel.max():.3e}")
        if rel.max() > 1e-6:
            raise AssertionError("the resumes disagree beyond 1e-6 relative")

    # the .caffemodel's blobs against the .vvmodel's
    _, weights = load_net(f"{prefix}_iter_{INTEROP_STEPS}.caffemodel")
    ref = params_to_weights(load_model(
        f"{prefix}_iter_{INTEROP_STEPS}.vvmodel")).by_name()
    n_blobs = 0
    for layer in weights.layers:
        if not layer.blobs:
            continue
        mine = ref[layer.name].blobs
        if len(mine) != len(layer.blobs) or any(
                (x.num, x.channels, x.height, x.width) !=
                (y.num, y.channels, y.height, y.width)
                or np.asarray(x.data, np.float32).tobytes()
                != np.asarray(y.data, np.float32).tobytes()
                for x, y in zip(layer.blobs, mine)):
            raise AssertionError(f"{layer.name}: the .caffemodel's blobs are "
                                 "not the .vvmodel's")
        n_blobs += len(mine)
    if n_blobs != 2 * len(ref):
        raise AssertionError(f"the .caffemodel holds {n_blobs} blobs")
    log(f"  {prefix.name}_iter_{INTEROP_STEPS}.caffemodel: {n_blobs} blobs "
        f"(layers {sorted(ref)}) bit-equal to the .vvmodel's")

    with _CliCapture() as out:
        _, launches["test"] = _counted(lambda: cli.main(
            ["test", "--model", str(net_path), "--weights",
             f"{prefix}_iter_{INTEROP_STEPS}.caffemodel", "--iterations",
             "1"]))
    means = {r.args[0]: float(r.args[1]) for r in out.records
             if r.msg == "%s = %g%s"}
    log(f"  test --weights {prefix.name}_iter_{INTEROP_STEPS}.caffemodel on "
        f"the LevelDB test store: {means}; K1 launches {launches['test']}")
    if sorted(means) != ["test_hit1", "test_hit5", "test_map"] or \
            not all(0.0 <= v <= 1.0 for v in means.values()) or \
            launches["test"] != (1, 0, 1):
        raise AssertionError("interop test: outputs or launches off")
    return {"k1_f32": sum(v[2] for v in launches.values()),
            "step_ms": step_ms, "wall_ms": wall_ms, "profile": prof,
            "sampler_ms": sampler_ms}


def _window_trainer(tmp: Path, paths: dict) -> int:
    """VIDEO_SHOT_WINDOW_DATA, the reference's window trainer, through
    `vvtpu-torch train` for WINDOW_STEPS steps over a LevelDB store of
    TEST_BATCH VideoShotWindow records (a target and 4 context shots of
    one video of the training store each), negatives from a reservoir of
    WINDOW_RESERVOIR shots; the K1 f32 launches."""
    import re
    from videovector_tpu_torch.data.generic import VideoShotWindowSource
    from videovector_tpu_torch.data.records import open_store_writer
    from videovector_tpu_torch.data.shots import ShotDataset
    from videovector_tpu_torch.data.wire import Datum, VideoShotWindow
    from videovector_tpu_torch.tools import cli
    videos = ShotDataset.from_records(paths["lmdb"][0]).videos
    store = tmp / "shot_windows_leveldb"
    t0 = time.perf_counter()
    with open_store_writer(str(store), "leveldb") as w:
        for i in range(TEST_BATCH):
            v = videos[i % len(videos)]
            ids = [(i + j) % len(v.features) for j in range(5)]
            w.put(f"{i:08d}", VideoShotWindow(
                video_id=int(v.video_id), shot_id=i,
                target_shot_word=Datum(float_data=v.features[ids[0]]),
                context_shot_words=[Datum(float_data=v.features[j])
                                    for j in ids[1:]]).encode())
    write_s = time.perf_counter() - t0
    text, n = re.subn(
        r'  type: VIDEO_SAMPLED_SHOTS_DATA\n  top: "data"\n'
        r"  video_sampled_shots_data_param \{.*?\n  \}\n",
        '  type: VIDEO_SHOT_WINDOW_DATA\n  top: "data"\n'
        f'  video_shot_window_data_param {{\n    source: "{store}"\n'
        f"    batch_size: {TRAIN_BATCH}\n    backend: LEVELDB\n"
        f"    num_negative_samples: {TRAIN_NEG}\n"
        f"    max_buffer_size: {WINDOW_RESERVOIR}\n"
        "    negative_swap_percentage: 50\n  }\n",
        _interop_net(paths), flags=re.S)
    if n != 1:
        raise AssertionError("the TRAIN data layer was not replaced once")
    net_path = tmp / "window_net.prototxt"
    net_path.write_text(text)
    solver = _cli_solver(tmp / "window_solver.prototxt", net_path,
                         tmp / "window", max_iter=WINDOW_STEPS,
                         test_interval=WINDOW_STEPS, snapshot=0, display=1)
    timer = _HostFedTimer(range(1, WINDOW_STEPS), range(0))
    t0 = time.perf_counter()
    with _driver_marks(timer) as built, _CliCapture() as out:
        _, k1 = _counted(lambda: cli.main(["train", "--solver", str(solver)]))
    train_s = time.perf_counter() - t0
    src = built[0].train_source.sources[0].source
    want = WINDOW_STEPS + 1 + 2
    losses = _iteration_losses(out)
    step_ms, wall_ms = timer.per_step()
    log(f"  window trainer (VIDEO_SHOT_WINDOW_DATA over {store.name}, "
        f"{TEST_BATCH} windows written in {write_s:.3f} s): source "
        f"{type(src).__name__}, {src.channels} channels; {WINDOW_STEPS} "
        f"steps in {train_s:.1f} s in-process (build included), "
        f"{step_ms:.4f} ms a step (CUDA events over steps 1..{WINDOW_STEPS - 1}"
        f"; host wall {wall_ms:.4f}) [{gpu_name_and_power_limit()}]; losses "
        f"{[round(v, 4) for _, v in losses]}; K1 launches {k1}, want "
        f"({want}, 0, {want})")
    if not isinstance(src, VideoShotWindowSource) or \
            src.channels != 1 + 4 + TRAIN_NEG or k1 != (want, 0, want) or \
            len(losses) != WINDOW_STEPS + 1 or \
            not all(math.isfinite(v) for _, v in losses):
        raise AssertionError("window trainer: source, losses or launches off")
    return k1[2]


def _db_features(out: str, name: str, backend: str) -> np.ndarray:
    """The rows extract wrote into the `backend` store of blob `name`, in
    extraction order, after checking the keys, the Datum shapes and the
    text file (the reference's %g rows for leveldb)."""
    from videovector_tpu_torch.data.records import open_store
    from videovector_tpu_torch.data.wire import Datum
    n = EXTRACT_BATCHES * BATCH
    reader = open_store(f"{out}_{name}_{backend}")
    keys = [reader.key(i).decode() for i in range(len(reader))]
    datums = [Datum.decode(bytes(reader.value(i))) for i in range(len(reader))]
    reader.close()
    if backend == "leveldb":
        want_keys = sorted(str(i) for i in range(n))
        dim = datums[0].height
        shape = (1, dim, 1)
    else:
        want_keys = [f"{i:010d}" for i in range(n)]
        dim = datums[0].channels
        shape = (dim, 1, 1)
    if keys != want_keys or any((d.channels, d.height, d.width) != shape
                                for d in datums):
        raise AssertionError(f"{backend} {name}: keys or Datum shapes off")
    rows = np.zeros((n, dim), np.float32)
    for k, d in zip(keys, datums):
        rows[int(k)] = d.float_data
    if backend == "leveldb":
        text = Path(f"{out}_{name}_leveldb/text_output.txt").read_text() \
            .splitlines()
        if len(text) != n + 1 or text[0] != "#features":
            raise AssertionError(f"leveldb {name}: text_output.txt rows")
        for i in (0, n - 1):
            if text[1 + i] != "".join(f"{float(v):g}," for v in rows[i]):
                raise AssertionError(f"leveldb {name}: text row {i} is not "
                                     "the reference's %g row")
    else:
        text = Path(f"{out}_{name}.txt").read_text().splitlines()
        if len(text) != n or text[0] != ",".join(f"{v:.6f}" for v in rows[0]):
            raise AssertionError(f"lmdb {name}: text file rows")
    return rows


def _interop_extraction(tmp: Path, dev) -> dict:
    """extract_features.main over an LMDB copy of the extraction frame
    store, at batch BATCH for EXTRACT_BATCHES batches, with --backend=vvr,
    lmdb and leveldb: the launch counts of each run, the features of both
    databases bit-equal to the VVR run's, images/s per backend."""
    from videovector_tpu_torch.tools import extract_features
    card = gpu_name_and_power_limit()
    inp = _write_extraction_inputs(tmp, dev)
    frames = str(tmp / "frames_lmdb")
    copy_s, nbytes = _copy_store(inp["store"], frames, "lmdb")
    _read_back(inp["store"], frames)
    net = tmp / "extraction_lmdb.prototxt"
    net.write_text(_replace_once(
        Path(inp["net"]).read_text(), f'    source: "{inp["store"]}"\n',
        f'    source: "{frames}"\n    backend: LMDB\n'))
    log(f"  extraction frames copied to LMDB: {nbytes / 1e6:.1f} MB in "
        f"{copy_s:.3f} s; the DATA layer reads {Path(frames).name}")
    argv = [f"--model={net}", f"--weights={inp['weights']}",
            f"--blobs={','.join(EXTRACT_BLOBS)}",
            f"--num_batches={EXTRACT_BATCHES}"]
    out = str(tmp / "features")
    counts = {"k2_f32": 0, "repack": 0, "k1_f32": 0}
    want_k2 = (K2_F32_PER_BATCH * EXTRACT_BATCHES, 0,
               K2_REPACK_PER_BATCH * EXTRACT_BATCHES,
               K2_F32_PER_BATCH * EXTRACT_BATCHES)
    want_k1 = (K1_PER_EXTRACT_BATCH * EXTRACT_BATCHES, 0,
               K1_PER_EXTRACT_BATCH * EXTRACT_BATCHES)
    feats, images_s = {}, {}
    for backend in ("vvr", "lmdb", "leveldb"):
        torch.cuda.synchronize()
        with _BatchMarks() as marks, _tally() as tallied:
            rc = extract_features.main(argv + [f"--out={out}",
                                               f"--backend={backend}"])
            torch.cuda.synchronize()
        k2c, k1c = _k2_counts(tallied), _k1_counts(tallied)
        images_s[backend] = BATCH * (EXTRACT_BATCHES - 1) / (
            marks.marks[-1] - marks.marks[0])
        log(f"  extract --backend={backend}: rc {rc}; K2 (all, sm90, repack, "
            f"f32) {k2c}, want {want_k2}; K1 (all, sm90, f32) {k1c}, want "
            f"{want_k1}; batches 2..{EXTRACT_BATCHES} "
            f"{images_s[backend]:.1f} images/s (host clock) [{card}]")
        if rc != 0 or k2c != want_k2 or k1c != want_k1:
            raise AssertionError(f"extract --backend={backend}: exit code or "
                                 "launch counts off")
        counts["k2_f32"] += k2c[3]
        counts["repack"] += k2c[2]
        counts["k1_f32"] += k1c[2]
        feats[backend] = {
            name: (_read_features(out, name) if backend == "vvr"
                   else _db_features(out, name, backend))
            for name in EXTRACT_BLOBS}
    for backend in ("lmdb", "leveldb"):
        for name in EXTRACT_BLOBS:
            if feats[backend][name].tobytes() != feats["vvr"][name].tobytes():
                raise AssertionError(f"{backend} {name}: features differ from "
                                     "the vvr run's")
    log("  the features read back from the LMDB and LevelDB stores are "
        "bit-equal to the --backend=vvr run's; the LevelDB text file has "
        "the reference's #features header and %g rows")
    return {**counts, "images_s": images_s}


def _host_only_sources(tmp: Path) -> None:
    """HDF5_DATA (files of the port's HDF5 writer: the card's machine has no
    h5py), FLEXIBLE_DATA over LMDB stores and MEMORY_DATA (fed by its
    caller, so no factory in either package): one batch each."""
    from videovector_tpu_torch.config import parse
    from videovector_tpu_torch.data.generic import MemoryDataSource
    from videovector_tpu_torch.data.hdf5 import write_hdf5
    from videovector_tpu_torch.data.records import open_store_writer
    from videovector_tpu_torch.data.wire import Datum
    from videovector_tpu_torch.graph.data_factory import make_data_source
    import importlib
    data = np.arange(10 * 8 * 6 * 5, dtype=np.float32).reshape(10, 8, 6, 5)
    label = (1 + np.arange(10, dtype=np.float32))[:, None]
    write_hdf5(str(tmp / "sample.h5"), {"data": data, "label": label})
    (tmp / "h5.txt").write_text(f"{tmp / 'sample.h5'}\n")
    rng = np.random.RandomState(3)
    with open_store_writer(str(tmp / "flex_frames"), "lmdb") as w:
        for i in range(12):
            w.put(f"f{i:03d}", Datum(channels=3, height=32, width=32,
                                     data=rng.randint(0, 256, 3 * 32 * 32,
                                                      dtype=np.uint8)
                                     .tobytes()).encode())
    with open_store_writer(str(tmp / "flex_index"), "lmdb") as w:
        for j, center in enumerate((2, 5, 7, 9)):
            w.put(f"{j:09d}f{center:03d}", f"{j + 1:04d}".encode())
    layers = {
        "HDF5_DATA": f'layers {{ name: "h" type: HDF5_DATA top: "data" '
                     f'top: "label" hdf5_data_param {{ source: '
                     f'"{tmp / "h5.txt"}" batch_size: 5 }} }}',
        "FLEXIBLE_DATA": f'layers {{ name: "f" type: FLEXIBLE_DATA '
                         f'top: "stack" top: "label" data_param {{ source: '
                         f'"{tmp / "flex_index"}" batch_size: 4 backend: LMDB }}'
                         f' flexible_data_param {{ flexible_source: '
                         f'"{tmp / "flex_frames"}" forward_len: 1 '
                         f'backward_len: 2 }} transform_param {{ crop_size: 28'
                         f' mirror: true }} }}'}
    shapes = {}
    for ltype, text in layers.items():
        batch = make_data_source(parse(text).get_list("layers")[0],
                                 phase="TRAIN").next_batch()
        shapes[ltype] = {k: v.shape for k, v in batch.items()}
        if not all(np.isfinite(v).all() for v in batch.values()):
            raise AssertionError(f"{ltype}: non-finite batch")
    hb = make_data_source(parse(layers["HDF5_DATA"]).get_list("layers")[0]) \
        .next_batch()
    if hb["data"].tobytes() != data[:5].tobytes() or \
            hb["label"].reshape(-1).tolist() != [1, 2, 3, 4, 5]:
        raise AssertionError("HDF5_DATA: rows are not the file's")
    mem = MemoryDataSource({"x": data.reshape(10, -1), "y": label}, 4)
    shapes["MEMORY_DATA"] = {k: v.shape for k, v in mem.next_batch().items()}
    decoders = []
    for mod in ("cv2", "PIL"):
        try:
            importlib.import_module(mod)
            decoders.append(f"{mod} present")
        except ImportError:
            decoders.append(f"{mod} absent")
    log(f"  host-only sources, one batch each: {shapes} (HDF5_DATA's rows "
        "are the file's); WINDOW_DATA is not driven on the card: it decodes "
        f"images through cv2 or PIL ({', '.join(decoders)} here) and the "
        "CPU tests hold it against JAX's")


def caffe_interop(dev, stores: tuple) -> dict:
    """ROADMAP item 1b on the card: the host stores as LMDB and LevelDB
    (_interop_stores), the sampler from the three backends
    (_sampler_batches), the LMDB-fed CLI training with its Caffe snapshot
    pair and both resumes (_interop_training), the window trainer over
    LevelDB (_window_trainer), extraction from LMDB into each backend
    (_interop_extraction) and the host-only sources. Returns the phase's
    K1 and K2 launches."""
    import tempfile
    card = gpu_name_and_power_limit()
    log(f"caffe_interop [{card}]:")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        paths = _interop_stores(tmp, stores)
        _sampler_batches(paths)
        torch.cuda.empty_cache()
        train = _interop_training(tmp, paths)
        torch.cuda.empty_cache()
        window_k1 = _window_trainer(tmp, paths)
        torch.cuda.empty_cache()
        ext = _interop_extraction(tmp, dev)
        _host_only_sources(tmp)
    log(f"  caffe_interop phase: {time.perf_counter() - t0:.1f} s; K1 f32 "
        f"launches {train['k1_f32'] + window_k1 + ext['k1_f32']}, K2 f32 "
        f"{ext['k2_f32']}, repacks {ext['repack']}")
    return {"k1_f32": train["k1_f32"] + window_k1 + ext["k1_f32"],
            "k2_f32": ext["k2_f32"], "repack": ext["repack"],
            "train": train, "images_s": ext["images_s"]}



@contextlib.contextmanager
def _train_results():
    """The TrainResults of the driver's train calls while the CLI runs."""
    from videovector_tpu_torch.solver import driver as drv
    results, orig = [], drv.train

    def kept(*args, **kw):
        results.append(orig(*args, **kw))
        return results[-1]

    drv.train = kept
    try:
        yield results
    finally:
        drv.train = orig


@contextlib.contextmanager
def _first_sampler_draws():
    """The driver's on-device sampler with the draws of its first call
    kept: that call runs draw_step and apply_step (the body of
    train_batch_with_device_negatives) with the draws recorded, every later
    call the function itself."""
    from videovector_tpu_torch.data import device_sampler as ds
    from videovector_tpu_torch.solver import driver as drv
    kept, orig = {}, drv.train_batch_with_device_negatives

    def first(reservoir, generator, host_part, num_negatives):
        if kept:
            return orig(reservoir, generator, host_part, num_negatives)
        b, c = host_part.shape[:2]
        draws = ds.draw_step(reservoir, generator, b, num_negatives, b * c)
        out = ds.apply_step(reservoir, host_part, draws)
        kept.update(draws=draws, buffer=reservoir.buffer, host=host_part,
                    batch=out[0])
        return out

    drv.train_batch_with_device_negatives = first
    try:
        yield kept
    finally:
        drv.train_batch_with_device_negatives = orig


def _check_first_draws(kept: dict) -> None:
    """The first step's batch: the host rows, then each item's
    TRAIN_NEG negatives, distinct reservoir rows, gathered; its accepted
    offers within 4 sigma of the swap rate."""
    d, host, batch = kept["draws"], kept["host"], kept["batch"]
    b, c = host.shape[:2]
    if tuple(batch.shape) != (b, c + TRAIN_NEG, HOST_DIM):
        raise AssertionError(f"device_negatives batch {tuple(batch.shape)}")
    distinct = int((d.ids.sort(dim=1).values.diff(dim=1) > 0).all(dim=1).sum())
    if distinct != b or not (torch.equal(batch[:, :c], host) and torch.equal(
            batch[:, c:], kept["buffer"][d.ids])):
        raise AssertionError(f"device_negatives: {distinct} of {b} items with "
                             "distinct negatives, or a batch not gathered")
    m, p = b * c, DN_SWAP / 100
    acc = int(d.accept.sum())
    sigma = math.sqrt(m * p * (1 - p))
    log(f"  the first step's draws: {b} items x {TRAIN_NEG} negatives, each "
        f"item's distinct; {acc} of {m} offers accepted (expected "
        f"{m * p:.0f} +- {4 * sigma:.1f} at 4 sigma)")
    if abs(acc - m * p) > 4 * sigma:
        raise AssertionError(f"accepted offers {acc} of {m}")


def _replaced_share(seed_buf, final, steps: int) -> None:
    """The share of reservoir rows that differ from the seed after `steps`
    steps, against 1 - (1 - p/N)^(M steps), the chance that at least one
    accepted offer of M a step landed on a row, within 4 sigma of a
    binomial over the N rows."""
    n = DN_BUFFER
    share = float((final.cpu() != torch.as_tensor(seed_buf)).any(dim=1)
                  .double().mean())
    offers = TRAIN_BATCH * DN_CONTEXT * steps
    want = 1 - (1 - DN_SWAP / 100 / n) ** offers
    sigma = math.sqrt(want * (1 - want) / n)
    log(f"  reservoir rows replaced over {steps} steps: {share:.4f} (expected "
        f"{want:.4f} +- {4 * sigma:.4f} at 4 sigma, swap {DN_SWAP:g}%, "
        f"{offers} offers into {n} rows)")
    if abs(share - want) > 4 * sigma:
        raise AssertionError(f"replaced share {share} vs {want}")


def _dn_feed_times(driver, dev, card) -> None:
    """The host source's ms a batch (host clock over 20), the bytes it
    ships against the full batch's, and the sampler's own sample + update
    on the card (CUDA events over 20) at the flagship's shapes."""
    from videovector_tpu_torch.data.device_sampler import (
        DeviceReservoir, train_batch_with_device_negatives,
    )
    src = driver.train_source
    t0 = time.perf_counter()
    for _ in range(20):
        batch = src.next_batch()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    nbytes = sum(np.asarray(v).nbytes for v in batch.values())
    full = TRAIN_BATCH * (DN_CONTEXT + TRAIN_NEG) * HOST_DIM * 4
    host = torch.as_tensor(batch["data"], device=dev)
    res = DeviceReservoir(torch.as_tensor(driver.device_negatives["buffer"],
                                          device=dev), DN_SWAP)
    gen = torch.Generator(device=dev).manual_seed(3)
    sampler_ms = time_ms(lambda: train_batch_with_device_negatives(
        res, gen, host, TRAIN_NEG))
    log(f"  device_negatives feed [{card}]: the host source (Python sampler, "
        f"no negatives) {host_ms:.3f} ms a batch (host clock over 20); H2D "
        f"{nbytes / 1e6:.2f} MB a step (data {tuple(batch['data'].shape)} + "
        f"video ids) against {full / 1e6:.2f} MB for (B, "
        f"{DN_CONTEXT + TRAIN_NEG}, {HOST_DIM}); the sampler's sample + "
        f"update on the card {sampler_ms:.4f} ms (CUDA events over 20: the "
        f"topk draw over ({TRAIN_BATCH}, {DN_BUFFER}), the gather, the "
        "concat, the winners' scatter-max and the "
        f"{DN_BUFFER * HOST_DIM * 4 / 1e6:.0f} MB reservoir copy)")


def _python_fed_step(tmp: Path, stores: tuple, card) -> float:
    """The step this path replaces: the same net without device_negatives,
    fed by the Python sampler (VVTPU_NATIVE_DATA=0, as an LMDB store is),
    host and reservoir both on the host, through the CLI."""
    import os
    from videovector_tpu_torch.tools import cli
    net_path = tmp / "py_net.prototxt"
    net_path.write_text(_emit()(*stores, buffer_size=DN_BUFFER))
    solver = _cli_solver(tmp / "py_solver.prototxt", net_path, tmp / "py",
                         max_iter=DN_PY_STEPS, test_interval=DN_INTERVAL,
                         snapshot=0)
    timer = _HostFedTimer(DN_PY_TIMED, range(0))
    os.environ["VVTPU_NATIVE_DATA"] = "0"
    try:
        with _driver_marks(timer):
            cli.main(["train", "--solver", str(solver)])
    finally:
        del os.environ["VVTPU_NATIVE_DATA"]
    step_ms, wall_ms = timer.per_step()
    log(f"  the step it replaces, the Python-sampler-fed CLI step at "
        f"B={TRAIN_BATCH} (host reservoir, (B, {DN_CONTEXT + TRAIN_NEG}, "
        f"{HOST_DIM}) shipped): "
        f"{step_ms:.4f} ms (CUDA events over {len(DN_PY_TIMED)} steps), host "
        f"wall {wall_ms:.4f} ms [{card}]")
    return step_ms


def _debug_and_vis(tmp: Path, stores: tuple, card) -> int:
    """DEBUG_STEPS steps of the native-fed flagship through the CLI with
    debug_info, display and snapshot_vis every DEBUG_EVERY: the
    [debug_info] lines and the vis_iter_*.json files checked. Returns its
    K1 launches."""
    from videovector_tpu_torch.tools import cli
    net_path = tmp / "debug_net.prototxt"
    net_path.write_text(_emit()(*stores, buffer_size=DN_BUFFER))
    vis_dir = tmp / "vis"
    solver = _cli_solver(tmp / "debug_solver.prototxt", net_path,
                         tmp / "debug", max_iter=DEBUG_STEPS,
                         test_interval=DEBUG_STEPS, snapshot=0,
                         display=DEBUG_EVERY, debug_info="true",
                         snapshot_vis=DEBUG_EVERY,
                         snapshot_vis_dir=f'"{vis_dir}"')
    t0 = time.perf_counter()
    with _CliCapture() as out:
        _, k1 = _counted(lambda: cli.main(["train", "--solver", str(solver)]))
    secs = time.perf_counter() - t0
    lines = out.lines("    [debug_info]")
    files = sorted(p.name for p in vis_dir.glob("vis_iter_*.json"))
    want = [f"vis_iter_{i}.json" for i in range(0, DEBUG_STEPS, DEBUG_EVERY)]
    doc = json.loads((vis_dir / want[0]).read_text()) if files else {}
    log(f"  debug_info + snapshot_vis: {DEBUG_STEPS} native-fed steps in "
        f"{secs:.1f} s (build included; K1 {k1}); {len(lines)} [debug_info] "
        f"lines, e.g. {lines[:2]}; {files}: {len(doc.get('layers', []))} "
        f"layers, blobs {sorted(doc.get('blobs', {}))[:6]} [{card}]")
    if sorted(files) != sorted(want) or not lines or \
            len(lines) % len(want) or not doc.get("blobs"):
        raise AssertionError(f"debug_info/snapshot_vis: {files}, "
                             f"{len(lines)} lines")
    return k1[0]


def device_negatives(dev, stores: tuple) -> dict:
    """ROADMAP item 7 on the card: generate_net.py's net with
    `device_negatives: true` (B = 128, 4096 wide, 10 negatives from a
    5,000 x 4096 f32 reservoir on the card, swap 50%) over the host
    training store, through `tools.cli.main` with a copy of the repo's
    solver (max_iter DN_STEPS, test_interval DN_INTERVAL): the seed
    buffer against a host NegativeReservoir fill from the same seed, the
    host batch's shape, the first step's draws, the replaced share, one K1
    f32-route launch per INNER_PRODUCT call; the step, its profile, the
    feed and the sampler timed, beside the Python-sampler-fed step it
    replaces; then debug_info and snapshot_vis on the native-fed net.
    Returns the K1 launches."""
    import tempfile

    from videovector_tpu_torch.data.shots import NegativeReservoir, ShotDataset
    from videovector_tpu_torch.tools import cli

    card = gpu_name_and_power_limit()
    log(f"device_negatives [{card}]:")
    t_phase = time.perf_counter()
    timer = _HostFedTimer(DN_TIMED, DN_PROFILED)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        net_path = tmp / "dn_net.prototxt"
        net_path.write_text(_emit()(*stores, buffer_size=DN_BUFFER,
                                    swap=int(DN_SWAP), device_negatives=True))
        solver = _cli_solver(tmp / "dn_solver.prototxt", net_path, tmp / "dn",
                             max_iter=DN_STEPS, test_interval=DN_INTERVAL,
                             snapshot=0)
        t0 = time.perf_counter()
        with _driver_marks(timer) as built, _train_results() as results, \
                _first_sampler_draws() as kept, _CliCapture() as out:
            _, k1 = _counted(lambda: cli.main(["train", "--solver",
                                               str(solver)]))
        train_s = time.perf_counter() - t0
        driver = built[0]
        dn = driver.device_negatives
        rs = int(driver.cfg.random_seed)
        want = NegativeReservoir(DN_BUFFER, HOST_DIM, int(DN_SWAP),
                                 np.random.RandomState(rs if rs >= 0 else 1234))
        want.fill(ShotDataset.from_records(stores[0]))
        host_shape = tuple(driver._first_batch_raw["data"].shape)
        losses = [float(r.args[1]) for r in out.records
                  if r.msg == "Iteration %d, loss = %g"]
        n_tests = len(range(0, DN_STEPS + 1, DN_INTERVAL))
        calls = DN_STEPS + 1 + n_tests
        log(f"  cli train with device_negatives: {train_s:.1f} s in-process "
            f"(build included); the TRAIN source "
            f"{type(driver.train_source.sources[0].source).__name__}; the "
            f"reservoir {tuple(dn['buffer'].shape)} f32 "
            f"({dn['buffer'].nbytes / 1e6:.1f} MB), swap "
            f"{dn['swap_percentage']:g}%, {dn['num_negatives']} negatives; "
            f"host batch {host_shape}; K1 launches {k1} for {DN_STEPS} steps "
            f"+ the final display forward + {n_tests} tests; losses {losses}")
        if not np.array_equal(dn["buffer"], want.buffer):
            raise AssertionError("the seed buffer differs from the host "
                                 "NegativeReservoir fill")
        if host_shape[:3] != (TRAIN_BATCH, DN_CONTEXT, HOST_DIM):
            raise AssertionError(f"device_negatives host batch {host_shape}")
        if k1 != (calls, 0, calls):
            raise AssertionError(f"device_negatives K1 launches {k1}: "
                                 f"expected {calls}, all f32")
        if not (losses and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"device_negatives losses {losses}")
        _check_first_draws(kept)
        _replaced_share(dn["buffer"], results[0].final_carry, DN_STEPS)
        step_ms, wall_ms = timer.per_step()
        log(f"  cli train step with device_negatives at B={TRAIN_BATCH} "
            f"(f32): {step_ms:.4f} ms (CUDA events over {len(DN_TIMED)} "
            f"steps, tests excluded) = "
            f"{TRAIN_BATCH * TRAIN_NEG / step_ms * 1e3:,.0f} triplets/s; host "
            f"wall {wall_ms:.4f} ms a step [{card}]")
        prof = training_profile(timer.prof, len(DN_PROFILED), wall_ms,
                                label=f"B={TRAIN_BATCH}, device_negatives")
        _dn_feed_times(driver, dev, card)
        py_ms = _python_fed_step(tmp, stores, card)
        log(f"  device_negatives step {step_ms:.4f} ms against the "
            f"Python-sampler-fed step {py_ms:.4f} ms: "
            f"{py_ms / step_ms:.2f}x [{card}]")
        debug_k1 = _debug_and_vis(tmp, stores, card)
    log(f"device_negatives phase: {time.perf_counter() - t_phase:.1f} s")
    return {"f32": k1[2] + debug_k1, "step_ms": step_ms, "py_ms": py_ms,
            "profile": prof}


def _class_frames(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n transformed frames (n, 3, 227, 227) in SERVE_CLASSES classes: a
    class's frames are its base image plus noise."""
    bases = rng.randn(SERVE_CLASSES, 3, EXTRACT_CROP, EXTRACT_CROP) * 50
    cls = np.arange(n) % SERVE_CLASSES
    frames = bases[cls] + 20 * rng.randn(n, 3, EXTRACT_CROP, EXTRACT_CROP)
    return frames.astype(np.float32), cls


def _artifact_counts(call, batch) -> dict:
    """The kernels' launches in one artifact call."""
    torch.cuda.synchronize()
    with _tally() as counts:
        call(batch)
    torch.cuda.synchronize()
    k2c, k1c = _k2_counts(counts), _k1_counts(counts)
    return {"k2": k2c[0], "k2_sm90": k2c[1], "repack": k2c[2],
            "k2_f32": k2c[3], "k1": k1c[0], "k1_sm90": k1c[1],
            "k1_f32": k1c[2]}


def _int8_fc(net, params, quant, batch, card) -> None:
    """fc6 and fc7 of the int8 Net on the card: the int32 accumulators of
    torch._int_mm against an int64 product on the CPU (exact), then the
    int8 fc6 + fc7 (quantize, _int_mm, dequantize) against K1's sm90 route
    on the same rows in bf16, in turns, beside the int8 bound."""
    from videovector_tpu_torch.ops import quant as q8
    from videovector_tpu_torch.ops.hopper import matmul as k1
    net.quant = quant
    with torch.no_grad():
        _, blobs = net.apply(params, batch, return_blobs=True)
    fcs = []
    bottoms = {l.get("name"): str(l.get_list("bottom")[0])
               for l in net.layers if l.get_list("bottom")}
    for name in ("fc6", "fc7"):
        x = blobs[bottoms[name]].reshape(BATCH, -1)
        qt = quant[name]
        x_q = q8.quantize_input(x, qt["s_x"])
        acc = q8.int8_matmul(x_q, qt["w_q"])
        want = x_q.cpu().long() @ qt["w_q"].cpu().long()
        if not torch.equal(acc.cpu().long(), want):
            raise AssertionError(f"int8 {name}: _int_mm differs from int64")
        fcs.append((x, qt, params[name]["b"],
                    params[name]["w"].to(torch.bfloat16)))
        log(f"  int8 {name}: ({BATCH} x {x.shape[1]}) . ({x.shape[1]} x "
            f"{qt['w_q'].shape[1]}) int32 accumulators equal the int64 CPU "
            f"product (max |acc| {int(acc.abs().max())})")
    fns = {"int8": lambda: [q8.int8_inner_product(x, qt, b)
                            for x, qt, b, _ in fcs],
           "k1_sm90": lambda: [k1.matmul(x.to(torch.bfloat16), wb, b)
                               for x, _, b, wb in fcs]}
    times = {n: [] for n in fns}
    for n in ("int8", "k1_sm90", "k1_sm90", "int8"):
        times[n].append(time_ms(fns[n]))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    ops = sum(2 * BATCH * x.shape[1] * qt["w_q"].shape[1] for x, qt, _, _ in fcs)
    nbytes = sum(x.numel() * 4 + qt["w_q"].numel() + BATCH * qt["w_q"].shape[1]
                 * 4 for x, qt, _, _ in fcs)
    bound = max(ops / PEAK_OPS_INT8, nbytes / PEAK_BYTES) * 1e3
    log(f"  int8 fc6 + fc7 at {BATCH} rows (quantize, torch._int_mm, "
        f"dequantize + bias) {ms['int8']:.4f} ms against K1's sm90 route on "
        f"bf16 operands {ms['k1_sm90']:.4f} ms (CUDA events, turns: "
        + ", ".join(f"{n} {v:.4f}" for n, t in times.items() for v in t)
        + f"); the int8 bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB) [{card}]")


def serving_artifact(dev, tmp: Path) -> dict:
    """ROADMAP item 10's serving path on the card: the CaffeNet extraction
    net at batch BATCH (a .caffemodel of seeded weights, blob ip2, written
    into `tmp`) frozen by `vvtpu-torch-serve export` four times (f32,
    --compute bfloat16, --quantize int8 --calib_batches 4, f32
    --symbolic_batch), `info` on each; each artifact loaded and run: f32
    against the live Net, bf16 within 2e-2, the int8 fc accumulators exact,
    int8 retrieval metrics within 0.02 of f32's on a class-structured
    batch, the symbolic one at BATCH and 256 rows; the kernels' launches in
    one call of each; frames/s, bytes and load time of each. Returns the
    launches of the counted calls, the net's and weights' paths ("inputs"),
    the artifacts' paths and the batch they ran on."""
    import io

    from videovector_tpu_torch.config import parse_file
    from videovector_tpu_torch.graph import Net
    from videovector_tpu_torch.graph.data_factory import make_data_source
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    from videovector_tpu_torch.metrics.retrieval import retrieval_stats
    from videovector_tpu_torch.ops.normalization import l2_normalize_rows
    from videovector_tpu_torch.tools import serving
    from videovector_tpu_torch.tools.cli import _load_weights
    from videovector_tpu_torch.tools.quantize import calibrate, quantize_weights

    card = gpu_name_and_power_limit()
    log(f"serving_artifact [{card}]:")
    t_phase = time.perf_counter()
    counts, results, paths = {}, {}, {}
    inp = _write_extraction_inputs(tmp, dev)
    net = Net(parse_file(inp["net"]), "TEST")
    layer = next(l for l in net.layers
                 if l.get("type") in DATA_LAYER_TYPES)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             make_data_source(layer, phase="TEST").next_batch().items()}
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0), {
        k: torch.empty(tuple(v.shape), device="meta")
        for k, v in batch.items()})
    params = _load_weights(inp["weights"], params, dev)
    with torch.no_grad():
        live = net.apply(params, batch, return_blobs=True)[1]["ip2"]
    calls = {}
    for name, extra in SERVE_VARIANTS:
        path = paths[name] = str(tmp / f"caffenet_{name}{serving.EXTENSION}")
        t0 = time.perf_counter()
        serving.main(["export", inp["net"], path, "--weights",
                      inp["weights"], "--blobs", "ip2"] + extra)
        export_s = time.perf_counter() - t0
        info = io.StringIO()
        with contextlib.redirect_stdout(info):
            serving.main(["info", path])
        meta = json.loads(info.getvalue())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call, _ = serving.load_serving(path)
        load_s = time.perf_counter() - t0
        calls[name] = call
        counts[name] = _artifact_counts(call, batch)
        fps = BATCH / time_ms(lambda: call(batch), iters=SERVE_TIMED) * 1e3
        results[name] = {"bytes": meta["payload_bytes"], "fps": fps}
        log(f"  {name}: export {export_s:.1f} s; info inputs "
            f"{meta['inputs']} outputs {meta['outputs']} batch_axes "
            f"{meta['batch_axes']} quantize {meta['quantize']} compute "
            f"{meta['compute_dtype']} platforms {meta['platforms']}; "
            f"{meta['payload_bytes'] / 1e6:.1f} MB payload, loaded in "
            f"{load_s:.2f} s; launches in one call {counts[name]}; "
            f"{fps:,.1f} frames/s at batch {BATCH} (CUDA events over "
            f"{SERVE_TIMED} calls) [{card}]")

    def feats(name, b=batch):
        return calls[name](b)["ip2"].float()

    f32 = feats("f32")
    scale = live.abs().max().item()
    f32_err = (f32 - live).abs().max().item()
    log(f"  f32 artifact against the live Net's ip2: max abs diff "
        f"{f32_err:.3e} (max |ip2| {scale:.3e}; bit-equal "
        f"{torch.equal(f32, live)})")
    if f32_err > 1e-5 * scale:
        raise AssertionError(f"f32 artifact off the live Net: {f32_err}")
    bf16_err = (feats("bf16") - live).abs().max().item()
    log(f"  bf16 artifact against the f32 Net: {bf16_err:.3e} of max "
        f"{scale:.3e}")
    if bf16_err > 2e-2 * scale:
        raise AssertionError(f"bf16 artifact off: {bf16_err}")
    for n in SERVE_SYMBOLIC_BATCHES:
        b = {k: (v if n == BATCH else torch.cat(
            [v] * (-(-n // BATCH)))[:n]) for k, v in batch.items()}
        out = feats("symbolic", b)
        if tuple(out.shape) != (n, 4096) or not torch.isfinite(out).all():
            raise AssertionError(f"symbolic artifact at {n}: {out.shape}")
        if n == BATCH and (out - f32).abs().max().item() > 1e-5 * scale:
            raise AssertionError("symbolic artifact off the f32 one")
        log(f"  symbolic artifact at batch {n}: {tuple(out.shape)}, "
            f"finite")
    # int8: the fc accumulators, then the retrieval contract
    # the export's calibration batches: the first batch of the source
    # it took shapes from, then 3 of a fresh stream
    calib_src = make_data_source(layer, phase="TEST")
    calib = [{k: v.cpu().numpy() for k, v in batch.items()}] + [
        calib_src.next_batch() for _ in range(3)]
    qnet = Net(parse_file(inp["net"]), "TEST")
    quant = quantize_weights(params, qnet, calibrate(qnet, params, calib))
    qnet.quant = quant
    with torch.no_grad():
        q_live = qnet.apply(params, batch, return_blobs=True)[1]["ip2"]
    q_err = (feats("int8") - q_live).abs().max().item()
    log(f"  int8 artifact against the live int8 Net (the same "
        f"calibration batches): {q_err:.3e}; modes "
        f"{ {k: v['mode'] for k, v in quant.items()} }")
    if q_err > 1e-5 * q_live.abs().max().item():
        raise AssertionError(f"int8 artifact off the int8 Net: {q_err}")
    _int8_fc(qnet, params, quant, batch, card)
    frames, cls = _class_frames(np.random.RandomState(8), BATCH)
    cb = {"data": torch.as_tensor(frames, device=dev),
          "label": torch.zeros(BATCH, device=dev)}
    vids = torch.arange(BATCH, device=dev)
    clst = torch.as_tensor(cls, device=dev)
    stats = {n: retrieval_stats(l2_normalize_rows(feats(n, cb)), vids, clst)
             for n in ("f32", "int8")}
    deltas = {k: abs(float(stats["f32"][k]) - float(stats["int8"][k]))
              for k in ("mean_ap", "hit_at_1", "hit_at_5")}
    log(f"  int8 against f32 on a {SERVE_CLASSES}-class batch of "
        f"{BATCH}: " + ", ".join(
            f"{k} {float(stats['f32'][k]):.4f} / "
            f"{float(stats['int8'][k]):.4f}" for k in deltas)
        + f"; deltas {deltas} (JAX's contract: <= {QUANT_METRIC_TOL})")
    if max(deltas.values()) > QUANT_METRIC_TOL:
        raise AssertionError(f"int8 retrieval metrics off: {deltas}")
    want = {"f32": dict(k2_f32=5, k2_sm90=0, repack=1, k1_f32=2, k1_sm90=0,
                        k1=2),
            "symbolic": dict(k2_f32=5, k2_sm90=0, repack=1, k1_f32=2,
                             k1_sm90=0, k1=2),
            "bf16": dict(k2_sm90=5, k2_f32=0, repack=1, k1_sm90=2, k1_f32=0,
                         k1=2),
            "int8": dict(k2_sm90=5, k2_f32=0, repack=1, k1=0)}
    for name, w in want.items():
        got = {k: counts[name][k] for k in w}
        if got != w or counts[name]["k2"] != 5:
            raise AssertionError(f"{name} artifact launches {counts[name]}")
    log(f"serving_artifact phase: {time.perf_counter() - t_phase:.1f} s")
    total = {k: sum(c[k] for c in counts.values())
             for k in counts["f32"]}
    return {**total, "results": results, "inputs": inp, "paths": paths,
            "batch": batch}


# the parallel phase (ROADMAP item 11): the flagship step on a one-rank
# NCCL mesh and on two gloo ranks sharing the card, the 2-stage enc-dec
# pipeline at scripts/bench_lstm_train.py's widths, K1 at the ranks' shard
# shapes, and the mesh retrieval engines at GALLERY_ROWS
PAR_STEPS = 3
PAR_WARMUP, PAR_TIMED = 5, 20
PAR_CLI_STEPS = 20
PAR_PP_BATCH = 64
PAR_PP_MICRO = 4
PAR_RANKS = 2
PAR_RANK_TIMEOUT = 300
PAR_LOSS_TOL = 1e-5        # relative, against the unsharded run
PAR_GRAD_TOL = 1e-4        # of the largest magnitude
# the tower's weight gradient is the cotangent of its bf16 cast, rounded to
# bf16 on every path: a rank's half (or column block) is rounded once and
# the unsharded one once, so they may differ by one bf16 rounding
BF16_ROUNDING = 2.0 ** -8
# K1's calls on the ranks: the DP half of the B = 128 tower (960 rows) and
# a TP rank's column block (1920 rows x 2048 columns), bf16 in, f32 out
K1_SHARDS = ((960, 4096, 4096), (1920, 4096, 2048))


def _flagship(dev, dropout: float = 0.9):
    """bench.py's B = 128 step: config, model, params, role-major batch and
    the loss a user's train step calls."""
    from videovector_tpu_torch.models.embedding import VideoEmbeddingModel
    cfg, params, batch = _train_setup(dev, TRAIN_BATCH, dropout_rate=dropout)
    model = VideoEmbeddingModel(cfg)

    def loss_fn(p, b, g):
        return model.loss(p, b, generator=g, train=True, role_major=True)
    return cfg, model, params, batch, loss_fn


def _unsharded(loss_fn, params, batch, solver, steps: int, dev,
               grad_map=None):
    """solver/train.py's step (value_and_grad, then solver_update), masks
    from one generator seeded i at step i, each gradient through
    `grad_map` when given: (losses, params, the first step's gradients)."""
    from videovector_tpu_torch.convert import map_params
    from videovector_tpu_torch.solver.solvers import (
        init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import value_and_grad
    vg = value_and_grad(loss_fn)
    gen = torch.Generator(device=dev)
    p, st, losses, g0 = params, init_solver_state(solver, params), [], None
    for i in range(steps):
        gen.manual_seed(i)
        (loss, _), g = vg(p, batch, gen)
        if grad_map is not None:
            g = map_params(grad_map, g)
        g0 = g if g0 is None else g0
        p, st = solver_update(solver, p, g, st)
        losses.append(loss)
    return losses, p, g0


def _max_rel(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() / max(
        b.float().abs().max().item(), 1e-30)


def _held_tree(what: str, got: dict, want: dict, tol: float,
               bf16_keys=(), spread: dict | None = None,
               failures: list | None = None) -> float:
    """The largest error of got's leaves against want's, each relative to
    the leaf's largest magnitude in want, held to tol; a failure is raised,
    or appended to `failures` (so that a rank reports every check).

    The tower's bf16-cast params named in bf16_keys are gradients rounded
    to bf16 on both sides: got's as the mean of ranks' roundings of their
    own gradients, want's once. Each element is held to those roundings,
    2**-8 x (spread + |want|), plus 1e-5 of the largest magnitude for the
    f32 sums' order; spread is the mean over the ranks of |their gradient|
    (default |got|: one rounding of the same sum)."""
    from videovector_tpu_torch.convert import leaves_with_paths
    want_l = dict(leaves_with_paths(want))
    spread_l = dict(leaves_with_paths(spread)) if spread is not None else {}
    worst, bad = 0.0, []
    for path, g in leaves_with_paths(got):
        w = want_l[path]
        name = f"{what} {'/'.join(path)}"
        if path[-1] in bf16_keys and path[0] == "tower":
            sp = spread_l.get(path, g).abs()
            n = ((g - w).abs() > BF16_ROUNDING * (sp + w.abs())
                 + 1e-5 * w.abs().max()).sum().item()
            if n:
                bad.append(f"{name}: {n} elements past the bf16 roundings")
            continue
        err = _max_rel(g, w)
        worst = max(worst, err)
        if not err <= tol:
            bad.append(f"{name}: {err:.3e} of max|ref| > {tol}")
    if bad and failures is None:
        raise AssertionError("; ".join(bad))
    if failures is not None:
        failures.extend(bad)
    return worst


def _one_rank_steps(dev, mesh, card: str) -> dict:
    """make_train_step and make_dp_train_step (f32 and bf16 wire) on the
    one-rank NCCL mesh, 3 steps each, against the unsharded step: f32 bit
    for bit; the bf16 wire bit for bit against the unsharded step whose
    gradients are rounded to bf16 and back (a one-rank all_reduce is the
    identity, so that rounding is all the wire does), and within JAX's
    bounds of the unsharded step; then the DP step timed against the
    unsharded one, in turns."""
    from videovector_tpu_torch.parallel import make_train_step
    from videovector_tpu_torch.parallel.shard_map_dp import make_dp_train_step
    from videovector_tpu_torch.parallel.train import shard_batch, shard_params
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.solvers import (
        init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import value_and_grad
    cfg, model, params, batch, loss_fn = _flagship(dev)
    solver = SolverConfig(**TRAIN_SOLVER)
    ref_l, ref_p, _ = _unsharded(loss_fn, params, batch, solver, PAR_STEPS,
                                 dev)
    bf_l, bf_p, _ = _unsharded(loss_fn, params, batch, solver, PAR_STEPS,
                               dev, grad_map=lambda g: g.to(torch.bfloat16)
                               .float())
    gen = torch.Generator(device=dev)
    steps = {"make_train_step": make_train_step(loss_fn, solver, mesh)}
    for wire in ("f32", "bf16"):
        steps[f"make_dp_train_step {wire} wire"] = make_dp_train_step(
            loss_fn, solver, mesh,
            psum_dtype=torch.bfloat16 if wire == "bf16" else None)
    out = {"launches": 0}
    for name, step in steps.items():
        p = shard_params(params, mesh)
        st = init_solver_state(solver, p)
        b = shard_batch(batch, mesh, {"data": 1}) if name == \
            "make_train_step" else batch
        losses = []
        torch.cuda.synchronize()
        with _tally() as counts:
            for i in range(PAR_STEPS):
                gen.manual_seed(i)
                p, st, met = step(p, st, b, gen)
                losses.append(met["loss"])
        torch.cuda.synchronize()
        launched = _got(counts, "k1.launches", "k1.sm90_launches")
        if launched != (PAR_STEPS,) * 2:
            raise AssertionError(f"{name}: K1 launches {launched[0]} "
                                 f"({launched[1]} sm90), expected "
                                 f"{PAR_STEPS}")
        out["launches"] += launched[0]
        want_l, want_p = (bf_l, bf_p) if "bf16" in name else (ref_l, ref_p)
        what = ("the unsharded step's with bf16-rounded gradients"
                if "bf16" in name else "the unsharded step's")
        same = (all(torch.equal(a, r) for a, r in zip(losses, want_l))
                and all(torch.equal(p["tower"][k], want_p["tower"][k])
                        for k in ("w", "b")))
        log(f"  {name}: losses {[float(x) for x in losses]}, bit-equal to "
            f"{what} (losses and params): {same}")
        if not same:
            raise AssertionError(f"{name}: not bit-equal to {what} on one "
                                 "rank")
        if "bf16" in name:
            loss_err = max(abs(float(a) - float(r)) / abs(float(r))
                           for a, r in zip(losses, ref_l))
            w, rw = p["tower"]["w"], ref_p["tower"]["w"]
            dw = (w - rw).abs().max().item()
            log(f"  {name} against the unsharded step (JAX's bounds): max "
                f"rel loss err {loss_err:.2e} (tol 2e-2); max|w - "
                f"w_unsharded| {dw:.3e} (tol 1e-2 x max|w| = "
                f"{1e-2 * rw.abs().max().item():.3e})")
            if not (loss_err <= 2e-2 and dw < 1e-2 * rw.abs().max().item()):
                raise AssertionError(f"{name}: outside JAX's bounds")

    # the DP step against the unsharded step, in turns; each runs
    # PAR_WARMUP steps, then PAR_TIMED between CUDA events
    vg = value_and_grad(loss_fn)

    def unsharded_step(p, st, b, g):
        (_, _), grads = vg(p, b, g)
        return solver_update(solver, p, grads, st)

    dp = steps["make_train_step"]
    sb = shard_batch(batch, mesh, {"data": 1})

    def run(kind):
        p = shard_params(params, mesh)
        st = init_solver_state(solver, p)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for i in range(PAR_WARMUP + PAR_TIMED):
            if i == PAR_WARMUP:
                torch.cuda.synchronize()
                ev[0].record()
            gen.manual_seed(i)
            if kind == "dp":
                p, st, _ = dp(p, st, sb, gen)
            else:
                p, st = unsharded_step(p, st, batch, gen)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / PAR_TIMED
    t = [run(k) for k in ("plain", "dp", "dp", "plain")]
    out["dp_ms"], out["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    nbytes = sum(v.numel() for v in params["tower"].values())
    log(f"  the B={TRAIN_BATCH} step on the one-rank NCCL mesh "
        f"(make_train_step) {out['dp_ms']:.4f} ms against the unsharded "
        f"step's {out['plain_ms']:.4f} ms (CUDA events over {PAR_TIMED} "
        f"steps after {PAR_WARMUP}, in turns: "
        f"{', '.join(f'{v:.4f}' for v in t)}; {card}); all_reduce a step: "
        f"{nbytes * 4 / 1e6:.1f} MB in f32, {nbytes * 2 / 1e6:.1f} MB on the "
        "bf16 wire")
    return out


def _one_rank_cli(dev, stores: tuple) -> int:
    """`vvtpu-torch train --mesh 1` against the run without --mesh on the
    host stores (generate_net.py's net, the repo's solver, PAR_CLI_STEPS
    steps): equal loss lines. Returns the K1 launches of the --mesh run."""
    import tempfile

    from videovector_tpu_torch.tools import cli
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        net_path = tmp / "net.prototxt"
        net_path.write_text(_emit()(*stores, buffer_size=5000))
        losses, launches = {}, {}
        for tag, extra in (("plain", []), ("mesh", ["--mesh", "1"])):
            solver = _cli_solver(tmp / f"{tag}.prototxt", net_path,
                                 tmp / tag, max_iter=PAR_CLI_STEPS,
                                 test_interval=10 * PAR_CLI_STEPS,
                                 snapshot=0, display=1)
            with _CliCapture() as out:
                rc, launches[tag] = _counted(lambda: cli.main(
                    ["train", "--solver", str(solver)] + extra))
            losses[tag] = out.lines("Iteration")
            losses[tag] = [l for l in losses[tag] if ", loss = " in l]
            if rc != 0:
                raise AssertionError(f"cli train {extra}: rc {rc}")
    log(f"  vvtpu-torch train --mesh 1, {PAR_CLI_STEPS} steps on the "
        f"{HOST_VIDEOS} x {HOST_SHOTS} store: {len(losses['mesh'])} loss "
        f"lines, equal to the run without --mesh: "
        f"{losses['mesh'] == losses['plain']} (last: {losses['mesh'][-1]}); "
        f"K1 launches {launches['mesh']} (all, sm90, f32)")
    if losses["mesh"] != losses["plain"] or not losses["mesh"]:
        raise AssertionError(f"train --mesh 1 {losses['mesh']} vs "
                             f"{losses['plain']}")
    return launches["mesh"][2]


def _gallery_engines(feats, vids, cls, mesh=None) -> dict:
    """The chunked engines on the gallery: sort and count over query chunks
    (with mesh: split over "data"), and with a mesh the gallery-sharded
    count engine, as Python floats."""
    from videovector_tpu_torch.metrics import retrieval as R
    out = {}
    for m in ("sort", "count"):
        out[m], _ = _timed(lambda: R.retrieval_stats_chunked(
            feats, vids, cls, method=m, mesh=mesh, device=feats.device))
    if mesh is not None:
        out["gshard count"], _ = _timed(lambda: R.retrieval_stats_chunked(
            feats, vids, cls, method="count", mesh=mesh, shard_gallery=True,
            device=feats.device))
    return {k: {n: float(x) for n, x in v.items()} for k, v in out.items()}


def _check_engines(what: str, got: dict, one: dict) -> None:
    for k, v in got.items():
        want = one["count" if "count" in k else "sort"]
        if v != want:
            raise AssertionError(f"{what} {k}: {v} vs one device {want}")
    log(f"  {what}: " + "; ".join(f"{k} {v}" for k, v in got.items())
        + ": bit-equal to the one-device engines")


def _k1_shard_times(dev, gen, card: str) -> dict:
    """K1 at the ranks' shapes (K1_SHARDS: bf16 in, f32 out, bias): against
    the plain version (the split-K plan at these shapes), timed in turns
    with the plain version and torch.mm (cuBLAS) over copies of w beyond
    L2, beside the bound."""
    from videovector_tpu_torch.ops.hopper import matmul as k1
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0, "bound_by": "operations"}
    for m, k, n in K1_SHARDS:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf)
        b = torch.randn((n,), generator=gen, device=dev)
        ws = [(torch.randn((k, n), generator=gen, device=dev) * 0.02).to(bf)
              for _ in range(max(2, math.ceil(L2_EXCESS * L2_BYTES
                                              / (k * n * 2))))]
        if k1.k1_route(x, ws[0], torch.float32) != "sm90":
            raise AssertionError(f"K1 {m}x{k}x{n}: not on the sm90 route")
        run = lambda w: k1.matmul(x, w, b)
        plain = lambda w: k1.matmul_plain(x, w, b)
        cublas = lambda w: torch.mm(x, w, out_dtype=torch.float32)
        err = compare(f"K1 shard {m}x{k}x{n}", run(ws[0]), plain(ws[0]))
        if not torch.equal(run(ws[0]), run(ws[0])):
            raise AssertionError("K1 shard: two runs of the split-K route "
                                 "differ")
        t = [time_graph_ms(fn, ws) for fn in (plain, run, cublas, cublas,
                                               run, plain)]
        ms, ms_plain, ms_lib = (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, \
            (t[2] + t[3]) / 2
        flops = 2 * m * k * n
        t_bytes = (m * k * 2 + k * n * 2 + n * 4 + m * n * 4) / PEAK_BYTES
        bound = max(t_bytes, flops / PEAK_FLOPS) * 1e3
        _, splits = k1.k1_split_plan(m, n, k, sms)
        log(f"  K1 {m}x{k}x{n} (bf16 in, f32 out, bias; {splits} splits): "
            f"kernel {ms:.4f} ms, plain {ms_plain:.4f}, cuBLAS torch.mm "
            f"{ms_lib:.4f}, bound {bound:.4f} ({flops / 1e9:.1f} GFLOP at "
            f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s; {bound / ms:.2f} of it); "
            f"turns {', '.join(f'{v:.4f}' for v in t)}; {card}")
        for key, v in (("ms", ms), ("plain_ms", ms_plain),
                       ("library_ms", ms_lib), ("bound_ms", bound)):
            out[key] += v
        out["err"] = max(out["err"], err)
    return out


def _rank_dp(dev, mesh) -> dict:
    """DP 2 x 1 through make_train_step, the rank's 64 windows (K1 on 960
    rows), 3 steps at dropout 0.9: losses against the unsharded run's, and
    at every step the gradient averaged over "data" against the unsharded
    gradient at the same params and masks. Then 3 steps at dropout 0
    against one device's grad_microbatch = 2 (each microbatch one rank's
    rows, so that the weight gradient rounds to bf16 as the ranks' does):
    the params."""
    from videovector_tpu_torch.ops.sharding import all_reduce_grads, axes_of
    from videovector_tpu_torch.parallel import make_train_step
    from videovector_tpu_torch.parallel.train import shard_batch, shard_params
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.solvers import (
        init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import (
        accumulate_microbatches, value_and_grad,
    )
    from videovector_tpu_torch.convert import map_params
    solver = SolverConfig(**TRAIN_SOLVER)
    failures, out = [], {}
    gen = torch.Generator(device=dev)
    for dropout in (0.9, 0.0):
        cfg, model, params, batch, loss_fn = _flagship(dev, dropout=dropout)
        vg = value_and_grad(loss_fn)
        b = shard_batch(batch, mesh, {"data": 1})
        rows = b["data"].shape[1]
        p = shard_params(params, mesh)
        st = init_solver_state(solver, p)
        step = make_train_step(loss_fn, solver, mesh)
        q, qs, losses, ref_l, grad_err = params, st, [], [], 0.0
        launches = [0, 0]   # the steps' own: the checks' calls not counted
        evs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
               for _ in range(PAR_STEPS)]
        for i in range(PAR_STEPS):
            if dropout:
                # the sharded gradient against the unsharded one, at the
                # same params and masks
                gen.manual_seed(i)
                with axes_of(mesh, batch=rows):
                    (_, _), g_rank = vg(p, b, gen)
                spread = all_reduce_grads(map_params(torch.abs, g_rank),
                                          mesh)
                g = all_reduce_grads(g_rank, mesh)   # in place
                gen.manual_seed(i)
                (loss, _), g_ref = vg(p, batch, gen)
                ref_l.append(float(loss))
                grad_err = max(grad_err, _held_tree(
                    f"DP step {i} gradients", g, g_ref, PAR_GRAD_TOL,
                    bf16_keys=("w",), spread=spread, failures=failures))
            else:
                # one device, each rank's rows a microbatch
                g, loss, _ = accumulate_microbatches(
                    vg, q, batch, {"data": 1}, PAR_RANKS, None)
                g = map_params(lambda t: t / PAR_RANKS, g)
                q, qs = solver_update(solver, q, g, qs)
                ref_l.append(float(loss) / PAR_RANKS)
            gen.manual_seed(i)
            torch.cuda.synchronize()
            with _tally() as counts:
                evs[i][0].record()
                p, st, met = step(p, st, b, gen)
                evs[i][1].record()
            launched = _got(counts, "k1.launches", "k1.sm90_launches")
            launches[0] += launched[0]
            launches[1] += launched[1]
            losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        key = "drop" if dropout else "nodrop"
        out[key] = {"losses": losses,
                    "loss_err": max(abs(a - r) / abs(r)
                                    for a, r in zip(losses, ref_l)),
                    "ms": sum(e0.elapsed_time(e1) for e0, e1 in evs)
                    / PAR_STEPS}
        if dropout:
            out["grad_err"] = grad_err
            out["launches"] = tuple(launches)
        else:
            out["param_err"] = _held_tree("DP params (gm 2 reference)", p,
                                          q, PAR_GRAD_TOL,
                                          failures=failures)
    out.update(rows=rows * batch["data"].shape[0], failures=failures,
               loss_err=max(out["drop"]["loss_err"],
                            out["nodrop"]["loss_err"]),
               losses=out["drop"]["losses"], ms=out["drop"]["ms"])
    return out


def _rank_tp(dev, mesh) -> dict:
    """TP 1 x 2 through make_tp_loss_fn (dropout off: its masks are per
    column block): K1 at 1920 x 4096 -> 2048 on each rank, 3 steps against
    the unsharded model's."""
    from videovector_tpu_torch.ops.collectives import all_gather
    from videovector_tpu_torch.ops.sharding import all_reduce_grads, mesh_axis
    from videovector_tpu_torch.parallel.shard_map_tp import (
        make_tp_loss_fn, place_tp_params,
    )
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.solvers import (
        init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import value_and_grad
    cfg, model, params, batch, _ = _flagship(dev, dropout=0.0)
    data = {"data": batch["data"].transpose(0, 1).contiguous()}  # (B, R, D)

    def ref_loss(p, b, g):
        return model.loss(p, b, generator=None, train=True)
    solver = SolverConfig(**TRAIN_SOLVER)
    ref_l, ref_p, ref_g = _unsharded(ref_loss, params, data, solver,
                                     PAR_STEPS, dev)
    tp_loss = make_tp_loss_fn(cfg, mesh)
    vg = value_and_grad(tp_loss)
    p = place_tp_params(params, mesh)
    st = init_solver_state(solver, p)
    ax = mesh_axis(mesh, "model")

    def whole(tree):
        return {"tower": {"w": all_gather(tree["tower"]["w"], ax, 1),
                          "b": all_gather(tree["tower"]["b"], ax, 0)}}
    losses, g0 = [], None
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    with _tally() as counts:
        for i in range(PAR_STEPS):
            (loss, _), g = vg(p, data, None)
            g = all_reduce_grads(g, mesh)
            g0 = whole(g) if g0 is None else g0
            p, st = solver_update(solver, p, g, st)
            losses.append(float(loss))
    ev[1].record()
    torch.cuda.synchronize()
    launches = _got(counts, "k1.launches", "k1.sm90_launches")
    failures = []
    return {"launches": launches,
            "shape": (data["data"].shape[0] * data["data"].shape[1],
                      p["tower"]["w"].shape[0], p["tower"]["w"].shape[1]),
            "loss_err": max(abs(a - float(r)) / abs(float(r))
                            for a, r in zip(losses, ref_l)),
            "grad_err": _held_tree("TP gradients", g0, ref_g, PAR_GRAD_TOL,
                                   bf16_keys=("w",), failures=failures),
            "param_err": _held_tree("TP params", whole(p), ref_p,
                                    PAR_GRAD_TOL, failures=failures),
            "failures": failures,
            "losses": losses, "ms": ev[0].elapsed_time(ev[1]) / PAR_STEPS}


def _encdec_setup(dev):
    """The pipeline's workload at scripts/bench_lstm_train.py's widths (I =
    H = 512, T = 20 + 10), B = PAR_PP_BATCH, a 512 -> 2 readout, from a
    seeded generator."""
    from videovector_tpu_torch.ops.recurrent import init_lstm_params
    gen = torch.Generator(device=dev).manual_seed(5)
    w, (t_obs, t_pred), b = ENCDEC_WIDTH, ENCDEC_T, PAR_PP_BATCH
    params = {"enc": init_lstm_params(gen, w, w),
              "dec": init_lstm_params(gen, w, w),
              "readout": {"w": torch.randn((w, 2), generator=gen,
                                           device=dev) * 0.05,
                          "b": torch.zeros(2, device=dev)}}
    cont_obs = torch.ones((t_obs, b), device=dev)
    cont_obs[0] = 0
    batch = {"observed": torch.randn((t_obs, b, w), generator=gen,
                                     device=dev),
             "cont_obs": cont_obs,
             "predicted": torch.randn((t_pred, b, w), generator=gen,
                                      device=dev),
             "cont_pred": torch.ones((t_pred, b), device=dev),
             "gt": torch.randn((t_pred, b, 2), generator=gen, device=dev)}
    return params, batch


def _rank_pp(dev, mesh) -> dict:
    """The pipeline 1 x 2 (stage r on rank r), PAR_PP_MICRO microbatches, 3
    SGD steps against reference_encdec_loss's."""
    from videovector_tpu_torch.ops.sharding import all_reduce_grads
    from videovector_tpu_torch.parallel.pipeline import (
        make_pp_loss_fn, reference_encdec_loss,
    )
    from videovector_tpu_torch.solver import SolverConfig
    from videovector_tpu_torch.solver.solvers import (
        init_solver_state, solver_update,
    )
    from videovector_tpu_torch.solver.train import value_and_grad
    params, batch = _encdec_setup(dev)
    solver = SolverConfig(**ENCDEC_SOLVER)
    ref_l, ref_p, ref_g = _unsharded(
        lambda p, b, g: (reference_encdec_loss(p, b), {}), params, batch,
        solver, PAR_STEPS, dev)
    pp = make_pp_loss_fn(mesh, num_microbatches=PAR_PP_MICRO)
    vg = value_and_grad(lambda p, b, g: (pp(p, b), {}))
    p, st, losses, g0 = params, init_solver_state(solver, params), [], None
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for i in range(PAR_STEPS):
        (loss, _), g = vg(p, batch, None)
        g = all_reduce_grads(g, mesh)
        g0 = g if g0 is None else g0
        p, st = solver_update(solver, p, g, st)
        losses.append(float(loss))
    ev[1].record()
    torch.cuda.synchronize()
    failures = []
    return {"loss_err": max(abs(a - float(r)) / abs(float(r))
                            for a, r in zip(losses, ref_l)),
            "grad_err": _held_tree("PP gradients", g0, ref_g, PAR_GRAD_TOL,
                                   failures=failures),
            "param_err": _held_tree("PP params", p, ref_p, PAR_GRAD_TOL,
                                    failures=failures),
            "failures": failures,
            "losses": losses, "ms": ev[0].elapsed_time(ev[1]) / PAR_STEPS}


def _parallel_rank(rank: int, rdzv: str, out: str, one: dict,
                   dev_type: str) -> None:
    """One of PAR_RANKS gloo ranks on the one card: DP, TP, the pipeline and
    the mesh retrieval engines; writes its results (or its traceback) to
    `out` as JSON."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    result = {"rank": rank}
    try:
        from videovector_tpu_torch import _build
        from videovector_tpu_torch.parallel import make_mesh
        _build.load_library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(dev_type)
        dist.init_process_group(
            "gloo", init_method="file://" + rdzv, rank=rank,
            world_size=PAR_RANKS,
            timeout=datetime.timedelta(seconds=PAR_RANK_TIMEOUT))
        result["dp"] = _rank_dp(dev, make_mesh(PAR_RANKS, 1,
                                               devices=dev_type))
        result["tp"] = _rank_tp(dev, make_mesh(1, PAR_RANKS,
                                               devices=dev_type))
        result["pp"] = _rank_pp(dev, make_mesh(1, PAR_RANKS,
                                               devices=dev_type))
        gen = torch.Generator(device=dev).manual_seed(11)
        feats, vids, cls = _class_gallery(dev, gen, GALLERY_ROWS)
        t0 = time.perf_counter()
        result["retrieval"] = _gallery_engines(
            feats, vids, cls, make_mesh(PAR_RANKS, 1, devices=dev_type))
        result["retrieval_s"] = time.perf_counter() - t0
        _check_engines(f"rank {rank}: the mesh engines over {PAR_RANKS} "
                       "gloo ranks", result["retrieval"], one)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    Path(out).write_text(json.dumps(result))


def _two_ranks(target, *args) -> list[dict]:
    """PAR_RANKS spawned processes sharing the card over gloo, each running
    target(rank, rendezvous file, result file, *args); the parent joins
    them with a timeout and fails the run on a timeout or an error."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"rank{r}.json") for r in range(PAR_RANKS)]
        procs = [ctx.Process(target=target,
                             args=(r, str(Path(tmp) / "rdzv"), outs[r])
                             + args)
                 for r in range(PAR_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + PAR_RANK_TIMEOUT
        # a rank that failed leaves the other waiting in a collective: stop
        # at the first failure, or at the deadline
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) or (
                    p.exitcode == 0 and '"error"' in Path(o).read_text())
                    for p, o in zip(procs, outs)):
                break
            time.sleep(0.5)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        results = [json.loads(Path(o).read_text()) if Path(o).exists()
                   else {"rank": r, "error": f"no result (exit code "
                         f"{procs[r].exitcode}, killed: {procs[r] in alive})"}
                   for r, o in enumerate(outs)]
    for r in results:
        if "error" in r:
            raise AssertionError(f"parallel rank {r['rank']}:\n{r['error']}")
    return results


def parallel(dev, stores: tuple) -> dict:
    """ROADMAP item 11 on the card. A one-rank NCCL mesh (make_mesh(1, 1)
    starts the group from an in-memory store; destroyed at the end): the
    flagship step at full width through make_train_step and
    make_dp_train_step (f32 and bf16 wire) against the unsharded step,
    `vvtpu-torch train --mesh 1` against the run without --mesh, the mesh
    retrieval engines at GALLERY_ROWS against the one-device engines. K1 at
    the ranks' shard shapes. Then two gloo ranks sharing the card: DP 2 x 1,
    TP 1 x 2, the pipeline 1 x 2 and the mesh engines. Returns K1's
    launches in those runs."""
    import torch.distributed as dist

    from videovector_tpu_torch.parallel import make_mesh
    card = gpu_name_and_power_limit()
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, devices=dev.type)
    try:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != backend:
            raise AssertionError(f"one-rank mesh on {dist.get_backend()}")
        log(f"parallel: a one-rank mesh over {backend} ({card})")
        out = _one_rank_steps(dev, mesh, card)
        out["launches_1920"], out["launches"] = out["launches"], 0
        out["cli_f32"] = _one_rank_cli(dev, stores)
        gen = torch.Generator(device=dev).manual_seed(11)
        feats, vids, cls = _class_gallery(dev, gen, GALLERY_ROWS)
        one = _gallery_engines(feats, vids, cls)
        log(f"  one-device engines at {GALLERY_ROWS} x 4096 f32: {one}")
        _check_engines("the mesh engines on one NCCL rank",
                       _gallery_engines(feats, vids, cls, mesh), one)
        del feats, vids, cls
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["k1"] = _k1_shard_times(dev, torch.Generator(device=dev).manual_seed(3),
                                card)
    t1 = time.perf_counter()
    ranks = _two_ranks(_parallel_rank, one, dev.type)
    for r in ranks:
        dp, tp, pp = r["dp"], r["tp"], r["pp"]
        log(f"  rank {r['rank']} of {PAR_RANKS} (gloo, the card time-shared "
            f"by both ranks: these are no scaling numbers): DP {PAR_RANKS} x 1 "
            f"K1 at {dp['rows']} rows, launches {dp['launches']} (all, "
            f"sm90); dropout 0.9: losses {dp['losses']} (max rel err "
            f"{dp['drop']['loss_err']:.2e} against the unsharded, tol "
            f"{PAR_LOSS_TOL}), each step's gradient {dp['grad_err']:.2e} of "
            f"max from the unsharded one at the same params (tol "
            f"{PAR_GRAD_TOL}; the bf16-cast tower weight's within its bf16 "
            "roundings: each rank's of its own gradient, and the "
            "unsharded one's); dropout 0 against one device's "
            f"grad_microbatch {PAR_RANKS}: losses "
            f"{dp['nodrop']['loss_err']:.2e}, params {dp['param_err']:.2e} "
            f"of max (tol {PAR_GRAD_TOL}); {dp['ms']:.3f} ms a step. TP 1 x "
            f"{PAR_RANKS} K1 at {tp['shape']}, launches {tp['launches']}; "
            f"loss err {tp['loss_err']:.2e}, gradients {tp['grad_err']:.2e}, "
            f"params {tp['param_err']:.2e}; {tp['ms']:.3f} ms a step. The "
            f"pipeline 1 x {PAR_RANKS} (I = H = {ENCDEC_WIDTH}, T = "
            f"{ENCDEC_T[0]} + {ENCDEC_T[1]}, B = {PAR_PP_BATCH}, "
            f"{PAR_PP_MICRO} microbatches): loss err {pp['loss_err']:.2e}, "
            f"gradients {pp['grad_err']:.2e}, params {pp['param_err']:.2e}; "
            f"{pp['ms']:.3f} ms a step. Mesh engines {r['retrieval_s']:.2f} "
            "s (host clock)")
        for name, res in (("DP", dp), ("TP", tp), ("PP", pp)):
            if res["failures"]:
                raise AssertionError(f"rank {r['rank']} {name}: "
                                     + "; ".join(res["failures"]))
            if not res["loss_err"] <= PAR_LOSS_TOL:
                raise AssertionError(f"{name} losses: {res['loss_err']}")
        for name, res in (("DP", dp), ("TP", tp)):
            # one sm90 launch a step, the step's tower on the rank's shard
            if res["launches"] != [PAR_STEPS, PAR_STEPS]:
                raise AssertionError(f"{name} K1 launches {res['launches']}, "
                                     f"expected {PAR_STEPS} (sm90)")
        out["launches"] += dp["launches"][0] + tp["launches"][0]
    log(f"parallel: {t1 - t0:.1f} s on one rank, {time.perf_counter() - t1:.1f}"
        f" s for the {PAR_RANKS} ranks (spawn and CUDA start included)")
    return out


# the mesh serving phase (ROADMAP item 11b): serve-artifact-caffenet-b50's
# net and .caffemodel exported under a mesh: 1 x 1 on a one-rank NCCL mesh,
# then on the two gloo ranks sharing the card 1 x 2 (f32 and bf16: fc6 and
# fc7 column-sharded) and 2 x 1 (f32, symbolic batch: the rows sharded),
# each against the one-device artifact of its kind
MESH_SERVE_ARTIFACTS = (("1x2_f32", 1, 2, [], "f32"),
                        ("1x2_bf16", 1, 2, ["--compute", "bfloat16"], "bf16"),
                        ("2x1_symbolic", 2, 1, ["--symbolic_batch"],
                         "symbolic"))
MESH_SERVE_TOL = 1e-5      # relative to max|ip2| of the one-device artifact
MESH_SERVE_TIMED = 10
# the launches of one call of each, and their routes
MESH_SERVE_LAUNCHES = {
    "f32": dict(k1=2, k1_f32=2, k2=5, k2_f32=5, repack=1),
    "bf16": dict(k1=2, k1_sm90=2, k2=5, k2_sm90=5, repack=1),
    "symbolic": dict(k1=2, k1_f32=2, k2=5, k2_f32=5, repack=1)}
# K1 on a model rank of the 1 x 2 artifacts: fc6's and fc7's column shards
# (K, N) at BATCH rows
K1_MESH_SHARDS = ((9216, 2048), (4096, 2048))


@contextlib.contextmanager
def _shard_plans(model_n: int):
    """K1 plans each product as it plans its column shard on one of
    `model_n` model ranks (the same block and split-K count), so that a
    one-device run sums each column in a 1 x model_n artifact's order."""
    from videovector_tpu_torch.ops.hopper import matmul as k1
    plans = k1.k1_split_plan, k1.k1_f32_plan
    k1.k1_split_plan = lambda m, n, k, sms: plans[0](m, n // model_n, k, sms)
    k1.k1_f32_plan = lambda m, n, k, sms: plans[1](m, n // model_n, k, sms)
    try:
        yield
    finally:
        k1.k1_split_plan, k1.k1_f32_plan = plans


def _mesh_serving_rank(rank: int, rdzv: str, out: str, paths: dict,
                       dev_type: str) -> None:
    """One of PAR_RANKS gloo ranks on the one card: each of
    MESH_SERVE_ARTIFACTS exported by `vvtpu-torch-serve export --mesh`,
    served through load_serving and mesh_serving against its one-device
    artifact (and the symbolic one at BATCH and 256 rows; a 1 x 2 one also
    against the one-device artifact run at the shards' K1 plans), the
    kernels' launches in one call, one profiled call (no library GEMM or
    conv) and the ms a call; writes its results (or its traceback) to
    `out`."""
    import datetime

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT))
    result = {"rank": rank}
    try:
        from videovector_tpu_torch import _build
        from videovector_tpu_torch.tools import serving
        _build.load_library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(dev_type)
        dist.init_process_group(
            "gloo", init_method="file://" + rdzv, rank=rank,
            world_size=PAR_RANKS,
            timeout=datetime.timedelta(seconds=PAR_RANK_TIMEOUT))
        with np.load(paths["batch"]) as z:
            batch = {k: torch.as_tensor(z[k], device=dev) for k in z.files}

        def rows(n):
            return {k: torch.cat([v] * -(-n // BATCH))[:n]
                    for k, v in batch.items()}
        for name, data_n, model_n, extra, ref in MESH_SERVE_ARTIFACTS:
            path = str(Path(paths["dir"]) / f"caffenet_{name}"
                       f"{serving.EXTENSION}")
            t0 = time.perf_counter()
            serving.main(["export", paths["net"], path, "--weights",
                          paths["weights"], "--blobs", "ip2", "--platforms",
                          dev_type, "--mesh", f"{data_n}x{model_n}"] + extra)
            export_s = time.perf_counter() - t0
            meta = serving.read_meta(path)
            call, _ = serving.load_serving(path)
            run = serving.mesh_serving(call, meta)
            one, _ = serving.load_serving(paths[ref])
            errs, pinned = {}, None
            for n in (BATCH, 256) if "--symbolic_batch" in extra else (BATCH,):
                got, want = run(rows(n))["ip2"], one(rows(n))["ip2"]
                if tuple(got.shape) != (n, 4096):
                    raise AssertionError(f"{name} at {n}: {got.shape}")
                errs[n] = _rel_err(got, want)
            if model_n > 1:
                with _shard_plans(model_n):
                    pinned = _rel_err(got, one(batch)["ip2"])
            counts = _artifact_counts(run, batch)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(batch)
                torch.cuda.synchronize()
            kernels = {e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA}
            ms = time_ms(lambda: run(batch), iters=MESH_SERVE_TIMED)
            result[name] = {
                "export_s": export_s, "bytes": meta["payload_bytes"],
                "devices": meta["devices"], "errs": errs, "pinned": pinned,
                "counts": counts, "kernels": len(kernels),
                "library": sorted(k for k in kernels
                                  if _is_library_kernel(k)),
                "ms": ms, "fps": BATCH / ms * 1e3}
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    Path(out).write_text(json.dumps(result))


def _k1_mesh_shard_times(dev, gen, card: str) -> dict:
    """K1 at a model rank's calls in the 1 x 2 artifacts (K1_MESH_SHARDS at
    BATCH rows, bias, f32 out), f32 operands on the f32 route and bf16 on
    the sm90 route: each against its plain version, timed by CUDA-graph
    replay in turns with the plain version and torch.mm (cuBLAS, TF32 off)
    over copies of w beyond L2, beside its bound. Returns, per dtype, the
    sums over the two shapes."""
    from videovector_tpu_torch.ops.hopper import matmul as k1
    out = {}
    for dt, route, size, peak in ((torch.float32, "f32", 4, PEAK_FLOPS_F32),
                                  (torch.bfloat16, "sm90", 2, PEAK_FLOPS)):
        acc = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "err": 0.0}
        t_ops_all = t_bytes_all = 0.0
        for k, n in K1_MESH_SHARDS:
            x = torch.randn((BATCH, k), generator=gen, device=dev).to(dt)
            b = torch.randn((n,), generator=gen, device=dev)
            ws = [(torch.randn((k, n), generator=gen, device=dev)
                   * k ** -0.5).to(dt)
                  for _ in range(max(2, math.ceil(L2_EXCESS * L2_BYTES
                                                  / (k * n * size))))]
            if k1.k1_route(x, ws[0], torch.float32) != route:
                raise AssertionError(f"K1 {BATCH}x{k}x{n} {dt}: not the "
                                     f"{route} route")

            def run(w, x=x, b=b):
                return k1.matmul(x, w, b)

            def plain(w, x=x, b=b):
                return k1.matmul_plain(x, w, b)

            def library(w, x=x, dt=dt):
                if dt == torch.float32:
                    return torch.mm(x, w)
                return torch.mm(x, w, out_dtype=torch.float32)
            err = compare(f"K1 {route} route, mesh shard {BATCH}x{k}x{n}",
                          run(ws[0]), plain(ws[0]))
            t = [time_graph_ms(fn, ws) for fn in (plain, run, library,
                                                   library, run, plain)]
            ms, ms_plain, ms_lib = (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, \
                (t[2] + t[3]) / 2
            flops = 2 * BATCH * k * n
            nbytes = size * (BATCH * k + k * n) + 4 * n + 4 * BATCH * n
            t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
            bound = max(t_ops, t_bytes) * 1e3
            log(f"  K1 {BATCH}x{k}x{n} ({str(dt)[6:]} in, f32 out, bias; "
                f"{route} route): kernel {ms:.4f} ms, plain {ms_plain:.4f}, "
                f"torch.mm {ms_lib:.4f}, bound {bound:.4f} "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; "
                f"{bound / ms:.2f} of it); turns "
                f"{', '.join(f'{v:.4f}' for v in t)} [{card}]")
            for key, v in (("ms", ms), ("plain_ms", ms_plain),
                           ("library_ms", ms_lib), ("bound_ms", bound)):
                acc[key] += v
            acc["err"] = max(acc["err"], err)
            t_ops_all += t_ops
            t_bytes_all += t_bytes
        acc["bound_by"] = "operations" if t_ops_all >= t_bytes_all \
            else "bytes"
        out[route] = acc
    return out


def mesh_serving_artifact(dev, tmp: Path, serve: dict) -> dict:
    """ROADMAP item 11b on the card: serving_artifact's net and .caffemodel
    (in `tmp`) exported by `vvtpu-torch-serve export --mesh 1x1` on a
    one-rank NCCL mesh (make_mesh(1, 1) starts the group; destroyed after),
    its outputs bit-equal to the one-device f32 artifact's; then two gloo
    ranks sharing the card export and serve MESH_SERVE_ARTIFACTS
    (_mesh_serving_rank; their times are the card time-shared by two
    processes, no scaling numbers); then K1 at the 1 x 2 artifacts' shard
    shapes. Returns the launches of the ranks' counted calls and K1's
    times."""
    import torch.distributed as dist

    from videovector_tpu_torch.parallel import make_mesh
    from videovector_tpu_torch.tools import serving
    card = gpu_name_and_power_limit()
    log(f"mesh_serving_artifact [{card}]:")
    t0 = time.perf_counter()
    inp, paths, batch = serve["inputs"], serve["paths"], serve["batch"]
    path = str(tmp / f"caffenet_1x1{serving.EXTENSION}")
    make_mesh(1, 1, devices=dev.type)
    try:
        backend = dist.get_backend()
        serving.main(["export", inp["net"], path, "--weights",
                      inp["weights"], "--blobs", "ip2", "--platforms",
                      dev.type, "--mesh", "1x1"])
    finally:
        dist.destroy_process_group()
    call, meta = serving.load_serving(path)
    one, _ = serving.load_serving(paths["f32"])
    got = serving.mesh_serving(call, meta)(batch)["ip2"]
    if not torch.equal(got, one(batch)["ip2"]):
        raise AssertionError("the 1 x 1 artifact differs from the one-device "
                             "f32 artifact")
    log(f"  export --mesh 1x1 on a one-rank {backend} mesh: meta mesh "
        f"{meta['mesh']}, nr_devices {meta['nr_devices']}; ip2 {tuple(got.shape)}"
        " bit-equal to the one-device f32 artifact's")
    np.savez(tmp / "mesh_batch.npz",
             **{k: v.cpu().numpy() for k, v in batch.items()})
    rank_paths = {"dir": str(tmp), "batch": str(tmp / "mesh_batch.npz"),
                  "net": inp["net"], "weights": inp["weights"], **paths}
    t1 = time.perf_counter()
    ranks = _two_ranks(_mesh_serving_rank, rank_paths, dev.type)
    t2 = time.perf_counter()
    total = {k: 0 for k in ("k1_f32", "k1_sm90", "k1_rows", "k2_f32",
                            "k2_sm90", "repack")}
    for r in ranks:
        for name, _, _, _, ref in MESH_SERVE_ARTIFACTS:
            res = r[name]
            # bf16: fc6's f32 sums on a column shard take K1's plan at N =
            # 2048 (twice the splits), and where they differ from the
            # one-device sums, fc7's bf16 inputs may round apart; at the
            # shards' plans the one-device artifact sums alike
            tol = MESH_SERVE_TOL if ref != "bf16" else REL_TOL[torch.bfloat16]
            log(f"  rank {r['rank']} of {PAR_RANKS}, {name} (gloo, the card "
                "time-shared by both ranks: no scaling number): export "
                f"{res['export_s']:.1f} s, {res['bytes'] / 1e6:.1f} MB, "
                f"devices {res['devices']}; ip2 against the one-device "
                f"{ref} artifact, max rel err "
                + ", ".join(f"{v:.3e} at {n} rows"
                            for n, v in res["errs"].items())
                + f" (tol {tol})"
                + ("" if res["pinned"] is None else
                   f", at the shards' K1 plans {res['pinned']:.3e} (tol "
                   f"{MESH_SERVE_TOL})")
                + "; launches in one call "
                f"{res['counts']}; {res['kernels']} device kernels in a "
                f"profiled call, library {res['library']}; "
                f"{res['ms']:.3f} ms a call, {res['fps']:,.1f} frames/s at "
                f"batch {BATCH} (CUDA events over {MESH_SERVE_TIMED} calls) "
                f"[{card}]")
            bad = [f"{n} rows: {v:.3e}" for n, v in res["errs"].items()
                   if not v <= tol]
            if res["pinned"] is not None and \
                    not res["pinned"] <= MESH_SERVE_TOL:
                bad.append(f"at the shards' plans: {res['pinned']:.3e}")
            if bad:
                raise AssertionError(f"rank {r['rank']} {name} off the "
                                     f"one-device artifact: {bad}")
            want = MESH_SERVE_LAUNCHES[ref]
            got = {k: res["counts"][k] for k in want}
            if got != want:
                raise AssertionError(f"rank {r['rank']} {name} launches "
                                     f"{res['counts']}, expected {want}")
            if res["library"]:
                raise AssertionError(f"library kernels on {name}: "
                                     f"{res['library']}")
            c = res["counts"]
            total["k1_f32" if ref == "f32" else "k1_rows"] += c["k1_f32"]
            total["k1_sm90"] += c["k1_sm90"]
            total["k2_f32"] += c["k2_f32"]
            total["k2_sm90"] += c["k2_sm90"]
            total["repack"] += c["repack"]
    k1 = _k1_mesh_shard_times(dev, torch.Generator(device=dev).manual_seed(5),
                              card)
    log(f"mesh_serving_artifact: {t1 - t0:.1f} s on one rank, {t2 - t1:.1f} "
        f"s for the {PAR_RANKS} ranks (spawn and CUDA start included), "
        f"{time.perf_counter() - t2:.1f} s for K1's shard times")
    return {**total, "k1": k1}


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
    import tempfile

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
        pools = pool_phase(dev, torch.Generator(device=dev).manual_seed(2))
        lrns = lrn_phase(dev, torch.Generator(device=dev).manual_seed(4))
        topks = topk_phase(dev, torch.Generator(device=dev).manual_seed(9))
        i3d = i3d_phase(dev, torch.Generator(device=dev).manual_seed(8))
        torch.cuda.empty_cache()
        timesformer = timesformer_phase(
            dev, torch.Generator(device=dev).manual_seed(10))
        torch.cuda.empty_cache()
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
    with tempfile.TemporaryDirectory() as stores_dir:
        stores = _write_host_stores(Path(stores_dir))
        host_launches = host_fed_training(dev, resident_ms, stores)
        train_launches += host_launches["train"]
        eval_launches += host_launches["test"]
        torch.cuda.empty_cache()
        net = net_training(dev, resident_ms, stores)
        torch.cuda.empty_cache()
        cli = cli_training(dev, stores)
        torch.cuda.empty_cache()
        exh = exhaustive_rank_eval(dev, stores)
        torch.cuda.empty_cache()
        interop = caffe_interop(dev, stores)
        torch.cuda.empty_cache()
        dn = device_negatives(dev, stores)
        torch.cuda.empty_cache()
        par = parallel(dev, stores)
    torch.cuda.empty_cache()
    zoo = layer_zoo(dev)
    tf32_checks(dev)
    torch.cuda.empty_cache()
    traj = trajectory(dev)
    torch.cuda.empty_cache()
    with torch.no_grad():
        gallery_eval(dev)
    torch.cuda.empty_cache()
    ext = extraction(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as serve_dir:
        serve = serving_artifact(dev, Path(serve_dir))
        torch.cuda.empty_cache()
        mesh = mesh_serving_artifact(dev, Path(serve_dir), serve)

    kernels = [
        {"name": "K1 matmul (TMA + wgmma GEMM, split-K, bias + ReLU "
                 "epilogue)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": launches["K1"] + serve["k1_sm90"],
         "max_abs_err": stats["K1"]["err"],
         "ms": stats["K1"]["ms"], "plain_ms": stats["K1"]["plain_ms"],
         "bound_ms": stats["K1"]["bound_ms"], "bound_by": "bytes",
         "library_ms": stats["K1"]["library_ms"]},
        {"name": "K1 matmul, the training tower's call (TMA + wgmma GEMM, "
                 "split-K, bias epilogue, f32 out)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": train_launches + par["launches_1920"],
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
        {"name": "K1 matmul, the Net's INNER_PRODUCT (f32 operands: TMA-fed "
                 "FFMA GEMM, split-K, bias epilogue)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_f32_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": (net["f32"] + cli["f32"] + ext["k1_f32"] + exh["f32"]
                      + zoo["f32"] + traj["f32"] + interop["k1_f32"]
                      + dn["f32"] + serve["k1_f32"] + par["cli_f32"]
                      + mesh["k1_rows"]),
         **{k: net["k1"][NET_ROWS][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
         "max_abs_err": max([v["err"] for v in net["k1"].values()]
                            + [exh["eval"]["fc7_err"], traj["readout_err"]])},
        {"name": "K1 matmul, core route at f32 (FMA tiles; the Net's f32 "
                 "operands take the f32 route, so only operands TMA cannot "
                 "address reach it: the trajectory readout, timed at its "
                 "shape)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": (net["launches"] + cli["launches"] - net["f32"]
                      - cli["f32"] + traj["core"]),
         **{k: traj["core_times"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
         "max_abs_err": max([v["core_err"] for v in net["k1"].values()]
                            + [traj["core_err"]])},
        {"name": "K1 matmul, the parallel ranks' tower shards (DP 2 x 1: "
                 f"{K1_SHARDS[0][0]} x 4096 x 4096; TP 1 x 2: "
                 f"{K1_SHARDS[1][0]} x 4096 x {K1_SHARDS[1][2]}; bf16 in, "
                 "f32 out, bias)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": par["launches"], "max_abs_err": par["k1"]["err"],
         **{k: par["k1"][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}},
        {"name": "K1 matmul, the 1 x 2 mesh serving artifact's column shards "
                 "at f32 (fc6 50 x 9216 x 2048 + fc7 50 x 4096 x 2048; "
                 "TMA-fed FFMA GEMM, split-K, bias epilogue)",
         "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_f32_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": mesh["k1_f32"], "max_abs_err": mesh["k1"]["f32"]["err"],
         **{k: mesh["k1"]["f32"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}},
        {"name": "K1 matmul, the 1 x 2 mesh serving artifact's column shards "
                 "in bf16 (fc6 50 x 9216 x 2048 + fc7 50 x 4096 x 2048; TMA "
                 "+ wgmma GEMM, split-K, bias epilogue)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": mesh["k1_sm90"], "max_abs_err": mesh["k1"]["sm90"]["err"],
         **{k: mesh["k1"]["sm90"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}},
        {"name": "K2 conv2d_im2col_gemm (implicit-GEMM conv: cp.async "
                 "gathers + TMA + wgmma, one launch per conv)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/conv_gemm_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/conv_gemm.py:18",
         "launches": launches["K2"] + serve["k2_sm90"] + mesh["k2_sm90"],
         "max_abs_err": stats["K2"]["err"],
         "ms": stats["K2"]["ms"], "plain_ms": stats["K2"]["plain_ms"],
         "bound_ms": stats["K2"]["bound_ms"], "bound_by": "operations",
         "library_ms": stats["K2"]["library_ms"]},
        {"name": "K2 space_to_depth (conv1's operands repacked for the sm90 "
                 "and f32 routes; timed at bf16, its time is inside K2's "
                 "conv1)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/conv_gemm_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/conv_gemm.py:18",
         "launches": (launches["repack"] + ext["repack"] + interop["repack"]
                      + serve["repack"] + mesh["repack"]),
         "max_abs_err": stats["repack"]["err"],
         "ms": stats["repack"]["ms"], "plain_ms": stats["repack"]["plain_ms"],
         "bound_ms": stats["repack"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "K2, the Net's CONVOLUTION at f32 (f32 route: cp.async "
                 "gathers + TMA weights + FFMA, split-K, one launch per conv)",
         "route": "cuda",
         "source": "videovector_tpu_torch/csrc/conv_gemm_f32_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/conv_gemm.py:18",
         "launches": (ext["k2_f32"] + interop["k2_f32"] + serve["k2_f32"]
                      + mesh["k2_f32"]),
         "max_abs_err": ext["k2"]["f32"]["err"],
         **{k: ext["k2"]["f32"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}},
        {"name": "K2, core route at f32 (implicit-GEMM conv on FMA tiles, one "
                 "launch per group; the Net's f32 convs take the f32 route, so "
                 "only operands its gathers cannot address reach it)",
         "route": "cuda",
         "source": "videovector_tpu_torch/csrc/conv_gemm.cu",
         "replaces": "videovector_tpu/ops/pallas/conv_gemm.py:18",
         "launches": ext["k2_core"], "max_abs_err": ext["k2"]["core"]["err"],
         **{k: ext["k2"]["core"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}},
    ]
    kernels += [
        {"name": f"max_pool_nhwc, {net}'s {n} pools (Caffe's ceil geometry "
                 "on NHWC, windows clipped to the image: no padded copy, no "
                 "indices; bf16)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/max_pool_nhwc.cu",
         "replaces": None, "launches": n_launches,
         "max_abs_err": pools[net]["err"],
         **{k: pools[net][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms")},
         "bound_by": "bytes"}
        for net, n, n_launches in (
            ("googlenet", 13, pools["googlenet"]["launches"]),
            ("caffenet", 3, launches["pool"]))]
    kernels += [
        {"name": f"lrn_nhwc, {net}'s 2 LRNs (Caffe's across-channels LRN on "
                 "NHWC, window clipped to the channels: one read of x, "
                 "squares, sums and scale in f32, one rounding; bf16)",
         "route": "cuda", "source": "videovector_tpu_torch/csrc/lrn_nhwc.cu",
         "replaces": None, "launches": n_launches,
         "max_abs_err": lrns[net]["err"],
         **{k: lrns[net][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms")},
         "bound_by": "bytes"}
        for net, n_launches in (("googlenet", lrns["googlenet"]["launches"]),
                                ("caffenet", launches["lrn"]))]
    kernels += [
        {"name": f"top_k_rows, the query's top-{TOP_K} of {rows} x {cols} f32 "
                 "scores (each score read once, k candidates a thread in "
                 "registers, slices merged by a second stage; the stable "
                 "sort's order)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/top_k_rows.cu",
         "replaces": None, "launches": n_launches,
         "max_abs_err": topks[(rows, cols)]["err"],
         "index_mismatches": topks[(rows, cols)]["mismatches"],
         **{k: topks[(rows, cols)][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")},
         "bound_by": "bytes"}
        for (rows, cols), n_launches in zip(TOPK_SHAPES, (1, launches["topk"]))]
    kernels += [
        {"name": f"K2, I3D's {i3d[kind]['n']} {what} at one "
                 f"{I3D_FRAMES}-frame clip (bf16)", "route": "cuda",
         "source": src, "replaces": None,
         "launches": i3d[kind]["launches"],
         "max_abs_err": i3d[kind]["err"],
         **{k: i3d[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms")},
         "bound_by": "operations"}
        for kind, what, src in (
            ("depth", "deep convs (the depth route: 19 3x3x3 and conv1 "
             "after its 3D repack, repack timed apart)",
             "videovector_tpu_torch/csrc/conv3d_gemm_sm90.cu"),
            ("flat", "1x1x1 convs (frames folded into the batch, the 2D "
             "sm90 route)", "videovector_tpu_torch/csrc/conv_gemm_sm90.cu"))]
    kernels += [
        {"name": f"max_pool, I3D's {i3d[kind]['n']} {what} pools at one "
                 f"{I3D_FRAMES}-frame clip (TF's SAME, windows clipped to "
                 "the clip; bf16)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/max_pool_nhwc.cu",
         "replaces": None, "launches": i3d[kind]["launches"],
         "max_abs_err": 0.0,
         **{k: i3d[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms")},
         "bound_by": "bytes"}
        for kind, what in (("pool_deep", "NDHWC"), ("pool_flat", "1x3x3"))]
    kernels += [
        {"name": f"attention, TimeSformer-L's {what} heads at one "
                 f"{TIMESFORMER_FRAMES}-frame clip (bf16, one block)",
         "route": "cuda",
         "source": "videovector_tpu_torch/csrc/attention_sm90.cu",
         "replaces": None, "launches": timesformer[kind]["launches"],
         "max_abs_err": timesformer[kind]["err"],
         **{k: timesformer[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms")},
         "bound_by": "bytes"}
        for kind, what in (("temporal", "196 x 12 temporal"),
                           ("spatial", "96 x 12 spatial"))]
    kernels.append(
        {"name": "K1 with the GELU epilogue, TimeSformer-L's fc1 (18,816 x "
                 "768 x 3,072, bf16)", "route": "cuda",
         "source": "videovector_tpu_torch/csrc/matmul_sm90.cu",
         "replaces": "videovector_tpu/ops/pallas/matmul.py:50",
         "launches": timesformer["k1_gelu"]["launches"],
         "max_abs_err": timesformer["k1_gelu"]["err"],
         **{k: timesformer["k1_gelu"][k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")},
         "bound_by": "operations"})
    log("(ms, plain_ms, bound_ms, library_ms: summed over the serving "
        f"path's shapes at batch {BATCH}: K1 fc6 + fc7 + tower with w cycled "
        "beyond L2, library cuBLAS torch.matmul; K2 conv1..conv5, library "
        "cuDNN F.conv2d. K1's training entry: one (1920 x 4096) . (4096 x "
        "4096) call, bf16 in, f32 out, its launches those of the training "
        f"main path, {TRAIN_MAIN_STEPS} steps + 2 remat_tower steps, and of "
        f"the host-fed run, {HOST_STEPS} + {HOST_RESUMED} steps. K1's "
        f"test-eval entry: one ({TEST_BATCH} x 4096) . (4096 x 4096) call "
        "with bias + ReLU, its launches the test evals' in train, drawn on "
        "the card and read from the test store. K1's Net entries: one (1920 x "
        "4096) . (4096 x 4096) call, f32 in and out, bias, on the f32 route "
        "and on the core route (bound: operations at the f32 FMA peak; "
        "library cuBLAS f32, TF32 off), their launches those of the Net, "
        f"{NET_STEPS} + {NET_RESUMED} steps and their test batches, and of "
        f"the CLI (cli_training: train, resume, test and time, "
        f"{cli['launches']} launches) and of extraction "
        f"({ext['k1_f32']}), of the exhaustive-shots train and test "
        f"({exh['f32']}: {EXH_STEPS} steps, the final display forward and "
        f"the tests at {TEST_BATCH} + {EXH_GALLERY_ROWS} rows), of the "
        f"layer zoo's fc8 ({zoo['f32']}) and of the trajectory phase "
        f"({traj['launches']}: the project's readout, hidden 32 -> 2, "
        f"{traj['core']} on the core route in train, test and time; the "
        f"enc-dec cells' {ENCDEC_WIDTH} -> {ENCDEC_WIDTH} readout, "
        f"{traj['f32']} on the f32 route) and of caffe_interop "
        f"({interop['k1_f32']}: the LMDB-fed train, its two resumes and "
        "test, the window trainer and the three extraction runs), by "
        "route; max_abs_err over that "
        f"shape, 673 rows, the exhaustive TEST fc7's {TEST_BATCH} + "
        f"{EXH_GALLERY_ROWS} rows and the enc-dec readout at each batch; "
        "the core route's over that shape and the trajectory readout's; "
        "its times at the trajectory readout's shape, library cuBLAS f32 "
        f"torch.addmm. K2's Net entry at f32: conv1..conv5 at batch {BATCH} "
        "from NCHW inputs, on the f32 route (the channels_last copies "
        "inside its time) and on the core route, bound at the f32 FMA peak, "
        "library cuDNN F.conv2d f32 (TF32 off), their launches those of "
        f"extraction, {EXTRACT_BATCHES} batches of {BATCH}, and of "
        f"caffe_interop's three extraction runs ({interop['k2_f32']}); the "
        "repack's launches those of serving, extraction and caffe_interop. "
        f"device_negatives adds {dn['f32']} K1 f32-route launches (its "
        f"train, tests and the debug_info run); serving_artifact adds one "
        f"counted call of each artifact: K1 sm90 {serve['k1_sm90']}, K1 f32 "
        f"{serve['k1_f32']}, K2 sm90 {serve['k2_sm90']}, K2 f32 "
        f"{serve['k2_f32']}, repack {serve['repack']}; parallel adds "
        f"{par['launches_1920']} K1 sm90 launches at the training tower's "
        "shape on the one-rank NCCL mesh (make_train_step, "
        "make_dp_train_step f32 and bf16 wire, 3 steps each), "
        f"{par['cli_f32']} f32-route launches of `train --mesh 1`, and the "
        f"{PAR_RANKS} gloo ranks' {par['launches']} sm90 launches at the "
        "shard shapes (DP and TP; its ms, plain_ms, bound_ms and library_ms "
        "summed over the two shapes); mesh_serving_artifact adds one counted "
        f"call of each mesh artifact on each of the {PAR_RANKS} gloo ranks: "
        f"the 1 x 2 f32 artifact's {mesh['k1_f32']} K1 f32-route launches at "
        f"the column shards and the 1 x 2 bf16 artifact's {mesh['k1_sm90']} "
        "sm90 ones (their rows: fc6 + fc7 shards at 50 rows, times summed "
        "over the two shapes, library torch.mm), the 2 x 1 symbolic "
        f"artifact's {mesh['k1_rows']} f32-route launches at 25 rows (in the "
        f"Net's f32 row), K2 f32 {mesh['k2_f32']}, K2 sm90 "
        f"{mesh['k2_sm90']}, repack {mesh['repack']}. max_pool_nhwc: "
        f"GoogLeNet's 13 and CaffeNet's 3 pools at batch {BATCH} in bf16, "
        "library F.max_pool2d with ceil_mode; its launches GoogLeNet's in one "
        "forward, CaffeNet's on the main path (3 an embed); it replaces no TPU kernel (the "
        "JAX package pools with XLA's reduce_window). lrn_nhwc: GoogLeNet's "
        f"and CaffeNet's 2 LRNs at batch {BATCH} in bf16, library "
        "F.local_response_norm on the NCHW view; its launches GoogLeNet's in "
        "one forward, CaffeNet's on the main path (2 an embed); it replaces "
        "no TPU kernel (the JAX package's LRN is XLA's elementwise ops). "
        f"top_k_rows: the query's top-{TOP_K} at 50 x 1,000,000 and 50 x "
        f"{GALLERY_ROWS} f32 scores, plain the stable torch.sort it "
        "replaced, library torch.topk (a yardstick only: no order at ties); "
        "its launches the phase's one at 1M and the main path's queries at "
        f"{GALLERY_ROWS}; it replaces no TPU kernel (the JAX package leaves "
        "lax.top_k to XLA))")
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
