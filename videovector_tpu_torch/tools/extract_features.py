"""vvtpu-torch-extract-features: forward a net and dump named blobs;
counterpart of videovector_tpu/tools/extract_features.py.

ref:tools/extract_features.cpp:26-211: load a net prototxt, apply the
weight files in order (ImageNet's, then the task's, :104-107), forward N
minibatches, and write each requested blob's rows to a record store (one
Datum each) and a csv text file (:141-198). The forward runs on the card
(the CPU with `--cpu` or `--gpu=-1`) through the port's Net at TEST, fed by
data/prefetch.py; every CONVOLUTION is a K2 launch and every INNER_PRODUCT
a K1 launch there.

Usage:
  python -m videovector_tpu_torch.tools.extract_features \\
      --model=net.prototxt [--weights=a.caffemodel --weights=b.vvmodel] \\
      --blobs=ip2 --out=features --num_batches=10 [--backend=leveldb] [--cpu]

The three backends write the JAX tool's bytes:
  vvr      <out>_<blob>.vvr (keys "%010d", Datum(channels=dim, height=1,
           width=1, float_data=row)) and <out>_<blob>.txt (one "%.6f" csv
           row per item);
  lmdb     the same keys and Datums in the LMDB <out>_<blob>_lmdb, and the
           same text file;
  leveldb  the reference's format (ref:tools/extract_features.cpp:125-188):
           the LevelDB <out>_<blob>_leveldb with decimal "%d" keys and
           Datum(channels=1, height=dim, width=1), and text_output.txt
           inside it, a "#features" header, then rows of "%g," values.
`--mesh N` extracts data-parallel over N ranks, one process a device
(parallel/mesh.py; launch with python -m torch.distributed.run): every
rank draws the same stream and forwards its rows of each batch, and rank
0 writes the stores and text files, byte-equal to a one-rank run's.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import torch

from videovector_tpu_torch.config.textformat import parse_file
from videovector_tpu_torch.data.prefetch import DevicePrefetcher
from videovector_tpu_torch.data.records import open_store_writer
from videovector_tpu_torch.data.wire import Datum
from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.graph.data_factory import MergedSource, make_data_source
from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
from videovector_tpu_torch.graph.net import Net
from videovector_tpu_torch.ops.sharding import writer_logs
from videovector_tpu_torch.solver.driver import _spec_from_batch
from videovector_tpu_torch.tools.cli import (
    _device, _load_weights, _mesh_of, mesh_run,
)
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

BACKENDS = ("vvr", "leveldb", "lmdb")


def extract(model_path: str, weight_paths: list[str], blob_names: list[str],
            out_prefix: str, num_batches: int, backend: str = "vvr",
            device=None, mesh=None) -> dict:
    """Returns {blob name: rows written}. `device`: where the Net runs (the
    card when None; raises without one). `mesh` (parallel.make_mesh; call
    on every rank): each rank forwards its rows of every batch, the rows
    are gathered back, and rank 0 writes."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown feature store backend {backend!r}")
    dev = resolve(DEFAULT if device is None else device)
    net = Net(parse_file(model_path), phase="TEST")
    source = MergedSource([make_data_source(l, phase="TEST")
                           for l in net.layers
                           if l.get("type") in DATA_LAYER_TYPES])
    batch0_raw = source.next_batch()
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0),
                         _spec_from_batch(batch0_raw))
    for wp in weight_paths:
        params = _load_weights(wp, params, dev)

    # reference CHECK: every requested blob exists BEFORE any output store
    # is created (extract_features.cpp:113-118)
    known = set(batch0_raw) | {str(t) for l in net.layers
                               for t in l.get_list("top")}
    missing = [n for n in blob_names if n not in known]
    if missing:
        raise ValueError(
            f"Unknown feature blob name(s) {missing} in the net "
            f"(ref CHECK has_blob, extract_features.cpp:113-118); "
            f"available: {sorted(known)}")

    # the batch consumed for shape inference is RE-FED as batch 0: the
    # source's cursor has moved on, and starting from it would skip the
    # dataset's first batch and shift every row against the reference
    stream = itertools.islice(itertools.chain([batch0_raw], source),
                              num_batches)
    shard = mesh_run(mesh, source)
    apply = shard.under_axes(net.apply)
    prefetcher = DevicePrefetcher(stream, depth=2, device=dev,
                                  transform=shard.rows)
    if not shard.writer:
        # the other ranks forward their rows and join the gathers
        try:
            for batch in prefetcher:
                with torch.inference_mode():
                    blobs = apply(params, batch, return_blobs=True)[1]
                shard.gather({n: blobs[n] for n in blob_names})
        finally:
            prefetcher.close()
        return {}
    # "leveldb" is the reference's output format; "vvr" and "lmdb" keep
    # zero-padded keys, so that key order is insertion order
    ref_format = backend == "leveldb"
    suffix = {"vvr": "_{}.vvr", "leveldb": "_{}_leveldb",
              "lmdb": "_{}_lmdb"}[backend]
    writers = {name: open_store_writer(out_prefix + suffix.format(name),
                                       backend)
               for name in blob_names}
    if ref_format:
        # the reference writes the csv inside the db directory (:141-142)
        texts = {}
        for name in blob_names:
            db_dir = out_prefix + suffix.format(name)
            os.makedirs(db_dir, exist_ok=True)
            texts[name] = open(os.path.join(db_dir, "text_output.txt"), "w")
            texts[name].write("#features\n")
    else:
        texts = {name: open(f"{out_prefix}_{name}.txt", "w")
                 for name in blob_names}
    counts = {name: 0 for name in blob_names}
    try:
        for batch in prefetcher:
            with torch.inference_mode():
                blobs = apply(params, batch, return_blobs=True)[1]
            blobs = shard.gather({n: blobs[n] for n in blob_names})
            for name in blob_names:
                feats = blobs[name].float().cpu().numpy()
                for row in feats.reshape(feats.shape[0], -1):
                    if ref_format:
                        key = str(counts[name])
                        datum = Datum(channels=1, height=len(row), width=1,
                                      float_data=row)
                        # C++ `stream << float` default formatting is %g
                        # (6 significant digits, scientific outside
                        # [1e-4, 1e6))
                        texts[name].write(
                            "".join(f"{float(v):g}," for v in row) + "\n")
                    else:
                        key = f"{counts[name]:010d}"
                        datum = Datum(channels=len(row), height=1, width=1,
                                      float_data=row)
                        texts[name].write(
                            ",".join(f"{v:.6f}" for v in row) + "\n")
                    writers[name].put(key, datum.encode())
                    counts[name] += 1
            log.info("Extracted features of %d query images for blobs %s",
                     counts[blob_names[0]], ",".join(blob_names))
    finally:
        prefetcher.close()
        for w in writers.values():
            w.close()
        for t in texts.values():
            t.close()
    log.info("Successfully extracted the features!")
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-extract-features")
    parser.add_argument("--model", required=True)
    parser.add_argument("--weights", action="append", default=[])
    parser.add_argument("--blobs", required=True,
                        help="comma-separated blob names")
    parser.add_argument("--out", required=True, help="output path prefix")
    parser.add_argument("--num_batches", type=int, default=10)
    parser.add_argument("--backend", default="vvr", choices=BACKENDS,
                        help="feature store format (leveldb = the "
                             "reference extract_features output format)")
    parser.add_argument("--mesh", default="",
                        help="data-parallel extraction over N ranks, one "
                             "process a device (launch with python -m "
                             "torch.distributed.run); rank 0 writes")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions)")
    parser.add_argument("--gpu", default=None,
                        help="device id; -1 = CPU (the reference binary's "
                             "GPU/CPU + device-id args, "
                             "ref tools/extract_features.cpp:52-66)")
    args = parser.parse_args(argv)
    mesh = _mesh_of(args)
    with writer_logs(mesh):
        extract(args.model, args.weights, args.blobs.split(","), args.out,
                args.num_batches, backend=args.backend, device=_device(args),
                mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
