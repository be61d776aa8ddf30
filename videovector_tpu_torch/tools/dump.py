"""dump_network / dump_learned_blobs: debugging dumps; counterpart of
videovector_tpu/tools/dump.py.

ref:tools/dump_network.cpp:27-77 (forward a net and dump every activation
blob) and ref:tools/dump_learned_blobs.cpp:27-62 (dump all learned weights).
Outputs BlobProto-format binary files (one per blob, through the port's
data/wire.py), readable by both packages and by Caffe tooling, plus an npz
bundle. These are the parity harness's building blocks (tools/parity.py):
diff one dump against another to check layer-level numerics.

`dump_network` runs on the card unless asked for the CPU (`--cpu`), with
TF32 off, so that its values are full f32 sums as the JAX package's
("highest" precision) dumps are.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from videovector_tpu_torch.data.wire import BlobProto
from videovector_tpu_torch.device import DEFAULT, resolve
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)


def _write_blob(path: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr, np.float32)
    if arr.ndim > 4:
        # BlobProto is 4-D (the reference Blob); writing only slice [0]
        # would make parity diffs pass on data they never saw. The full
        # array is in activations.npz: skip the .blob loudly instead
        log.warning("%s: %d-D activation does not fit a 4-D BlobProto: "
                    "skipped (full array is in activations.npz)",
                    path, arr.ndim)
        return
    shaped = arr.reshape((1,) * (4 - arr.ndim) + arr.shape)
    with open(path, "wb") as f:
        f.write(BlobProto.from_array(shaped).encode())


def dump_network(model_path: str, out_dir: str, *, weights=(),
                 batch: dict | None = None, device=DEFAULT) -> dict:
    """Forward the TEST net on one batch from its data layers (or `batch`)
    with the weight files applied in order; write every blob. Returns
    {blob: array}."""
    from videovector_tpu_torch.config.textformat import parse_file
    from videovector_tpu_torch.graph.data_factory import (
        MergedSource, make_data_source,
    )
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    from videovector_tpu_torch.graph.net import Net
    from videovector_tpu_torch.ops.linear import no_tf32
    from videovector_tpu_torch.tools.cli import _load_weights

    dev = resolve(device)
    net = Net(parse_file(model_path), phase="TEST")
    if batch is None:
        sources = [make_data_source(l, phase="TEST")
                   for l in net.layers if l.get("type") in DATA_LAYER_TYPES]
        batch = MergedSource(sources).next_batch()
    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in batch.items()}
    params, _ = net.init(torch.Generator(device=dev).manual_seed(0), {
        k: torch.empty(tuple(v.shape), dtype=torch.float32, device="meta")
        for k, v in batch.items()})
    for wp in weights:
        params = _load_weights(wp, params, dev)
    with torch.no_grad(), no_tf32():
        _, blobs = net.apply(params, batch, return_blobs=True)

    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, arr in blobs.items():
        arr = _host(arr)
        _write_blob(os.path.join(out_dir, f"{name}.blob"), arr)
        out[name] = arr
    np.savez(os.path.join(out_dir, "activations.npz"), **out)
    log.info("Dumped %d activation blobs to %s", len(out), out_dir)
    return out


def dump_learned_blobs(params: dict, out_dir: str) -> None:
    """Every param as <layer>.<param>.blob, and weights.npz."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for lname, lp in params.items():
        for pname, arr in lp.items():
            arr = _host(arr)
            _write_blob(os.path.join(out_dir, f"{lname}.{pname}.blob"), arr)
            flat[f"{lname}/{pname}"] = arr
    np.savez(os.path.join(out_dir, "weights.npz"), **flat)
    log.info("Dumped %d learned blobs to %s", len(flat), out_dir)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-dump")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("network")
    p.add_argument("--model", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--weights", action="append", default=[])
    p.add_argument("--input", action="append", default=[],
                   help="name=path.blob: feed a fixed BlobProto as a graph "
                        "input instead of pulling from the net's data layers "
                        "(the dump_network parity workflow)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the card)")
    p = sub.add_parser("learned_blobs")
    p.add_argument("--weights", required=True, help=".vvmodel file")
    p.add_argument("--out", required=True)
    p.add_argument("--cpu", action="store_true",
                   help="accepted for the JAX tool's flags; nothing runs "
                        "on a device")
    args = parser.parse_args(argv)
    if args.command == "network":
        batch = None
        if args.input:
            batch = {}
            for spec in args.input:
                name, _, path = spec.partition("=")
                with open(path, "rb") as f:
                    batch[name] = BlobProto.decode(f.read()).to_array()
        dump_network(args.model, args.out, weights=args.weights, batch=batch,
                     device="cpu" if args.cpu else DEFAULT)
    else:
        from videovector_tpu_torch.solver.checkpoint import load_model
        dump_learned_blobs(load_model(args.weights), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
