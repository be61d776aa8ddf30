"""Serving export: freeze a trained net into a self-contained artifact;
counterpart of videovector_tpu/tools/serving.py.

The reference's deployment story is "ship the prototxt + .caffemodel and
run extract_features" (ref:tools/extract_features.cpp:26-211). Here the
TEST-phase forward, with the weights frozen in as the program's buffers,
serializes through `torch.export` into one artifact that runs with no
prototxt and no weight files: 8 magic bytes, a little-endian uint32 meta
length, the JSON meta, then the `torch.export.save` payload. The magic and
the extension (.vvtserve) are the port's own (.vvserve, StableHLO through
jax.export, stays with the JAX package). K1 and K2 are in the program as
the custom ops `vvtpu::k1_matmul` and `vvtpu::k2_conv2d_nhwc`: a CUDA
artifact launches them when it runs, and `load_serving` imports their
registrations before it deserializes. `info` reads the meta with the
standard library alone.

  vvtpu-torch-serve export net.prototxt out.vvtserve --weights w.caffemodel --blobs=ip2
  vvtpu-torch-serve info   out.vvtserve
  vvtpu-torch-serve run    out.vvtserve      # smoke-run on random inputs

An artifact holds one device's program: `--platforms cuda` (the default:
the card, which must be there) or `--platforms cpu`. `shard_serving` and
`run --mesh N` serve one device's artifact data-parallel, one rank a
device (parallel.make_mesh). A multi-device artifact (`export --mesh`,
`export_serving(mesh=)`, `mesh_serving`) waits for ROADMAP item 11b.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys

from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAGIC = b"VVTSERV1"
EXTENSION = ".vvtserve"
PLATFORMS = ("cuda", "cpu")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to videovector_tpu_torch yet (ROADMAP queue "
        "1, item 11b: the multi-device serving artifact)")


def _device(platforms) -> str:
    """The one device an artifact is exported for: cuda unless asked."""
    plats = list(platforms or ["cuda"])
    bad = [p for p in plats if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platform(s) {bad}: a videovector_tpu_torch "
                         f"artifact is exported for one of {PLATFORMS}")
    if len(plats) != 1:
        raise ValueError(f"platforms {plats}: a videovector_tpu_torch artifact "
                         "holds one device's program; export one per platform")
    return plats[0]


def _serve_module(net, params, blob_names, stateful, quant):
    """An nn.Module whose forward(batch) -> {blob: tensor} runs the Net
    with `params` and the quant table as its buffers."""
    import torch

    class Serve(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.slots = {}
            for ln, lp in params.items():
                for pn, t in lp.items():
                    self._buffer(("p", ln, pn), t)
            self.modes = {}
            for ln, entry in (quant or {}).items():
                for k, v in entry.items():
                    if k == "mode":
                        self.modes[ln] = v
                    else:
                        self._buffer(("q", ln, k), v)

        def _buffer(self, key, t):
            name = f"b{len(self.slots)}"
            self.register_buffer(name, t.detach())
            self.slots[key] = name

        def _tables(self):
            p, q = {}, {}
            for (kind, ln, k), name in self.slots.items():
                (p if kind == "p" else q).setdefault(ln, {})[k] = \
                    getattr(self, name)
            for ln, mode in self.modes.items():
                q[ln]["mode"] = mode
            return p, q

        def forward(self, batch):
            from videovector_tpu_torch.ops.recurrent import LstmState
            p, q = self._tables()
            net.quant = q or None
            feed = {k: v for k, v in batch.items()
                    if not k.startswith("state:")}
            if stateful:
                state = {ln: LstmState(batch[f"state:{ln}:c"],
                                       batch[f"state:{ln}:h"])
                         for ln in stateful}
                _, blobs, st = net.apply(p, feed, state=state,
                                         return_blobs=True, return_state=True)
            else:
                _, blobs = net.apply(p, feed, return_blobs=True)
                st = {}
            missing = [n for n in blob_names if n not in blobs]
            if missing:
                raise ValueError(f"blobs not in net: {missing}")
            out = {n: blobs[n] for n in blob_names}
            for ln in stateful:
                out[f"state:{ln}:c"] = st[ln].c
                out[f"state:{ln}:h"] = st[ln].h
            return out

    return Serve()


def _output_axes(serve, inputs: dict, in_axes: dict):
    """Each output's batch axis, found as JAX's export finds it: run the
    forward on fake tensors at the inputs' shapes and at twice their batch,
    and see which output dims double (exact: only batch dims vary). A net
    with a static batch refuses the doubled run; its axes stay unrecorded
    ({}, {}), as in JAX."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    def at(mult):
        with FakeTensorMode(allow_non_fake_inputs=True):
            feed = {k: torch.empty(tuple(
                d * mult if i == in_axes[k] else d
                for i, d in enumerate(v.shape)), dtype=v.dtype,
                device=v.device) for k, v in inputs.items()}
            with torch.no_grad():
                return {k: (tuple(int(d) for d in v.shape), v.dtype)
                        for k, v in serve(feed).items()}

    out_axes, out_shapes = {}, {}
    try:
        out1, out2 = at(1), at(2)
    except Exception as e:  # noqa: BLE001 - a static-batch net
        log.info("output batch-axis inference skipped (static-batch "
                 "net?): %s", e)
        return out_axes, out_shapes
    for name, (shape, dtype) in out1.items():
        doubled = [i for i, (a, b) in enumerate(zip(shape, out2[name][0]))
                   if a != b and b == 2 * a]
        out_axes[name] = doubled[0] if doubled else None
        out_shapes[name] = [list(shape), str(dtype).replace("torch.", "")]
    return out_axes, out_shapes


def export_serving(model_path: str, weight_paths: list[str],
                   blob_names: list[str], out_path: str, *,
                   platforms: list[str] | None = None,
                   symbolic_batch: bool = False,
                   input_shapes: dict | None = None,
                   quantize: str | None = None,
                   calib_batches: int = 4,
                   calib_data: list | None = None,
                   compute_dtype: str | None = None,
                   mesh=None) -> dict:
    """Freeze the phase=TEST forward(batch) -> {blob: activation} with the
    params inside; write a self-contained artifact. Returns its meta.

    platforms: ["cuda"] (default) or ["cpu"]: the device the program runs
    on. symbolic_batch=True exports each input's batch axis as one
    torch.export.Dim, so that ONE artifact serves any batch size (a layer
    that needs a static batch makes the export fail loudly).
    quantize="int8" calibrates on `calib_batches` batches from a fresh
    stream of the net's data sources (or `calib_data`) and freezes the
    quant table (tools/quantize.py): int8 INNER_PRODUCTs, weight_only
    convs. compute_dtype="bfloat16" freezes the bf16-operand math (f32
    sums) of the live extraction pipeline, with the INNER_PRODUCT and
    CONVOLUTION weights frozen in bf16 (the casts the Net would make on
    every call). A stateful (LSTM) net's cross-batch carry becomes the
    inputs and outputs "state:<layer>:{c,h}"."""
    import numpy as np
    import torch

    from videovector_tpu_torch.config.textformat import parse_file
    from videovector_tpu_torch.device import resolve
    from videovector_tpu_torch.graph.data_factory import (
        MergedSource, make_data_source,
    )
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    from videovector_tpu_torch.graph.net import Net
    from videovector_tpu_torch.tools.cli import _load_weights
    from videovector_tpu_torch.tools.export_model import export, save

    if mesh is not None:
        raise _not_ported("a multi-device serving export (mesh=)")
    platform = _device(platforms)
    dev = resolve(platform)
    net_msg = parse_file(model_path)
    net = Net(net_msg, phase="TEST", compute_dtype=compute_dtype)

    # example shapes: explicit input_shapes (needed for push-fed layers
    # like MEMORY_DATA), the data layers' first batch, the input
    # declarations
    batch0: dict = {k: np.zeros(tuple(shape), np.float32)
                    for k, shape in (input_shapes or {}).items()}
    sources = []
    for l in net.layers:
        if l.get("type") not in DATA_LAYER_TYPES:
            continue
        if all(str(t) in batch0 for t in l.get_list("top")):
            continue  # the caller supplied this layer's shapes
        sources.append(make_data_source(l, phase="TEST"))
    merged0 = MergedSource(sources) if sources else None
    if merged0 is not None:
        batch0.update({k: np.asarray(v)
                       for k, v in merged0.next_batch().items()})
    input_names = list(net_msg.get_list("input"))
    input_dims = [int(d) for d in net_msg.get_list("input_dim")]
    for idx, name in enumerate(input_names):
        dims = input_dims[idx * 4:(idx + 1) * 4]
        batch0[str(name)] = np.zeros(dims, np.float32)
    if not batch0:
        raise ValueError("net has neither data layers nor input "
                         "declarations (pass input_shapes / --input_shape)")
    # each input's batch axis: 0 for declared inputs; time-major sources
    # (tracking (T, B, ...)) declare theirs through batch_axes()
    in_axes = {k: 0 for k in batch0}
    if merged0 is not None:
        for k, a in merged0.batch_axes().items():
            if k in in_axes:
                in_axes[k] = int(a)

    params, _ = net.init(torch.Generator(device=dev).manual_seed(0), {
        k: torch.empty(v.shape, dtype=torch.float32, device="meta")
        for k, v in batch0.items()})
    for wp in weight_paths:
        params = _load_weights(wp, params, dev)

    quant = None
    if quantize == "int8":
        from videovector_tpu_torch.tools.quantize import (
            calibrate, quantize_weights,
        )
        if calib_data is not None:
            calib = list(calib_data)
        elif sources:
            # a fresh source stream gives the calibration batches, with the
            # same skip filter as above and the static inputs merged into
            # every batch
            covered = set((input_shapes or {}).keys()) \
                | {str(n) for n in input_names}
            static = {k: batch0[k] for k in covered if k in batch0}
            src = MergedSource([make_data_source(l, phase="TEST")
                                for l in net.layers
                                if l.get("type") in DATA_LAYER_TYPES
                                and not all(str(t) in covered
                                            for t in l.get_list("top"))])
            calib = [batch0]
            for _ in range(max(0, calib_batches - 1)):
                b = dict(static)
                b.update({k: np.asarray(v)
                          for k, v in src.next_batch().items()})
                calib.append(b)
        else:
            raise ValueError(
                "int8 quantization needs calibration data: the net has no "
                "data layers, so pass calib_data=[{input: array}, ...]")
        quant = quantize_weights(params, net, calibrate(net, params, calib))
        log.info("int8 PTQ: quantized %d layers (%s)", len(quant),
                 ",".join(sorted(quant)))
        # the quantized layers' f32 weights are not in the program (JAX's
        # export drops the unused constants alike)
        params = {ln: {pn: t for pn, t in lp.items()
                       if not (ln in quant and pn == "w")}
                  for ln, lp in params.items()}
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if net.compute_dtype is not None:
        types = {l.get("name"): l.get("type") for l in net.layers}
        params = {ln: {pn: (t.to(net.compute_dtype) if pn == "w" and
                            types.get(ln) in ("INNER_PRODUCT", "CONVOLUTION")
                            else t) for pn, t in lp.items()}
                  for ln, lp in params.items()}

    inputs = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in batch0.items()}
    stateful = list(net.stateful_layer_names)
    if stateful:
        with torch.no_grad():
            _, _, st0 = net.apply(params, inputs, return_state=True)
        for ln in stateful:
            for part in ("c", "h"):
                inputs[f"state:{ln}:{part}"] = torch.zeros_like(
                    getattr(st0[ln], part), dtype=torch.float32)
                in_axes[f"state:{ln}:{part}"] = 0   # an LstmState is (B, H)

    serve = _serve_module(net, params, blob_names, stateful, quant)
    out_axes, out_shapes = _output_axes(serve, inputs, in_axes)
    dynamic = None
    if symbolic_batch:
        batch_dim = torch.export.Dim("batch", min=1, max=1 << 20)
        dynamic = ({k: {in_axes[k]: batch_dim} for k in inputs},)
    with torch.no_grad():
        program = export(serve, (inputs,), dynamic_shapes=dynamic)
    import io
    buf = io.BytesIO()
    save(program, buf)
    payload = buf.getvalue()

    meta = {
        "inputs": {k: [[-1 if symbolic_batch and i == in_axes[k] else int(d)
                        for i, d in enumerate(v.shape)], "float32"]
                   for k, v in inputs.items()},
        "batch_axes": {**in_axes, **out_axes},
        "outputs": list(blob_names) + sorted(k for k in inputs
                                             if k.startswith("state:")),
        # shapes at the EXAMPLE batch (the batch dim varies when
        # symbolic_batch; its axis per tensor is in batch_axes)
        "output_shapes": out_shapes,
        "state": sorted(k for k in inputs if k.startswith("state:")),
        "platforms": [platform],
        "mesh": None,
        "nr_devices": 1,
        "model": model_path,
        "quantize": quantize or "none",
        "compute_dtype": compute_dtype or "float32",
    }
    meta_bytes = json.dumps(meta).encode()
    with open(out_path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(meta_bytes)))
        f.write(meta_bytes)
        f.write(payload)
    log.info("Exported %s -> %s (%d bytes, platforms=%s)", model_path,
             out_path, len(payload), platform)
    return meta


def _read_header(f, path: str) -> dict:
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError(f"{path}: not a videovector_tpu_torch serving "
                         "artifact")
    (meta_len,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(meta_len).decode())


def read_meta(path: str) -> dict:
    """The artifact's JSON meta (inputs, outputs, platforms, quantize, and
    the payload's size), with the standard library alone and without
    deserializing the program."""
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        header = f.tell()
        f.seek(0, 2)
        meta["payload_bytes"] = f.tell() - header
    return meta


def load_serving(path: str):
    """(call_fn, meta): call_fn({name: array or tensor}) -> {blob: tensor},
    the inputs moved to the artifact's device as f32. Needs no prototxt or
    weights: the port's op registrations are imported, then the program is
    deserialized."""
    import io

    import torch

    from videovector_tpu_torch.tools.export_model import load_exported

    with open(path, "rb") as f:
        meta = _read_header(f, path)
        program = load_exported(io.BytesIO(f.read()))
    dev = torch.device(meta["platforms"][0])
    module = program.module()

    def call(batch: dict) -> dict:
        feed = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in batch.items()}
        with torch.no_grad():
            return module(feed)

    return call, meta


def mesh_serving(call, meta):
    raise _not_ported("mesh_serving (a multi-device artifact)")


def shard_serving(call, meta, mesh):
    """Data-parallel serving: a callable that takes the GLOBAL batch (the
    same on every rank of `mesh`), runs the one-device artifact on this
    rank's rows and returns the global outputs on every rank (the ranks'
    rows gathered over "data"; the shards are independent, so that gather
    is the only collective).

    The artifact must accept the per-rank batch: export with
    --symbolic_batch (any divisible global batch), or feed a global batch
    of artifact_batch x ranks. Tensors split on their recorded batch axis
    (meta["batch_axes"]: time-major LSTM blobs are (T, B, ...), axis 1;
    state:* carries axis 0); artifacts without that field default to axis
    0."""
    from videovector_tpu_torch.ops.collectives import all_gather
    from videovector_tpu_torch.ops.sharding import mesh_axis, rank_rows

    if int(meta.get("nr_devices") or 1) > 1:
        raise ValueError(
            f"artifact bakes a {meta['nr_devices']}-device program (export "
            "mesh=...); run it via mesh_serving — shard_serving is for "
            "single-device artifacts")
    ax = mesh_axis(mesh, "data")
    axes = meta.get("batch_axes") or {}

    def _axis(name):
        a = axes.get(name, 0)
        if a is None:
            raise ValueError(
                f"output {name!r} has no batch axis (per-shard values "
                "would differ) — export without it for sharded serving")
        return a

    def sharded_call(batch):
        import torch
        local = {}
        for k, v in batch.items():
            a = _axis(k)
            if v.shape[a] % ax.size:
                raise ValueError(
                    f"input {k!r} batch {v.shape[a]} (axis {a}) not "
                    f"divisible by the mesh data axis ({ax.size})")
            local[k] = rank_rows(torch.as_tensor(v), ax, a)
        out = call(local)
        return {n: all_gather(o, ax, _axis(n)) for n, o in out.items()}

    return sharded_call


def _time_calls(call, batch, iterations: int, device: str) -> float:
    """Seconds a call: CUDA events around `iterations` calls on the card,
    the host clock on the CPU."""
    import time

    import torch
    if device == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            call(batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iterations
    t0 = time.perf_counter()
    for _ in range(iterations):
        call(batch)
    return (time.perf_counter() - t0) / iterations


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-serve")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("export", help="freeze net+weights into an artifact")
    p.add_argument("model")
    p.add_argument("out")
    p.add_argument("--weights", action="append", default=[])
    p.add_argument("--blobs", required=True,
                   help="comma-separated blob names to serve")
    p.add_argument("--platforms", default="",
                   help="the device the artifact runs on: cuda (default) "
                        "or cpu")
    p.add_argument("--symbolic_batch", action="store_true",
                   help="export the batch axis as a torch.export.Dim: one "
                        "artifact serves any batch size")
    p.add_argument("--input_shape", action="append", default=[],
                   help="name=4,3,227,227: explicit input shapes (needed "
                        "for MEMORY_DATA-fed nets)")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8 PTQ: calibrated symmetric per-channel "
                        "weights, int8 fc math, weight_only convs, a "
                        "smaller artifact")
    p.add_argument("--calib_batches", type=int, default=4,
                   help="calibration batches for --quantize")
    p.add_argument("--compute", default="", choices=["", "bfloat16"],
                   help="freeze bf16 GEMM/conv operands (f32 sums): the "
                        "live pipeline's throughput math; the default keeps "
                        "f32 reference numerics")
    p.add_argument("--mesh", default="",
                   help="a multi-device program: waits for ROADMAP item 11b")

    p = sub.add_parser("info", help="print an artifact's metadata as JSON, "
                                    "without loading the program")
    p.add_argument("artifact")

    p = sub.add_parser("run", help="smoke-run an artifact on random inputs")
    p.add_argument("artifact")
    p.add_argument("--mesh", default="",
                   help="data-parallel serving over N ranks (one process a "
                        "device; see parallel.make_mesh): the global batch "
                        "is the artifact's batch x N")
    p.add_argument("--iterations", type=int, default=0,
                   help="also time the artifact: N timed calls after a "
                        "warmup, reporting ms/call and items/s")
    p.add_argument("--memory", action="store_true",
                   help="report the card's peak allocated memory over a "
                        "call")

    args = parser.parse_args(argv)
    if args.command == "export" and args.mesh:
        raise _not_ported("export --mesh")
    if args.command == "export":
        platforms = [s for s in args.platforms.split(",") if s] or None
        shapes = {}
        for spec in args.input_shape:
            name, _, dims = spec.partition("=")
            shapes[name] = tuple(int(d) for d in dims.split(","))
        export_serving(args.model, args.weights, args.blobs.split(","),
                       args.out, platforms=platforms,
                       symbolic_batch=args.symbolic_batch,
                       input_shapes=shapes or None,
                       quantize=args.quantize or None,
                       calib_batches=args.calib_batches,
                       compute_dtype=args.compute or None)
    elif args.command == "info":
        print(json.dumps(read_meta(args.artifact), indent=2, sort_keys=True))
    elif args.command == "run":
        import numpy as np
        import torch
        call, meta = load_serving(args.artifact)
        device = meta["platforms"][0]
        rng = np.random.RandomState(0)
        mult = 1
        if args.mesh:
            from videovector_tpu_torch.tools.cli import _parse_mesh
            mesh = _parse_mesh(args.mesh, device)
            call = shard_serving(call, meta, mesh)
            mult = mesh.size(0)
        axes = meta.get("batch_axes") or {}
        batch = {k: rng.randn(*[8 * mult if d == -1 else
                                (d * mult if i == axes.get(k, 0) else d)
                                for i, d in enumerate(shape)]).astype(dtype)
                 for k, (shape, dtype) in meta["inputs"].items()}
        if args.memory and device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = call(batch)
        if args.memory and device == "cuda":
            torch.cuda.synchronize()
            log.info("serving artifact: peak allocated %.1f MB",
                     torch.cuda.max_memory_allocated() / 1e6)
        for name, arr in out.items():
            log.info("%s: shape=%s mean=%.6f", name, tuple(arr.shape),
                     float(arr.float().mean()))
        if args.iterations > 0:
            dt = _time_calls(call, batch, args.iterations, device)
            axes = meta.get("batch_axes") or {}
            # items/s only where some input has a recorded batch axis
            items_ax = next(((k, ax) for k, ax in axes.items()
                             if ax is not None and k in batch), None)
            if items_ax is not None:
                k0, ax0 = items_ax
                items = batch[k0].shape[ax0]
                log.info("Serving: %.3f ms/call (%.1f calls/s, %.0f items/s)",
                         dt * 1e3, 1.0 / dt, items / dt)
            else:
                log.info("Serving: %.3f ms/call (%.1f calls/s)",
                         dt * 1e3, 1.0 / dt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
