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

An artifact is for one platform: `--platforms cuda` (the default: the
card, which must be there) or `--platforms cpu`. `shard_serving` and
`run --mesh N` serve one device's artifact data-parallel, one rank a
device (parallel.make_mesh).

A multi-device artifact (`export --mesh DxM`, `export_serving(mesh=)`)
is exported by D*M ranks, one a device, as JAX's needs D*M devices: each
rank traces the forward on its shard (every 2-D param cut to its columns
when M > 1, as JAX's export shards every 2-D leaf over "model"; the batch
cut to its rows over "data") with the mesh's collectives in the program
(ops/collectives.py, traced: `_c10d_functional` ops beside K1 and K2), and
rank 0 writes every rank's program into one file. A program names a
collective's process group by a string that depends on the groups its
process made before, so the trace's names are rewritten to the axis they
belong to ("mesh:data", "mesh:model"; the meta's "groups"), and
`mesh_serving` binds them to its own mesh's groups before the first call.
A rank's program also names the device it was traced on (its buffers,
its constants): it is served by the rank of that index on that device,
as a launch of one process a device in the exporting order gives:

  python -m torch.distributed.run --nproc_per_node 4 -m \
      videovector_tpu_torch.tools.serving export net.prototxt out.vvtserve \
      --weights w.caffemodel --blobs=ip2 --mesh 2x2
  python -m torch.distributed.run --nproc_per_node 4 -m \
      videovector_tpu_torch.tools.serving run out.vvtserve
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import sys

from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAGIC = b"VVTSERV1"
EXTENSION = ".vvtserve"
PLATFORMS = ("cuda", "cpu")
# the group names a multi-device program is written with, one a mesh axis
GROUPS = {f"mesh:{axis}": axis for axis in ("data", "model")}


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
    inputs and outputs "state:<layer>:{c,h}".

    mesh (parallel.make_mesh's "data" x "model" mesh, every rank of the
    group calling this) exports a multi-device artifact: each rank's
    program computes on its shard (module docstring); rank 0 writes the
    file, and the call returns on every rank once it is written. The meta
    adds "mesh" and "nr_devices", as JAX's does, and, with more than one
    device, each rank's program's bytes ("payloads", in rank order), the
    device each was traced on ("devices") and the axis of each group name
    ("groups"). Load it with `mesh_serving` on as many ranks."""
    import numpy as np
    import torch

    from videovector_tpu_torch.config.textformat import parse_file
    from videovector_tpu_torch.device import resolve
    from videovector_tpu_torch.graph.data_factory import (
        MergedSource, make_data_source,
    )
    from videovector_tpu_torch.graph.layers import DATA_LAYER_TYPES
    from videovector_tpu_torch.graph.net import Net
    from videovector_tpu_torch.ops.sharding import is_writer, mesh_device
    from videovector_tpu_torch.tools.cli import _load_weights

    platform = _device(platforms or (mesh and [mesh.device_type]))
    if mesh is None:
        dev = resolve(platform)
    elif mesh.device_type != platform:
        raise ValueError(f"a {mesh.device_type} mesh exports for "
                         f"{mesh.device_type}, not {platform}")
    else:
        dev = mesh_device(mesh)
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

    def serve_of(p):
        return _serve_module(net, p, blob_names, stateful, quant)

    serve = serve_of(params)
    # the whole module's output axes, before any mesh axis is active (the
    # collectives cannot run on fake tensors)
    out_axes, out_shapes = _output_axes(serve, inputs, in_axes)
    if mesh is None:
        payloads = [_program(serve, inputs, in_axes, symbolic_batch)]
    else:
        payloads, sizes, devices = _mesh_programs(
            serve_of, params, inputs, in_axes, symbolic_batch, mesh)

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
    if mesh is not None:
        meta["mesh"] = {"data": mesh.size(0), "model": mesh.size(1)}
        meta["nr_devices"] = mesh.size()
        if mesh.size() > 1:
            meta.update(payloads=sizes, devices=devices, groups=GROUPS)
    if is_writer(mesh):
        meta_bytes = json.dumps(meta).encode()
        with open(out_path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(meta_bytes)))
            f.write(meta_bytes)
            for p in payloads:
                f.write(p)
        log.info("Exported %s -> %s (%d bytes, platforms=%s, devices=%d)",
                 model_path, out_path, sum(len(p) for p in payloads),
                 platform, meta["nr_devices"])
    if meta["nr_devices"] > 1:
        import torch.distributed as dist
        dist.barrier()   # the file is there when any rank returns
    return meta


def _program(serve, inputs: dict, in_axes: dict, symbolic_batch: bool,
             groups: dict | None = None) -> bytes:
    """The torch.export payload of serve(inputs), its batch axes one
    torch.export.Dim when symbolic_batch, its collectives' group names
    renamed through `groups`."""
    import torch

    from videovector_tpu_torch.tools.export_model import export, save
    dynamic = None
    if symbolic_batch:
        batch_dim = torch.export.Dim("batch", min=1, max=1 << 20)
        dynamic = ({k: {in_axes[k]: batch_dim} for k in inputs},)
    with torch.no_grad():
        program = export(serve, (inputs,), dynamic_shapes=dynamic)
    if groups:
        _rename_groups(program.graph_module, groups)
    buf = io.BytesIO()
    save(program, buf)
    return buf.getvalue()


def _mesh_programs(serve_of, params, inputs: dict, in_axes: dict,
                   symbolic_batch: bool, mesh) -> tuple[list, list, list]:
    """(payloads, sizes, devices): this rank traces serve_of(its params'
    shard) on its rows of `inputs` under the mesh's axes; rank 0 receives
    every rank's program in rank order (the other ranks' `payloads` is
    empty), every rank each program's size and the device it was traced
    on.

    The rows are cut, and the outputs gathered back over "data", outside
    the program (mesh_serving): the symbolic batch is then the rank's,
    which any global batch that divides by D gives, and the program holds
    no data collective but where the Net itself gathers (the stats layers'
    whole batch)."""
    import torch.distributed as dist

    from videovector_tpu_torch.ops.sharding import (
        axes_of, local_rows, mesh_axis, mesh_device, shard_params,
    )
    n = mesh.size()
    if dist.get_world_size() != n:
        raise ValueError(
            f"a {mesh.size(0)}x{mesh.size(1)} export runs on {n} ranks, one "
            f"a device; the process group has {dist.get_world_size()}")
    data = mesh_axis(mesh, "data")
    # fresh tensors: a view's storage offset would be traced into the
    # program's example metadata
    rows = {k: v.clone() for k, v in _data_rows(inputs, data,
                                                 in_axes).items()}
    names = {mesh_axis(mesh, axis).group.group_name: baked
             for baked, axis in GROUPS.items()}
    serve = serve_of(shard_params(params, mesh,
                                  model_axis=mesh.size(1) > 1))
    with axes_of(mesh, batch=local_rows(rows, in_axes), traced=True):
        payload = _program(serve, rows, in_axes, symbolic_batch, names)
    if n == 1:
        return [payload], None, None
    info = [None] * n
    dist.all_gather_object(info, (len(payload), str(mesh_device(mesh))))
    got = [None] * n if dist.get_rank() == 0 else None
    dist.gather_object(payload, got, dst=0)
    return got or [], [size for size, _ in info], [d for _, d in info]


def _rename_groups(gm, names: dict) -> None:
    """Rewrite the process-group name of every `_c10d_functional` op in
    the graph module `gm` through `names` (old -> new); a collective on a
    group not in `names` raises."""
    for node in gm.graph.nodes:
        op = node.target
        if node.op != "call_function" or \
                getattr(op, "namespace", None) != "_c10d_functional":
            continue
        for i, arg in enumerate(op._schema.arguments):
            if arg.name == "group_name":
                if node.args[i] not in names:
                    raise ValueError(
                        f"{op} on process group {node.args[i]!r}, which is "
                        f"none of the mesh's axes' ({sorted(names)})")
                node.update_arg(i, names[node.args[i]])
    gm.recompile()


def _data_rows(batch: dict, ax, axes: dict) -> dict:
    """The rank's rows of each input, cut on its batch axis (`axes`,
    default 0) over the mesh's data axis `ax`."""
    from videovector_tpu_torch.ops.sharding import rank_rows
    out = {}
    for k, v in batch.items():
        a = axes.get(k, 0)
        if v.shape[a] % ax.size:
            raise ValueError(
                f"input {k!r} batch {v.shape[a]} (axis {a}) not divisible "
                f"by the mesh data axis ({ax.size})")
        out[k] = rank_rows(v, ax, a)
    return out


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


class MeshPrograms:
    """A multi-device artifact's programs, bound to no mesh yet: calling it
    raises; mesh_serving(call, meta) loads the rank's program and binds it
    to its mesh."""

    def __init__(self, path: str, start: int, meta: dict):
        self.path, self.start, self.meta = path, start, meta

    def program(self, rank: int):
        """The ExportedProgram of `rank`."""
        from videovector_tpu_torch.tools.export_model import load_exported
        sizes = self.meta["payloads"]
        with open(self.path, "rb") as f:
            f.seek(self.start + sum(sizes[:rank]))
            return load_exported(io.BytesIO(f.read(sizes[rank])))

    def __call__(self, batch):
        m = self.meta["mesh"]
        raise RuntimeError(
            f"{self.path} holds a {self.meta['nr_devices']}-device program "
            f"(mesh {m['data']}x{m['model']}), one part a rank: run it "
            "through mesh_serving(call, meta) on that many ranks, one a "
            "device")


def load_serving(path: str):
    """(call_fn, meta): call_fn({name: array or tensor}) -> {blob: tensor},
    the inputs moved to the artifact's device as f32. Needs no prototxt or
    weights: the port's op registrations are imported, then the program is
    deserialized. A multi-device artifact's call_fn is its MeshPrograms,
    which runs through mesh_serving alone."""
    import torch

    from videovector_tpu_torch.tools.export_model import load_exported

    with open(path, "rb") as f:
        meta = _read_header(f, path)
        if int(meta.get("nr_devices") or 1) > 1:
            return MeshPrograms(path, f.tell(), meta), meta
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
    """Load-side twin of `export_serving(mesh=)`: a callable that takes the
    global batch (the same on every rank) and returns the global outputs
    on every rank. It runs on meta["nr_devices"] ranks, one a device
    (python -m torch.distributed.run), on a make_mesh of the artifact's
    shape and platform; it cuts the rank's rows, runs the rank's program
    with its group names bound to this mesh's groups, and gathers each
    output that has a batch axis over "data". A rank whose device is not
    the one its program was exported on raises. A one-device artifact's
    call comes back as it is."""
    ndev = int(meta.get("nr_devices") or 1)
    if ndev == 1:
        return call
    import torch
    import torch.distributed as dist

    from videovector_tpu_torch.ops.collectives import all_gather
    from videovector_tpu_torch.ops.sharding import mesh_axis, mesh_device
    from videovector_tpu_torch.parallel import make_mesh
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", 1))
    if world != ndev:
        raise ValueError(
            f"artifact was exported for {ndev} devices; {world} available "
            f"(one rank a device: python -m torch.distributed.run "
            f"--nproc_per_node {ndev} ...)")
    m = meta["mesh"]
    mesh = make_mesh(data=int(m["data"]), model=int(m["model"]),
                     devices=meta["platforms"][0])
    rank, dev = dist.get_rank(), mesh_device(mesh)
    if torch.device(meta["devices"][rank]) != dev:
        raise ValueError(
            f"rank {rank}'s program was exported on {meta['devices'][rank]}, "
            f"which its buffers and constants name; this rank serves on "
            f"{dev}: serve one rank a device in the exporting ranks' order")
    module = call.program(rank).module()
    _rename_groups(module, {baked: mesh_axis(mesh, axis).group.group_name
                            for baked, axis in meta["groups"].items()})
    data = mesh_axis(mesh, "data")
    axes = meta.get("batch_axes") or {}

    def run(batch: dict) -> dict:
        feed = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in _data_rows(batch, data, axes).items()}
        with torch.no_grad():
            out = module(feed)
        return {n: o if data.size == 1 or axes.get(n, 0) is None
                else all_gather(o, data, axes.get(n, 0))
                for n, o in out.items()}

    run.mesh = mesh
    return run


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
    from videovector_tpu_torch.ops.sharding import mesh_axis

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
        out = call(_data_rows(batch, ax, {k: _axis(k) for k in batch}))
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
                   help="DxM: a multi-device program (2-D weights column-"
                        "sharded over the M model ranks, the batch over the "
                        "D data ranks), exported by D*M ranks (python -m "
                        "torch.distributed.run --nproc_per_node D*M); run "
                        "it on as many")

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
    if args.command == "export":
        from videovector_tpu_torch.ops.sharding import writer_logs
        from videovector_tpu_torch.tools.cli import _parse_mesh
        platforms = [s for s in args.platforms.split(",") if s] or None
        shapes = {}
        for spec in args.input_shape:
            name, _, dims = spec.partition("=")
            shapes[name] = tuple(int(d) for d in dims.split(","))
        mesh = _parse_mesh(args.mesh, _device(platforms))
        with writer_logs(mesh):
            export_serving(args.model, args.weights, args.blobs.split(","),
                           args.out, platforms=platforms,
                           symbolic_batch=args.symbolic_batch,
                           input_shapes=shapes or None,
                           quantize=args.quantize or None,
                           calib_batches=args.calib_batches,
                           compute_dtype=args.compute or None, mesh=mesh)
    elif args.command == "info":
        print(json.dumps(read_meta(args.artifact), indent=2, sort_keys=True))
    elif args.command == "run":
        _run(args)
    return 0


def _run(args) -> None:
    """`run`: the artifact on random inputs (8 rows a data rank where its
    batch is symbolic), through mesh_serving or shard_serving where asked,
    logged by rank 0."""
    import numpy as np
    import torch

    from videovector_tpu_torch.ops.sharding import writer_logs
    call, meta = load_serving(args.artifact)
    device = meta["platforms"][0]
    rng = np.random.RandomState(0)
    # the symbolic batch's multiple, and the static batch's
    per, grow = 1, 1
    mesh = None
    if int(meta.get("nr_devices") or 1) > 1:
        if args.mesh:
            raise SystemExit("--mesh: this artifact already bakes a "
                             f"{meta['nr_devices']}-device program; it "
                             "runs on its export mesh via mesh_serving")
        call = mesh_serving(call, meta)
        mesh, per = call.mesh, meta["mesh"]["data"]
    elif args.mesh:
        from videovector_tpu_torch.tools.cli import _parse_mesh
        mesh = _parse_mesh(args.mesh, device)
        call = shard_serving(call, meta, mesh)
        per = grow = mesh.size(0)
    axes = meta.get("batch_axes") or {}
    batch = {k: rng.randn(*[8 * per if d == -1 else
                            (d * grow if i == axes.get(k, 0) else d)
                            for i, d in enumerate(shape)]).astype(dtype)
             for k, (shape, dtype) in meta["inputs"].items()}
    with writer_logs(mesh):
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


if __name__ == "__main__":
    sys.exit(main())
