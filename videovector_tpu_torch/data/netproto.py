"""Full NetParameter serialization: layer configs, learned blobs (and
diffs), and the reference's SolverState; counterpart of
videovector_tpu/data/netproto.py, whose bytes it writes and reads.

Net::ToProto writes the complete NetParameter, every LayerParameter with
its configuration fields and its learned BlobProtos (and the diffs when
write_diff is set), and the reference builds a Net straight from such a
binary file (ref:src/caffe/net.cpp:774-801; Snapshot at
ref:src/caffe/solver.cpp:321-341; ReadNetParamsFromBinaryFileOrDie,
ref:include/caffe/util/io.hpp:51-90). This module composes the config
codec (config/binproto.py) with data/weights.py's blob layouts, so that a
net round-trips with its architecture.

Blob payloads are spliced at the wire level (LayerParameter field 6), not
through Message float lists: a 4096 x 4096 blob stays one array. Params
and history come in as tensors (any device) or numpy arrays and leave
this module as numpy at the file boundary; the trees it returns hold
tensors on the template's devices.
"""

from __future__ import annotations

import numpy as np
import torch

from videovector_tpu_torch.config import binproto
from videovector_tpu_torch.config.textformat import Message
from videovector_tpu_torch.data.weights import (
    LayerBlobs, NetWeights, load_into_params, params_to_weights,
)
from videovector_tpu_torch.data.wire import (
    BlobProto, _decode_int32, iter_fields, write_bytes, write_int, write_msg,
    write_varint,
)

_LAYERS_FNUM = 2      # NetParameter.layers
_BLOBS_FNUM = 6       # LayerParameter.blobs


def _strip_layers(net_msg: Message) -> Message:
    top = Message()
    for k, vals in net_msg.fields.items():
        if k == "layers":
            continue
        for v in vals:
            top.add(k, v)
    return top


def save_net(path: str, net_msg: Message, params: dict, *,
             diffs: dict | None = None) -> None:
    """Write a full binary NetParameter (configs + blobs [+ diffs]).

    `net_msg` is the parsed net prototxt (the pre-filter graph — both
    phases, like the reference which snapshots the phase-merged net);
    `params` the trained pytree; `diffs` an optional grads pytree
    (snapshot_diff semantics: BlobProto.diff alongside data)."""
    blob_layers = params_to_weights(params).by_name()
    diff_layers = params_to_weights(diffs).by_name() if diffs else {}

    buf = bytearray(binproto.encode(_strip_layers(net_msg), "NetParameter"))
    for layer in net_msg.get_list("layers"):
        lbuf = bytearray(binproto.encode(layer, "LayerParameter"))
        lname = str(layer.get("name"))
        lw = blob_layers.get(lname)
        if lw is not None:
            ld = diff_layers.get(lname)
            for i, blob in enumerate(lw.blobs):
                if ld is not None and i < len(ld.blobs):
                    blob = BlobProto(num=blob.num, channels=blob.channels,
                                     height=blob.height, width=blob.width,
                                     data=blob.data, diff=ld.blobs[i].data)
                write_msg(lbuf, _BLOBS_FNUM, blob.encode())
        write_msg(buf, _LAYERS_FNUM, bytes(lbuf))
    with open(path, "wb") as f:
        f.write(bytes(buf))


def _split_blobs(layer_bytes: bytes):
    """Separate LayerParameter.blobs from the config fields at wire level."""
    cfg = bytearray()
    blobs = []
    for fnum, wt, v in iter_fields(layer_bytes):
        if fnum == _BLOBS_FNUM and wt == 2:
            blobs.append(BlobProto.decode(v))
        elif wt == 2:
            write_bytes(cfg, fnum, bytes(v))
        elif wt == 0:
            write_varint(cfg, (fnum << 3) | 0)
            write_varint(cfg, v)
        else:  # 4/8-byte chunks: re-emit verbatim
            write_varint(cfg, (fnum << 3) | wt)
            cfg += v
    return bytes(cfg), blobs


def load_net(path: str):
    """Read a full binary NetParameter → (net_msg, NetWeights).

    net_msg carries every config field (text-parser conventions, blobs
    stripped); NetWeights carries the BlobProtos (data and, if present,
    diffs) for name-matched loading via data/weights.load_into_params."""
    with open(path, "rb") as f:
        data = f.read()
    top_cfg = bytearray()
    layer_chunks = []
    for fnum, wt, v in iter_fields(data):
        if fnum == _LAYERS_FNUM and wt == 2:
            layer_chunks.append(v)
        elif wt == 2:
            write_bytes(top_cfg, fnum, bytes(v))
        else:
            write_varint(top_cfg, (fnum << 3) | wt)
            if wt == 0:
                write_varint(top_cfg, v)
            else:
                top_cfg += v
    net_msg = binproto.decode(bytes(top_cfg), "NetParameter")
    weights = NetWeights(name=net_msg.get("name", "") or "")
    for chunk in layer_chunks:
        cfg_bytes, blobs = _split_blobs(chunk)
        layer_msg = binproto.decode(cfg_bytes, "LayerParameter")
        net_msg.add("layers", layer_msg)
        weights.layers.append(LayerBlobs(
            name=str(layer_msg.get("name", "")), blobs=blobs))
    return net_msg, weights


# ---------------------------------------------------------------------------
# SolverState (.solverstate) — both-ways interop
# ---------------------------------------------------------------------------
#
# The reference snapshots <prefix>_iter_N.solverstate: SolverState{iter=1,
# learned_net=2, history=3 repeated BlobProto} (ref:src/caffe/proto/
# caffe.proto:176-180; written SGDSolver::SnapshotSolverState
# ref:src/caffe/solver.cpp:321-341,578-596; restored :419-429). The history
# blobs carry NO names — they are ordered exactly like net_->params(): layer
# order in the net, blob order within each layer. Export/import therefore
# takes an explicit `layer_order` (param-carrying layer names in net order)
# and reuses data/weights.params_to_weights's per-blob layout conventions,
# so history blob shapes match the .caffemodel param blob shapes the
# reference expects (momentum history mirrors param shapes).

_SS_ITER, _SS_LEARNED_NET, _SS_HISTORY = 1, 2, 3


def save_solverstate(path: str, it: int, history: dict, learned_net: str,
                     layer_order: list) -> None:
    """history: pytree {layer: {pname: array}} (momentum / AdaGrad accum);
    layer_order: names of param-carrying layers in NET order."""
    hw = params_to_weights(history).by_name()
    buf = bytearray()
    write_int(buf, _SS_ITER, int(it))
    write_bytes(buf, _SS_LEARNED_NET, learned_net.encode())
    for lname in layer_order:
        lw = hw.get(lname)
        if lw is None:
            raise KeyError(f"layer_order names layer {lname!r} absent from "
                           f"the history pytree")
        for blob in lw.blobs:
            write_msg(buf, _SS_HISTORY, blob.encode())
    with open(path, "wb") as f:
        f.write(bytes(buf))


def load_solverstate(path: str):
    """Read a SolverState binary → (iter, learned_net, list[BlobProto])."""
    with open(path, "rb") as f:
        data = f.read()
    it, learned_net, blobs = 0, "", []
    for fnum, wt, v in iter_fields(data):
        if fnum == _SS_ITER:
            it = _decode_int32(v)
        elif fnum == _SS_LEARNED_NET:
            learned_net = v.decode()
        elif fnum == _SS_HISTORY:
            blobs.append(BlobProto.decode(v))
    return it, learned_net, blobs


def _layer_blob_count(lp: dict) -> int:
    """How many blobs params_to_weights emits for this layer's params —
    the slicing key for the nameless history list."""
    if "w_i" in lp:  # LSTM family: W_i, W_h [, W_o2h, W_h2o] [, biases]
        if "w_o2h" in lp:  # conditional variant: 4 weights + 3 biases
            return 4 + (3 if "b" in lp else 0)
        return 2 + (1 if "b" in lp else 0)
    return sum(1 for k in ("w", "table", "b") if k in lp)


def _zeros_like(params: dict) -> dict:
    """f32 zeros shaped like each param, on its device (a numpy array's on
    the CPU)."""
    return {ln: {pn: torch.zeros(tuple(a.shape), dtype=torch.float32,
                                 device=getattr(a, "device", "cpu"))
                 for pn, a in lp.items()}
            for ln, lp in params.items()}


def history_from_blobs(blobs: list, params_template: dict,
                       layer_order: list) -> dict:
    """Map the ordered history BlobProtos onto a params-shaped pytree,
    applying the same layout conversions as .caffemodel loading (IP weight
    transpose, LSTM gate reshapes)."""
    weights = NetWeights()
    pos = 0
    for lname in layer_order:
        lp = params_template.get(lname)
        if lp is None:
            raise KeyError(f"layer_order names layer {lname!r} absent from "
                           f"the params template")
        n = _layer_blob_count(lp)
        if pos + n > len(blobs):
            raise ValueError(
                f"solverstate history has {len(blobs)} blobs but layer "
                f"order {layer_order} needs more — net/state mismatch")
        weights.layers.append(LayerBlobs(name=lname,
                                         blobs=blobs[pos:pos + n]))
        pos += n
    if pos != len(blobs):
        raise ValueError(
            f"solverstate history has {len(blobs)} blobs; the net's param "
            f"layers consume only {pos} — net/state mismatch")
    return load_into_params(weights, _zeros_like(params_template))


def diffs_from_weights(weights: NetWeights, params: dict) -> dict | None:
    """Extract the diff payloads of a snapshot_diff NetParameter into a
    grads-shaped pytree (same layout rules as load_into_params)."""
    has_diff = any(len(b.diff) for l in weights.layers for b in l.blobs)
    if not has_diff:
        return None
    diff_weights = NetWeights(name=weights.name)
    for l in weights.layers:
        diff_weights.layers.append(LayerBlobs(name=l.name, blobs=[
            BlobProto(num=b.num, channels=b.channels, height=b.height,
                      width=b.width, data=np.asarray(b.diff, np.float32))
            for b in l.blobs]))
    return load_into_params(diff_weights, _zeros_like(params))
