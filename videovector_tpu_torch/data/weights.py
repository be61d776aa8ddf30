"""Caffe-compatible model-weight IO; counterpart of
videovector_tpu/data/weights.py.

A `.caffemodel` is a binary NetParameter holding per-layer BlobProtos
(caffe.proto: NetParameter{name=1, layers=2}; LayerParameter{bottom=2,
top=3, name=4, type=5, blobs=6}; saved by Net::ToProto
ref:src/caffe/net.cpp:774-801, loaded name-matched by CopyTrainedLayersFrom
ref:src/caffe/net.cpp:692-771). This module reads and writes exactly that
subset, so reference-trained weights load into the port's graph engine and
the port's weights load in the reference and in the JAX package.

Layouts: Caffe's INNER_PRODUCT weight blob is (num_output, K), (1, 1, N, K)
in 4-D; the graph engine's param is (K, N). `load_into_params` transposes
it and makes the result contiguous: K1 reads a transposed view only on its
slow core route (ops/hopper/matmul.py::k1_route). Conv blobs are OIHW in
both. Params are tensors ({layer: {"w"/"b"/"table": tensor}} or an LSTM
dict); loaded blobs land on each target's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from videovector_tpu_torch.data.wire import (
    BlobProto, _decode_int32, iter_fields, write_bytes, write_int, write_msg,
)


@dataclass
class LayerBlobs:
    name: str = ""
    type_id: int = 0
    blobs: list = dfield(default_factory=list)   # list[BlobProto]

    def encode(self) -> bytes:
        buf = bytearray()
        write_bytes(buf, 4, self.name.encode())
        if self.type_id:
            write_int(buf, 5, self.type_id)
        for b in self.blobs:
            write_msg(buf, 6, b.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "LayerBlobs":
        m = cls()
        for fnum, wt, v in iter_fields(data):
            if fnum == 4:
                m.name = v.decode()
            elif fnum == 5:
                m.type_id = _decode_int32(v)
            elif fnum == 6:
                m.blobs.append(BlobProto.decode(v))
        return m


@dataclass
class NetWeights:
    """The blobs-only view of a NetParameter."""
    name: str = ""
    layers: list = dfield(default_factory=list)   # list[LayerBlobs]

    def encode(self) -> bytes:
        buf = bytearray()
        if self.name:
            write_bytes(buf, 1, self.name.encode())
        for layer in self.layers:
            write_msg(buf, 2, layer.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "NetWeights":
        m = cls()
        for fnum, wt, v in iter_fields(data):
            if fnum == 1:
                m.name = v.decode()
            elif fnum == 2:
                m.layers.append(LayerBlobs.decode(v))
        return m

    @classmethod
    def load(cls, path: str) -> "NetWeights":
        with open(path, "rb") as f:
            return cls.decode(f.read())

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.encode())

    def by_name(self) -> dict:
        return {layer.name: layer for layer in self.layers}


def _np(t) -> np.ndarray:
    """A param (tensor on any device, or array) as an f32 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def lstm_blobs_to_params(blobs: list, template: dict) -> dict:
    """Caffe LSTM blobs -> the graph engine's layout, as f32 numpy arrays.
    Reference blobs (lstm_layer.cpp:70-97): W_i (1, 4, H, I), W_h (1, 4, H,
    H), bias (1, 1, 4, H), gate blocks in [i, f, o, g] order (the same as
    ours). Ours: w_i (I, 4H), w_h (H, 4H), b (4H,).

    The CONDITIONAL variant (template has w_o2h) carries 7 blobs
    (ref:src/caffe/layers/lstm_conditional_layer.cpp:70-112): [W_i, W_h,
    W_o2h (1, 4, H, O), W_h2o (1, 1, O, H), b, b_o2h, b_h2o]. Blob counts
    are checked against the template, as the reference's
    CopyTrainedLayersFrom CHECKs them (net.cpp:692-763)."""
    def gate_weight(blob):
        arr = blob.to_array()          # (1, 4, H, X)
        _, g, h, x = arr.shape
        # (4, H, X) -> (X, 4, H) -> (X, 4H)
        return np.transpose(arr[0], (2, 0, 1)).reshape(x, g * h) \
            .astype(np.float32)

    cond = "w_o2h" in template
    has_b = "b" in template
    expect = (7 if has_b else 4) if cond else (3 if has_b else 2)
    if len(blobs) != expect:
        raise ValueError(
            f"LSTM layer: {len(blobs)} blobs in the weights file, expected "
            f"{expect} for this net config (the reference CHECK_EQs blob "
            f"counts, net.cpp:692-763)")
    out = {"w_i": gate_weight(blobs[0]), "w_h": gate_weight(blobs[1])}
    if cond:
        out["w_o2h"] = gate_weight(blobs[2])
        h2o = blobs[3].to_array()      # (1, 1, O, H) -> ours (H, O)
        out["w_h2o"] = np.ascontiguousarray(
            h2o.reshape(h2o.shape[-2], h2o.shape[-1]).T).astype(np.float32)
        if has_b:
            out["b"] = blobs[4].to_array().reshape(-1).astype(np.float32)
            out["b_o2h"] = blobs[5].to_array().reshape(-1).astype(np.float32)
            out["b_h2o"] = blobs[6].to_array().reshape(-1).astype(np.float32)
    elif has_b:
        out["b"] = blobs[2].to_array().reshape(-1).astype(np.float32)
    return out


def _like(arr: np.ndarray, tgt: torch.Tensor) -> torch.Tensor:
    """arr as a contiguous f32 tensor on tgt's device."""
    return torch.as_tensor(np.ascontiguousarray(arr, np.float32),
                           device=tgt.device)


def load_into_params(weights: NetWeights, params: dict, *,
                     strict: bool = False) -> dict:
    """Name-matched weight copy into a graph-engine param tree. Mirrors
    CopyTrainedLayersFrom (ref:src/caffe/net.cpp:692-763): source layers
    the net lacks are ignored, a net layer the file lacks keeps its params
    (or raises KeyError when `strict`), blob counts and shapes must match.
    Returns a new tree; each loaded param is a contiguous f32 tensor on its
    target's device."""
    src = weights.by_name()
    out = {ln: dict(lp) for ln, lp in params.items()}
    for lname, lparams in out.items():
        if lname not in src:
            if strict:
                raise KeyError(f"no weights for layer {lname!r}")
            continue
        blobs = src[lname].blobs
        if "w_i" in lparams:  # LSTM family
            for k, arr in lstm_blobs_to_params(blobs, lparams).items():
                if tuple(arr.shape) != tuple(lparams[k].shape):
                    raise ValueError(
                        f"layer {lname!r} param {k!r}: shape "
                        f"{arr.shape} vs {tuple(lparams[k].shape)}")
                lparams[k] = _like(arr, lparams[k])
            continue
        order = [k for k in ("w", "table", "b") if k in lparams]
        if len(blobs) != len(order):
            # the reference CHECK_EQs source and target blob counts for
            # matched layers (net.cpp:692-763): an extra blob (a bias for a
            # bias_term: false layer) is a config mismatch, not a drop
            raise ValueError(f"layer {lname!r}: {len(blobs)} blobs in the "
                             f"weights file for {len(order)} params "
                             f"(the reference CHECK_EQs blob counts)")
        for k, blob in zip(order, blobs):
            arr = blob.to_array()
            tgt = lparams[k]
            if k == "w" and len(tgt.shape) == 2:
                # INNER_PRODUCT: Caffe (1, 1, N, K) -> ours (K, N)
                arr = arr.reshape(arr.shape[-2], arr.shape[-1]).T
            else:
                # conv (OIHW, the same layout), biases, tables
                arr = arr.reshape(tuple(tgt.shape))
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"layer {lname!r} param {k!r}: shape {arr.shape} vs "
                    f"{tuple(tgt.shape)}")
            lparams[k] = _like(arr, tgt)
    return out


def params_to_weights(params: dict, name: str = "net") -> NetWeights:
    """Export a graph-engine param tree (tensors or arrays) to Caffe's
    layout."""
    layers = []
    for lname in sorted(params.keys()):
        lp = params[lname]
        if "w_i" in lp:  # LSTM family: ours (I, 4H) -> Caffe (1, 4, H, I)
            hidden = _np(lp["w_h"]).shape[0]

            def gate_blob(key):
                arr = _np(lp[key])     # (X, 4H)
                x = arr.shape[0]
                caffe = arr.reshape(x, 4, hidden).transpose(1, 2, 0)
                return BlobProto(num=1, channels=4, height=hidden, width=x,
                                 data=np.ascontiguousarray(caffe)
                                 .reshape(-1))

            blobs = [gate_blob("w_i"), gate_blob("w_h")]
            cond = "w_o2h" in lp
            if cond:
                # the conditional variant's blob order is [W_i, W_h, W_o2h,
                # W_h2o, b, b_o2h, b_h2o] (lstm_conditional_layer.cpp:70-112)
                blobs.append(gate_blob("w_o2h"))
                h2o = _np(lp["w_h2o"])                    # (H, O) -> (O, H)
                blobs.append(BlobProto(
                    num=1, channels=1, height=h2o.shape[1],
                    width=h2o.shape[0],
                    data=np.ascontiguousarray(h2o.T).reshape(-1)))
            if "b" in lp:
                blobs.append(BlobProto(num=1, channels=1, height=4,
                                       width=hidden, data=_np(lp["b"])))
                if cond:
                    blobs.append(BlobProto(num=1, channels=1, height=4,
                                           width=hidden,
                                           data=_np(lp["b_o2h"])))
                    b_h2o = _np(lp["b_h2o"])
                    blobs.append(BlobProto(
                        num=1, channels=1, height=1, width=b_h2o.shape[0],
                        data=b_h2o))
            layers.append(LayerBlobs(name=lname, blobs=blobs))
            continue
        blobs = []
        for k in ("w", "table", "b"):
            if k not in lp:
                continue
            arr = _np(lp[k])
            if k == "w" and arr.ndim == 2:
                arr = arr.T  # ours (K, N) -> Caffe (N, K)
                blob = BlobProto(num=1, channels=1, height=arr.shape[0],
                                 width=arr.shape[1], data=arr.reshape(-1))
            elif arr.ndim == 1:
                blob = BlobProto(num=1, channels=1, height=1,
                                 width=arr.shape[0], data=arr.reshape(-1))
            else:
                blob = BlobProto.from_array(arr)
            blobs.append(blob)
        layers.append(LayerBlobs(name=lname, blobs=blobs))
    return NetWeights(name=name, layers=layers)
