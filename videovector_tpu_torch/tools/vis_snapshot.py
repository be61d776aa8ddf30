"""VisSnapshot: a JSON dump of the net's structure and selected activations
for web visualization (ref:src/caffe/solver.cpp:345-416 +
util/pb2json.cpp); counterpart of videovector_tpu/tools/vis_snapshot.py.

One JSON file holds the layer graph (name/type/bottoms/tops), the parameter
shapes, and truncated activation samples per blob (the reference's
ToTruncatedProto keeps a corner of each blob; this keeps the first
`max_elements` values plus shape and stats). Blobs may be tensors on any
device or numpy arrays.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)


def vis_snapshot(net, params, blobs: dict, out_path: str, *,
                 max_elements: int = 64,
                 vis_blobs: list[str] | None = None) -> dict:
    """`vis_blobs` mirrors SolverParameter.snapshot_vis_blobs (csv split by
    the caller): empty/None dumps every blob; otherwise only the named
    blobs, and the net-structure section is included only when the FIRST
    name is the special token "network" (ref:src/caffe/solver.cpp:355-370).
    `max_elements` mirrors snapshot_vis_truncate_len (ref default 30 when
    unset; 64 here, as in the JAX package, for the no-config default)."""
    include_net = not vis_blobs or vis_blobs[0] == "network"
    doc: dict = {"name": net.name, "phase": net.phase, "layers": [],
                 "blobs": {}}
    if include_net:
        for layer in net.layers:
            doc["layers"].append({
                "name": layer.get("name"),
                "type": layer.get("type"),
                "bottom": [str(b) for b in layer.get_list("bottom")],
                "top": [str(t) for t in layer.get_list("top")],
                "params": {p: list(a.shape)
                           for p, a in params.get(layer.get("name"), {}).items()},
            })

    def num(v):
        # strict JSON has no NaN/Infinity tokens; a diverged run (the case
        # most worth visualizing) must still give parseable output, so
        # non-finite values are written as strings
        v = float(v)
        return v if np.isfinite(v) else str(v)

    for name, arr in blobs.items():
        if vis_blobs and name not in vis_blobs:
            continue
        arr = _host(arr)
        flat = arr.reshape(-1)
        doc["blobs"][name] = {
            "shape": list(arr.shape),
            "mean_abs": num(np.abs(arr).mean()),
            "min": num(arr.min()),
            "max": num(arr.max()),
            "values": [num(v) for v in flat[:max_elements]],
        }
    with open(out_path, "w") as f:
        json.dump(doc, f, allow_nan=False)
    return doc
