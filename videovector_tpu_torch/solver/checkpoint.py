"""Snapshot and restore; counterpart of videovector_tpu/solver/checkpoint.py
(the native npz pair and the reference's .caffemodel/.solverstate pair).

Two files per snapshot, in the JAX package's layout, so that each package
resumes from the other's:

  <prefix>_iter_N.vvmodel  npz of the param tree (flat "layer/name" keys,
                           "/" and "%" escaped; gradients under "diff/"
                           when snapshot_diff is set)
  <prefix>_iter_N.vvstate  npz of the history tree, "__iter__" and
                           "__model__" (the .vvmodel's file name)

Loading gives f32 CPU tensors. `export_caffe_snapshot` writes the
reference's pair beside it (snapshot_format: "caffe"), and
`restore_solverstate` resumes from such a pair, the port's, JAX's or the
reference's (data/netproto.py). Orbax snapshots stay with the JAX package.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from videovector_tpu_torch.convert import params_to_numpy
from videovector_tpu_torch.data.netproto import (
    history_from_blobs, load_solverstate, save_net, save_solverstate,
)
from videovector_tpu_torch.data.weights import NetWeights, load_into_params


def _esc(part: str) -> str:
    # "/" separates the flat key's parts, so a "/" inside a layer name
    # ("inception_3a/1x1") is escaped, or loading would nest it
    return part.replace("%", "%25").replace("/", "%2F")


def _unesc(part: str) -> str:
    return part.replace("%2F", "/").replace("%25", "%")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_esc(str(k))}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = [_unesc(p) for p in key.split("/")]
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.as_tensor(np.asarray(v))
    return out


def _write_atomic(path: str, flat: dict) -> None:
    """savez to a temp file, then rename: a crash mid-write never leaves a
    truncated snapshot where a resume would find it."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:  # a file handle keeps our extension
        np.savez(f, **flat)
    os.replace(tmp, path)


def snapshot(prefix: str, it: int, params: dict, state: dict | None = None,
             diffs: dict | None = None):
    """Write the model (and the solver state). Trees may hold tensors on any
    device or numpy arrays. Returns (model_path, state_path or None)."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".", exist_ok=True)
    model_path = f"{prefix}_iter_{it}.vvmodel"
    flat_model = _flatten(params_to_numpy(params))
    if diffs is not None:
        flat_model.update(_flatten({"diff": params_to_numpy(diffs)}))
    _write_atomic(model_path, flat_model)
    state_path = None
    if state is not None:
        state_path = f"{prefix}_iter_{it}.vvstate"
        flat = _flatten({"history": params_to_numpy(state["history"])})
        flat["__iter__"] = np.asarray(int(state["iter"]))
        flat["__model__"] = np.asarray(os.path.basename(model_path))
        _write_atomic(state_path, flat)
    return model_path, state_path


class AsyncSnapshotter:
    """Background snapshot writer: the train loop pays for the copy to the
    host, and serialization and disk IO overlap the next steps. One write
    in flight at a time; `wait()` (or the next `submit`) joins the previous
    write and re-raises its error."""

    def __init__(self):
        self._thread = None
        self._exc: BaseException | None = None

    def submit(self, prefix: str, it: int, params, state=None, diffs=None,
               extra=None):
        """params, state and diffs should be host copies: the writer reads
        them after submit returns. `extra()`, if given, runs after the
        files are written (e.g. another snapshot format's writer)."""
        self.wait()

        def _run():
            try:
                snapshot(prefix, it, params, state, diffs)
                if extra is not None:
                    extra()
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="vvtpu-torch-snapshot")
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def load_model(path: str) -> dict:
    with np.load(path) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    tree.pop("diff", None)  # snapshot_diff's gradients are not params
    return tree


def load_diffs(path: str) -> dict | None:
    """The gradients a snapshot_diff snapshot stored, or None."""
    with np.load(path) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return tree.get("diff")


def restore(state_path: str):
    """(params, state) from a .vvstate and the .vvmodel it names (Caffe's
    `--snapshot` resume)."""
    with np.load(state_path) as z:
        flat = {k: z[k] for k in z.files}
    it = int(flat.pop("__iter__"))
    model_name = str(flat.pop("__model__"))
    model_path = os.path.join(os.path.dirname(state_path), model_name)
    params = load_model(model_path)
    return params, {"iter": it, "history": _unflatten(flat)["history"]}


def restore_solverstate(state_path: str, params_template: dict,
                        layer_order: list):
    """Resume from the reference's `.solverstate` binary: the momentum
    history, the iteration and the `.caffemodel` weights it points at,
    mapped onto the template's param tree (ref:src/caffe/solver.cpp:419-429
    Solver::Restore -> RestoreSolverState :578-596). Returns (params,
    state), tensors on the template's devices.

    `layer_order`: the param-carrying layers' names in net order; the
    history blobs are nameless and ordered like net_->params(). The
    learned_net path is tried as written, then beside the solverstate (the
    reference stores whatever snapshot_prefix produced)."""
    it, learned_net, blobs = load_solverstate(state_path)
    model_path = learned_net
    if model_path and not os.path.exists(model_path):
        cand = os.path.join(os.path.dirname(os.path.abspath(state_path)),
                            os.path.basename(model_path))
        if os.path.exists(cand):
            model_path = cand
    if not model_path or not os.path.exists(model_path):
        raise FileNotFoundError(
            f"solverstate {state_path!r} points at learned_net "
            f"{learned_net!r}, which does not exist (also tried next to the "
            f"solverstate)")
    params = load_into_params(NetWeights.load(model_path), params_template)
    history = history_from_blobs(blobs, params_template, layer_order)
    return params, {"iter": it, "history": history}


def export_caffe_snapshot(prefix: str, it: int, params: dict, state: dict,
                          net_msg, layer_order: list):
    """Write the reference's snapshot pair: `<prefix>_iter_N.caffemodel`
    (the full NetParameter, configs and blobs, as Net::ToProto) and
    `<prefix>_iter_N.solverstate` (iter, learned_net and the momentum
    history in net order), so that `caffe train --snapshot=<...>.solverstate`
    resumes the run with its momentum (ref:src/caffe/solver.cpp:321-341).
    Trees may hold tensors on any device or numpy arrays. Returns
    (model_path, state_path)."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".",
                exist_ok=True)
    model_path = f"{prefix}_iter_{it}.caffemodel"
    save_net(model_path, net_msg, params_to_numpy(params))
    state_path = f"{prefix}_iter_{it}.solverstate"
    save_solverstate(state_path, int(state["iter"]),
                     params_to_numpy(state["history"]), model_path,
                     layer_order)
    return model_path, state_path
