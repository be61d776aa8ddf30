"""Net: the graph engine; counterpart of videovector_tpu/graph/net.py.

Interprets a Caffe-style NetParameter (parsed by config/textformat) for one
phase into `apply(params, batch) -> (loss, outputs)`, the equivalent of
`Net::Init` + `ForwardFromTo` (ref:src/caffe/net.cpp:34-224, :502-543).
Differences by design, as in the JAX package:

- No InsertSplits (ref:src/caffe/util/insert_splits.cpp): a blob read by
  several layers needs no copy layer.
- In-place layers (top == bottom) are name rebinding.
- Backward is autograd of the loss.
- Data-layer tops are graph inputs fed by the host data pipeline
  (graph/data_factory.py).

Phase filtering (`include`/`exclude` NetStateRule, ref:src/caffe/net.cpp:226-329,
rules caffe.proto:193-209) is applied at construction. By default the
scoring head runs fused (graph/fuse.py: the per-role NORMALIZATION / ELTWISE
PROD / SUM chains as batched role-major ops), off for layer-prefix runs;
inputs named in `role_major_inputs` are fed (R, B, feat...). Tensors decide
where the work runs: params on the device of the generator given to
`init`, batches wherever the caller puts them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from videovector_tpu_torch.config.textformat import Message
from videovector_tpu_torch.config.upgrade import net_needs_upgrade, upgrade_net
from videovector_tpu_torch.data.hdf5 import write_hdf5
from videovector_tpu_torch.data.wire import BlobProto
from videovector_tpu_torch.graph.fuse import ScoringFusion, fusion_enabled
from videovector_tpu_torch.graph.layers import (
    DATA_LAYER_TYPES, LAYERS, PENDING_TYPES, SINK_LAYER_TYPES,
    STATEFUL_LAYER_TYPES, ApplyContext,
)
from videovector_tpu_torch.metrics.retrieval import (
    IdToClassMap, check_num_videos, retrieval_rank_stats_fixed_ref_report,
    retrieval_rank_stats_report, retrieval_stats_report, video_level_average,
)
from videovector_tpu_torch.models.mednet import torch_dtype
from videovector_tpu_torch.ops import collectives
from videovector_tpu_torch.ops.sharding import is_writer
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# the stats layers whose `stats_output_file` makes them host sinks, and the
# parameter message that names it
_STATS_PARAM = {
    "RETRIEVAL_STATS": "retrieval_stats_param",
    "RETRIEVAL_RANK_STATS": "retrieval_rank_stats_param",
    "RETRIEVAL_RANK_STATS_FIXED_REF": "retrieval_rank_stats_fixed_ref_param",
}


def _state_meets_rule(rule: Message, phase: str, level: int, stages: set) -> bool:
    """ref:src/caffe/net.cpp:271-329 (StateMeetsRule)."""
    if rule.has("phase") and rule.get("phase") != phase:
        return False
    if rule.has("min_level") and level < int(rule.get("min_level")):
        return False
    if rule.has("max_level") and level > int(rule.get("max_level")):
        return False
    for s in rule.get_list("stage"):
        if s not in stages:
            return False
    for s in rule.get_list("not_stage"):
        if s in stages:
            return False
    return True


def filter_layers(net_msg: Message, phase: str, level: int = 0,
                  stages: tuple = ()) -> list[Message]:
    """ref:src/caffe/net.cpp:226-268 (FilterNet): a layer with include rules
    is kept iff ANY include rule matches; otherwise it is dropped iff any
    exclude rule matches."""
    stages_set = set(stages)
    kept = []
    for layer in net_msg.get_list("layers") + net_msg.get_list("layer"):
        includes = layer.get_list("include")
        excludes = layer.get_list("exclude")
        if includes:
            keep = any(_state_meets_rule(r, phase, level, stages_set)
                       for r in includes)
        else:
            keep = not any(_state_meets_rule(r, phase, level, stages_set)
                           for r in excludes)
        if keep:
            kept.append(layer)
    return kept


@dataclass
class ParamMeta:
    """lr/decay multipliers per layer blob (ref blobs_lr / weight_decay
    repeated fields on V1 LayerParameter; net.cpp:467-499)."""
    lr_mult: float = 1.0
    decay_mult: float = 1.0
    shared_owner: str | None = None  # layer name that owns the tensor, if shared
    shared_shape: tuple | None = None  # consumer's own blob shape, when it
    # differs from the owner's (PERMISSIVE count-matched share; Caffe gives
    # each consumer its own Blob shape over the shared data, net.cpp:405-464)


def _meta_tensor(spec) -> torch.Tensor:
    """A "meta" tensor (shape and dtype, no data) like `spec`: a tensor, a
    numpy array, or anything with .shape and a numpy or torch .dtype."""
    dtype = spec.dtype
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(tuple(spec.shape), dtype=dtype, device="meta")


class Net:
    """A compiled view of a NetParameter for one phase.

    compute_dtype: None (f32, the reference's numerics), "float32" or
    "bfloat16" (the INNER_PRODUCT and CONVOLUTION operands; sums stay f32).
    fuse_scoring: the
    scoring-head fusion (graph/fuse.py; also off under
    VVTPU_DISABLE_FUSION=1)."""

    def __init__(self, net_msg: Message, phase: str = "TRAIN", *,
                 level: int = 0, stages: tuple = (), side: dict | None = None,
                 compute_dtype=None, fuse_scoring: bool = True):
        self.compute_dtype = (torch_dtype(compute_dtype)
                              if compute_dtype is not None else None)
        self.fuse_scoring = bool(fuse_scoring) and fusion_enabled()
        # input blobs the caller feeds role-major: the batch carries
        # (R, B, feat...) for a blob whose logical shape is (B, R, feat...).
        # apply() binds the logical view (movedim, right for any consumer)
        # and hands the raw tensor to the scoring fusion, which absorbs the
        # leading SLICE(dim1)/CONCAT(dim0) into a free reshape. Set by
        # SolverDriver (role_major_data) or directly by benchmarks.
        self.role_major_inputs: tuple = ()
        # layers the last apply() ran symbolically (tests, logs)
        self._last_absorbed = 0
        # the int8 PTQ side table (tools/quantize.py): {layer name: {"w_q",
        # "s_w", "s_x", "mode"}}; INNER_PRODUCT and CONVOLUTION layers named
        # in it run their quantized branch
        self.quant = None
        # legacy V0 auto-upgrade on load (ref ReadNetParamsFromTextFileOrDie
        # -> UpgradeV0Net, util/upgrade_proto.cpp)
        if net_needs_upgrade(net_msg):
            log.info("Upgrading legacy V0 NetParameter")
            net_msg = upgrade_net(net_msg)
        self.name = net_msg.get("name", "net")
        self.phase = phase
        self.layers = filter_layers(net_msg, phase, level, stages)
        self.side = dict(side or {})
        self.param_meta: dict[str, dict[str, ParamMeta]] = {}
        self._load_side_tables()

        # graph inputs: NetParameter-level `input`/`input_dim` plus all tops of
        # data layers
        self.input_names: list[str] = list(net_msg.get_list("input"))
        self.data_layer_tops: dict[str, list[str]] = {}
        for layer in self.layers:
            if layer.get("type") in DATA_LAYER_TYPES:
                tops = [str(t) for t in layer.get_list("top")]
                self.data_layer_tops[layer.get("name")] = tops
                self.input_names.extend(tops)
                if layer.get("type") == "MEMORY_DATA" \
                        and layer.has("memory_data_param"):
                    # ref memory_data_layer.cpp:18-20 CHECK_GT(batch_size *
                    # channels * height * width, 0). A param-less
                    # MEMORY_DATA stays the documented extension: shapes
                    # come from the fed batch (our Reset() equivalent).
                    mp = layer.get_msg("memory_data_param")
                    dims = [int(mp.get(k, 0) or 0) for k in
                            ("batch_size", "channels", "height", "width")]
                    if min(dims) <= 0:
                        raise ValueError(
                            f"layer {layer.get('name')!r}: batch_size, "
                            f"channels, height, and width must be specified "
                            f"and positive in memory_data_param (got "
                            f"{dims}; ref memory_data_layer.cpp:18-20)")

        # host sinks: file-writing layers, dumped host-side from the
        # returned blobs by process_host_sinks
        self.host_sinks = [
            {"name": l.get("name"), "type": l.get("type"),
             "bottoms": [str(b) for b in l.get_list("bottom")], "cfg": l}
            for l in self.layers if l.get("type") in SINK_LAYER_TYPES
        ]
        for s in self.host_sinks:
            # reference count contracts: WriteToFile takes exactly one
            # bottom (ref:include/caffe/loss_layers.hpp:35), HDF5Output
            # exactly two, data + label (ref:include/caffe/
            # data_layers.hpp:700): a different count would silently
            # write files the reference's format never produces
            want = 1 if s["type"] == "WRITE_TO_FILE" else 2
            if len(s["bottoms"]) != want:
                raise ValueError(
                    f"layer {s['name']!r} ({s['type']}): expected exactly "
                    f"{want} bottom blob(s), got {len(s['bottoms'])} "
                    f"(the reference CHECKs ExactNumBottomBlobs)")
        # stats layers with stats_output_file also dump a per-item csv
        # (ref:src/caffe/layers/retrieval_stats_layer.cpp:148-155,310-340,
        # retrieval_rank_stats_layer.cpp:188-268,
        # retrieval_rank_stats_fixed_ref_layer.cpp:120-221)
        self.host_sinks += [
            {"name": l.get("name"), "type": l.get("type"),
             "bottoms": [str(b) for b in l.get_list("bottom")], "cfg": l}
            for l in self.layers
            if l.get("type") in _STATS_PARAM
            and l.get_msg(_STATS_PARAM[l.get("type")]).get("stats_output_file")
        ]

        # AutoTopBlobs (ref:include/caffe/layer.hpp:258 + net.cpp AppendTop):
        # loss layers may omit `top:`; auto-name the implicit loss tops.
        # Copy-on-write: the caller's NetParameter Messages must not gain
        # synthetic tops (serializing/diffing the config afterwards would
        # emit tops the user never wrote)
        for li, layer in enumerate(self.layers):
            ldef = LAYERS.get(layer.get("type"))
            if (ldef is not None and ldef.default_loss_weights
                    and not layer.get_list("top")):
                copy = Message()
                for k, vals in layer.fields.items():
                    for v in vals:
                        copy.add(k, v)
                for i in range(len(ldef.default_loss_weights)):
                    copy.add("top", f"{layer.get('name')}_auto_top_{i}")
                self.layers[li] = copy

        # loss weights per (layer, top index)
        self.loss_weights: dict[str, list[float]] = {}
        for layer in self.layers:
            ltype = layer.get("type")
            if ltype in DATA_LAYER_TYPES:
                continue
            n_top = len(layer.get_list("top"))
            given = [float(v) for v in layer.get_list("loss_weight")]
            ldef = LAYERS.get(ltype)
            defaults = list(ldef.default_loss_weights or ()) if ldef else []
            weights = []
            for i in range(n_top):
                if i < len(given):
                    weights.append(given[i])
                elif i < len(defaults):
                    weights.append(defaults[i])
                else:
                    weights.append(0.0)
            self.loss_weights[layer.get("name")] = weights

        self._check_types()

    def output_loss_weights(self) -> dict[str, float]:
        """blob name -> loss weight of its (latest) producing top: the
        reference's blob_loss_weights_ lookup behind the display suffix
        '(* w = x loss)' on loss-weighted output lines
        (ref:src/caffe/solver.cpp:204-214, tools/caffe.cpp:177-185)."""
        out: dict[str, float] = {}
        for layer in self.layers:
            if layer.get("type") in DATA_LAYER_TYPES:
                continue
            ws = self.loss_weights.get(layer.get("name"), [])
            for i, t in enumerate(str(x) for x in layer.get_list("top")):
                out[t] = ws[i] if i < len(ws) else 0.0
        return out

    # ------------------------------------------------------------------
    def _check_types(self):
        for layer in self.layers:
            ltype = layer.get("type")
            if ltype in DATA_LAYER_TYPES or ltype in LAYERS:
                continue
            where = f"layer type {ltype!r} (layer {layer.get('name')!r})"
            if ltype in PENDING_TYPES:
                raise NotImplementedError(
                    f"{where} is not ported to videovector_tpu_torch yet "
                    f"(ROADMAP queue 1, item {PENDING_TYPES[ltype]})")
            raise NotImplementedError(f"{where} is not registered")

    def _load_side_tables(self):
        """Load csv side tables referenced by layer configs (id->class maps for
        retrieval stats, id->weight for max-margin).

        A path that is DECLARED but missing is a hard error, matching the
        reference's CHECK-fail semantics: a typo'd csv must not silently
        degrade retrieval classes to raw video ids or margin weights to None
        (ref:src/caffe/layers/retrieval_stats_layer.cpp:48
        CHECK_GE(video_id_to_class_.size(), 1);
        max_margin_loss_layer.cpp:26-33). An UNSET id_to_class_file keeps
        the documented identity-classes extension (see projects/
        videovec_embedding/generate_net.py). Pre-seeding self.side[name]
        (the `side=` ctor arg) is the explicit opt-out for tests. Tables
        stay on the host; the layers move them to their inputs' device."""
        def _require(path, layer_name, what):
            if not os.path.exists(path):
                raise ValueError(
                    f"layer {layer_name!r}: {what} {path!r} does not exist "
                    f"(the reference CHECK-fails on a missing/empty side "
                    f"table; fix the path or pre-seed Net(side=...))")

        for layer in self.layers:
            name = layer.get("name")
            if name in self.side:
                continue
            path = layer.get_msg("retrieval_stats_param").get("id_to_class_file")
            if path:
                _require(path, name, "id_to_class_file")
                id_map = IdToClassMap.from_csv(path)
                if id_map.ids.shape[0] < 1:
                    raise ValueError(
                        f"layer {name!r}: id_to_class_file {path!r} has no "
                        f"entries (ref CHECK_GE(video_id_to_class_.size(), 1),"
                        f" retrieval_stats_layer.cpp:48)")
                self.side[name] = id_map
                continue
            path = layer.get_msg("infogain_loss_param").get("source")
            if path:
                _require(path, name, "infogain source")
                # the H matrix from a BlobProto binary
                # (ref:src/caffe/layers/infogain_loss_layer.cpp:18-24)
                with open(path, "rb") as f:
                    arr = BlobProto.decode(f.read()).to_array()
                self.side[name] = torch.as_tensor(
                    arr.reshape(arr.shape[-2], arr.shape[-1]))
                continue
            if (layer.get("type") == "INFOGAIN_LOSS"
                    and len(layer.get_list("bottom")) < 3):
                raise ValueError(
                    f"layer {name!r}: INFOGAIN_LOSS with 2 bottoms needs "
                    f"infogain_loss_param.source (ref CHECK(has_source()), "
                    f"infogain_loss_layer.cpp:17-19)")
            path = layer.get_msg("max_margin_loss_param").get("id_to_weight_file")
            if path:
                _require(path, name, "id_to_weight_file")
                ids, ws = [], []
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        a, b = line.split(",")
                        ids.append(int(a))
                        w = float(b)
                        if w < 0:  # ref CHECK_GE(weight, 0)
                            raise ValueError(
                                f"layer {name!r}: negative weight {w} in "
                                f"{path!r} (ref max_margin_loss_layer.cpp:34)")
                        ws.append(w)
                order = np.argsort(ids)
                self.side[name] = (
                    torch.as_tensor(np.asarray(ids)[order].astype(np.int32)),
                    torch.as_tensor(np.asarray(ws)[order].astype(np.float32)))

    # ------------------------------------------------------------------
    def batch_validators(self):
        """Host-side per-batch checks that the forward does not make.

        RETRIEVAL_STATS with video_level_retrieval needs the batch's
        distinct-video-id count to EQUAL max_num_videos: extra ids are
        silently dropped by video_level_average and missing segments pad
        with zeros, corrupting video-level mAP with no error. The reference
        CHECKs this at forward
        (ref:src/caffe/layers/retrieval_stats_layer.cpp:188). Returns a list
        of callables(batch_dict) to run on each host batch before it is fed
        to an eval; they raise ValueError on violation."""
        validators = []
        for layer in self.layers:
            if layer.get("type") != "RETRIEVAL_STATS":
                continue
            p = layer.get_msg("retrieval_stats_param")
            if not bool(p.get("video_level_retrieval", False)):
                continue
            nv = int(p.get("max_num_videos", 0))
            bottoms = [str(b) for b in layer.get_list("bottom")]
            if len(bottoms) < 2:
                continue
            vid_blob = bottoms[1]

            def _check(batch, vid_blob=vid_blob, nv=nv):
                if vid_blob in batch:  # only checkable for graph-input ids
                    check_num_videos(batch[vid_blob], nv)
            validators.append(_check)
        return validators

    # ------------------------------------------------------------------
    def _context(self, generator=None, *, device=None) -> ApplyContext:
        return ApplyContext(phase=self.phase, generator=generator,
                            side=self.side, compute_dtype=self.compute_dtype,
                            quant=self.quant, device=device)

    def init(self, generator: torch.Generator, batch_spec: dict[str, Any]):
        """Create params on the generator's device, drawing every filler from
        it in layer order. batch_spec maps every graph-input blob name to a
        tensor, an array, or anything with .shape and .dtype. Returns
        (params, param_meta): params is {layer_name: {blob_name: tensor}},
        param_meta the lr/decay multipliers and sharing info (ref
        AppendParam net.cpp:405-464).

        Shapes are inferred without real work: each layer up to the last
        one that holds params runs on "meta" tensors (no data; the kernels'
        entry points run their plain versions there). The layers after it
        need no input shapes."""
        blobs: dict[str, torch.Tensor] = {}
        for name in self.input_names:
            if name not in batch_spec:
                raise ValueError(f"batch_spec missing graph input {name!r}")
            blobs[name] = _meta_tensor(batch_spec[name])

        params: dict[str, dict[str, torch.Tensor]] = {}
        meta: dict[str, dict[str, ParamMeta]] = {}
        shared_owner_by_name: dict[str, tuple[str, str]] = {}
        # dropout draws on "meta" tensors consume nothing from this one
        ctx = self._context(torch.Generator(), device="meta")
        compute = [l for l in self.layers
                   if l.get("type") not in DATA_LAYER_TYPES]
        last = max((i for i, l in enumerate(compute)
                    if LAYERS[l.get("type")].has_params), default=-1)

        for layer in compute[:last + 1]:
            ltype = layer.get("type")
            lname = layer.get("name")
            bottoms = [str(b) for b in layer.get_list("bottom")]
            in_shapes = []
            for b in bottoms:
                if b not in blobs:
                    raise ValueError(
                        f"layer {lname!r} bottom {b!r} not produced yet")
                in_shapes.append(tuple(blobs[b].shape))

            ldef = LAYERS[ltype]
            lparams = ldef.init(generator, layer, in_shapes)

            # named-param sharing (V1 `param:` strings on LayerParameter)
            share_names = [str(s) for s in layer.get_list("param")]
            lr_mults = [float(v) for v in layer.get_list("blobs_lr")]
            decay_mults = [float(v) for v in layer.get_list("weight_decay")]
            # a non-empty multiplier list must cover every param blob
            # exactly, and multipliers are non-negative: the reference
            # CHECK_EQs/CHECK_GEs (net.cpp:467-499); silently defaulting a
            # missing entry to 1 would leave a blob the user meant to
            # freeze trainable
            for fname, mults in (("blobs_lr", lr_mults),
                                 ("weight_decay", decay_mults)):
                if mults and len(mults) != len(lparams):
                    raise ValueError(
                        f"layer {lname!r}: {fname} has {len(mults)} entries "
                        f"for {len(lparams)} param blobs (the reference "
                        f"CHECK_EQs the counts, net.cpp:472-496)")
                if any(v < 0 for v in mults):
                    raise ValueError(
                        f"layer {lname!r}: negative {fname} multiplier "
                        f"(reference CHECK_GE, net.cpp:476,491)")
            lmeta: dict[str, ParamMeta] = {}
            for i, pname in enumerate(list(lparams.keys())):
                m = ParamMeta(
                    lr_mult=lr_mults[i] if i < len(lr_mults) else 1.0,
                    decay_mult=decay_mults[i] if i < len(decay_mults) else 1.0)
                if i < len(share_names) and share_names[i]:
                    sname = share_names[i]
                    if sname in shared_owner_by_name:
                        owner_layer, owner_blob = shared_owner_by_name[sname]
                        owned = params[owner_layer][owner_blob]
                        modes = layer.get_list("blob_share_mode")
                        mode = str(modes[i]) if i < len(modes) else "STRICT"
                        if owned.shape != lparams[pname].shape:
                            # PERMISSIVE: element-count match suffices
                            # (ref AppendParam net.cpp:405-464, DimCheckMode)
                            if mode != "PERMISSIVE" or \
                                    owned.numel() != lparams[pname].numel():
                                raise ValueError(
                                    f"shared param {sname!r} shape mismatch: "
                                    f"{tuple(owned.shape)} vs "
                                    f"{tuple(lparams[pname].shape)}")
                            m.shared_shape = tuple(lparams[pname].shape)
                        del lparams[pname]
                        m.shared_owner = owner_layer
                    else:
                        shared_owner_by_name[sname] = (lname, pname)
                lmeta[pname] = m
            if lparams:
                params[lname] = lparams
            if lmeta:
                meta[lname] = lmeta

            # shape inference: the layer's apply on meta tensors
            resolved = {k: v.to("meta") for k, v in
                        self._resolve_params(params, meta, lname).items()}
            with torch.no_grad():
                outs = ldef.apply(resolved, [blobs[b] for b in bottoms],
                                  layer, ctx)
            for t, o in zip((str(t) for t in layer.get_list("top")), outs):
                blobs[t] = o

        self.param_meta = meta
        return params, meta

    def _resolve_params(self, params, meta, lname, whole: bool = True):
        """Materialize a layer's param dict, following shared_owner links.

        Under a "model" axis (ops/collectives.py) the 2-D params are the
        rank's column shards (parallel.train.shard_params): they are
        gathered over "model" (GSPMD's values) unless `whole` is False,
        for an INNER_PRODUCT that computes on its shard; a shared param
        viewed through another shape is gathered either way."""
        gather = collectives.axis("model") is not None

        def full(arr):
            return collectives.model_gather(arr, 1) \
                if gather and arr.dim() == 2 else arr
        out = {k: full(v) if whole else v
               for k, v in params.get(lname, {}).items()}
        for pname, m in meta.get(lname, {}).items():
            if m.shared_owner is not None:
                # owner stores it under the same blob name by construction
                arr = params[m.shared_owner][pname]
                if whole or m.shared_shape is not None:
                    arr = full(arr)
                if m.shared_shape is not None:
                    # PERMISSIVE count-matched share: view the owner's data
                    # through this consumer's blob shape (Caffe keeps a
                    # per-consumer Blob shape over shared storage)
                    arr = arr.reshape(m.shared_shape)
                out[pname] = arr
        return out

    def param_multipliers(self) -> tuple[dict, dict]:
        """(lr_mults, decay_mults): trees shaped like the params `init`
        returned (owned blobs only), of each blob's blobs_lr and
        weight_decay multipliers, for train(lr_mults=, decay_mults=) (the
        JAX SolverDriver builds the same trees, solver/driver.py:252-261).
        """
        lr, decay = {}, {}
        for lname, lmeta in self.param_meta.items():
            for pname, m in lmeta.items():
                if m.shared_owner is None:
                    lr.setdefault(lname, {})[pname] = m.lr_mult
                    decay.setdefault(lname, {})[pname] = m.decay_mult
        return lr, decay

    # ------------------------------------------------------------------
    def apply(self, params, batch: dict[str, Any], *,
              generator: torch.Generator | None = None,
              return_blobs: bool = False, state=None,
              return_state: bool = False, max_layers: int | None = None,
              return_sink_blobs: bool = False):
        """Forward pass. Returns (loss, outputs) where outputs maps every
        blob name that is not consumed downstream (net outputs,
        ref:src/caffe/net.cpp:206-212), or all blobs if return_blobs. The
        loss is sum(w * sum(top)) over the tops with a nonzero loss weight.

        `generator`: the torch.Generator that DROPOUT draws its masks from
        (required at TRAIN when a DROPOUT layer's ratio is > 0).

        `state` is the cross-batch recurrent carry (layer name ->
        LstmState, the reference's next_cell_/next_out_ buffers,
        ref:src/caffe/layers/lstm_layer.cpp:171-173,261-264); with
        `return_state=True` the result gains a third element, the updated
        carry to feed into the next forward (still attached to this
        forward's graph: the caller detaches it between batches).

        `max_layers` stops after the first N compute layers (the engine
        analogue of Net::ForwardFromTo, ref:src/caffe/net.cpp:502-514),
        with the scoring fusion off, so that `vvtpu time`'s prefix
        marginals see the per-layer graph.

        `return_sink_blobs` appends one more element: the host-sink
        bottom blobs ({name: tensor}), for feeding process_host_sinks."""
        blobs: dict[str, Any] = {}
        rm_raw: dict[str, torch.Tensor] = {}
        for name in self.input_names:
            if name not in batch:
                raise ValueError(f"batch missing graph input {name!r}")
            arr = batch[name]
            if name in self.role_major_inputs and arr.dim() >= 2:
                # fed (R, B, feat...): bind the logical (B, R, feat...)
                # view; the fusion gets the raw tensor
                rm_raw[name] = arr
                arr = torch.movedim(arr, 0, 1)
            blobs[name] = arr

        # the batch's device, else the params' (DUMMY_DATA's tops go there)
        dev = next((v.device for v in (*blobs.values(), *(
            t for lp in params.values() for t in lp.values()))
            if isinstance(v, torch.Tensor)), None)
        ctx = self._context(generator, device=dev)
        ctx.state_in = state
        loss = None
        consumed: set[str] = set()
        # absorbable motif layers run symbolically; their blobs materialize
        # batched at their first real use
        fz = (ScoringFusion(role_major=rm_raw)
              if self.fuse_scoring and max_layers is None else None)
        applied = 0
        for layer in self.layers:
            ltype = layer.get("type")
            lname = layer.get("name")
            if ltype in DATA_LAYER_TYPES:
                continue
            if max_layers is not None and applied >= max_layers:
                break
            applied += 1
            bottoms = [str(b) for b in layer.get_list("bottom")]
            consumed.update(bottoms)
            # re-producing a blob (in-place top) makes it available again:
            # the reference erases bottoms from available_blobs and
            # re-inserts tops (net.cpp AppendBottom/AppendTop), so a net
            # ENDING in an in-place layer still reports that blob as a
            # net output (net.cpp:206-212)
            consumed.difference_update(str(t) for t in layer.get_list("top"))
            weights = self.loss_weights.get(lname, [])
            if fz is not None:
                if fz.try_absorb(layer, blobs, weights) is not None:
                    continue
                for b in bottoms:
                    if b not in blobs and b in fz.syms:
                        blobs[b] = fz.materialize(b)
            outs = LAYERS[ltype].apply(
                self._resolve_params(params, self.param_meta, lname,
                                     whole=not _column_parallel(layer, ctx)),
                [blobs[b] for b in bottoms], layer, ctx)
            for i, (t, o) in enumerate(zip(
                    (str(t) for t in layer.get_list("top")), outs)):
                blobs[t] = o
                if fz is not None:
                    # a real rebinding kills the symbol, retires a raw
                    # role-major input of the same name, and bumps the root
                    # version so a later SLICE(dim0) captures the new value
                    fz.note_rebind(t)
                w = weights[i] if i < len(weights) else 0.0
                if w != 0.0:
                    term = w * torch.sum(o)
                    loss = term if loss is None else loss + term
        if fz is not None:
            # a live symbol that nothing consumed is a net output (or, with
            # return_blobs, part of the full blob map)
            for name in list(fz.syms):
                if name not in blobs and (return_blobs or name not in consumed):
                    blobs[name] = fz.materialize(name)
        self._last_absorbed = fz.absorbed_layers if fz is not None else 0
        if loss is None:
            loss = torch.zeros((), dtype=torch.float32, device=dev)

        tail = ()
        if return_state:
            tail = (dict(ctx.state_out),)
        if return_sink_blobs:
            tail += ({b: blobs[b] for s in self.host_sinks
                      for b in s["bottoms"]},)
        if return_blobs:
            return (loss, blobs) + tail
        outputs = {k: v for k, v in blobs.items() if k not in consumed}
        return (loss, outputs) + tail

    def role_major_candidates(self, batch) -> list[str]:
        """Input blobs eligible for the role-major feed: consumed by a
        SLICE(dim1) into all-width-1 slices that the scoring fusion can
        absorb (graph/fuse.py drole symbols). SolverDriver's
        `role_major_data` option picks the batch keys to transpose with it.
        """
        if not self.fuse_scoring:
            return []
        out = []
        for layer in self.layers:
            if layer.get("type") != "SLICE":
                continue
            p = layer.get_msg("slice_param")
            if int(p.get("slice_dim", 1)) != 1:
                continue
            src = str(layer.get_list("bottom")[0])
            tops = [str(t) for t in layer.get_list("top")]
            arr = batch.get(src)
            if src not in self.input_names or arr is None \
                    or getattr(arr, "ndim", 0) < 2 \
                    or arr.shape[1] != len(tops):
                continue
            points = [int(v) for v in p.get_list("slice_point")]
            if points and points != list(range(1, len(tops))):
                continue
            out.append(src)
        return out

    @property
    def stateful_layer_names(self) -> list:
        """Names of the layers that carry recurrent state across batches."""
        return [str(l.get("name")) for l in self.layers
                if l.get("type") in STATEFUL_LAYER_TYPES]

    def loss_fn(self, params, batch, generator=None):
        loss, _ = self.apply(params, batch, generator=generator)
        return loss

    def debug_info(self, params, batch, *, generator=None) -> dict:
        """Per-blob mean-abs activation stats, the analogue of Caffe's
        `debug_info` forward printing (ref:src/caffe/net.cpp:581-636):
        {blob_name: mean_abs} plus {"param:layer/param": mean_abs}, each
        also logged. At TRAIN with no generator, dropout draws from one
        seeded 0 on the batch's device."""
        if generator is None and self.phase == "TRAIN":
            dev = next((v.device for v in batch.values()
                        if isinstance(v, torch.Tensor)), torch.device("cpu"))
            generator = torch.Generator(device=dev).manual_seed(0)
        _, blobs = self.apply(params, batch, generator=generator,
                              return_blobs=True)
        stats = {name: float(v.detach().float().abs().mean())
                 for name, v in blobs.items()}
        for lname, lp in params.items():
            for pname, arr in lp.items():
                stats[f"param:{lname}/{pname}"] = float(
                    arr.detach().float().abs().mean())
        for name, value in sorted(stats.items()):
            log.info("    [debug_info] %s: mean abs = %g", name, value)
        return stats

    def process_host_sinks(self, blobs: dict, *, append: bool = False,
                           mesh=None, shard_gallery: bool = False):
        """Dump the sink layers' bottoms (call with `return_blobs=True`
        outputs, or the `return_sink_blobs` map): WRITE_TO_FILE writes a csv
        (ref write_to_file_layer.cpp:36-64), HDF5_OUTPUT an .h5 file (ref
        hdf5_output_layer.cpp), and RETRIEVAL_STATS and
        RETRIEVAL_RANK_STATS(_FIXED_REF) with a stats_output_file their
        per-item report csv. The reference truncates each file on every Forward
        (write_to_file_layer.cpp:42, retrieval_stats_layer.cpp:150), and so
        does append=False, the default; append=True accumulates
        WRITE_TO_FILE's rows across calls instead (the JAX package's
        extension for multi-batch eval loops).

        `mesh` (parallel.make_mesh; call on every rank with the whole
        blobs): the RETRIEVAL_STATS report's query chunks shard over the
        mesh's "data" axis (metrics.retrieval's mesh engine),
        `shard_gallery=True` its gallery rows instead; rank 0 writes every
        file."""
        writer = is_writer(mesh)
        for sink in self.host_sinks:
            cfg = sink["cfg"]
            bottoms = [blobs[b] for b in sink["bottoms"]]
            if sink["type"] == "RETRIEVAL_STATS":
                # every rank takes part in the mesh engines
                self._retrieval_stats_sink(sink, bottoms, mesh,
                                           shard_gallery)
            elif not writer:
                continue
            elif sink["type"] == "WRITE_TO_FILE":
                wp = cfg.get_msg("write_to_file_param")
                _write_to_file(wp.get("output_file", f"{sink['name']}.csv"),
                               _host(bottoms[0]),
                               int(wp.get("feat_size", -1)), append)
            elif sink["type"] == "HDF5_OUTPUT":
                path = cfg.get_msg("hdf5_output_param").get(
                    "file_name", f"{sink['name']}.h5")
                # the dataset names are fixed, "data" from bottom[0] and
                # "label" from bottom[1], of one batch size
                # (ref:src/caffe/layers/hdf5_output_layer.cpp:31-60), so
                # that an HDF5_DATA layer can read the file back
                data, label = _host(bottoms[0]), _host(bottoms[1])
                if data.shape[0] != label.shape[0]:
                    raise ValueError(
                        f"HDF5_OUTPUT {sink['name']!r}: data and label "
                        f"batch sizes differ ({data.shape[0]} vs "
                        f"{label.shape[0]}; the reference CHECK_EQs them)")
                write_hdf5(path, {"data": data, "label": label})
            elif sink["type"] == "RETRIEVAL_RANK_STATS":
                p = cfg.get_msg("retrieval_rank_stats_param")
                ctxf, tgtf = bottoms
                retrieval_rank_stats_report(
                    ctxf.reshape(ctxf.shape[0], -1),
                    tgtf.reshape(tgtf.shape[0], -1),
                    p.get("stats_output_file"),
                    compute_ap=bool(p.get("compute_ap", False)),
                    positive_size=int(p.get("positive_size", 0)),
                    negative_size=int(p.get("negative_size", 0)),
                    device=ctxf.device)
            else:   # RETRIEVAL_RANK_STATS_FIXED_REF
                p = cfg.get_msg("retrieval_rank_stats_fixed_ref_param")
                feats, vids, reff, ref_vids = bottoms
                retrieval_rank_stats_fixed_ref_report(
                    feats.reshape(feats.shape[0], -1), vids.reshape(-1),
                    reff.reshape(reff.shape[0], -1), ref_vids.reshape(-1),
                    p.get("stats_output_file"), device=feats.device)

    def _retrieval_stats_sink(self, sink, bottoms, mesh=None,
                              shard_gallery=False):
        p = sink["cfg"].get_msg("retrieval_stats_param")
        feats = bottoms[0].reshape(bottoms[0].shape[0], -1)
        vids = bottoms[1].reshape(-1).to(torch.int32)
        if bool(p.get("video_level_retrieval", False)):
            nv = int(p.get("max_num_videos", 0))
            # host-side twin of the reference's CHECK_EQ
            # (retrieval_stats_layer.cpp:188)
            check_num_videos(vids, nv)
            feats, vids = video_level_average(feats, vids, nv)
        id_map = self.side.get(sink["name"])
        classes = id_map.lookup(vids) if id_map is not None else vids
        retrieval_stats_report(
            feats.detach().cpu().numpy(), vids.cpu().numpy(),
            classes.cpu().numpy(), p.get("stats_output_file"),
            exclude_same_video_shots=bool(
                p.get("exclude_same_video_shots", True)),
            # extension: `gallery_dtype: "bfloat16"` stores the gallery
            # compact; ranks exact w.r.t. the quantized distances
            gallery_dtype=str(p.get("gallery_dtype", "float32")
                              or "float32"),
            mesh=mesh, shard_gallery=shard_gallery, device=feats.device)

    # ------------------------------------------------------------------
    def flat_param_list(self, params):
        """(layer_name, blob_name, lr_mult, decay_mult) for every owned param,
        in deterministic order: the solver's view (ref net params vector)."""
        out = []
        for lname in sorted(params.keys()):
            for pname in sorted(params[lname].keys()):
                m = self.param_meta.get(lname, {}).get(pname, ParamMeta())
                out.append((lname, pname, m.lr_mult, m.decay_mult))
        return out


def _column_parallel(layer, ctx) -> bool:
    """An INNER_PRODUCT on K1 (regularization <= 0, not int8), which under
    a "model" axis computes on the rank's column shard of its weight."""
    if layer.get("type") != "INNER_PRODUCT":
        return False
    reg = float(layer.get_msg("inner_product_param").get("regularization",
                                                          0.0))
    return reg <= 0.0 and (ctx.quant or {}).get(layer.get("name")) is None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write_to_file(path: str, arr: np.ndarray, feat_size: int,
                   append: bool) -> None:
    """WRITE_TO_FILE's csv, byte for byte the JAX package's. The blob is
    viewed as Caffe's (N, C, H, W): a 2-D (N, F) blob is (N, F, 1, 1), so
    each row holds H.W values (feat_size caps it, write_to_file_layer.cpp:
    21-25). The rows run channel-major and start "c,b", though the header
    names batch_id first: the reference's loop writes the channel first
    (:49-52)."""
    header = (not append or not os.path.exists(path)
              or os.path.getsize(path) == 0)
    n = arr.shape[0]
    c = arr.shape[1] if arr.ndim > 1 else 1
    flat = arr.reshape(n, c, -1)
    feat = feat_size if feat_size > 0 else flat.shape[2]
    # every value formatted once, in the rows' (channel, batch) order
    vals = [format(v, "g") for v in
            flat[:, :, :feat].transpose(1, 0, 2).ravel().tolist()]
    k = min(feat, flat.shape[2])
    with open(path, "a" if append else "w") as f:
        if header:
            f.write(f"#batch_id,channel_id,features(1..{feat})\n")
        f.write("".join(
            f"{ci},{b}," + ",".join(vals[(ci * n + b) * k:(ci * n + b + 1) * k])
            + "\n" for ci in range(c) for b in range(n)))
