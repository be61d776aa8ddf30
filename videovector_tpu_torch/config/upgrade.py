"""Legacy (V0) prototxt upgrade; counterpart of
videovector_tpu/config/upgrade.py, a copy of it.

ref:src/caffe/util/upgrade_proto.cpp: V0 nets wrap per-layer params in a
nested `layer { ... }` message with string types and flat fields
(num_output, kernelsize, ...), and express padding as separate `padding`
layers. `upgrade_net` converts to the V1 form, with the reference's
semantics:

- padding-layer folding follows UpgradeV0PaddingLayers (:54-108): blob
  producers tracked by LAST top index (in-place reuse safe), pad folded
  into the consuming conv/POOL layer, with the reference's CHECKs
  (conv/pool-only consumer, single input/output) raised as ValueError --
  the `OrDie` behavior of ReadNetParamsFromTextFileOrDie.
- field mapping follows UpgradeV0LayerParameter (:110-460) field by
  field, including every per-type conditional (`source` -> data_param /
  hdf5_data_param / image_data_param / window_data_param /
  infogain_loss_param; det_* -> window_data_param fg_threshold etc.;
  shuffle_images -> image_data_param.shuffle; transform fields
  scale/meanfile/cropsize/mirror -> transform_param). An incompatible
  field/type pair raises (the reference marks is_fully_compatible=false
  and the OrDie reader aborts).
"""

from __future__ import annotations

from videovector_tpu_torch.config.textformat import Message

# V0 string type → V1 enum name (ref UpgradeV0LayerType :458-516)
_TYPE_MAP = {
    "accuracy": "ACCURACY", "bnll": "BNLL", "concat": "CONCAT",
    "conv": "CONVOLUTION", "data": "DATA", "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS", "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA", "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL", "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS",
    "innerproduct": "INNER_PRODUCT", "lrn": "LRN",
    "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING", "relu": "RELU", "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX", "softmax_loss": "SOFTMAX_LOSS", "split": "SPLIT",
    "tanh": "TANH", "window_data": "WINDOW_DATA",
}

# per-type targets for the conditional fields, mirroring the reference's
# if/else chains; a (field, v0_type) pair absent here is incompatible
_SOURCE_TARGET = {
    "data": ("data_param", "source"),
    "hdf5_data": ("hdf5_data_param", "source"),
    "images": ("image_data_param", "source"),
    "window_data": ("window_data_param", "source"),
    "infogain_loss": ("infogain_loss_param", "source"),
}
_BATCHSIZE_TARGET = {
    "data": ("data_param", "batch_size"),
    "hdf5_data": ("hdf5_data_param", "batch_size"),
    "images": ("image_data_param", "batch_size"),
    "window_data": ("window_data_param", "batch_size"),
}
_RAND_SKIP_TARGET = {
    "data": ("data_param", "rand_skip"),
    "images": ("image_data_param", "rand_skip"),
}
_CONV_OR_IP = {"conv": "convolution_param",
               "innerproduct": "inner_product_param"}
_CONV_OR_POOL = {"conv": "convolution_param", "pool": "pooling_param"}


def net_needs_upgrade(net_msg: Message) -> bool:
    """ref NetNeedsUpgrade: any layers entry with a nested `layer` message."""
    return any(isinstance(l.get("layer"), Message)
               for l in net_msg.get_list("layers"))


def _incompatible(field: str, v0_type: str):
    # the reference LOG(ERROR)s "Unknown parameter <field> for layer type"
    # and the OrDie reader aborts on is_fully_compatible == false
    raise ValueError(
        f"V0 upgrade: unknown parameter {field!r} for layer type "
        f"{v0_type!r} (ref UpgradeV0LayerParameter marks this "
        f"incompatible and ReadNetParamsFrom*OrDie aborts)")


def upgrade_layer(conn: Message) -> Message:
    """One V0 `layers { layer {...} bottom... top... }` connection → V1
    (ref UpgradeLayerParameter :110-460, field-by-field)."""
    v0 = conn.get_msg("layer")
    out = Message()
    for b in conn.get_list("bottom"):
        out.add("bottom", b)
    for t in conn.get_list("top"):
        out.add("top", t)
    if v0.has("name"):
        out.add("name", v0.get("name"))
    v0_type = str(v0.get("type", ""))
    if v0_type and v0_type not in _TYPE_MAP:
        raise ValueError(f"V0 upgrade: unknown layer type {v0_type!r} "
                         f"(ref UpgradeV0LayerType LOG(FATAL))")
    v1_type = _TYPE_MAP.get(v0_type, v0_type.upper())
    out.add("type", v1_type)

    params: dict[str, Message] = {}

    def put(pname: str, field: str, vals):
        params.setdefault(pname, Message())
        for v in vals:
            params[pname].add(field, v)

    def put_cond(table: dict, field: str, vals, v1_field: str | None = None):
        tgt = table.get(v0_type)
        if tgt is None:
            _incompatible(field, v0_type)
        if isinstance(tgt, tuple):
            pname, v1f = tgt
        else:
            pname, v1f = tgt, v1_field or field
        put(pname, v1f, vals)

    for field, vals in v0.fields.items():
        if field in ("name", "type"):
            continue
        elif field in ("blobs_lr", "weight_decay", "blobs"):
            # learning-rate/decay multipliers and learned blobs stay
            # top-level repeated fields in V1 (ref :127-137,441-452)
            for v in vals:
                out.add(field, v)
        elif field in ("num_output",):
            put_cond(_CONV_OR_IP, field, vals)
        elif field == "biasterm":
            put_cond(_CONV_OR_IP, field, vals, "bias_term")
        elif field in ("weight_filler", "bias_filler"):
            put_cond(_CONV_OR_IP, field, vals)
        elif field == "pad":
            put_cond(_CONV_OR_POOL, field, vals)
        elif field == "kernelsize":
            put_cond(_CONV_OR_POOL, field, vals, "kernel_size")
        elif field == "group":
            if v0_type != "conv":
                _incompatible(field, v0_type)
            put("convolution_param", "group", vals)
        elif field == "stride":
            put_cond(_CONV_OR_POOL, field, vals)
        elif field == "pool":
            if v0_type != "pool":
                _incompatible(field, v0_type)
            # V0 pool methods are strings ("max"/"ave"/"stochastic");
            # V1 is the enum name (ref :229-253)
            names = {"max": "MAX", "ave": "AVE", "stochastic": "STOCHASTIC"}
            put("pooling_param", "pool",
                [names.get(str(v).lower(), v) for v in vals])
        elif field == "dropout_ratio":
            if v0_type != "dropout":
                _incompatible(field, v0_type)
            put("dropout_param", "dropout_ratio", vals)
        elif field in ("local_size", "alpha", "beta"):
            if v0_type != "lrn":
                _incompatible(field, v0_type)
            put("lrn_param", field, vals)
        elif field == "source":
            put_cond(_SOURCE_TARGET, field, vals)
        elif field == "batchsize":
            put_cond(_BATCHSIZE_TARGET, field, vals)
        elif field == "rand_skip":
            put_cond(_RAND_SKIP_TARGET, field, vals)
        elif field == "scale":
            put("transform_param", "scale", vals)
        elif field == "meanfile":
            put("transform_param", "mean_file", vals)
        elif field == "cropsize":
            put("transform_param", "crop_size", vals)
        elif field == "mirror":
            put("transform_param", "mirror", vals)
        elif field == "shuffle_images":
            if v0_type != "images":
                _incompatible(field, v0_type)
            put("image_data_param", "shuffle", vals)
        elif field in ("new_height", "new_width"):
            if v0_type != "images":
                _incompatible(field, v0_type)
            put("image_data_param", field, vals)
        elif field == "concat_dim":
            if v0_type != "concat":
                _incompatible(field, v0_type)
            put("concat_param", "concat_dim", vals)
        elif field in ("det_fg_threshold", "det_bg_threshold",
                       "det_fg_fraction", "det_context_pad",
                       "det_crop_mode"):
            if v0_type != "window_data":
                _incompatible(field, v0_type)
            put("window_data_param", field.removeprefix("det_"), vals)
        elif field == "hdf5_output_param":
            if v0_type != "hdf5_output":
                _incompatible(field, v0_type)
            for v in vals:
                out.add("hdf5_output_param", v)
        elif field in ("new_num", "new_channels"):
            # V0 ReshapeLayer dims the reference's upgrade never copies
            # (upgrade_proto.cpp handles new_height/new_width for
            # image_data only) — dropped like the reference; passing them
            # through would put unknown top-level fields on the V1 layer
            # that the LayerParameter schema rejects at write time
            pass
        else:
            # fields the reference's V0 message doesn't define pass
            # through at top level (forward compatibility)
            for v in vals:
                out.add(field, v)
    for pname, pmsg in params.items():
        out.add(pname, pmsg)
    return out


def _fold_padding(net_msg: Message) -> list[Message]:
    """ref UpgradeV0PaddingLayers (:54-108): drop `padding` layers, fold
    their pad into the consuming conv/pool's V0 `pad` field, rewire the
    bottom. Producers resolve by LAST top index so in-place blob reuse
    behaves exactly like the reference's blob_name_to_last_top_idx."""
    layers = net_msg.get_list("layers")
    last_top: dict[str, int] = {str(n): -1
                                for n in net_msg.get_list("input")}
    kept: list[Message] = []
    for i, conn in enumerate(layers):
        v0 = conn.get_msg("layer")
        v0_type = str(v0.get("type", ""))
        if v0_type != "padding":
            # rebuild so rewiring doesn't mutate the input — the nested
            # "layer" message must be DEEP-copied (a shallow rebuild
            # shares it, so the pad injection below would write through
            # to the caller's message)
            def _deep(m: Message) -> Message:
                nm = Message()
                for k, vals in m.fields.items():
                    for v in vals:
                        nm.add(k, _deep(v) if isinstance(v, Message) else v)
                return nm
            new_conn = _deep(conn)
            if not new_conn.has("layer"):
                # ensure the fold target below is ATTACHED (get_msg on a
                # missing key returns a detached Message whose pad would
                # be silently lost)
                new_conn.add("layer", Message())
            kept.append(new_conn)
        for j, b in enumerate(conn.get_list("bottom")):
            bname = str(b)
            if bname not in last_top:
                raise ValueError(
                    f"V0 upgrade: unknown blob input {bname!r} to layer "
                    f"{i} (ref LOG(FATAL), upgrade_proto.cpp:74)")
            idx = last_top[bname]
            if idx == -1:
                continue
            src = layers[idx]
            if str(src.get_msg("layer").get("type", "")) == "padding":
                if v0_type not in ("conv", "pool"):
                    raise ValueError(
                        "V0 upgrade: padding layer feeds a "
                        f"non-conv/pool layer {v0_type!r} (undefined in "
                        "Caffe; ref CHECK, upgrade_proto.cpp:86)")
                if len(conn.get_list("bottom")) != 1 \
                        or len(src.get_list("bottom")) != 1 \
                        or len(src.get_list("top")) != 1:
                    raise ValueError(
                        "V0 upgrade: padding fold needs single-input "
                        "conv/pool and single-in/out padding layer "
                        "(ref CHECKs, upgrade_proto.cpp:90-96)")
                tgt = kept[-1]
                tgt.get_msg("layer").fields["pad"] = \
                    [src.get_msg("layer").get("pad", 0)]
                tgt.fields["bottom"] = [str(src.get_list("bottom")[0])]
        for t in conn.get_list("top"):
            last_top[str(t)] = i
    return kept


def upgrade_net(net_msg: Message) -> Message:
    """ref UpgradeV0Net: fold padding layers (UpgradeV0PaddingLayers),
    then convert every layer (UpgradeLayerParameter)."""
    if not net_needs_upgrade(net_msg):
        return net_msg
    out = Message()
    if net_msg.has("name"):
        out.add("name", net_msg.get("name"))
    for f in ("input", "input_dim", "force_backward"):
        for v in net_msg.get_list(f):
            out.add(f, v)
    for conn in _fold_padding(net_msg):
        out.add("layers", upgrade_layer(conn))
    return out
