"""Layer registry: adapts the port's ops to prototxt-configured graph nodes;
counterpart of videovector_tpu/graph/layers.py.

A layer is a pair of functions:

  init(generator, cfg, in_shapes) -> params     (dict name -> tensor; may be {})
  apply(params, inputs, cfg, ctx) -> outputs    (list of tensors)

`cfg` is the LayerParameter `Message`; `ctx` carries the phase, the dropout
generator, the host-loaded side tables and the GEMM and conv operand
dtype. Autograd replaces every Backward. Data-layer
types are not here: the Net treats their tops as graph inputs fed by the
data pipeline (see graph/net.py, graph/data_factory.py).

Registered: every compute type of the JAX package: the flagship's
(generate_net.py's nets), the vision, neuron and glue types (CONVOLUTION on
K2, POOLING, LRN, IM2COL, the neuron types, SOFTMAX, SPLIT, FLATTEN,
FLATTEN_BATCH, SILENCE), ID_TO_WEIGHT_MAPPING, ARGMAX, MVN, Caffe's loss
zoo, ACCURACY, the retrieval and classification stats, the sinks,
DUMMY_DATA, and the LSTM workload's (LSTM, LSTM_LINEAR, LSTM_ENC_DEC,
LSTM_CONDITIONAL, LSTM_SINGLE_STEP, SOCIAL_POOLING). `PENDING_TYPES`, the
types a later ROADMAP item would port, is empty.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from videovector_tpu_torch.core import fillers
from videovector_tpu_torch.core.seeds import iteration_seed
from videovector_tpu_torch.metrics import retrieval as retrieval_metrics
from videovector_tpu_torch.metrics.classification import classification_stats
from videovector_tpu_torch.ops import (
    activations, collectives, conv, losses, lrn, pooling, recurrent,
    reductions,
)
from videovector_tpu_torch.ops.embedding import id_to_weight_lookup
from videovector_tpu_torch.ops.hopper.conv_gemm import conv2d_nchw
from videovector_tpu_torch.ops.linear import (
    inner_product, shard_matmul, tower_matmul,
)
from videovector_tpu_torch.ops.normalization import l2_normalize_rows, mvn
from videovector_tpu_torch.ops.quant import (
    dequantize_conv_weight, int8_conv2d, int8_inner_product,
)
from videovector_tpu_torch.ops.social import social_pooling


@dataclass
class ApplyContext:
    phase: str = "TRAIN"            # TRAIN or TEST
    # dropout's masks: drawn from this generator, in layer order
    generator: torch.Generator | None = None
    side: dict = field(default_factory=dict)   # layer_name -> host-loaded tables
    # GEMM and conv operand dtype (f32 sums either way). None = f32, the
    # reference's numerics; torch.bfloat16 is the throughput extension
    # (solver prototxt `compute_dtype` -> Net(compute_dtype=...)), the
    # cast discipline of models/embedding.py's compute_dtype
    compute_dtype: torch.dtype | None = None
    # int8 PTQ side table {layer_name: ...} of the JAX package's serving
    # exporter; not ported yet (ROADMAP item 10)
    quant: Any = None
    # where a layer without bottoms (DUMMY_DATA) puts its tops: the batch's
    # device ("meta" in Net.init's shape pass)
    device: Any = None
    # cross-batch recurrent state (the reference's next_cell_/next_out_
    # carry, lstm_layer.cpp:171-173,261-264): layer name -> LstmState.
    # Stateful layers read state_in and write state_out;
    # Net.apply(state=..., return_state=True) exposes both ends
    state_in: Any = None
    state_out: dict = field(default_factory=dict)


@dataclass(frozen=True)
class LayerDef:
    init: Callable   # (generator, cfg, in_shapes) -> params
    apply: Callable  # (params, inputs, cfg, ctx) -> list[outputs]
    # default loss weights per top; None => all zeros (not a loss layer)
    default_loss_weights: tuple | None = None

    @property
    def has_params(self) -> bool:
        return self.init is not _no_params


LAYERS: dict[str, LayerDef] = {}

# Types whose tops come from the host data pipeline (the reference's data
# layers, ref:include/caffe/data_layers.hpp): the Net maps their tops to
# graph inputs.
DATA_LAYER_TYPES = {
    "DATA", "IMAGE_DATA", "WINDOW_DATA", "MEMORY_DATA", "HDF5_DATA",
    "VIDEO_SHOT_WINDOW_DATA", "VIDEO_SHOTS_DATA", "VIDEO_SAMPLED_SHOTS_DATA",
    "VIDEO_SHOT_WINDOW_TEST_DATA", "FIXED_VIDEO_SHOT_TEST_DATA",
    "FLEXIBLE_DATA", "TRACKING_WINDOWS_DATA", "TRACKING_WINDOWS_SOCIAL_DATA",
}

# Sink layers: no tops in the graph; the Net records them in `host_sinks`
# and dumps their bottoms host-side after the step.
SINK_LAYER_TYPES = {"WRITE_TO_FILE", "HDF5_OUTPUT"}

# Layers that carry recurrent state across batches (ref next_cell_/next_out_,
# lstm_layer.cpp:171-173,261-264).
STATEFUL_LAYER_TYPES = {"LSTM", "LSTM_LINEAR"}

# The JAX package's other registered compute types, by the ROADMAP queue-1
# item that ports them: none is left.
PENDING_TYPES: dict[str, str] = {}


def register(name: str, *, loss_weights=None):
    def deco(builder):
        init_fn, apply_fn = builder()
        LAYERS[name] = LayerDef(init_fn, apply_fn, loss_weights)
        return builder
    return deco


def _no_params(generator, cfg, in_shapes):
    return {}


def _flat_dim(shape):
    out = 1
    for d in shape[1:]:
        out *= int(d)
    return out


def _filler(p, name):
    return fillers.get_filler(p.get_msg(name) if p.has(name) else None)


# ---------------------------------------------------------------------------
# Compute layers
# ---------------------------------------------------------------------------

@register("INNER_PRODUCT")
def _inner_product():
    def init(generator, cfg, in_shapes):
        p = cfg.get_msg("inner_product_param")
        n = int(p.get("num_output"))
        k = _flat_dim(in_shapes[0])
        # Caffe blob layout is (num_output, K); ours is (K, num_output) for
        # x @ W: fill in Caffe layout, then transpose (contiguous, so that
        # a bf16 copy is one TMA can address)
        params = {"w": _filler(p, "weight_filler")(generator, (n, k))
                  .T.contiguous()}
        if p.get("bias_term", True):
            params["b"] = _filler(p, "bias_filler")(generator, (n,))
        return params

    def apply(params, inputs, cfg, ctx):
        """With regularization <= 0, the forward is one K1 launch on a CUDA
        tensor (ops.linear.tower_matmul: bias epilogue, f32 out, backward in
        torch.matmul), with the operands in the Net's compute dtype (f32
        when unset; a negative regularization is inert and keeps f32, as in
        JAX). A positive one keeps ops.linear.inner_product's (1 + r/2)
        weight-gradient quirk, in f32. A layer in the Net's int8 `quant`
        side table (tools/quantize.py) with regularization 0 runs
        ops.quant.int8_inner_product instead: int8 x int8 -> int32 on
        torch._int_mm, dequantized in f32, plus the bias."""
        p = cfg.get_msg("inner_product_param")
        reg = float(p.get("regularization", 0.0))
        q = (ctx.quant or {}).get(cfg.get("name"))
        if q is not None and reg == 0.0:
            return [int8_inner_product(inputs[0], q, params.get("b"))]
        x, w, b = inputs[0], params["w"], params.get("b")
        if reg > 0.0:
            return [inner_product(x, w, b, regularization=reg)]
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        cdt = ctx.compute_dtype if reg == 0.0 and ctx.compute_dtype \
            is not None else torch.float32
        if collectives.axis("model") is not None and \
                w.shape[1] == int(p.get("num_output")):
            # a whole weight under a model axis (Net gathers a shared
            # param it reshapes): the product of the whole, on every rank
            return [shard_matmul(x, w, b, compute_dtype=cdt)]
        # under a model axis, w is the rank's column shard: K1 on it, the
        # columns gathered over "model" (ops/linear.py::tower_matmul)
        return [tower_matmul(x, w, b, compute_dtype=cdt)]

    return init, apply


@register("ID_TO_WEIGHT_MAPPING")
def _id_to_weight():
    def init(generator, cfg, in_shapes):
        # the table is (max_ids, num_output)
        # (Caffe id_to_weight_mapping_layer.cpp:16-29)
        p = cfg.get_msg("id_to_weight_mapping_param")
        return {"table": _filler(p, "weight_filler")(
            generator, (int(p.get("max_ids")), int(p.get("num_output"))))}

    def apply(params, inputs, cfg, ctx):
        return [id_to_weight_lookup(inputs[0], params["table"])]

    return init, apply


# ---------------------------------------------------------------------------
# Vision layers (conv stack)
# ---------------------------------------------------------------------------

def _kernel_geometry(p):
    """kernel_size/kernel_h/kernel_w (+ the stride/pad twins) by Caffe's
    ConvolutionParameter/PoolingParameter conventions."""
    def pair(base, default):
        square_key = base if base != "kernel" else "kernel_size"
        if p.has(f"{base}_h") or p.has(f"{base}_w"):
            if not (p.has(f"{base}_h") and p.has(f"{base}_w")):
                # ref conv_layer.cpp:14-29: "X is X OR X_h and X_w are
                # required": the missing one would silently take the
                # square default (0-width kernel, wrong stride)
                raise ValueError(f"non-square geometry needs BOTH {base}_h "
                                 f"and {base}_w (the reference CHECKs, "
                                 f"conv_layer.cpp:14-29)")
            if p.has(square_key):
                # ref CHECKs the square and rectangular forms exclusive
                raise ValueError(f"{square_key} cannot be combined with "
                                 f"{base}_h/{base}_w (ref conv_layer.cpp:"
                                 f"14-29 CHECKs them exclusive)")
            return (int(p.get(f"{base}_h", default)),
                    int(p.get(f"{base}_w", default)))
        v = int(p.get(square_key, default))
        return (v, v)
    kernel = pair("kernel", 0)
    if kernel[0] <= 0 or kernel[1] <= 0:
        raise ValueError(f"kernel size {kernel} must be positive "
                         f"(ref CHECK_GT(kernel_h_/kernel_w_, 0))")
    return kernel, pair("stride", 1), pair("pad", 0)


@register("CONVOLUTION")
def _convolution():
    def init(generator, cfg, in_shapes):
        p = cfg.get_msg("convolution_param")
        num_output = int(p.get("num_output"))
        groups = int(p.get("group", 1))
        (kh, kw), _, _ = _kernel_geometry(p)
        c_in = int(in_shapes[0][1])
        params = {"w": _filler(p, "weight_filler")(
            generator, (num_output, c_in // groups, kh, kw))}
        if p.get("bias_term", True):
            params["b"] = _filler(p, "bias_filler")(generator, (num_output,))
        return params

    def apply(params, inputs, cfg, ctx):
        """One K2 launch on a CUDA tensor (the f32 route for f32 operands;
        the sm90 route for bf16), in the Net's compute dtype;
        ops.hopper.conv_gemm.conv2d_nchw. The ReLU after it stays its own
        layer, for JAX's tie gradient. A layer in the Net's `quant` side
        table runs its mode: "weight_only" (what tools/quantize.py gives a
        conv) dequantizes the int8 weights and runs K2 on bf16 operands,
        the f32 bias inside the f32 sum and one rounding to bf16, as JAX's
        conv2d(preferred f32) then the cast; "int8" quantizes the input and
        sums exactly in int32 (ops.quant.int8_conv2d)."""
        p = cfg.get_msg("convolution_param")
        _, stride, pad = _kernel_geometry(p)
        groups = int(p.get("group", 1))
        x, b = inputs[0], params.get("b")
        q = (ctx.quant or {}).get(cfg.get("name"))
        if q is not None and q.get("mode", "int8") == "weight_only":
            return [conv2d_nchw(x, dequantize_conv_weight(q), b,
                                stride=stride, pad=pad, groups=groups,
                                compute_dtype=torch.bfloat16)]
        if q is not None:
            return [int8_conv2d(x, q, b, stride=stride, pad=pad,
                                groups=groups)]
        return [conv2d_nchw(x, params["w"], b, stride=stride, pad=pad,
                            groups=groups, compute_dtype=ctx.compute_dtype)]

    return init, apply


@register("POOLING")
def _pooling():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("pooling_param")
        kernel, stride, pad = _kernel_geometry(p)
        method = p.get("pool", "MAX")
        if method == "MAX":
            return [pooling.max_pool(inputs[0], kernel=kernel, stride=stride,
                                     pad=pad)]
        if method == "AVE":
            return [pooling.avg_pool(inputs[0], kernel=kernel, stride=stride,
                                     pad=pad)]
        if method == "STOCHASTIC":
            # the race draws from ctx.generator (JAX's rng; none = TEST)
            return [pooling.stochastic_pool(
                inputs[0], kernel=kernel, stride=stride, pad=pad,
                generator=ctx.generator,
                deterministic=ctx.phase != "TRAIN")]
        raise ValueError(f"Unknown pool method {method!r}")

    return _no_params, apply


@register("LRN")
def _lrn():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("lrn_param")
        kw = dict(local_size=int(p.get("local_size", 5)),
                  alpha=float(p.get("alpha", 1.0)),
                  beta=float(p.get("beta", 0.75)))
        if p.get("norm_region", "ACROSS_CHANNELS") == "WITHIN_CHANNEL":
            return [lrn.lrn_within_channel(inputs[0], **kw)]
        return [lrn.lrn_cross_channel(inputs[0], **kw)]

    return _no_params, apply


@register("IM2COL")
def _im2col():
    def apply(params, inputs, cfg, ctx):
        kernel, stride, pad = _kernel_geometry(
            cfg.get_msg("convolution_param"))
        return [conv.im2col(inputs[0], kernel=kernel, stride=stride, pad=pad)]

    return _no_params, apply


# ---------------------------------------------------------------------------
# Neuron layers
# ---------------------------------------------------------------------------

def _simple(fn):
    def apply(params, inputs, cfg, ctx):
        return [fn(inputs[0], cfg, ctx)]
    return _no_params, apply


@register("RELU")
def _relu():
    return _simple(lambda x, cfg, ctx: activations.relu(
        x, float(cfg.get_msg("relu_param").get("negative_slope", 0.0))))


@register("SIGMOID")
def _sigmoid():
    return _simple(lambda x, cfg, ctx: activations.sigmoid(x))


@register("TANH")
def _tanh():
    return _simple(lambda x, cfg, ctx: activations.tanh(x))


@register("BNLL")
def _bnll():
    return _simple(lambda x, cfg, ctx: activations.bnll(x))


@register("ABSVAL")
def _absval():
    return _simple(lambda x, cfg, ctx: activations.absval(x))


@register("POWER")
def _power():
    def f(x, cfg, ctx):
        p = cfg.get_msg("power_param")
        return activations.power(x, power=float(p.get("power", 1.0)),
                                 scale=float(p.get("scale", 1.0)),
                                 shift=float(p.get("shift", 0.0)))
    return _simple(f)


@register("THRESHOLD")
def _threshold():
    return _simple(lambda x, cfg, ctx: activations.threshold(
        x, float(cfg.get_msg("threshold_param").get("threshold", 0.0))))


@register("SOFTMAX")
def _softmax():
    return _simple(lambda x, cfg, ctx: activations.softmax(x))


@register("DROPOUT")
def _dropout():
    def apply(params, inputs, cfg, ctx):
        """Masks come from ctx.generator, the one generator the caller hands
        Net.apply (train's, reseeded at each iteration), drawn in layer order
        with one torch.rand of the blob's shape per DROPOUT layer
        (ops.activations.dropout_mask). JAX folds crc32(layer name) into its
        key instead; the streams cannot match, so parity tests inject JAX's
        masks through dropout_mask."""
        rate = float(cfg.get_msg("dropout_param").get("dropout_ratio", 0.5))
        if ctx.phase == "TRAIN" and ctx.generator is None and rate > 0:
            # the reference ALWAYS drops at TRAIN (dropout_layer.cpp):
            # silently disabling dropout because no generator was passed
            # would train a different model than the prototxt describes
            raise ValueError(
                f"DROPOUT {cfg.get('name')!r}: TRAIN-phase forward needs "
                f"generator= (pass a torch.Generator to Net.apply/loss_fn)")
        deterministic = ctx.phase != "TRAIN" or ctx.generator is None
        return [activations.dropout(
            inputs[0], rate=rate, generator=ctx.generator,
            deterministic=deterministic,
            layout=None if deterministic else _dropout_layout(
                inputs[0], cfg.get("name")))]
    return _no_params, apply


def _dropout_layout(x, name):
    """On a batch shard, the (shape, batch axis) in which DROPOUT draws the
    whole batch's mask (ops.activations.batch_dropout_mask): a blob whose
    axis 0 is g blocks of the rank's batch rows (g = 1 for a plain blob,
    the role count for a role-major CONCAT, T for a FLATTEN_BATCH) is drawn
    as (g, B, ...) with the batch on axis 1; a time-major (T, B, ...) blob
    on axis 1. Off a batch shard, None: x's shape, axis 0."""
    if collectives.axis("data") is None:
        return None
    lay = collectives.layout()
    b = lay.get("batch")
    if not b:
        return None
    if lay.get("time_major") and x.dim() > 1 and x.shape[1] == b:
        return tuple(x.shape), 1
    if x.dim() >= 1 and x.shape[0] % b == 0:
        return (x.shape[0] // b, b) + tuple(x.shape[1:]), 1
    raise ValueError(
        f"DROPOUT {name!r} on a batch shard: no batch axis of the rank's "
        f"{b} rows in a {tuple(x.shape)} blob")


# ---------------------------------------------------------------------------
# Shape / glue layers
# ---------------------------------------------------------------------------

@register("CONCAT")
def _concat():
    def apply(params, inputs, cfg, ctx):
        dim = int(cfg.get_msg("concat_param").get("concat_dim", 1))
        return [torch.cat(inputs, dim=dim)]
    return _no_params, apply


@register("SLICE")
def _slice():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("slice_param")
        dim = int(p.get("slice_dim", 1))
        points = [int(v) for v in p.get_list("slice_point")]
        x = inputs[0]
        n_out = len(cfg.get_list("top"))
        if points:
            # ref slice_layer.cpp:32-44: CHECK_EQ(#points, #tops - 1) and
            # each point strictly increasing within (0, size): a short
            # list would silently DROP trailing channels, a non-increasing
            # one would emit empty slices
            if len(points) != n_out - 1:
                raise ValueError(
                    f"SLICE {cfg.get('name')!r}: {len(points)} slice_point "
                    f"for {n_out} tops (the reference CHECK_EQs "
                    f"#slice_point == #tops - 1)")
            prev = 0
            for pt in points:
                if not prev < pt < x.shape[dim]:
                    raise ValueError(
                        f"SLICE {cfg.get('name')!r}: slice_point {pt} not "
                        f"strictly increasing within (0, {x.shape[dim]})")
                prev = pt
            bounds = [0] + points + [x.shape[dim]]
        else:
            if x.shape[dim] % n_out != 0:
                # ref slice_layer.cpp:60-66 CHECK_EQ-fails here; a silent
                # remainder would cause shape drift downstream.
                raise ValueError(
                    f"SLICE {cfg.get('name')!r}: dim {dim} size "
                    f"{x.shape[dim]} not divisible by {n_out} tops and no "
                    "slice_point given")
            step = x.shape[dim] // n_out
            bounds = [i * step for i in range(n_out)] + [x.shape[dim]]
        # one split (its backward concatenates the tops' gradients), not
        # n_out narrows (each narrow's backward scatters into a zero tensor
        # of x's shape, and autograd sums the n_out of them)
        return list(torch.split(
            x, [bounds[i + 1] - bounds[i] for i in range(n_out)], dim=dim))
    return _no_params, apply


@register("SPLIT")
def _split():
    def apply(params, inputs, cfg, ctx):
        return [inputs[0]] * len(cfg.get_list("top"))
    return _no_params, apply


@register("FLATTEN")
def _flatten():
    def apply(params, inputs, cfg, ctx):
        # reshape, not view: a channels_last conv output is copied into
        # Caffe's c*h*w order, the order the next INNER_PRODUCT expects
        return [inputs[0].reshape(inputs[0].shape[0], -1)]
    return _no_params, apply


@register("FLATTEN_BATCH")
def _flatten_batch():
    def apply(params, inputs, cfg, ctx):
        # ref flatten_batch_layer.cpp:10-28: the channel axis moves into the
        # batch, (N, C, H, W) -> (N*C, H*W); with batch_size, regrouped to
        # (batch_size, N*C*H*W / batch_size)
        x = inputs[0]
        bs = cfg.get_msg("flatten_batch_param").get("batch_size")
        if bs:
            return [x.reshape(int(bs), -1)]
        return [x.reshape(x.shape[0] * x.shape[1], -1)]
    return _no_params, apply


@register("SILENCE")
def _silence():
    def apply(params, inputs, cfg, ctx):
        return []
    return _no_params, apply


@register("ELTWISE")
def _eltwise():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("eltwise_param")
        op = p.get("operation", "SUM")
        if op == "PROD":
            return [reductions.eltwise_prod(
                *inputs,
                stable_grad=bool(p.get("stable_prod_grad", True)))]
        if op == "MAX":
            return [reductions.eltwise_max(*inputs)]
        coeffs = [float(c) for c in p.get_list("coeff")] or None
        return [reductions.eltwise_sum(*inputs, coeffs=coeffs)]
    return _no_params, apply


@register("ARGMAX")
def _argmax():
    def apply(params, inputs, cfg, ctx):
        """Caffe argmax_layer.cpp: a top (N, 1, top_k, 1) of indices, or
        (N, 2, top_k, 1) with the values on channel 1 when out_max_val;
        1 <= top_k <= dim is checked. Caffe's partial_sort compares
        (value, index) pairs with std::greater, so equal values rank the
        LARGER index first: a stable descending sort of the flipped row."""
        p = cfg.get_msg("argmax_param")
        x = inputs[0]
        n = x.shape[0]
        flat = x.reshape(n, -1)
        dim = flat.shape[1]
        k = int(p.get("top_k", 1))
        if not 1 <= k <= dim:
            raise ValueError(
                f"ARGMAX {cfg.get('name')!r}: top_k={k} outside [1, {dim}] "
                f"(ref argmax_layer.cpp:16-18 CHECKs)")
        order_f = torch.argsort(-flat.flip(1), dim=1, stable=True)[:, :k]
        idx = dim - 1 - order_f
        idx_f = idx.to(torch.float32)
        if p.get("out_max_val", False):
            vals = torch.gather(flat, 1, idx)
            return [torch.stack([idx_f, vals], dim=1).reshape(n, 2, k, 1)]
        return [idx_f.reshape(n, 1, k, 1)]
    return _no_params, apply


@register("MVN")
def _mvn():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("mvn_param")
        return [mvn(inputs[0],
                    normalize_variance=bool(p.get("normalize_variance", True)),
                    across_channels=bool(p.get("across_channels", False)))]
    return _no_params, apply


@register("NORMALIZATION")
def _normalization():
    return _simple(lambda x, cfg, ctx: l2_normalize_rows(x))


@register("SUM")
def _sum():
    def apply(params, inputs, cfg, ctx):
        num_output = int(cfg.get_msg("sum_param").get("num_output", 1))
        return [reductions.sum_reduce(inputs[0], num_output)]
    return _no_params, apply


@register("WRITE_TO_FILE")
def _write_to_file():
    # Caffe write_to_file_layer.cpp: a csv per forward, written by
    # Net.process_host_sinks
    def apply(params, inputs, cfg, ctx):
        return []
    return _no_params, apply


@register("HDF5_OUTPUT")
def _hdf5_output():
    # Caffe hdf5_output_layer.cpp: an .h5 file per forward, written by
    # Net.process_host_sinks
    def apply(params, inputs, cfg, ctx):
        return []
    return _no_params, apply


# ---------------------------------------------------------------------------
# Loss and eval-stats layers
# ---------------------------------------------------------------------------

@register("MAX_MARGIN_LOSS", loss_weights=(1.0, 0.0))
def _max_margin():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("max_margin_loss_param")
        margin = float(p.get("margin", 1.0))
        norm = p.get("norm", "L1")  # proto default = L1 (caffe.proto:864)
        weights = None
        if len(inputs) == 3:
            third = inputs[2]
            if p.get("use_direct_weight", False):
                weights = third
            else:
                # id -> weight csv loaded at net build into ctx.side
                table = ctx.side.get(cfg.get("name"))
                if table is not None:
                    ids_sorted, w_sorted = (t.to(third.device) for t in table)
                    q = third.reshape(-1).to(torch.int32)
                    pos = torch.searchsorted(ids_sorted, q).clamp(
                        0, ids_sorted.shape[0] - 1)
                    w = torch.where(ids_sorted[pos] == q, w_sorted[pos], 0.0)
                    weights = w.reshape(third.shape)
        loss, violations = losses.max_margin_loss(
            inputs[0], inputs[1], margin=margin, norm=norm, weights=weights)
        return [loss, violations]
    return _no_params, apply


@register("RETRIEVAL_STATS", loss_weights=(0.0, 0.0, 0.0))
def _retrieval_stats():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("retrieval_stats_param")
        id_map = ctx.side.get(cfg.get("name"))
        inputs = _whole_batch(inputs)
        feats = inputs[0].reshape(inputs[0].shape[0], -1)
        vids = inputs[1].reshape(-1).to(torch.int32)
        if bool(p.get("video_level_retrieval", False)):
            # average shots per video first, then rank the videos
            # (ref:src/caffe/layers/retrieval_stats_layer.cpp:165-208);
            # max_num_videos must equal the distinct-id count, which
            # Net.batch_validators checks on the host
            nv = int(p.get("max_num_videos", 0))
            if nv <= 0:
                raise ValueError(
                    "video_level_retrieval requires max_num_videos > 0 "
                    "(= the distinct video-id count; the reference CHECKs "
                    "equality, retrieval_stats_layer.cpp:188)")
            feats, vids = retrieval_metrics.video_level_average(
                feats, vids, nv)
        classes = id_map.lookup(vids) if id_map is not None else vids
        out = retrieval_metrics.retrieval_stats(
            feats, vids, classes,
            # proto default is TRUE (ref caffe.proto RetrievalStatsParameter
            # exclude_same_video_shots = 3 [default = true])
            exclude_same_video_shots=bool(p.get("exclude_same_video_shots",
                                                True)))
        return [out["mean_ap"], out["hit_at_1"], out["hit_at_5"]]
    return _no_params, apply


@register("EUCLIDEAN_LOSS", loss_weights=(1.0,))
def _euclidean():
    def apply(params, inputs, cfg, ctx):
        l1 = bool(cfg.get_msg("euclidean_loss_param").get("l1", False))
        return [losses.euclidean_loss(inputs[0], inputs[1], l1=l1)]
    return _no_params, apply


def _rows(x):
    return x.reshape(x.shape[0], -1)


@register("HINGE_LOSS", loss_weights=(1.0,))
def _hinge():
    def apply(params, inputs, cfg, ctx):
        norm = cfg.get_msg("hinge_loss_param").get("norm", "L1")
        return [losses.hinge_loss(_rows(inputs[0]), inputs[1], norm=norm)]
    return _no_params, apply


@register("SOFTMAX_LOSS", loss_weights=(1.0,))
def _softmax_loss():
    def apply(params, inputs, cfg, ctx):
        return [losses.softmax_loss(_rows(inputs[0]), inputs[1])]
    return _no_params, apply


@register("MULTINOMIAL_LOGISTIC_LOSS", loss_weights=(1.0,))
def _multinomial_logistic():
    def apply(params, inputs, cfg, ctx):
        return [losses.multinomial_logistic_loss(_rows(inputs[0]), inputs[1])]
    return _no_params, apply


@register("SIGMOID_CROSS_ENTROPY_LOSS", loss_weights=(1.0,))
def _sigmoid_cross_entropy():
    def apply(params, inputs, cfg, ctx):
        return [losses.sigmoid_cross_entropy_loss(inputs[0], inputs[1])]
    return _no_params, apply


@register("INFOGAIN_LOSS", loss_weights=(1.0,))
def _infogain():
    def apply(params, inputs, cfg, ctx):
        # the matrix: infogain_loss_param.source, read into ctx.side by
        # the Net
        h = ctx.side.get(cfg.get("name"))
        if h is None:
            raise ValueError("INFOGAIN_LOSS needs its infogain matrix in "
                             "ctx.side")
        return [losses.infogain_loss(_rows(inputs[0]), inputs[1], h)]
    return _no_params, apply


@register("CONTRASTIVE_LOSS", loss_weights=(1.0,))
def _contrastive():
    def apply(params, inputs, cfg, ctx):
        margin = float(cfg.get_msg("contrastive_loss_param").get("margin", 1.0))
        return [losses.contrastive_loss(inputs[0], inputs[1], inputs[2],
                                        margin=margin)]
    return _no_params, apply


@register("ACCURACY", loss_weights=(0.0,))
def _accuracy():
    def apply(params, inputs, cfg, ctx):
        top_k = int(cfg.get_msg("accuracy_param").get("top_k", 1))
        # equal rows on every rank of a batch shard: losses.accuracy
        # averages the ranks' means
        return [losses.accuracy(_rows(inputs[0]), inputs[1], top_k=top_k)]
    return _no_params, apply


def _whole_batch(inputs):
    """A stats layer's bottoms on a batch shard: every rank's rows gathered
    (ranks, medians and mAP are not means of the ranks' values); they carry
    no gradient (loss weight 0)."""
    if collectives.axis("data") is None:
        return inputs
    return [collectives.data_gather(x.detach(), 0) for x in inputs]


def _rank_tops(out: dict) -> list:
    return [out["median_rank"], out["recall_at_1"], out["recall_at_5"],
            out["recall_at_10"], out["mean_ap"]]


@register("RETRIEVAL_RANK_STATS", loss_weights=(0.0,) * 5)
def _retrieval_rank_stats():
    def apply(params, inputs, cfg, ctx):
        p = cfg.get_msg("retrieval_rank_stats_param")
        inputs = _whole_batch(inputs)
        return _rank_tops(retrieval_metrics.retrieval_rank_stats(
            _rows(inputs[0]), _rows(inputs[1]),
            compute_ap=bool(p.get("compute_ap", False)),
            positive_size=int(p.get("positive_size", 0)),
            negative_size=int(p.get("negative_size", 0))))
    return _no_params, apply


@register("RETRIEVAL_RANK_STATS_FIXED_REF", loss_weights=(0.0,) * 5)
def _retrieval_rank_stats_fixed_ref():
    def apply(params, inputs, cfg, ctx):
        inputs = _whole_batch(inputs)
        return _rank_tops(retrieval_metrics.retrieval_rank_stats_fixed_ref(
            _rows(inputs[0]), inputs[1].reshape(-1).to(torch.int32),
            _rows(inputs[2]), inputs[3].reshape(-1).to(torch.int32)))
    return _no_params, apply


@register("CLASSIFICATION_STATS", loss_weights=(0.0, 0.0, 0.0))
def _classification_stats():
    def apply(params, inputs, cfg, ctx):
        inputs = _whole_batch(inputs)
        num_classes = int(cfg.get_msg("classification_stats_param")
                          .get("num_classes", inputs[0].shape[1]))
        out = classification_stats(_rows(inputs[0]), inputs[1],
                                   num_classes=num_classes)
        return [out["per_class_accuracy"], out["per_class_ap"],
                out["accuracy"]]
    return _no_params, apply


@register("SOCIAL_POOLING")
def _social_pooling():
    def init(generator, cfg, in_shapes):
        f = int(cfg.get_msg("social_pooling_param").get("pool_feat_size", 32))
        # the reference fills w and b with the inner_product fillers when
        # given; without a weight filler, a gaussian of std 0.1
        ip = cfg.get_msg("inner_product_param")
        wfill = fillers.get_filler(ip.get_msg("weight_filler")
                                   if ip.has("weight_filler") else
                                   {"type": "gaussian", "std": 0.1})
        return {"w": wfill(generator, (2, f)),
                "b": _filler(ip, "bias_filler")(generator, (f,))}

    def apply(params, inputs, cfg, ctx):
        # bottoms: features (1, B, D[, 1]), relations (1, B, B)[, mean
        # (1, B, 2)]
        if collectives.axis("data") is not None:
            # every agent's row pools over every other agent of its scene
            raise ValueError(
                f"SOCIAL_POOLING {cfg.get('name')!r} couples the agents of "
                "its batch; it does not run on a batch shard (a mesh data "
                "axis of more than one rank)")
        x = inputs[0]
        feats = x if x.dim() == 2 else x.reshape(x.shape[1], -1)
        b = feats.shape[0]
        rel = inputs[1].reshape(b, b)
        mean_pos = inputs[2].reshape(b, 2) if len(inputs) > 2 else None
        out = social_pooling(feats, rel, params["w"], params["b"], mean_pos)
        return [out.reshape(1, b, -1, 1)]

    return init, apply


# ---------------------------------------------------------------------------
# LSTM family
# ---------------------------------------------------------------------------
# The reference layers carry (cell, hidden) state across forward calls
# (next_cell_/next_out_, ref lstm_layer.cpp:171-173,261-264). The Net keeps
# it as an explicit carry: LSTM and LSTM_LINEAR read ctx.state_in[name]
# (the zero state when absent, the reference's initial zero buffers) and
# write their final LstmState into ctx.state_out[name]. train threads the
# dict across batches, detached; cont bits still decide whether a carried
# state is used at a sequence start. No Pallas kernel is on this path in
# the JAX package: the products are ops.linear.dot's (TF32 off).

def _lstm_init(generator, cfg, in_shapes, *, conditional=False):
    ip = cfg.get_msg("inner_product_param")
    lstm_p = cfg.get_msg("lstm_param")
    hidden = int(ip.get("num_output"))
    input_dim = 1
    for d in in_shapes[0][2:]:
        input_dim *= int(d)
    # FillerParameter's std defaults to 1 (ref caffe.proto) when a
    # weight_filler is given without one; with no filler at all the
    # reference would zero-init (constant filler), so, as in JAX, a
    # gaussian of std 0.1. The filler's type is not read: always gaussian
    std = (float(ip.get_msg("weight_filler").get("std", 1.0))
           if ip.has("weight_filler") else 0.1)
    return recurrent.init_lstm_params(
        generator, input_dim, hidden, weight_std=std,
        output_dim=int(lstm_p.get("final_output_size", 1)),  # ref default 1
        conditional=conditional)


def _lstm_args(cfg) -> dict:
    # the proto default is 1 (ref caffe.proto LstmParameter
    # clipping_threshold [default = 1]): the reference clips by default
    return {"clip_threshold": float(
        cfg.get_msg("lstm_param").get("clipping_threshold", 1.0))}


def _as_tbi(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def _as_tb(c):
    return c.reshape(c.shape[0], c.shape[1])


def _stateful_lstm(linear: bool):
    def init(generator, cfg, in_shapes):
        return _lstm_init(generator, cfg, in_shapes)

    def apply(params, inputs, cfg, ctx):
        name = cfg.get("name")
        h, fin = recurrent.lstm(params, _as_tbi(inputs[0]), _as_tb(inputs[1]),
                                state=(ctx.state_in or {}).get(name),
                                linear=linear, **_lstm_args(cfg))
        ctx.state_out[name] = fin
        return [h]

    return init, apply


@register("LSTM")
def _lstm():
    return _stateful_lstm(linear=False)


@register("LSTM_LINEAR")
def _lstm_linear():
    return _stateful_lstm(linear=True)


@register("LSTM_ENC_DEC")
def _lstm_enc_dec():
    def init(generator, cfg, in_shapes):
        enc = _lstm_init(generator, cfg, [in_shapes[0]])
        dec = _lstm_init(generator, cfg, [in_shapes[2]])
        return {**{f"enc_{k}": v for k, v in enc.items()},
                **{f"dec_{k}": v for k, v in dec.items()}}

    def apply(params, inputs, cfg, ctx):
        enc = {k[4:]: v for k, v in params.items() if k.startswith("enc_")}
        dec = {k[4:]: v for k, v in params.items() if k.startswith("dec_")}
        enc_h, dec_h = recurrent.lstm_enc_dec(
            enc, dec, _as_tbi(inputs[0]), _as_tb(inputs[1]),
            _as_tbi(inputs[2]), _as_tb(inputs[3]), **_lstm_args(cfg))
        return [enc_h, dec_h]

    return init, apply


@register("LSTM_CONDITIONAL")
def _lstm_conditional():
    def init(generator, cfg, in_shapes):
        return _lstm_init(generator, cfg, in_shapes, conditional=True)

    def apply(params, inputs, cfg, ctx):
        # bottoms: data (T, B, I), cont (T, B), first_input (B, O)
        first = inputs[2].reshape(inputs[2].shape[0], -1)
        out, _ = recurrent.lstm_conditional(
            params, _as_tbi(inputs[0]), first, _as_tb(inputs[1]),
            **_lstm_args(cfg))
        return [out]

    return init, apply


@register("LSTM_SINGLE_STEP")
def _lstm_single_step():
    def init(generator, cfg, in_shapes):
        # bottom[0] is (B, I)
        return _lstm_init(generator, cfg, [(1,) + tuple(in_shapes[0])])

    def apply(params, inputs, cfg, ctx):
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        state = None
        if len(inputs) >= 3:
            state = recurrent.LstmState(
                inputs[1].reshape(inputs[1].shape[0], -1),
                inputs[2].reshape(inputs[2].shape[0], -1))
        h, c = recurrent.lstm_single_step(params, x, state, **_lstm_args(cfg))
        return [h, c]

    return init, apply


# ---------------------------------------------------------------------------
# DUMMY_DATA
# ---------------------------------------------------------------------------

@register("DUMMY_DATA")
def _dummy_data():
    def apply(params, inputs, cfg, ctx):
        """A filler-driven layer, not a pipeline input (Caffe
        dummy_data_layer.cpp:31-55): a constant filler fills once (the same
        values every forward); any other refills on every forward. Top i is
        drawn from a generator seeded by the layer's salt crc32(name) and i
        (iteration_seed), XORed with the seed of the step's generator, which
        train reseeds every iteration: JAX folds the same salt into the
        step's key. Without a generator the fill depends on the layer and
        the top alone. The streams are torch's, not threefry's."""
        p = cfg.get_msg("dummy_data_param")
        dims = [[int(v) for v in p.get_list(k)]
                for k in ("num", "channels", "height", "width")]
        fill_cfgs = p.get_list("data_filler")
        salt = zlib.crc32(str(cfg.get("name")).encode())
        step = ctx.generator.initial_seed() if ctx.generator is not None else 0
        dev = torch.device(ctx.device if ctx.device is not None else "cpu")
        outs = []
        for i in range(len(cfg.get_list("top"))):
            shape = tuple(d[i] if i < len(d) else d[0] for d in dims)
            if dev.type == "meta":
                outs.append(torch.empty(shape, device=dev))
                continue
            fcfg = fill_cfgs[i] if i < len(fill_cfgs) else (
                fill_cfgs[0] if fill_cfgs else None)
            gen = torch.Generator(device=dev).manual_seed(
                iteration_seed(salt, i) ^ step)
            outs.append(fillers.get_filler(fcfg)(gen, shape))
        return outs
    return _no_params, apply
