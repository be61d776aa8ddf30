"""Post-training int8 quantization for the frozen serving path; counterpart
of videovector_tpu/tools/quantize.py.

An extension beyond the reference (which serves f32 only,
ref:tools/extract_features.cpp). The scheme is the standard symmetric one:

- weights: per-output-channel scales (conv OIHW -> per O; INNER_PRODUCT
  (K, N) -> per column N), w_q = round(w / s_w) clipped to +-127, stored
  int8: the artifact shrinks 4x too.
- activations: per-tensor scales from a CALIBRATION pass: run the f32 net
  on sample batches, record each quantized layer's input absmax
  (s_x = absmax / 127), quantize on the fly at serve time.
- the mode of each layer is the JAX package's rule: "int8" for
  INNER_PRODUCT (an exact int8 x int8 -> int32 product, then y * (s_x *
  s_w) + b in f32; ops/quant.py) and "weight_only" for CONVOLUTION (int8
  storage, the weights dequantized to bf16 at call time for K2's sm90
  route).

Accuracy contract: retrieval metrics (mAP / hit@k) on int8 features stay
within 0.02 of the f32 artifact's (tests/test_torch_quantize.py, and
chip_smoke.py's serving_artifact phase on the card).
"""

from __future__ import annotations

import torch

from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

QUANT_LAYER_TYPES = ("INNER_PRODUCT", "CONVOLUTION")


def calibrate(net, params, batches, *, layer_names=None) -> dict:
    """Run the f32 net on `batches` (list of batch dicts of arrays or
    tensors) and return {layer_name: s_x} input scales for every
    quantizable layer.

    A layer's input is its bottom[0] blob; absmax accumulates over all
    calibration batches (max calibration: simple and bias-free for the
    post-ReLU activations this workload feeds into conv/fc). The batches go
    to the params' device."""
    targets = {}
    for layer in net.layers:
        name = layer.get("name")
        if layer.get("type") not in QUANT_LAYER_TYPES:
            continue
        if layer_names is not None and name not in layer_names:
            continue
        bottoms = [str(b) for b in layer.get_list("bottom")]
        if bottoms:
            targets[name] = bottoms[0]

    dev = next(t.device for lp in params.values() for t in lp.values())
    absmax = {name: 0.0 for name in targets}
    for batch in batches:
        with torch.no_grad():
            _, blobs = net.apply(params, {k: torch.as_tensor(v, device=dev)
                                          for k, v in batch.items()},
                                 return_blobs=True)
        for name, bottom in targets.items():
            if bottom not in blobs:
                raise ValueError(
                    f"calibration: layer {name!r} input blob {bottom!r} "
                    f"not among net blobs")
            absmax[name] = max(absmax[name],
                               float(blobs[bottom].abs().max()))
    scales = {}
    for name, m in absmax.items():
        if m == 0.0:
            log.warning("calibration: layer %s saw all-zero inputs; "
                        "skipping quantization for it", name)
            continue
        scales[name] = m / 127.0
    return scales


def quantize_weights(params: dict, net, input_scales: dict) -> dict:
    """The quant side table {layer_name: {"w_q" int8, "s_w" f32 per output
    channel, "s_x" f32 0-d, "mode"}} for every calibrated quantizable
    layer, as tensors on the weights' device (f32 arithmetic with true
    divisions and round half to even: the JAX package's numpy values bit
    for bit).

    Layers whose weights are all zero, or with the INNER_PRODUCT
    `regularization` quirk active, stay f32 (skipped)."""
    types = {l.get("name"): l.get("type") for l in net.layers}
    cfgs = {l.get("name"): l for l in net.layers}
    quant = {}
    for name, s_x in input_scales.items():
        ltype = types.get(name)
        lp = params.get(name)
        if lp is None or "w" not in lp:
            continue
        w = lp["w"].detach().to(torch.float32)
        d127 = torch.tensor(127.0, device=w.device)
        if ltype == "INNER_PRODUCT":
            if float(cfgs[name].get_msg("inner_product_param")
                     .get("regularization", 0.0)) != 0.0:
                continue  # the custom-gradient path: serving never needs it
            s_w = w.abs().amax(dim=0) / d127                     # (N,)
        elif ltype == "CONVOLUTION":
            s_w = w.reshape(w.shape[0], -1).abs().amax(dim=1) / d127  # (O,)
        else:
            continue
        if bool((s_w == 0.0).all()):
            continue
        s_w = torch.where(s_w == 0.0, torch.ones_like(s_w), s_w)
        scale = s_w[None, :] if ltype == "INNER_PRODUCT" \
            else s_w[:, None, None, None]
        w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        # the mode is the JAX package's per-type rule: true int8 math for
        # the fc layers, int8 storage with bf16 math for the convs
        mode = "int8" if ltype == "INNER_PRODUCT" else "weight_only"
        quant[name] = {"w_q": w_q.contiguous(), "s_w": s_w,
                       "s_x": torch.tensor(s_x, dtype=torch.float32,
                                           device=w.device),
                       "mode": mode}
    return quant
