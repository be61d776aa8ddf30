"""The LSTM family; counterpart of videovector_tpu/ops/recurrent.py.

Reference implementations (hand-written BPTT in C++/CUDA):
  ref:src/caffe/layers/lstm_layer.cpp            (the cell, the carry)
  ref:src/caffe/layers/lstm_enc_dec_layer.cpp    (seq2seq composition)
  ref:src/caffe/layers/lstm_conditional_layer.cpp (output fed back as input)
  ref:src/caffe/layers/lstm_linear_layer.cpp     (no tanh on g gate / cell out)
  ref:src/caffe/layers/lstm_single_step_layer.cpp

The input projection x.W_i of ALL timesteps is one (T.B, I) x (I, 4H)
product before the loop (the reference does the same with 4 GEMMs,
lstm_layer.cpp:176-196); each timestep then runs the (B, H) x (H, 4H)
recurrent product and the elementwise cell. The time loop is a Python loop
of eager ops (JAX's lax.scan); autograd replaces the hand BPTT. Every
product goes through ops.linear.dot: f32 sums, TF32 off in forward and
backward. No Pallas kernel is on this path in the JAX package, so none is
here: the products are cuBLAS's, the cell PyTorch's elementwise ops.

Semantics kept:
- gate order [i, f, o, g]; i/f/o sigmoid, g tanh (lstm_layer.cpp:240-247)
- per-timestep continuation bits `cont` (T, B): h_{t-1} and c_{t-1} are
  multiplied by cont[t]; 0 starts a new sequence mid-batch (:221-257)
- cross-batch state carry: the final (c, h) is returned for the caller to
  thread into the next batch (the reference keeps next_cell_/next_out_
  inside the layer, :268-271); the caller detaches it between batches
  (truncated BPTT: the reference's backward never crosses a batch)
- forget-gate bias initialized to 5.0 (:94-96)
- gradient clipping of the pre-gate activations (`grad_clip`, caffe_bound
  in BPTT, :378-389)

Parameter layout: w_i (I, 4H), w_h (H, 4H), b (4H,), column blocks in gate
order; data/weights.py converts Caffe's (1, 4, H, I) blobs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from videovector_tpu_torch.ops.linear import dot


class LstmState(NamedTuple):
    c: torch.Tensor   # (B, H)
    h: torch.Tensor   # (B, H)


def zero_state(batch: int, hidden: int, dtype=torch.float32,
               device=None) -> LstmState:
    return LstmState(torch.zeros((batch, hidden), dtype=dtype, device=device),
                     torch.zeros((batch, hidden), dtype=dtype, device=device))


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, threshold):
        ctx.threshold = threshold
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # jnp.clip's values: a gradient at exactly +-threshold passes as it is
        return torch.clamp(g, -ctx.threshold, ctx.threshold), None


def grad_clip(x, threshold: float):
    """Identity forward; the backward clamps the gradient to
    [-threshold, threshold] (ref caffe_bound on pre-gate diffs,
    lstm_layer.cpp:378-389)."""
    return _GradClip.apply(x, threshold)


def init_lstm_params(generator: torch.Generator, input_dim: int, hidden: int,
                     *, weight_std: float = 0.1, forget_bias: float = 5.0,
                     output_dim: int | None = None,
                     conditional: bool = False) -> dict:
    """Gaussian weights and the forget bias 5 (ref lstm_layer.cpp:70-97),
    drawn from `generator` (on its device) in the order w_i, w_h[, w_h2o,
    w_o2h]. With `conditional`, the h2o/o2h projections
    (ref lstm_conditional_layer.cpp:24-60)."""
    dev = generator.device

    def normal(*shape):
        return weight_std * torch.randn(shape, generator=generator, device=dev)

    b = torch.zeros((4 * hidden,), device=dev)
    b[hidden:2 * hidden] = forget_bias
    p = {"w_i": normal(input_dim, 4 * hidden),
         "w_h": normal(hidden, 4 * hidden), "b": b}
    if conditional:
        o = output_dim or input_dim
        p["w_h2o"] = normal(hidden, o)
        p["b_h2o"] = torch.zeros((o,), device=dev)
        p["w_o2h"] = normal(o, 4 * hidden)
        p["b_o2h"] = torch.zeros((4 * hidden,), device=dev)
    return p


def _cell(pre, c_prev_masked, hidden: int, *, linear: bool,
          clip_threshold: float):
    """pre: (B, 4H) pre-gate activations (every projection included).
    i, f and o are one sigmoid over the first 3H columns (elementwise, so
    the values are JAX's three sigmoids')."""
    if clip_threshold > 0:
        pre = grad_clip(pre, clip_threshold)
    ifo = torch.sigmoid(pre[:, :3 * hidden])
    i, f, o = ifo[:, :hidden], ifo[:, hidden:2 * hidden], ifo[:, 2 * hidden:]
    g_pre = pre[:, 3 * hidden:]
    g = g_pre if linear else torch.tanh(g_pre)
    c = f * c_prev_masked + i * g
    h = o * (c if linear else torch.tanh(c))
    return c, h


def _f32_state(state: LstmState | None, b: int, hidden: int,
               device) -> LstmState:
    # the carries stay f32 (the sum's dtype) whatever the params' dtype
    if state is None:
        return zero_state(b, hidden, device=device)
    return LstmState(state.c.float(), state.h.float())


def _input_projection(params, x):
    t, b, i_dim = x.shape
    pre_x = dot(x.reshape(t * b, i_dim), params["w_i"]) + params["b"]
    return pre_x.reshape(t, b, -1).float()


def _step_masks(cont):
    """cont (T, B) -> T masks (B, 1) in f32. The loops take their
    timesteps, of these and of the input projection, through unbind: its
    backward stacks the T gradients once, where indexing pre_x[step] would
    give each step's gradient a zero tensor of the whole (T, B, 4H) to be
    summed."""
    return cont.float()[:, :, None].unbind(0)


def lstm(params, x, cont, state: LstmState | None = None, *,
         clip_threshold: float = 0.0, linear: bool = False):
    """x: (T, B, I); cont: (T, B) continuation bits.
    Returns (h_all (T, B, H), final LstmState)."""
    b = x.shape[1]
    hidden = params["w_h"].shape[0]
    c, h = _f32_state(state, b, hidden, x.device)
    pre_x = _input_projection(params, x)
    hs = []
    for pre_t, mask in zip(pre_x.unbind(0), _step_masks(cont)):
        pre = pre_t + dot(h * mask, params["w_h"])
        c, h = _cell(pre, c * mask, hidden, linear=linear,
                     clip_threshold=clip_threshold)
        hs.append(h)
    return torch.stack(hs), LstmState(c, h)


def lstm_single_step(params, x, state: LstmState | None = None, *,
                     clip_threshold: float = 0.0, linear: bool = False):
    """One step (ref lstm_single_step_layer.cpp): x (B, I), an optional
    state -> (h (B, H), c (B, H))."""
    b = x.shape[0]
    hidden = params["w_h"].shape[0]
    if state is None:
        state = zero_state(b, hidden, x.dtype, x.device)
    pre = dot(x, params["w_i"]) + params["b"] + dot(state.h, params["w_h"])
    c, h = _cell(pre, state.c, hidden, linear=linear,
                 clip_threshold=clip_threshold)
    return h, c


def lstm_enc_dec(enc_params, dec_params, enc_x, enc_cont, dec_x, dec_cont, *,
                 clip_threshold: float = 0.0):
    """Seq2seq (ref lstm_enc_dec_layer.cpp:21-207): the encoder runs, its
    final CELL seeds the decoder's (the decoder's hidden state starts at
    zero), the decoder runs. Returns (enc_h, dec_h). The reference copies
    the decoder's initial-cell gradient back into the encoder by hand
    (:186-187); here autograd follows the data dependency."""
    enc_h, enc_state = lstm(enc_params, enc_x, enc_cont,
                            clip_threshold=clip_threshold)
    b = dec_x.shape[1]
    hidden = dec_params["w_h"].shape[0]
    dec_state = LstmState(enc_state.c, torch.zeros(
        (b, hidden), dtype=dec_x.dtype, device=dec_x.device))
    dec_h, _ = lstm(dec_params, dec_x, dec_cont, state=dec_state,
                    clip_threshold=clip_threshold)
    return enc_h, dec_h


def lstm_conditional(params, x, first_input, cont,
                     state: LstmState | None = None, *,
                     clip_threshold: float = 0.0):
    """Self-feeding decoder (ref lstm_conditional_layer.cpp:169-345):
    pre-gates = x.W_i + b + prev_output.W_o2h + b_o2h + (cont.h).W_h, where
    prev_output is `first_input` at t = 0 and the previous timestep's
    output after it (fed back unmasked: cont masks only h and c);
    output_t = h_t.W_h2o + b_h2o.

    x: (T, B, I); first_input: (B, O); cont: (T, B).
    Returns (outputs (T, B, O), final LstmState)."""
    b = x.shape[1]
    hidden = params["w_h"].shape[0]
    c, h = _f32_state(state, b, hidden, x.device)
    out = first_input.float()
    pre_x = _input_projection(params, x)
    outs = []
    for pre_t, mask in zip(pre_x.unbind(0), _step_masks(cont)):
        pre = (pre_t + dot(out, params["w_o2h"]) + params["b_o2h"]
               + dot(h * mask, params["w_h"]))
        c, h = _cell(pre, c * mask, hidden, linear=False,
                     clip_threshold=clip_threshold)
        out = (dot(h, params["w_h2o"]) + params["b_h2o"]).float()
        outs.append(out)
    return torch.stack(outs), LstmState(c, h)
