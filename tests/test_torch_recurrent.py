"""The port's LSTM family (videovector_tpu_torch.ops.recurrent) against the
JAX package's (videovector_tpu.ops.recurrent) on the CPU.

The same seeded numpy params, inputs and cotangents go to both. Values are
held within rtol 1e-5 / atol 1e-6 and the gradients of every param, input
and carried state within rtol 1e-4 / atol 1e-5, in f32 (the two loops sum
in other orders over up to 12 timesteps). grad_clip's gradient is held bit
for bit, exactly at +-threshold too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu.ops import recurrent as jrec
from videovector_tpu_torch.ops import recurrent as trec

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-5


def _params(rng, i, h, *, conditional=False, o=2, std=0.3):
    p = {"w_i": rng.randn(i, 4 * h) * std, "w_h": rng.randn(h, 4 * h) * std,
         "b": rng.randn(4 * h) * 0.1}
    p["b"][h:2 * h] += 5.0
    if conditional:
        p.update(w_h2o=rng.randn(h, o) * std, b_h2o=rng.randn(o) * 0.1,
                 w_o2h=rng.randn(o, 4 * h) * std, b_o2h=rng.randn(4 * h) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _cont(rng, t, b):
    cont = np.ones((t, b), np.float32)
    cont[0, 0] = 0.0
    cont[t // 2, 1:] = 0.0       # sequences restart mid-batch
    return cont


def _compare(jfn, tfn, floats: dict, cot_seed: int):
    """jfn(**jnp floats) and tfn(**torch floats) each return a list of
    arrays; held equal in value, and in the gradient of every float input
    of sum(out_k * cot_k) with seeded cotangents."""
    jin = {k: jax.tree.map(jnp.asarray, v) for k, v in floats.items()}
    jout = jfn(**jin)
    cr = np.random.RandomState(cot_seed)
    cots = [cr.randn(*np.shape(o)).astype(np.float32) for o in jout]

    def scalar(f):
        return sum(jnp.sum(o * c) for o, c in zip(jfn(**f), cots))
    jgrads = jax.grad(scalar)(jin)

    def leaf(a):
        return torch.tensor(np.asarray(a), requires_grad=True)
    tin = {k: ({n: leaf(a) for n, a in v.items()} if isinstance(v, dict)
               else leaf(v)) for k, v in floats.items()}
    tout = tfn(**tin)
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL)
    sum((t * torch.as_tensor(c)).sum() for t, c in zip(tout, cots)).backward()
    for k, v in tin.items():
        pairs = ([(v[n], jgrads[k][n]) for n in v] if isinstance(v, dict)
                 else [(v, jgrads[k])])
        for t, j in pairs:
            # an input the function does not read: JAX's zeros, torch's None
            g = t.grad.numpy() if t.grad is not None else np.zeros(t.shape)
            np.testing.assert_allclose(g, np.asarray(j), rtol=G_RTOL,
                                       atol=G_ATOL)


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("carried", [False, True])
def test_lstm_matches_jax(rng, linear, clip, carried):
    """cont zeros mid-batch, with and without a carried state (whose
    gradients are compared too), the linear variant (LSTM_LINEAR), and a
    clipping threshold small enough that the clamp bites."""
    t, b, i, h = 7, 4, 5, 6
    floats = {"params": _params(rng, i, h),
              "x": rng.randn(t, b, i).astype(np.float32),
              "c0": rng.randn(b, h).astype(np.float32),
              "h0": rng.randn(b, h).astype(np.float32)}
    cont = _cont(rng, t, b)

    def run(mod, as_arr):
        def fn(params, x, c0, h0):
            st = mod.LstmState(c0, h0) if carried else None
            out, fin = mod.lstm(params, x, as_arr(cont), st,
                                clip_threshold=clip, linear=linear)
            return [out, fin.c, fin.h]
        return fn
    _compare(run(jrec, jnp.asarray), run(trec, torch.as_tensor), floats, 3)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("linear", [False, True])
def test_lstm_single_step_matches_jax(rng, with_state, linear):
    b, i, h = 5, 4, 3
    floats = {"params": _params(rng, i, h),
              "x": rng.randn(b, i).astype(np.float32),
              "c0": rng.randn(b, h).astype(np.float32),
              "h0": rng.randn(b, h).astype(np.float32)}

    def run(mod):
        def fn(params, x, c0, h0):
            st = mod.LstmState(c0, h0) if with_state else None
            return list(mod.lstm_single_step(params, x, st, linear=linear,
                                             clip_threshold=0.1))
        return fn
    _compare(run(jrec), run(trec), floats, 4)


def test_lstm_enc_dec_matches_jax(rng):
    """The decoder's cell is seeded with the encoder's final cell, its
    hidden state with zeros; gradients reach the encoder through the cell."""
    te, td, b, i, h = 6, 4, 3, 5, 4
    floats = {"enc": _params(rng, i, h), "dec": _params(rng, i, h),
              "ex": rng.randn(te, b, i).astype(np.float32),
              "dx": rng.randn(td, b, i).astype(np.float32)}
    ec, dc = _cont(rng, te, b), np.ones((td, b), np.float32)

    def run(mod, as_arr):
        def fn(enc, dec, ex, dx):
            return list(mod.lstm_enc_dec(enc, dec, ex, as_arr(ec), dx,
                                         as_arr(dc), clip_threshold=5.0))
        return fn
    _compare(run(jrec, jnp.asarray), run(trec, torch.as_tensor), floats, 5)


@pytest.mark.parametrize("carried", [False, True])
def test_lstm_conditional_matches_jax(rng, carried):
    """The previous output is fed back unmasked; cont masks h and c only."""
    t, b, i, h, o = 6, 3, 4, 5, 2
    floats = {"params": _params(rng, i, h, conditional=True, o=o),
              "x": rng.randn(t, b, i).astype(np.float32),
              "first": rng.randn(b, o).astype(np.float32),
              "c0": rng.randn(b, h).astype(np.float32),
              "h0": rng.randn(b, h).astype(np.float32)}
    cont = _cont(rng, t, b)

    def run(mod, as_arr):
        def fn(params, x, first, c0, h0):
            st = mod.LstmState(c0, h0) if carried else None
            out, fin = mod.lstm_conditional(params, x, first, as_arr(cont),
                                            st, clip_threshold=1.0)
            return [out, fin.c, fin.h]
        return fn
    _compare(run(jrec, jnp.asarray), run(trec, torch.as_tensor), floats, 6)


def test_grad_clip_gradient_matches_jax_at_the_threshold():
    """The upstream gradient clamped to [-t, t], as jnp.clip gives it: a
    gradient at exactly +-t passes unchanged, beyond it is cut, and the
    forward is the identity."""
    t = 0.5
    f = np.float32(t)
    below, above = np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(1))
    up = np.array([-2.0, -t, -below, 0.0, 0.25, below, t, above, 3.0],
                  np.float32)
    assert below < t < above
    x = np.linspace(-1, 1, up.size).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jrec.grad_clip(v, t) * up))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    y = trec.grad_clip(tx, t)
    assert torch.equal(y.detach(), torch.as_tensor(x))
    (y * torch.as_tensor(up)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tx.grad.numpy(), np.clip(up, -t, t))


@pytest.mark.parametrize("conditional", [False, True])
def test_init_statistics_and_forget_bias(conditional):
    """The port's init: JAX's shapes, the forget block of b at 5 and the
    rest 0, gaussian weights of the asked std (drawn from the generator:
    the streams are torch's, so the statistics are compared)."""
    i, h, o = 64, 48, 7
    gen = torch.Generator().manual_seed(0)
    p = trec.init_lstm_params(gen, i, h, weight_std=0.2, output_dim=o,
                              conditional=conditional)
    jp = jrec.init_lstm_params(jax.random.PRNGKey(0), i, h, weight_std=0.2,
                               output_dim=o, conditional=conditional)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("b", "b_h2o", "b_o2h"):
        if k in p:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    assert torch.all(p["b"][h:2 * h] == 5.0)
    for k in ("w_i", "w_h", "w_h2o", "w_o2h"):
        if k in p:
            w = p[k]
            assert abs(w.mean().item()) < 0.02, k
            assert abs(w.std().item() / 0.2 - 1) < 0.1, k
    # the draws come from the generator: the same seed, the same params
    q = trec.init_lstm_params(torch.Generator().manual_seed(0), i, h,
                              weight_std=0.2, output_dim=o,
                              conditional=conditional)
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_zero_state():
    st = trec.zero_state(3, 4)
    assert isinstance(st, trec.LstmState)
    assert st.c.shape == st.h.shape == (3, 4) and not st.c.any()
