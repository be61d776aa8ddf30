"""The port's reductions (videovector_tpu_torch.ops.reductions: sum_reduce,
eltwise_prod with both backwards, eltwise_sum, eltwise_max) against the JAX
package's, on the CPU: values within 1e-6 and gradients within 1e-6
relative, on the inputs of tests/test_ops.py, and the division backward's
NaN pattern at zeros equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu import ops as jops
from videovector_tpu_torch.ops import reductions as tred


def _close(got, ref, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _value_and_grads(jfn, tfn, xs, g):
    """fn(*xs) and the gradients of sum(fn(*xs) * g) in both packages."""
    jx = [jnp.asarray(x) for x in xs]
    jv, vjp = jax.vjp(jfn, *jx)
    jg = vjp(jnp.asarray(g))
    tx = [_t(x) for x in xs]
    tv = tfn(*tx)
    tv.backward(torch.as_tensor(g))
    return (tv.detach().numpy(), [t.grad.numpy() for t in tx],
            np.asarray(jv), [np.asarray(v) for v in jg])


@pytest.mark.parametrize("num_output", [1, 10])
def test_sum_reduce_matches_jax(rng, num_output):
    x = rng.randn(4, 3, 2, 1).astype(np.float32)
    g = rng.randn(4, num_output).astype(np.float32)
    tv, tg, jv, jg = _value_and_grads(
        lambda a: jops.sum_reduce(a, num_output),
        lambda a: tred.sum_reduce(a, num_output), [x], g)
    assert tv.shape == (4, num_output)
    _close(tv, jv)
    _close(tg[0], jg[0])
    # backward of the broadcast is the sum over the broadcast axis
    _close(tg[0], np.broadcast_to(g.sum(1)[:, None, None, None], x.shape))


@pytest.mark.parametrize("op", ["prod", "prod_div", "sum", "sum_coeff", "max"])
@pytest.mark.parametrize("n_inputs", [2, 3])
def test_eltwise_matches_jax(rng, op, n_inputs):
    xs = [rng.randn(3, 4).astype(np.float32) for _ in range(n_inputs)]
    g = rng.randn(3, 4).astype(np.float32)
    coeffs = [0.25, 0.75, -1.5][:n_inputs]
    jfn, tfn = {
        "prod": (jops.eltwise_prod, tred.eltwise_prod),
        "prod_div": (lambda *a: jops.eltwise_prod(*a, stable_grad=False),
                     lambda *a: tred.eltwise_prod(*a, stable_grad=False)),
        "sum": (jops.eltwise_sum, tred.eltwise_sum),
        "sum_coeff": (lambda *a: jops.eltwise_sum(*a, coeffs=coeffs),
                      lambda *a: tred.eltwise_sum(*a, coeffs=coeffs)),
        "max": (jops.eltwise_max, tred.eltwise_max),
    }[op]
    tv, tg, jv, jg = _value_and_grads(jfn, tfn, xs, g)
    _close(tv, jv)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_eltwise_max_tie_splits_the_gradient_as_jax():
    a = np.array([[1.0, 2.0, 3.0]], np.float32)
    b = np.array([[1.0, 0.0, 3.0]], np.float32)
    g = np.ones((1, 3), np.float32)
    _, tg, _, jg = _value_and_grads(jops.eltwise_max, tred.eltwise_max,
                                    [a, b], g)
    for x, y in zip(tg, jg):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tg[0], [[0.5, 1.0, 0.5]])


def test_prod_division_grad_nan_pattern_at_zeros_equals_jax(rng):
    """stable_prod_grad false: (out / x_i) * g is 0/0 = NaN exactly where
    x_i is 0 (the reference's documented hazard); the stable backward stays
    finite there. Both NaN patterns and values equal JAX's."""
    a = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(4, 3).astype(np.float32)
    a[0, 0] = 0.0
    b[2, 1] = 0.0
    g = np.full((4, 3), 2.0, np.float32)
    for stable in (True, False):
        _, tg, _, jg = _value_and_grads(
            lambda x, y: jops.eltwise_prod(x, y, stable_grad=stable),
            lambda x, y: tred.eltwise_prod(x, y, stable_grad=stable),
            [a, b], g)
        for x, y in zip(tg, jg):
            np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
            _close(np.nan_to_num(x), np.nan_to_num(y))
        if stable:
            assert all(np.isfinite(x).all() for x in tg)
            _close(tg[0], 2 * b)
        else:
            assert np.isnan(tg[0][0, 0]) and np.isnan(tg[1][2, 1])
            assert np.isnan(tg[0]).sum() == 1 and np.isnan(tg[1]).sum() == 1


def test_eltwise_sum_coeff_count_checked():
    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="coeff count"):
        tred.eltwise_sum(x, x, coeffs=[1.0])
    # a single input needs no custom backward
    assert tred.eltwise_prod(x, stable_grad=False) is x
