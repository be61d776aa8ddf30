"""The port's vision and neuron ops (videovector_tpu_torch.ops: conv.col2im,
pooling, lrn, activations) against the JAX package's on the CPU.

Inputs and cotangents come from numpy with a seed; each case compares the
values and the gradient of sum(out * cotangent) with respect to the input.
Tolerances: 1e-6 relative to max|ref| for values and gradients of f32 ops
(the two sum in other orders; the neuron ops are elementwise), exact where
the op only moves values (col2im on integers, max pooling, the STOCHASTIC
race's pick). The NHWC max pool is also compared at the serving path's 16
pool geometries (tests/torch_pool_cases.py) in bf16 and f32. STOCHASTIC
pooling's TRAIN branch gets JAX's uniforms through
`pooling.stochastic_uniforms`, as dropout gets JAX's masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pool_cases as pool_cases
from videovector_tpu.ops import activations as jact
from videovector_tpu.ops import conv as jconv
from videovector_tpu.ops import lrn as jlrn
from videovector_tpu.ops import pooling as jpool
from videovector_tpu_torch.ops import activations as tact
from videovector_tpu_torch.ops import conv as tconv
from videovector_tpu_torch.ops import lrn as tlrn
from videovector_tpu_torch.ops import pooling as tpool

torch.set_num_threads(1)
TOL = 1e-6


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _vjp_both(jfn, tfn, x, seed=7):
    """(jax out, port out, jax dx, port dx) for the cotangent drawn from
    `seed`."""
    jx = jnp.asarray(x)
    jout, vjp = jax.vjp(jfn, jx)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    tout = tfn(tx)
    (tdx,) = torch.autograd.grad(tout, tx, torch.as_tensor(cot))
    return np.asarray(jout), tout, np.asarray(jdx), tdx


# -- col2im -------------------------------------------------------------------

@pytest.mark.parametrize("hw,kernel,stride,pad", [
    ((7, 9), (3, 3), (1, 1), (1, 1)), ((11, 8), (5, 3), (2, 3), (2, 0)),
    ((13, 13), (11, 11), (4, 4), (0, 0))])
def test_col2im_matches_jax_and_is_im2cols_adjoint(hw, kernel, stride, pad):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, *hw).astype(np.float32)
    cols = np.asarray(jconv.im2col(jnp.asarray(x), kernel=kernel,
                                   stride=stride, pad=pad))
    _close(tconv.im2col(torch.as_tensor(x), kernel=kernel, stride=stride,
                        pad=pad), cols, 0)
    # integer-valued columns: the scatter-add is exact in any order
    c = rs.randint(-4, 5, cols.shape).astype(np.float32)
    ref = jconv.col2im(jnp.asarray(c), input_hw=hw, kernel=kernel,
                       stride=stride, pad=pad)
    got = tconv.col2im(torch.as_tensor(c), input_hw=hw, kernel=kernel,
                       stride=stride, pad=pad)
    _close(got, ref, 0)
    # <im2col(x), c> == <x, col2im(c)>
    lhs = float((cols.astype(np.float64) * c).sum())
    rhs = float((x.astype(np.float64) * got.numpy()).sum())
    assert abs(lhs - rhs) <= 1e-9 * max(abs(lhs), 1.0) + 1e-3


# -- pooling ------------------------------------------------------------------

# (H, W, kernel, stride, pad): CaffeNet's 55 -> 27 -> 13 -> 6 chain, padded
# windows that clip, ceil windows that overhang, a non-square geometry
POOL_GEOMS = [
    (13, 13, (3, 3), (2, 2), (0, 0)), (12, 10, (3, 3), (2, 2), (1, 1)),
    (9, 11, (2, 3), (2, 1), (1, 0)), (7, 7, (3, 3), (3, 3), (1, 1)),
    (6, 8, (4, 2), (1, 2), (2, 1))]


@pytest.mark.parametrize("geom", POOL_GEOMS)
def test_max_pool_matches_jax(geom):
    h, w, kernel, stride, pad = geom
    x = np.random.RandomState(1).randn(2, 3, h, w).astype(np.float32)
    jout, tout, jdx, tdx = _vjp_both(
        lambda a: jpool.max_pool(a, kernel=kernel, stride=stride, pad=pad),
        lambda a: tpool.max_pool(a, kernel=kernel, stride=stride, pad=pad), x)
    _close(tout, jout, 0)
    _close(tdx, jdx, 0)


def _nhwc_pool_both(x, kernel, stride, pad):
    """(port, JAX) max pools of (N, H, W, C) torch x: the port's
    `max_pool(layout="NHWC")`, JAX's NCHW pool on the permuted input in
    x's dtype, both back as NHWC torch tensors of x's dtype."""
    got = tpool.max_pool(x, kernel=kernel, stride=stride, pad=pad,
                         layout="NHWC")
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[x.dtype]
    jx = jnp.asarray(x.permute(0, 3, 1, 2).float().numpy()).astype(jdt)
    jout = jpool.max_pool(jx, kernel=kernel, stride=stride, pad=pad)
    assert jout.dtype == jdt
    want = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    return got, want.to(x.dtype).permute(0, 2, 3, 1)


def _equal_values(got, want):
    """Equal shapes, dtypes and values at 0 tolerance, NaN where the other
    has NaN. XLA's max takes +0.0 over -0.0 where aten's scan keeps the
    first of the tie, so a window of both zeros reads 0 either way but its
    sign may differ (tests/test_torch_max_pool.py holds the port's signs to
    aten's)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got[keep].float(), want[keep].float())


def _pool_values(shape, dtype, seed):
    """Small integers and halves of both signs, zeros as +0.0 or -0.0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-3, 4, shape, generator=g).float() / 2
    neg = torch.rand(shape, generator=g) < 0.5
    return torch.where((x == 0) & neg, torch.tensor(-0.0), x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", pool_cases.GEOMETRIES, ids=pool_cases.IDS)
def test_nhwc_max_pool_matches_jax_at_the_serving_pools(case, dtype):
    """GoogLeNet's 13 and CaffeNet's 3 pools (tests/torch_pool_cases.py),
    the inception modules' 3x3/1 pad-1 pool among them."""
    hwc, kernel, stride, pad = pool_cases.pool_args(case)
    x = _pool_values((2, *hwc), dtype, seed=sum(hwc) + stride[0])
    _equal_values(*_nhwc_pool_both(x, kernel, stride, pad))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["nan", "negative_zero", "all_neg_inf"])
def test_nhwc_max_pool_matches_jax_at_edge_values(kind, dtype):
    """Planted NaNs (a window that holds one reads NaN in both), windows of
    -0.0 and negatives alone (both read -0.0, bit for bit), and whole
    windows of -inf beside the padding (both read -inf), at the inception
    pool's 3x3/1 pad 1 and at 3x3/2 pad 1."""
    x = _pool_values((2, 14, 14, 24), dtype, seed=len(kind))
    for stride in ((1, 1), (2, 2)):
        if kind == "nan":
            x[0, 3, 4, 5] = x[1, 0, 0, 7] = x[1, 13, 13, 0] = float("nan")
        elif kind == "negative_zero":
            x = torch.where(x >= 0, torch.tensor(-0.0, dtype=dtype), x)
        else:
            x[0, :5, :5] = -float("inf")
        got, want = _nhwc_pool_both(x, (3, 3), stride, (1, 1))
        _equal_values(got, want)
        if kind == "nan":
            assert want.isnan().sum() >= 3
        elif kind == "negative_zero":
            assert pool_cases.same_bits(got, want)
            assert (want.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32) < 0).all()
        else:
            assert (want[0, :2, :2] == -float("inf")).all()


@pytest.mark.parametrize("kernel,stride,pad", [((3, 3), (2, 2), (0, 0)),
                                               ((3, 3), (1, 1), (1, 1)),
                                               ((2, 2), (2, 2), (0, 0))])
def test_nhwc_max_pool_gradient_matches_jax(kernel, stride, pad):
    """A CPU NHWC pool that autograd records takes the plain version, whose
    gradient of sum(pool(x) * g) equals jax.grad of JAX's pool on distinct
    values (no ties): overlapping windows add into x's gradient in both."""
    gen = torch.Generator().manual_seed(sum(kernel) + pad[0])
    x = torch.randn((2, 9, 11, 6), generator=gen, requires_grad=True)
    out = tpool.max_pool(x, kernel=kernel, stride=stride, pad=pad,
                         layout="NHWC")
    g = torch.randn(out.shape, generator=gen)
    (out * g).sum().backward()

    def loss(jx):
        y = jpool.max_pool(jx, kernel=kernel, stride=stride, pad=pad)
        return jnp.sum(y * jnp.asarray(g.permute(0, 3, 1, 2).numpy()))
    want = jax.grad(loss)(jnp.asarray(x.detach().permute(0, 3, 1, 2)
                                      .numpy()))
    assert torch.allclose(x.grad, torch.from_numpy(np.array(want))
                          .permute(0, 2, 3, 1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("geom", POOL_GEOMS)
def test_avg_pool_divides_by_the_padded_window(geom):
    h, w, kernel, stride, pad = geom
    x = np.random.RandomState(2).randn(2, 3, h, w).astype(np.float32)
    jout, tout, jdx, tdx = _vjp_both(
        lambda a: jpool.avg_pool(a, kernel=kernel, stride=stride, pad=pad),
        lambda a: tpool.avg_pool(a, kernel=kernel, stride=stride, pad=pad), x)
    _close(tout, jout)
    _close(tdx, jdx)


def test_avg_pool_edge_divisor_is_not_torchs():
    """At a clipped corner Caffe divides by the window within the padded
    bounds: a 3x3 window at pad 1 over a 2x2 all-ones image holds 4 ones
    and divides by 4 (window rows -1..1 and 1..2 clipped at h + pad = 3),
    where F.avg_pool2d's count_include_pad divides by 9 or by 4 elsewhere."""
    x = np.ones((1, 1, 4, 4), np.float32)
    ref = np.asarray(jpool.avg_pool(jnp.asarray(x), kernel=(3, 3),
                                    stride=(2, 2), pad=(1, 1)))
    got = tpool.avg_pool(torch.as_tensor(x), kernel=(3, 3), stride=(2, 2),
                         pad=(1, 1))
    _close(got, ref, 0)
    assert not np.allclose(ref, 1.0)   # the edge divisor is not the count


def test_avg_pool_keeps_bf16():
    x = torch.randn(1, 2, 7, 7).to(torch.bfloat16)
    assert tpool.avg_pool(x, kernel=(3, 3), stride=(2, 2)).dtype == torch.bfloat16


@pytest.mark.parametrize("geom", POOL_GEOMS[:3])
def test_stochastic_pool_test_branch_matches_jax(geom):
    h, w, kernel, stride, pad = geom
    rs = np.random.RandomState(3)
    x = np.abs(rs.randn(2, 3, h, w)).astype(np.float32) + 0.1
    x[0, 0] = 0.0          # windows of zeros: 0/0 -> 0
    x[1, 1, :2] *= -1.0    # signed windows
    jfn = lambda a: jpool.stochastic_pool(a, kernel=kernel, stride=stride,
                                          pad=pad, deterministic=True)
    tfn = lambda a: tpool.stochastic_pool(a, kernel=kernel, stride=stride,
                                          pad=pad, deterministic=True)
    jout, tout, jdx, tdx = _vjp_both(jfn, tfn, x)
    _close(tout, jout, 1e-6)
    assert np.all(tout.detach().numpy()[0, 0] == 0.0)
    _close(tdx, jdx, 1e-6)
    # no generator is the TEST branch too, at any phase
    _close(tpool.stochastic_pool(torch.as_tensor(x), kernel=kernel,
                                 stride=stride, pad=pad, generator=None,
                                 deterministic=False), jout, 1e-6)


@pytest.mark.parametrize("geom", POOL_GEOMS)
def test_stochastic_pool_train_race_with_jax_uniforms(geom, monkeypatch):
    """Overlapping windows included (stride < kernel): each window's pick is
    JAX's, element for element, given JAX's uniforms."""
    h, w, kernel, stride, pad = geom
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, h, w).astype(np.float32)
    x[1, 2] = -np.abs(x[1, 2])   # no positive value: the first element wins
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, x.shape, minval=1e-6, maxval=1.0))
    monkeypatch.setattr(tpool, "stochastic_uniforms",
                        lambda shape, generator, device: torch.tensor(u))
    jfn = lambda a: jpool.stochastic_pool(a, kernel=kernel, stride=stride,
                                          pad=pad, rng=key,
                                          deterministic=False)
    tfn = lambda a: tpool.stochastic_pool(a, kernel=kernel, stride=stride,
                                          pad=pad, generator=torch.Generator(),
                                          deterministic=False)
    jout, tout, jdx, tdx = _vjp_both(jfn, tfn, x)
    _close(tout, jout, 0)
    _close(tdx, jdx, 0)


def test_stochastic_uniforms_range_and_generator():
    g = torch.Generator().manual_seed(0)
    u = tpool.stochastic_uniforms((1000,), g, "cpu")
    assert u.min() >= 1e-6 and u.max() < 1.0
    assert torch.equal(u, tpool.stochastic_uniforms(
        (1000,), torch.Generator().manual_seed(0), "cpu"))


# -- LRN ----------------------------------------------------------------------

@pytest.mark.parametrize("local_size,alpha,beta", [(5, 1e-4, 0.75),
                                                   (3, 0.5, 0.6), (1, 2.0, 1.0)])
@pytest.mark.parametrize("region", ["across", "within"])
def test_lrn_matches_jax(local_size, alpha, beta, region):
    x = np.random.RandomState(6).randn(2, 7, 6, 5).astype(np.float32) * 3
    jfn = {"across": jlrn.lrn_cross_channel,
           "within": jlrn.lrn_within_channel}[region]
    tfn = {"across": tlrn.lrn_cross_channel,
           "within": tlrn.lrn_within_channel}[region]
    kw = dict(local_size=local_size, alpha=alpha, beta=beta)
    jout, tout, jdx, tdx = _vjp_both(lambda a: jfn(a, **kw),
                                     lambda a: tfn(a, **kw), x)
    _close(tout, jout)
    _close(tdx, jdx, 2e-6)


@pytest.mark.parametrize("fn", [tlrn.lrn_cross_channel, tlrn.lrn_within_channel])
def test_lrn_refuses_an_even_size(fn):
    with pytest.raises(ValueError, match="odd"):
        fn(torch.zeros(1, 4, 3, 3), local_size=4)


# -- neuron ops ---------------------------------------------------------------

def _neuron_input():
    """Values with ties at 0, both signs, large magnitudes (bnll's overflow
    branch) and small ones."""
    rs = np.random.RandomState(8)
    x = np.concatenate([rs.randn(40) * 3, [0.0, -0.0, 0.0, 25.0, -25.0, 90.0,
                                           -90.0, 1e-8, -1e-8, 0.5]])
    return x.astype(np.float32).reshape(5, 10)


NEURONS = {
    "sigmoid": (jact.sigmoid, tact.sigmoid),
    "tanh": (jact.tanh, tact.tanh),
    "bnll": (jact.bnll, tact.bnll),
    "absval": (jact.absval, tact.absval),
    "threshold": (lambda a: jact.threshold(a, 0.25),
                  lambda a: tact.threshold(a, 0.25)),
    "threshold0": (jact.threshold, tact.threshold),
    "power2": (lambda a: jact.power(a, power=2.0, scale=0.5, shift=1.0),
               lambda a: tact.power(a, power=2.0, scale=0.5, shift=1.0)),
    "power1": (lambda a: jact.power(a, power=1.0, scale=-2.0, shift=0.5),
               lambda a: tact.power(a, power=1.0, scale=-2.0, shift=0.5)),
    "relu_leak": (lambda a: jact.relu(a, 0.1), lambda a: tact.relu(a, 0.1)),
}


@pytest.mark.parametrize("name", sorted(NEURONS))
def test_neuron_op_values_and_gradients_match_jax(name):
    jfn, tfn = NEURONS[name]
    x = _neuron_input()
    if name.startswith("threshold"):
        # a cast from bool: no gradient in the port, zeros in JAX
        tout = tfn(torch.tensor(x, requires_grad=True))
        assert not tout.requires_grad
        _close(tout, jfn(jnp.asarray(x)), 0)
        assert np.all(np.asarray(jax.grad(lambda a: jfn(a).sum())(
            jnp.asarray(x))) == 0)
        return
    jout, tout, jdx, tdx = _vjp_both(jfn, tfn, x)
    _close(tout, jout)
    _close(tdx, jdx)


@pytest.mark.parametrize("name,want", [("absval", 1.0), ("bnll", 0.5),
                                       ("sigmoid", 0.25), ("tanh", 1.0)])
def test_neuron_gradient_at_zero_is_jaxs(name, want):
    """absval's gradient at 0 is +1 as in JAX (torch.abs's is 0)."""
    jfn, tfn = NEURONS[name]
    jg = float(jax.grad(lambda a: jfn(a))(jnp.float32(0.0)))
    x = torch.zeros((), requires_grad=True)
    (tg,) = torch.autograd.grad(tfn(x), x)
    assert jg == want and float(tg) == want


@pytest.mark.parametrize("p", [0.5, 1.5, 3.0, -1.0])
def test_power_at_a_zero_base_matches_jax(p):
    """A fractional exponent at base 0 has an infinite gradient in both;
    a negative base with a fractional exponent gives NaN in both."""
    x = np.array([0.0, 1.0, -1.0, 2.0], np.float32)
    jfn = lambda a: jact.power(a, power=p, scale=1.0, shift=0.0)
    tfn = lambda a: tact.power(a, power=p, scale=1.0, shift=0.0)
    jout, tout, jdx, tdx = _vjp_both(jfn, tfn, x)
    np.testing.assert_array_equal(np.isnan(tout.detach().numpy()),
                                  np.isnan(jout))
    np.testing.assert_array_equal(np.isinf(tdx.numpy()), np.isinf(jdx))
    np.testing.assert_array_equal(np.isnan(tdx.numpy()), np.isnan(jdx))
    fin = np.isfinite(jout)
    np.testing.assert_allclose(tout.detach().numpy()[fin], jout[fin],
                               rtol=1e-6)
    fin = np.isfinite(jdx)
    np.testing.assert_allclose(tdx.numpy()[fin], jdx[fin], rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 6), (2, 5, 3, 3), (7,)])
def test_softmax_matches_jax_layer(shape):
    """Over axis 1 (axis 0 for a vector), as JAX's SOFTMAX layer."""
    x = np.random.RandomState(9).randn(*shape).astype(np.float32) * 4
    axis = 1 if len(shape) > 1 else 0
    jout, tout, jdx, tdx = _vjp_both(
        lambda a: jax.nn.softmax(a, axis=axis), tact.softmax, x)
    _close(tout, jout)
    _close(tdx, jdx)
