"""The port's Caffe loss zoo and ACCURACY (videovector_tpu_torch.ops.losses)
against the JAX package's (videovector_tpu.ops.losses) on the CPU.

The cases are those of tests/test_losses.py, with the same seeded numpy
inputs fed to both packages. Forward values and the gradients of every
float input (jax.grad against torch autograd) are held within rtol 1e-5 and
atol 1e-6, in f32. Ties are pinned where the two libraries could part: the
hinge gradients at a tie (0.5, as jnp.maximum gives), the log-prob floor,
and ACCURACY's order among equal scores (lax.top_k's lower index first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videovector_tpu import ops as jops
from videovector_tpu_torch.ops import losses as tl

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _check(jfn, tfn, floats, consts=(), **kw):
    """jfn(*floats, *consts, **kw) and tfn(...) agree in value and in the
    gradient of every float input."""
    jargs = [jnp.asarray(a) for a in floats]
    jc = [jnp.asarray(c) for c in consts]
    jval, jgrads = jax.value_and_grad(
        lambda *f: jfn(*f, *jc, **kw), argnums=tuple(range(len(floats))))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in floats]
    tval = tfn(*targs, *[torch.as_tensor(c) for c in consts], **kw)
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL, atol=ATOL)
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL)
    return tval.item()


@pytest.mark.parametrize("l1", [False, True])
def test_euclidean_loss(rng, l1):
    a = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(4, 6).astype(np.float32)
    b[0, :2] = a[0, :2]     # |a - b|'s kink
    got = _check(jops.euclidean_loss, tl.euclidean_loss, (a, b), l1=l1)
    want = np.sum(np.abs(a - b)) / 4 if l1 else np.sum((a - b) ** 2) / 4 / 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_hinge_loss(rng, norm):
    s = rng.randn(5, 8).astype(np.float32)
    y = rng.randint(0, 8, size=(5,)).astype(np.float32)
    _check(jops.hinge_loss, tl.hinge_loss, (s,), (y,), norm=norm)


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_hinge_loss_tie_gradient(norm):
    """1 + s*sign == 0 exactly: both give the hinge's gradient 0.5."""
    s = np.array([[-1.0, 1.0, 0.5], [0.25, -1.0, 1.0]], np.float32)
    y = np.array([1, 2], np.float32)
    _check(jops.hinge_loss, tl.hinge_loss, (s,), (y,), norm=norm)


def test_softmax_loss_vs_multinomial(rng):
    logits = rng.randn(6, 9).astype(np.float32)
    y = rng.randint(0, 9, size=(6,)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    _check(jops.softmax_loss, tl.softmax_loss, (logits,), (y,))
    _check(jops.multinomial_logistic_loss, tl.multinomial_logistic_loss,
           (probs.astype(np.float32),), (y,))


def test_softmax_loss_log_floor():
    """A label whose log prob is below log(1e-20) is floored there, in both
    packages, with no gradient through the floored term."""
    logits = np.array([[0.0, 80.0, 0.0], [1.0, 2.0, 3.0]], np.float32)
    y = np.array([0, 2], np.float32)
    got = _check(jops.softmax_loss, tl.softmax_loss, (logits,), (y,))
    assert got > 23.0
    probs = np.array([[0.0, 1.0], [0.5, 0.5]], np.float32)
    _check(jops.multinomial_logistic_loss, tl.multinomial_logistic_loss,
           (probs,), (np.array([0, 1], np.float32),))


def test_sigmoid_cross_entropy(rng):
    x = (rng.randn(4, 5) * 30).astype(np.float32)
    x[0, :2] = 0.0      # the kinks of |x| and max(x, 0)
    t = rng.randint(0, 2, size=(4, 5)).astype(np.float32)
    _check(jops.sigmoid_cross_entropy_loss, tl.sigmoid_cross_entropy_loss,
           (x,), (t,))


@pytest.mark.parametrize("margin", [1.0, 2.5])
def test_contrastive_loss(rng, margin):
    a = rng.randn(6, 3).astype(np.float32)
    b = rng.randn(6, 3).astype(np.float32)
    y = rng.randint(0, 2, size=(6,)).astype(np.float32)
    _check(jops.contrastive_loss, tl.contrastive_loss, (a, b), (y,),
           margin=margin)


def test_contrastive_loss_tie_gradient():
    """margin - d^2 == 0 exactly for a dissimilar pair: JAX's jnp.maximum
    gives the hinge's gradient 0.5 at the tie, and so does the port's
    torch.maximum (torch.clamp would give 1)."""
    a = np.array([[1.0, 0.0], [0.0, 0.0]], np.float32)
    b = np.array([[0.0, 0.0], [0.5, 0.5]], np.float32)
    y = np.array([0, 0], np.float32)
    jg = jax.grad(lambda a: jops.contrastive_loss(
        a, jnp.asarray(b), jnp.asarray(y), margin=1.0))(jnp.asarray(a))
    # d^2 = 1 = margin on pair 0: d/da = (1 - y)(-2 (a - b)) * 0.5 / 2 / 2
    np.testing.assert_allclose(np.asarray(jg)[0], [-0.25, 0.0])
    _check(jops.contrastive_loss, tl.contrastive_loss, (a, b), (y,),
           margin=1.0)


def test_infogain_loss(rng):
    p = rng.rand(4, 3).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    p[0, 1] = 0.0       # floored at 1e-20
    y = rng.randint(0, 3, size=(4,)).astype(np.float32)
    h = rng.rand(3, 3).astype(np.float32)
    _check(jops.infogain_loss, tl.infogain_loss, (p,), (y, h))


@pytest.mark.parametrize("top_k", [1, 3])
def test_accuracy(rng, top_k):
    s = rng.randn(20, 6).astype(np.float32)
    y = rng.randint(0, 6, size=(20,)).astype(np.float32)
    want = float(jops.accuracy(jnp.asarray(s), jnp.asarray(y), top_k=top_k))
    assert tl.accuracy(torch.as_tensor(s), torch.as_tensor(y),
                       top_k=top_k).item() == want


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_accuracy_ties_rank_the_lower_index_first(top_k):
    """Rows of equal scores: lax.top_k takes the lowest indices, and so does
    the port's stable sort."""
    s = np.array([[1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, 2.0],
                  [3.0, 3.0, 0.0, 3.0]], np.float32)
    for label in range(4):
        y = np.full(3, label, np.float32)
        want = float(jops.accuracy(jnp.asarray(s), jnp.asarray(y),
                                   top_k=top_k))
        got = tl.accuracy(torch.as_tensor(s), torch.as_tensor(y), top_k=top_k)
        assert got.item() == want, (label, top_k)
