"""PyTorch port, the multi-label CTC loss: loss and gradient against the JAX
package's ``training/ctc.py`` on the CPU for the cases of
``tests/test_ctc.py`` (reductions, repeated labels, the Gaussian colour
term, ``blank1`` masking, short inputs and targets), within its atol 1e-4.
The gradient is ``jax.grad`` against autograd, d loss / d log_probs and
d loss / d realval; the port's loss never calls torch's native
``ctc_loss``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_image_translator_tpu.training.ctc import \
    custom_ctc_loss as jax_ctc
from manga_image_translator_tpu_torch.training import custom_ctc_loss

torch.set_num_threads(2)

ATOL = 1e-4


def _log_softmax(x):
    return torch.log_softmax(torch.from_numpy(x), -1).numpy()


def make_case(name):
    """(log_probs, targets, realval, targets_realval, in_len, tg_len,
    keyword arguments) of one case."""
    if name == 'plain':
        rs = np.random.RandomState(0)
        n, t, v, s = 3, 12, 7, 4
        lp = _log_softmax(rs.randn(n, t, v).astype(np.float32))
        tg = rs.randint(1, v, (n, s)).astype(np.int64)
        return (lp, tg, None, None, np.array([t, t - 2, t - 4]),
                np.array([s, s - 1, s - 2]), {})
    if name == 'repeated_labels':
        rs = np.random.RandomState(1)
        lp = _log_softmax(rs.randn(2, 16, 5).astype(np.float32))
        tg = np.array([[1, 1, 2, 2, 1, 3], [2, 2, 2, 1, 1, 1]], np.int64)
        return lp, tg, None, None, np.array([16, 16]), np.array([6, 6]), {}
    if name == 'empty_target':
        rs = np.random.RandomState(2)
        lp = _log_softmax(rs.randn(2, 9, 6).astype(np.float32))
        tg = np.array([[3, 4, 5], [1, 2, 0]], np.int64)
        return lp, tg, None, None, np.array([9, 5]), np.array([0, 2]), {}
    rs = np.random.RandomState(3)
    n, t, v, s, r = 2, 10, 6, 3, 4
    lp = _log_softmax(rs.randn(n, t, v).astype(np.float32))
    if name == 'colour':
        tg = np.array([[1, 2, 3], [2, 5, 5]], np.int64)
    else:                                   # blank1 labels pay no colour
        tg = np.array([[5, 2, 5], [5, 5, 1]], np.int64)
    rv = rs.rand(n, t, r).astype(np.float32)
    trv = rs.rand(n, s, r).astype(np.float32)
    return (lp, tg, rv, trv, np.array([t, t - 3]), np.array([3, 2]),
            {'sigma': 0.7, 'blank1': 5})


CASES = ['plain', 'repeated_labels', 'empty_target', 'colour', 'blank1']


def _jax(lp, tg, rv, trv, il, tl, kw, reduction):
    return jax_ctc(jnp.asarray(lp), jnp.asarray(tg),
                   None if rv is None else jnp.asarray(rv),
                   None if trv is None else jnp.asarray(trv),
                   jnp.asarray(il), jnp.asarray(tl), reduction=reduction,
                   **kw)


def _port(lp, tg, rv, trv, il, tl, kw, reduction):
    return custom_ctc_loss(lp, torch.from_numpy(tg),
                           None if rv is None else rv,
                           None if trv is None else torch.from_numpy(trv),
                           torch.from_numpy(il), torch.from_numpy(tl),
                           reduction=reduction, **kw)


@pytest.mark.parametrize('reduction', ['none', 'mean', 'sum'])
@pytest.mark.parametrize('case', CASES)
def test_loss_matches_jax(case, reduction):
    lp, tg, rv, trv, il, tl, kw = make_case(case)
    # the JAX loss has 'none' and 'mean'; its 'sum' is the sum of 'none'
    ref = np.asarray(_jax(lp, tg, rv, trv, il, tl, kw,
                          'mean' if reduction == 'mean' else 'none'))
    if reduction == 'sum':
        ref = ref.sum()
    got = _port(torch.from_numpy(lp), tg,
                None if rv is None else torch.from_numpy(rv), trv, il, tl,
                kw, reduction)
    assert got.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize('case', CASES)
def test_gradient_matches_jax(case):
    """d mean-loss / d log_probs (and d / d realval where there is one):
    autograd against jax.grad."""
    lp, tg, rv, trv, il, tl, kw = make_case(case)
    argnums = (0,) if rv is None else (0, 1)
    ref = jax.grad(lambda a, b: _jax(a, tg, b, trv, il, tl, kw, 'mean'),
                   argnums=argnums)(jnp.asarray(lp),
                                    None if rv is None else jnp.asarray(rv))
    lp_t = torch.from_numpy(lp).requires_grad_(True)
    rv_t = None if rv is None else torch.from_numpy(rv).requires_grad_(True)
    _port(lp_t, tg, rv_t, trv, il, tl, kw, 'mean').backward()
    np.testing.assert_allclose(lp_t.grad.numpy(), np.asarray(ref[0]),
                               atol=ATOL, rtol=0)
    assert np.abs(np.asarray(ref[0])).max() > 0
    if rv is not None:
        np.testing.assert_allclose(rv_t.grad.numpy(), np.asarray(ref[1]),
                                   atol=ATOL, rtol=0)


def test_gradient_is_minus_the_posterior():
    """Without the colour term the gradient is the true d/d log_probs:
    torch's native CTC gradient (logits convention) minus exp(log_probs)
    at active steps, as tests/test_ctc.py holds the JAX loss."""
    lp, tg, _, _, il, tl, _ = make_case('plain')
    lp_t = torch.from_numpy(lp).requires_grad_(True)
    custom_ctc_loss(lp_t, torch.from_numpy(tg), None, None,
                    torch.from_numpy(il), torch.from_numpy(tl),
                    reduction='sum').backward()
    ref_in = torch.from_numpy(lp).requires_grad_(True)
    torch.nn.functional.ctc_loss(
        ref_in.permute(1, 0, 2), torch.from_numpy(tg), torch.from_numpy(il),
        torch.from_numpy(tl), blank=0, reduction='sum').backward()
    active = np.zeros_like(lp)
    for b, n in enumerate(il):
        active[b, :n] = 1
    expected = (ref_in.grad.numpy() - np.exp(lp)) * active
    np.testing.assert_allclose(lp_t.grad.numpy() * active, expected,
                               atol=1e-3)


def test_colour_term_and_blank1_behave():
    """Matching colours lower the loss; labels equal to blank1 ignore the
    predicted colours."""
    lp, tg, rv, trv, il, tl, kw = make_case('colour')
    near = torch.from_numpy(np.broadcast_to(
        trv.mean(1, keepdims=True), rv.shape).copy())
    args = (torch.from_numpy(tg), None, torch.from_numpy(trv),
            torch.from_numpy(il), torch.from_numpy(tl))

    def loss(targets, realval):
        return float(custom_ctc_loss(torch.from_numpy(lp), targets, realval,
                                     *args[2:], **kw))
    assert loss(args[0], near) < loss(args[0], near + 5.0)
    only_blank1 = torch.full_like(args[0], kw['blank1'])
    assert loss(only_blank1, near) == pytest.approx(
        loss(only_blank1, near + 100.0))
