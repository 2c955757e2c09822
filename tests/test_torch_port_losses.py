"""The port's training losses against the JAX package's, values and grads.

The same seeded numpy embeddings go through `fancyrec_tpu.losses` (with
jax.value_and_grad) and `fancyrec_tpu_torch.losses` (with torch autograd).
Tolerance: float32, atol = rtol = 5e-5, that of tests/test_tower_parity.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fancyrec_tpu import losses as J
from fancyrec_tpu_torch import losses as P

TOL = dict(atol=5e-5, rtol=5e-5)


def _embs(seed, b=5, c=8, ties=False):
    rng = np.random.RandomState(seed)
    brand = rng.randn(b, c).astype(np.float32)
    post = rng.randn(b, c).astype(np.float32)
    if ties:
        # equal post rows and equal brand rows: exact ties in every score
        # row and column, which the stable double argsort ranks by index
        post[3] = post[1]
        brand[2] = brand[0]
    return brand, post


def _torch_value_and_grads(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return float(out.detach()), [t.grad.numpy() for t in ts]


def _check(fn_jax, fn_torch, *arrays):
    want, want_g = jax.value_and_grad(fn_jax, argnums=tuple(
        range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    got, got_g = _torch_value_and_grads(fn_torch, *arrays)
    np.testing.assert_allclose(got, float(want), **TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("ties", [False, True])
def test_rank_weights_match_jax(ties):
    brand, post = _embs(0, ties=ties)
    scores = post @ brand.T
    for axis in (0, 1):
        want = np.asarray(J.rank_weights(jnp.asarray(scores), axis))
        got = P.rank_weights(torch.from_numpy(scores), axis).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cost_style", ["sum", "mean"])
@pytest.mark.parametrize("ties", [False, True])
def test_triplet_loss_matches_jax(cost_style, ties):
    brand, post = _embs(1, ties=ties)
    ids = np.array([0, 1, 0, 2, 3], np.int32)
    _check(lambda b, p: J.triplet_loss(jnp.asarray(ids), b, p, margin=0.2,
                                       cost_style=cost_style),
           lambda b, p: P.triplet_loss(torch.from_numpy(ids).long(), b, p,
                                       margin=0.2, cost_style=cost_style),
           brand, post)


@pytest.mark.parametrize("cost_style", ["sum", "mean"])
@pytest.mark.parametrize("ties", [False, True])
def test_crossclr_loss_matches_jax(cost_style, ties):
    brand, post = _embs(2, ties=ties)
    _check(lambda b, p: J.crossclr_loss(b, p, cost_style=cost_style),
           lambda b, p: P.crossclr_loss(b, p, cost_style=cost_style),
           brand, post)


def test_lab_loss_matches_jax():
    brand, _ = _embs(3)
    _check(J.lab_loss, P.lab_loss, brand)


@pytest.mark.parametrize("cost_style", ["sum", "mean"])
@pytest.mark.parametrize("ties", [False, True])
def test_contrastive_loss_matches_jax(cost_style, ties):
    brand, post = _embs(4, ties=ties)
    jstate = J.init_queue_state(12, 8)
    pstate = P.init_queue_state(12, 8)
    _check(lambda b, p: J.contrastive_loss(b, p, jstate,
                                           cost_style=cost_style)[0],
           lambda b, p: P.contrastive_loss(b, p, pstate,
                                           cost_style=cost_style)[0],
           brand, post)


@pytest.mark.parametrize("mode", ["queue", "no_queue", "no_intra"])
def test_contrastive_queue_threaded_over_steps(mode):
    """Three steps with the queue state threaded through both packages; the
    queue (K=8, B=3) wraps on the third step."""
    k, b, c = 8, 3, 6
    flags = dict(no_queue=mode == "no_queue", no_intra=mode == "no_intra")
    jstate = J.init_queue_state(k, c)
    pstate = P.init_queue_state(k, c)
    for step in range(3):
        brand, post = _embs(10 + step, b=b, c=c)

        def fj(br, po, st=jstate):
            return J.contrastive_loss(br, po, st, **flags)[0]

        def fp(br, po, st=pstate):
            return P.contrastive_loss(br, po, st, **flags)[0]

        _check(fj, fp, brand, post)
        _, jstate = J.contrastive_loss(jnp.asarray(brand), jnp.asarray(post),
                                       jstate, **flags)
        _, pstate = P.contrastive_loss(torch.from_numpy(brand),
                                       torch.from_numpy(post), pstate, **flags)
        np.testing.assert_allclose(pstate.queue.numpy(),
                                   np.asarray(jstate.queue), **TOL)
        assert pstate.ptr == int(jstate.ptr)
        assert not pstate.queue.requires_grad


def test_contrastive_loss_leaves_the_old_queue_untouched():
    brand, post = _embs(5)
    state = P.init_queue_state(12, 8)
    _, new = P.contrastive_loss(torch.from_numpy(brand),
                                torch.from_numpy(post), state)
    assert float(state.queue.abs().sum()) == 0.0 and state.ptr == 0
    assert new.ptr == 5 and float(new.queue[:5].abs().sum()) > 0
