"""The training path's kernel modules against the JAX package, on the CPU.

On CPU tensors the port's autograd functions run the plain versions of
the CUDA kernels: the GRU recurrence's backward (K1-bwd) and the fused
brand-aspect dropout + mean, forward and backward (K2). The same seeded
numpy inputs go through the JAX functions (the Pallas GRU kernel and its
backward in interpret mode, the brand tower) and the port's.
Tolerance: float32, atol = rtol = 5e-5 unless a test states another.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fancyrec_tpu.models.brand import BrandAspects as JaxBrandAspects
from fancyrec_tpu.models.gru import BiGRU as JaxBiGRU
from fancyrec_tpu.ops.gru_scan import gru_scan_pallas
from fancyrec_tpu_torch.models.brand import BrandAspects
from fancyrec_tpu_torch.models.gru import BiGRU
from fancyrec_tpu_torch.models.layers import Dropout
from fancyrec_tpu_torch.ops.brand_dropout import (
    aspect_dropout_bwd_ref, aspect_dropout_fwd_ref, aspect_dropout_mean,
    dropout_mask, keep_threshold, philox4x32_10)
from fancyrec_tpu_torch.ops.gru_scan import gru_scan, gru_scan_ref

TOL = dict(atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# K1: the GRU recurrence's backward


def _scan_inputs(seed, t, b, h):
    rng = np.random.RandomState(seed)
    xw = rng.randn(t, 2, b, 3 * h).astype(np.float32)
    w_hh = (rng.randn(2, 3 * h, h) / np.sqrt(h)).astype(np.float32)
    b_hh = (0.1 * rng.randn(2, 3 * h)).astype(np.float32)
    dout = rng.randn(t, 2, b, h).astype(np.float32)
    return xw, w_hh, b_hh, dout


def _torch_grads(fn, dout, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(dout))


@pytest.mark.parametrize("t,b,h", [(6, 3, 8), (5, 2, 8), (1, 1, 4)])
def test_gru_scan_grads_match_pallas_backward(t, b, h):
    """dxw, dW_hh, db_hh against jax.grad of the Pallas kernel, whose
    custom_vjp runs the Pallas backward kernel in interpret mode, and
    against torch autograd through the plain forward."""
    xw, w_hh, b_hh, dout = _scan_inputs(t * 10 + b, t, b, h)
    _, vjp = jax.vjp(lambda x, w, bb: gru_scan_pallas(x, w, bb, True),
                     jnp.asarray(xw), jnp.asarray(w_hh), jnp.asarray(b_hh))
    want = vjp(jnp.asarray(dout))
    got = _torch_grads(gru_scan, dout, xw, w_hh, b_hh)
    plain = _torch_grads(gru_scan_ref, dout, xw, w_hh, b_hh)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), **TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_bigru_grads_match_jax(packed):
    """The BiGRU module's grads (input and all eight weight tensors) with
    ragged lengths: the packed text path zeroes past each length, the
    unpacked visual path reverses from the batch max."""
    b, t, d, h = 4, 7, 10, 8
    rng = np.random.RandomState(20 + int(packed))
    lengths = np.array([7 if packed else 5, 3, 5, 1], np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.randn(b, t, d) * mask[..., None]).astype(np.float32)
    cot = rng.randn(b, t, 2 * h).astype(np.float32)
    bound = 1.0 / np.sqrt(h)
    params = {"%s_%s" % (n, dr): rng.uniform(-bound, bound, shape)
              .astype(np.float32)
              for dr in ("fwd", "bwd")
              for n, shape in (("w_ih", (3 * h, d)), ("w_hh", (3 * h, h)),
                               ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}
    jmod = JaxBiGRU(h, packed=packed, use_pallas=True)
    kw = ({"lengths": jnp.asarray(lengths)} if packed
          else {"batch_len": jnp.asarray(5)})

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, **kw)
        return jnp.sum(out * jnp.asarray(cot))

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    port = BiGRU(d, h, packed=packed)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.tensor(x, requires_grad=True)
    out = (port(xt, lengths=torch.from_numpy(lengths).long()) if packed
           else port(xt, batch_len=torch.tensor(5)))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p[name]),
                                   **TOL)


# ---------------------------------------------------------------------------
# Philox4x32-10: Random123's known-answer vectors


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10([torch.tensor([c], dtype=torch.int64)
                         for c in counter], key)
    assert tuple(int(x) for x in got) == want


def test_dropout_mask_is_a_function_of_the_element():
    """Any aspect window of the mask equals the same rows of the whole
    mask, and columns not a multiple of 4 take each element's own word."""
    for c in (12, 10):
        thr, _ = keep_threshold(9, 0.5)
        whole = dropout_mask((7, 9), thr, 3, 9, c, 0, 9, "cpu")
        part = dropout_mask((7, 9), thr, 3, 9, c, 4, 7, "cpu")
        assert torch.equal(part, whole[:, 4:7])
    # c = 10 via the per-element path equals c = 10 read out of the
    # flat Philox stream of a 4-aligned layout
    e = torch.arange(3 * 9 * 10, dtype=torch.int64)
    words = torch.stack(philox4x32_10(
        (e >> 2, torch.zeros_like(e), torch.zeros_like(e),
         torch.zeros_like(e)), (7, 9)), dim=-1)
    flat = words[torch.arange(e.numel()), e & 3] <= thr
    assert torch.equal(flat.reshape(3, 9, 10), whole)


# ---------------------------------------------------------------------------
# K2: the brand tower's fused dropout + mean


def _brand_setup(seed=0, brand_num=5, aspects=16, common=12):
    jmod = JaxBrandAspects(brand_num=brand_num, num_aspects=aspects,
                           common_dim=common)
    ids = np.array([0, 3, 4, 3], np.int32)       # a duplicate brand id
    params = jmod.init({"params": jax.random.PRNGKey(seed)},
                       jnp.asarray(ids))["params"]
    port = BrandAspects(brand_num, aspects, common)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params.items()})
    port.seed_generator = torch.Generator().manual_seed(seed)
    return jmod, params, port, ids


def test_brand_keep1_matches_jax_forward_and_grads():
    """Training mode at p = 0 (keep = 1) runs the fused op's plain versions
    and equals the JAX brand tower's deterministic mean, l1_penalty
    included in the grads, duplicate ids summed into the table."""
    jmod, params, port, ids = _brand_setup()
    cot = np.random.RandomState(1).randn(len(ids), 12).astype(np.float32)

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(ids), deterministic=True,
                         mean=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(params)
    port.p = 0.0
    port.train()
    got = port(torch.from_numpy(ids).long())
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[name]),
                                   **TOL)
    port.eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            port(torch.from_numpy(ids).long()).numpy(), np.asarray(want),
            **TOL)


def test_aspect_dropout_matches_materialised_mask():
    """keep = 0.5: forward and (dw, dasp) against torch autograd through
    mean(w[:, :, None] * asp[None] * m / keep, 1) with the replayed mask;
    an aspect count past one plain-version chunk, columns not a multiple
    of 4."""
    rng = np.random.RandomState(2)
    b, a, c, keep, seed = 3, 70, 10, 0.5, (12345, 678)
    w = torch.tensor(rng.randn(b, a).astype(np.float32), requires_grad=True)
    asp = torch.tensor(rng.randn(a, c).astype(np.float32), requires_grad=True)
    g = torch.from_numpy(rng.randn(b, c).astype(np.float32))
    out = aspect_dropout_mean(w, asp, seed, keep)
    got = torch.autograd.grad(out, [w, asp], g)
    m = dropout_mask(seed, keep_threshold(a, keep)[0], b, a, c, 0, a, "cpu")
    ref = (w[:, :, None] * asp[None] * m / keep).mean(dim=1)
    want = torch.autograd.grad(ref, [w, asp], g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
    dw, dasp = aspect_dropout_bwd_ref(w.detach(), asp.detach(), g, seed, keep)
    np.testing.assert_array_equal(dw.numpy(), got[0].numpy())
    np.testing.assert_array_equal(dasp.numpy(), got[1].numpy())


def test_aspect_dropout_seeding_and_keep_rate():
    rng = np.random.RandomState(3)
    b, a, c = 4, 32, 16
    w = torch.from_numpy(rng.randn(b, a).astype(np.float32))
    asp = torch.from_numpy(rng.randn(a, c).astype(np.float32))
    one = aspect_dropout_fwd_ref(w, asp, (1, 2), 0.5)
    assert torch.equal(one, aspect_dropout_fwd_ref(w, asp, (1, 2), 0.5))
    assert not torch.allclose(one, aspect_dropout_fwd_ref(w, asp, (1, 3), 0.5))
    assert not torch.allclose(one, aspect_dropout_fwd_ref(w, asp, (2, 2), 0.5))
    for keep in (0.5, 0.8):
        m = dropout_mask((5, 6), keep_threshold(a, keep)[0], b, a, c, 0, a,
                         "cpu")
        sigma = np.sqrt(keep * (1 - keep) / m.numel())
        assert abs(float(m.float().mean()) - keep) < 4 * sigma
    # inverted dropout is unbiased: the seed-average approaches the
    # deterministic mean (the JAX package's brand-tower test, atol 0.15)
    avg = torch.stack([aspect_dropout_fwd_ref(w, asp, (s, 0), 0.5)
                       for s in range(200)]).mean(dim=0)
    np.testing.assert_allclose(avg.numpy(), ((w @ asp) / a).numpy(),
                               atol=0.15)


def test_brand_training_mode_draws_fresh_seed_words():
    _, _, port, ids = _brand_setup(seed=4)
    port.train()
    x = torch.from_numpy(ids).long()
    first, second = port(x), port(x)
    assert not torch.allclose(first, second)
    port.seed_generator = torch.Generator().manual_seed(4)
    assert torch.equal(port(x), first)
    port.seed_generator = None
    with pytest.raises(RuntimeError, match="seed_dropout"):
        port(x)


def test_tower_dropout_replays_from_its_generator():
    drop = Dropout(0.2)
    x = torch.ones(200, 100)
    drop.generator = torch.Generator().manual_seed(0)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), a)
    kept = float((a != 0).float().mean())
    assert abs(kept - 0.8) < 4 * np.sqrt(0.8 * 0.2 / x.numel())
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.8))
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.generator = None
    with pytest.raises(RuntimeError, match="seed_dropout"):
        drop(x)
