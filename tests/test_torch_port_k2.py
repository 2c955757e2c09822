"""K2, the brand tower's fused dropout + mean, with its mask carried as
packed keep bits from the forward to the backward, on the CPU.

On CPU tensors the autograd function runs the plain versions: the forward
returns the packed bits beside its output and the backward reads them
(`aspect_dropout_bwd_bits_ref`), which must give the same bits of dw and
dasp as the backward that redraws the mask from the seed. The JAX brand
tower (its XLA path at keep = 1) is the reference for the autograd path.
Tolerance: float32, atol = rtol = 5e-5 against JAX; exact between the two
plain backwards (same mask, same sum order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fancyrec_tpu.models.brand import BrandAspects as JaxBrandAspects
from fancyrec_tpu_torch.models.brand import BrandAspects
from fancyrec_tpu_torch.ops import brand_dropout as bd
from fancyrec_tpu_torch.ops.brand_dropout import (
    aspect_dropout_bwd_bits_ref, aspect_dropout_bwd_ref,
    aspect_dropout_fwd_ref, aspect_dropout_mean, aspect_dropout_plan,
    dropout_mask, keep_threshold, pack_keep_bits, unpack_keep_bits)

TOL = dict(atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("c", [10, 32, 33, 1027])
def test_pack_keep_bits_layout(c):
    """Bit c & 31 of word c >> 5 of row (b, a) is element (b, a, c); the
    tail bits past C are zero; unpacking gives the mask back."""
    rng = np.random.RandomState(c)
    mask = torch.from_numpy(rng.rand(2, 3, c) < 0.5)
    bits = pack_keep_bits(mask)
    words = -(-c // 32)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (2, 3, words)
    u = bits.numpy().astype(np.int64) & 0xFFFFFFFF
    for col in range(32 * words):
        got = (u[..., col >> 5] >> (col & 31)) & 1
        want = mask[..., col].numpy() if col < c else np.zeros((2, 3))
        np.testing.assert_array_equal(got, want)
    assert torch.equal(unpack_keep_bits(bits, c), mask)
    full = pack_keep_bits(torch.ones(1, c, dtype=torch.bool))
    assert int(full[0, -1]) & 0xFFFFFFFF == (1 << (c - 32 * (words - 1))) - 1


@pytest.mark.parametrize("b,a,c,keep", [
    (3, 70, 10, 0.5), (2, 130, 64, 0.3), (5, 17, 33, 0.9), (1, 64, 1027, 0.5),
    (4, 9, 12, 1.0)])
def test_bwd_from_bits_is_bit_identical(b, a, c, keep):
    """The forward's bits are the packed Philox mask; the backward from them
    equals the backward that redraws the mask, bit for bit; the forward
    with bits gives the same output as without."""
    rng = np.random.RandomState(b * a + c)
    w = torch.from_numpy(rng.randn(b, a).astype(np.float32))
    asp = torch.from_numpy(rng.randn(a, c).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, c).astype(np.float32))
    seed = (a * 7919, c * 104729)
    out, bits = aspect_dropout_fwd_ref(w, asp, seed, keep, with_bits=True)
    assert torch.equal(out, aspect_dropout_fwd_ref(w, asp, seed, keep))
    mask = dropout_mask(seed, keep_threshold(a, keep)[0], b, a, c, 0, a,
                        "cpu")
    assert torch.equal(bits, pack_keep_bits(mask))
    for got, want in zip(aspect_dropout_bwd_bits_ref(w, asp, g, bits, keep),
                         aspect_dropout_bwd_ref(w, asp, g, seed, keep)):
        assert torch.equal(got, want)


def test_autograd_saves_bits_and_never_redraws(monkeypatch):
    """keep = 0.5: autograd's grads come from the saved bits (the backward
    never draws a mask) and equal the seed-replaying plain backward; with
    no grad wanted, no bits are made."""
    rng = np.random.RandomState(5)
    b, a, c, keep, seed = 4, 90, 40, 0.5, (31, 41)
    w = torch.tensor(rng.randn(b, a).astype(np.float32), requires_grad=True)
    asp = torch.tensor(rng.randn(a, c).astype(np.float32), requires_grad=True)
    g = torch.from_numpy(rng.randn(b, c).astype(np.float32))
    out = aspect_dropout_mean(w, asp, seed, keep)
    assert out.grad_fn is not None

    def no_draw(*args, **kwargs):
        raise AssertionError("the backward drew a mask")

    with monkeypatch.context() as mp:
        mp.setattr(bd, "dropout_mask", no_draw)
        got = torch.autograd.grad(out, [w, asp], g)
    want = aspect_dropout_bwd_ref(w.detach(), asp.detach(), g, seed, keep)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    calls, pack = [], bd.pack_keep_bits
    with monkeypatch.context() as mp:
        mp.setattr(bd, "pack_keep_bits",
                   lambda m: calls.append(m) or pack(m))
        with torch.no_grad():
            plain = aspect_dropout_mean(w, asp, seed, keep)
    assert not calls
    assert torch.equal(plain, out.detach())


def test_bits_autograd_matches_jax_brand_tower():
    """Training mode at keep = 1 through the bits (every bit set) against
    the JAX brand tower's deterministic mean, forward and grads, l1_penalty
    and a duplicate brand id included; 40 columns leave a padded word."""
    brand_num, aspects, common = 6, 70, 40
    jmod = JaxBrandAspects(brand_num=brand_num, num_aspects=aspects,
                           common_dim=common)
    ids = np.array([1, 5, 2, 5, 0], np.int32)
    params = jmod.init({"params": jax.random.PRNGKey(3)},
                       jnp.asarray(ids))["params"]
    port = BrandAspects(brand_num, aspects, common)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params.items()})
    port.seed_generator = torch.Generator().manual_seed(3)
    cot = np.random.RandomState(4).randn(len(ids), common).astype(np.float32)

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(ids), deterministic=True,
                         mean=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(params)
    port.p = 0.0
    port.train()
    saved = []
    orig = bd.aspect_dropout_bwd_bits_ref

    def spy(w, asp, g, bits, keep):
        saved.append(bits)
        return orig(w, asp, g, bits, keep)

    bd.aspect_dropout_bwd_bits_ref = spy
    try:
        got = port(torch.from_numpy(ids).long())
        (got * torch.from_numpy(cot)).sum().backward()
    finally:
        bd.aspect_dropout_bwd_bits_ref = orig
    assert len(saved) == 1
    assert torch.equal(unpack_keep_bits(saved[0], common),
                       torch.ones(len(ids), aspects, common, dtype=torch.bool))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[name]),
                                   **TOL)


@pytest.mark.parametrize("b,a,c,sms", [
    (8, 2000, 1024, 132), (8, 2000, 1024, 114), (3, 37, 130, 132),
    (9, 33, 1027, 132), (4, 301, 96, 132), (64, 5000, 8192, 132),
    (1, 1, 1, 132)])
def test_aspect_dropout_plan(b, a, c, sms):
    """Every aspect in exactly one split, no split empty, a span a whole
    number of aspects a warp and within the shared-memory tile, about one
    wave of two blocks an SM where A allows, and scratch for every split's
    rows of C rounded up to 128; the streamed backward, two blocks an SM
    and at most one a group of 4 aspects, exactly where its block takes
    the shape (C % 4 == 0, C <= 1024, B <= 8)."""
    plan = aspect_dropout_plan(b, a, c, sms)
    assert plan.span % 8 == 0 and 8 <= plan.span <= 256
    assert (plan.splits - 1) * plan.span < a <= plan.splits * plan.span
    assert plan.scratch_floats == plan.splits * b * -(-c // 128) * 128
    tiles = -(-c // 128) * -(-b // 8)
    if plan.span < 256 and a > 8 * plan.splits:
        assert tiles * plan.splits >= sms
        assert tiles * plan.splits <= 2 * sms + tiles
    if c % 4 == 0 and c <= 1024 and b <= 8:
        assert plan.bwd_blocks == min(-(-a // 4), 2 * sms)
    else:
        assert plan.bwd_blocks == 0
    if (b, a, c, sms) == (8, 2000, 1024, 132):
        assert plan == (32, 64, 32 * 8 * 1024, 264)
