"""The port's bi-GRU recurrence and BiGRU module against the JAX package.

The same numpy inputs go through the JAX function (the lax.scan path, or
the Pallas kernel in interpret mode) and the port's counterpart on the CPU,
which runs the plain version of the CUDA kernel. Tolerance: float32,
atol = rtol = 5e-5, that of tests/test_tower_parity.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fancyrec_tpu.models.gru import BiGRU as JaxBiGRU
from fancyrec_tpu.ops.gru_scan import gru_scan_pallas
from fancyrec_tpu_torch.models.gru import BiGRU
from fancyrec_tpu_torch.ops.gru_scan import gru_scan, gru_scan_ref

TOL = dict(atol=5e-5, rtol=5e-5)


def _scan_inputs(seed, t=6, b=3, h=8):
    rng = np.random.RandomState(seed)
    xw = rng.randn(t, 2, b, 3 * h).astype(np.float32)
    w_hh = (rng.randn(2, 3 * h, h) / np.sqrt(h)).astype(np.float32)
    b_hh = (0.1 * rng.randn(2, 3 * h)).astype(np.float32)
    return xw, w_hh, b_hh


@pytest.mark.parametrize("t,b,h", [(6, 3, 8), (8, 5, 16), (1, 1, 4)])
def test_gru_scan_matches_pallas_interpret(t, b, h):
    xw, w_hh, b_hh = _scan_inputs(t * 100 + b, t, b, h)
    want = np.asarray(gru_scan_pallas(jnp.asarray(xw), jnp.asarray(w_hh),
                                      jnp.asarray(b_hh), True))
    got = gru_scan(torch.from_numpy(xw), torch.from_numpy(w_hh),
                   torch.from_numpy(b_hh))
    assert got.shape == (t, 2, b, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gru_scan_bf16_matches_pallas_interpret():
    """bf16 activations, float32 gate math in both: they differ only where
    a float32 sum-order difference crosses a bf16 rounding boundary, one
    bf16 ulp of h (2^-8 relative) -- hence atol 2e-2 on |h| < 1."""
    xw, w_hh, b_hh = _scan_inputs(7)
    want = np.asarray(gru_scan_pallas(
        jnp.asarray(xw, jnp.bfloat16), jnp.asarray(w_hh), jnp.asarray(b_hh),
        True).astype(jnp.float32))
    got = gru_scan_ref(torch.from_numpy(xw).bfloat16(),
                       torch.from_numpy(w_hh), torch.from_numpy(b_hh))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_bigru_matches_jax(packed, use_pallas):
    b, t, d, h = 4, 7, 10, 8
    rng = np.random.RandomState(int(packed) * 2 + int(use_pallas))
    lengths = np.array([7 if packed else 5, 3, 5, 1], np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.randn(b, t, d) * mask[..., None]).astype(np.float32)
    bound = 1.0 / np.sqrt(h)
    params = {"%s_%s" % (n, dr): rng.uniform(-bound, bound, shape)
              .astype(np.float32)
              for dr in ("fwd", "bwd")
              for n, shape in (("w_ih", (3 * h, d)), ("w_hh", (3 * h, h)),
                               ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}

    jmod = JaxBiGRU(h, packed=packed, use_pallas=use_pallas)
    if packed:
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          lengths=jnp.asarray(lengths))
    else:
        # the batch max (5 here, below the static T=7) is where the
        # backward direction starts
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          batch_len=jnp.asarray(5))

    port = BiGRU(d, h, packed=packed)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        if packed:
            got = port(torch.from_numpy(x),
                       lengths=torch.from_numpy(lengths).long())
        else:
            got = port(torch.from_numpy(x), batch_len=torch.tensor(5))
    assert got.shape == (b, t, 2 * h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
