"""The port's cosine scores (K4) against the JAX package.

On the CPU the port's `cosine_scores` runs the plain version of its CUDA
kernel, `cosine_scores_ref`; the JAX side runs the Pallas kernel
`cosine_scores_pallas` in interpret mode and the XLA `cosine_sim_matrix`
that the JAX evaluator uses. All three agree at atol = rtol = 2e-5 (the
tolerance of tests/test_similarity_ops.py: float32 sums over D in other
orders), and an all-zero post row is NaN in the same places in all three.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fancyrec_tpu.eval.metrics import cosine_sim_matrix as jax_cosine_sim
from fancyrec_tpu.ops.similarity import cosine_scores_pallas
from fancyrec_tpu_torch.eval.metrics import cosine_sim_matrix
from fancyrec_tpu_torch.ops import similarity as tsim

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, n, d, seed):
    rng = np.random.RandomState(seed)
    brands = rng.randn(b, d).astype(np.float32)
    posts = rng.randn(n, d).astype(np.float32)
    posts[n // 3] = 0.0                     # a real all-zero post row
    return brands, posts


def _assert_same(got, want):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], **TOL)


@pytest.mark.parametrize("b", [1, 6])
@pytest.mark.parametrize("n", [1000, 4096, 777])
def test_cosine_scores_ref_matches_jax(n, b):
    brands, posts = _inputs(b, n, 130, seed=n + b)
    got = tsim.cosine_scores_ref(torch.from_numpy(brands),
                                 torch.from_numpy(posts)).numpy()
    assert got.shape == (b, n) and got.dtype == np.float32
    assert np.isnan(got[:, n // 3]).all()
    assert np.isfinite(np.delete(got, n // 3, axis=1)).all()
    _assert_same(got, np.asarray(cosine_scores_pallas(
        jnp.asarray(brands), jnp.asarray(posts), interpret=True)))
    _assert_same(got, np.asarray(jax_cosine_sim(jnp.asarray(brands),
                                                jnp.asarray(posts))))
    # the port's own plain cosine, which the metrics tests use
    _assert_same(got, cosine_sim_matrix(torch.from_numpy(brands),
                                        torch.from_numpy(posts)).numpy())


def test_zero_brand_row_is_nan_in_both_packages():
    brands, posts = _inputs(3, 64, 16, seed=1)
    brands[1] = 0.0
    got = tsim.cosine_scores_ref(torch.from_numpy(brands),
                                 torch.from_numpy(posts)).numpy()
    assert np.isnan(got[1]).all()
    _assert_same(got, np.asarray(cosine_scores_pallas(
        jnp.asarray(brands), jnp.asarray(posts), block=32, interpret=True)))


def test_dispatch_takes_the_plain_version_on_cpu(monkeypatch):
    brands, posts = _inputs(2, 50, 8, seed=2)
    calls = []
    ref = tsim.cosine_scores_ref
    monkeypatch.setattr(tsim, "cosine_scores_ref",
                        lambda *a: calls.append(1) or ref(*a))
    launches = tsim.cosine_scores_cuda.launches
    out = tsim.cosine_scores(torch.from_numpy(brands), torch.from_numpy(posts))
    assert calls == [1] and tsim.cosine_scores_cuda.launches == launches
    _assert_same(out.numpy(), ref(torch.from_numpy(brands),
                                  torch.from_numpy(posts)).numpy())


def test_cuda_launcher_refuses_cpu_tensors():
    brands, posts = _inputs(2, 50, 8, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        tsim.cosine_scores_cuda(torch.from_numpy(brands),
                                torch.from_numpy(posts))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsim.cosine_scores(torch.zeros(2, 8, device="meta"),
                           torch.zeros(5, 8, device="meta"))


@pytest.mark.parametrize("b,n,d,sms,want", [
    (51, 816, 1024, 132, 32),        # the test split: 7 tiles, a stage each
    (51, 1_000_000, 1024, 132, 1),   # 1M posts: the single pass
    (51, 1, 1024, 132, 32),
    (3, 5, 7, 132, 1),               # one D stage: nothing to split
    (64, 129, 1000, 132, 32),        # a ragged last stage
    (51, 53 * 128, 1024, 132, 5),    # slices of 7, 7, 7, 7 and 4 stages
    (51, 816, 1024, 16, 5),          # a small card: 7 tiles x 5 >= 32
    (130, 2 * 128 * 132, 64, 132, 1),
])
def test_cosine_slices(b, n, d, sms, want):
    """K4's slice count: the tiles times S reach two blocks an SM where the
    stages allow, S = 1 at scale, and the slices of whole stages cover D
    once, the last one ragged where the stages do not divide."""
    s = tsim.cosine_slices(b, n, d, sms)
    assert s == want
    tiles = -(-n // 128) * -(-b // 64)
    stages = -(-d // 32)
    if tiles >= 2 * sms:
        assert s == 1
    else:
        assert tiles * s >= min(2 * sms, tiles * stages)
    per = -(-stages // s)                 # the kernel's stages a slice
    assert -(-stages // per) == s
    bounds = [(z * per * 32, min(d, (z + 1) * per * 32)) for z in range(s)]
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
