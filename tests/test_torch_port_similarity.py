"""The port's int8 quantization and top-k against the JAX package.

On the CPU the port's `topk_int8` runs the plain version of its CUDA
kernel; the JAX side runs the fused Pallas kernel in interpret mode.
Indices must be equal (selection is by score, then the smaller index, in
both). Values agree within 1e-6: only the float32 order of the brand
scale multiply and the brand inverse norm's last ulp (jax.lax.rsqrt vs
torch.rsqrt) differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fancyrec_tpu.ops import similarity as jsim
from fancyrec_tpu_torch.ops import similarity as tsim

VTOL = dict(rtol=1e-6, atol=1e-6)


def _case(seed, b=6, n=1000, d=128):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            rng.randn(n, d).astype(np.float32))


def test_quantize_bit_identical_to_jax():
    _, rows = _case(1, n=300)
    rows[17] = 0.0                      # all-zero row: inv 0, never NaN
    qj, ij = (np.asarray(a) for a in jsim.quantize_rows_int8(jnp.asarray(rows)))
    qjn, ijn = jsim.quantize_rows_int8_np(rows)
    qn, inn = tsim.quantize_rows_int8_np(rows)
    qt, it = tsim.quantize_rows_int8(torch.from_numpy(rows))
    # numpy mirrors: bit-identical across the packages
    np.testing.assert_array_equal(qn, qjn)
    np.testing.assert_array_equal(inn, ijn)
    # the torch quantizer: q bit-identical to both JAX quantizers, inv
    # bit-identical to the numpy mirror (jax.lax.rsqrt on the CPU is not
    # correctly rounded, so the JAX pair itself differs by an ulp)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(it.numpy(), inn)
    np.testing.assert_allclose(it.numpy(), ij, rtol=1e-6)
    assert qt.dtype == torch.int8 and it[17] == 0


def _fused_pair(brands, posts, k, n_valid=None, block=128):
    qp, p_inv = tsim.quantize_rows_int8_np(posts)
    vj, ij = jsim.retrieval_topk_fused_int8(
        jnp.asarray(brands), jnp.asarray(qp), jnp.asarray(p_inv), k,
        block=block, n_valid=n_valid, interpret=True)
    vt, it = tsim.topk_int8(torch.from_numpy(brands), torch.from_numpy(qp),
                            torch.from_numpy(p_inv), k, n_valid=n_valid)
    return (np.asarray(vj), np.asarray(ij)), (vt.numpy(), it.numpy())


@pytest.mark.parametrize("b,n,k,n_valid", [
    (6, 1000, 10, None),       # ragged last block
    (6, 1024, 10, 700),        # pre-padded index with a true row count
    (4, 256, 8, 5),            # k > n_valid: -inf filler at index 0
    (51, 512, 10, None),       # the serving brand count
])
def test_topk_int8_matches_fused_pallas(b, n, k, n_valid):
    brands, posts = _case(b * 1000 + n, b=b, n=n)
    (vj, ij), (vt, it) = _fused_pair(brands, posts, k, n_valid)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(vt, vj, **VTOL)
    if n_valid is not None and k > n_valid:
        assert np.isneginf(vt[:, n_valid:]).all()
        assert (it[:, n_valid:] == 0).all()


def test_topk_int8_exact_ties_take_the_smaller_index():
    brands, posts = _case(5, b=3, n=512)
    posts[300:310] = posts[40]          # ten exact duplicates of row 40
    posts[200] = posts[7]
    # make the duplicates win for brand 0
    posts[40] = posts[300:310] = brands[0] * 3.0
    (vj, ij), (vt, it) = _fused_pair(brands, posts, 12)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(vt, vj, **VTOL)
    assert list(it[0, :11]) == [40] + list(range(300, 310))


@pytest.mark.parametrize("strategy", ["matrix", "scan"])
@pytest.mark.parametrize("quantized", [False, True])
def test_retrieval_topk_matches_jax(strategy, quantized):
    brands, posts = _case(9 + quantized, b=5, n=900)
    posts[100:104] = posts[3]           # ties
    n_valid = 850
    if quantized:
        qp, p_inv = tsim.quantize_rows_int8_np(posts)
        jargs = (jnp.asarray(qp),)
        jkw = {"posts_inv": jnp.asarray(p_inv)}
        targs = (torch.from_numpy(qp),)
        tkw = {"posts_inv": torch.from_numpy(p_inv)}
    else:
        jargs, jkw = (jnp.asarray(posts),), {}
        targs, tkw = (torch.from_numpy(posts),), {}
    vj, ij = jsim.retrieval_topk(jnp.asarray(brands), *jargs, 10, block=128,
                                 strategy=strategy, n_valid=n_valid, **jkw)
    vt, it = tsim.retrieval_topk(torch.from_numpy(brands), *targs, 10,
                                 block=128, strategy=strategy,
                                 n_valid=n_valid, **tkw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **VTOL)


def test_retrieval_topk_k_above_n_pads_like_jax():
    brands, posts = _case(11, b=2, n=5)
    vj, ij = jsim.retrieval_topk(jnp.asarray(brands), jnp.asarray(posts), 8,
                                 strategy="matrix")
    vt, it = tsim.retrieval_topk(torch.from_numpy(brands),
                                 torch.from_numpy(posts), 8,
                                 strategy="matrix")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **VTOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    brands, posts = _case(12, b=2, n=64)
    qp, p_inv = tsim.quantize_rows_int8_np(posts)
    with pytest.raises(ValueError, match="CUDA"):
        tsim.topk_int8_cuda(torch.from_numpy(brands), torch.from_numpy(qp),
                            torch.from_numpy(p_inv), 4)
    with pytest.raises(ValueError, match="k <= 128"):
        tsim.topk_int8(torch.from_numpy(brands), torch.from_numpy(qp),
                       torch.from_numpy(p_inv), 129)


@pytest.mark.parametrize("b,n,d,k,grid,ks,stages,ring", [
    (51, 1_000_000, 1024, 10, 132, 256, 4, False),   # the serving shape
    (51, 4080, 1024, 10, 32, 256, 4, False),   # the freshly built index
    (130, 650, 1024, 128, 6, 128, 6, False),   # three brand tiles, k = 128
    (51, 900, 2048, 128, 8, 128, 6, True),     # rows too wide beside k = 128
    (51, 1000, 4096, 128, 8, 128, 6, True),    # the brands through the ring
    (51, 1000, 4096, 10, 8, 128, 8, True),
    (3, 50, 4100, 10, 1, 128, 8, True),        # wide, not 16-byte rows
    (3, 5, 36, 10, 1, 256, 6, False),          # a tiny N, not 16-byte rows
    (4, 0, 128, 8, 1, 256, 6, False),          # no valid post: one block
])
def test_topk_int8_plan(b, n, d, k, grid, ks, stages, ring):
    plan = tsim.topk_int8_plan(b, n, d, k, 132)
    assert (plan.grid, plan.ks, plan.stages, plan.ring_brands) == (
        grid, ks, stages, ring)
    assert tsim._k3_smem(d, k, ks, stages, ring) <= tsim._K3_SMEM
    if stages < 8:       # as many stages as fit
        assert tsim._k3_smem(d, k, ks, stages + 1, ring) > tsim._K3_SMEM
    if ring:             # no stage width fits 4 stages beside the brands
        assert all(tsim._k3_smem(d, k, w, 4, False) > tsim._K3_SMEM
                   for w in tsim._K3_STAGE_BYTES)
    # quantized brands in rows of round_up(D, 256), their scales, their
    # 64-bit first thresholds, each block's best key of each brand and the
    # blocks' lists of 64-bit keys, each part on 16 bytes, in that order
    sizes = (b * -(-d // 256) * 256, 4 * b, 8 * b, 8 * b * grid,
             8 * b * grid * k)
    want, off = [], 0
    for size in sizes:
        want.append(off)
        off += -(-size // 16) * 16
    assert plan.parts == tuple(want) and plan.scratch_bytes == off


def test_topk_int8_plan_refuses_what_the_kernel_does_not_take():
    for k, d in ((0, 1024), (129, 1024), (10, 30), (10, 0)):
        with pytest.raises(ValueError, match="K3 takes"):
            tsim.topk_int8_plan(51, 1000, d, k, 132)
    # the plain version answers at a width the ring takes, as the JAX
    # kernel does
    brands, posts = _case(13, b=2, n=64, d=4096)
    qp, p_inv = tsim.quantize_rows_int8_np(posts)
    vals, idxs = tsim.topk_int8(torch.from_numpy(brands), torch.from_numpy(qp),
                                torch.from_numpy(p_inv), 128)
    assert vals.shape == (2, 128) and (idxs[:, 64:] == 0).all()
