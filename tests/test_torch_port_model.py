"""The port's FancyRec against the JAX package's, on shared weights.

JAX FancyRec variables (initialized, then perturbed so that every bias and
running statistic is non-trivial) are carried across with
`fancyrec_tpu_torch.interop.load_jax_variables`; `embed_post` and
`embed_brand` must agree at float32 tolerance atol = rtol = 5e-5 (that of
tests/test_tower_parity.py) on ragged batches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fancyrec_tpu.config import Config as JaxConfig
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.train.state import init_state
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.interop import load_jax_variables
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
from tests.torch_port_tiny import ragged_batch, tiny_cfg_kwargs

TOL = dict(atol=5e-5, rtol=5e-5)


def jax_variables(cfg_kwargs, seed=0):
    """Initialized JAX variables as numpy, every leaf perturbed."""
    jcfg = JaxConfig(**cfg_kwargs).finalize()
    model, state = init_state(jcfg, seed=seed)
    rng = np.random.RandomState(seed + 1)
    noisy = lambda x: (np.asarray(x)                          # noqa: E731
                       + 0.05 * rng.randn(*np.shape(x))).astype(np.float32)
    params = jax.tree.map(noisy, jax.device_get(state.params))
    stats = jax.tree.map(lambda x: np.abs(noisy(x)),
                         jax.device_get(state.batch_stats))
    return jcfg, model, params, stats


def port_model(cfg_kwargs, params, stats):
    model = FancyRec(Config(**cfg_kwargs).finalize())
    load_jax_variables(model, params, stats)
    return model.eval()


@pytest.mark.parametrize("text_net,fusion_style,norm", [
    ("transformers", "ph", True),      # the recipe's towers
    ("transformers", "fc", False),
    ("bi-gru", "ph", False),
    ("bi-gru", "fc", True),
])
def test_embed_post_and_brand_match_jax(text_net, fusion_style, norm):
    kw = tiny_cfg_kwargs(text_net, fusion_style, norm)
    jcfg, jmodel, params, stats = jax_variables(kw)
    model = port_model(kw, params, stats)
    batch = ragged_batch(jcfg, 5, seed=3)

    variables = {"params": params, "batch_stats": stats}
    want = jmodel.apply(
        variables,
        JVisualBatch(jnp.asarray(batch["frames"]), jnp.asarray(batch["origin"]),
                     jnp.asarray(batch["vmask"])),
        JTextBatch(jnp.asarray(batch["bows"]), jnp.asarray(batch["tokens"]),
                   jnp.asarray(batch["type_ids"]), jnp.asarray(batch["tmask"])),
        deterministic=True, method=jmodel.embed_post)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model.embed_post(
            VisualBatch(t["frames"], t["origin"], t["vmask"]),
            TextBatch(t["bows"], t["tokens"].long(), t["type_ids"].long(),
                      t["tmask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    ids = np.arange(jcfg.brand_num, dtype=np.int32)
    want_b = jmodel.apply({"params": params}, jnp.asarray(ids),
                          deterministic=True, method=jmodel.embed_brand)
    with torch.no_grad():
        got_b = model.embed_brand(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)


def test_interop_rejects_a_mismatched_tree():
    kw = tiny_cfg_kwargs()
    _, _, params, stats = jax_variables(kw)
    model = FancyRec(Config(**dict(kw, fusion_style="fc")).finalize())
    with pytest.raises(ValueError, match="do not match"):
        load_jax_variables(model, params, stats)
