"""The flagship forward and the multi-rank dry run (`fancyrec_tpu_torch.
entry`) against the root `__graft_entry__.py` of the JAX package, on the
CPU.

  * `flagship_config` equals `_flagship_cfg` field by field, tiny and
    full; `example_batch` equals `_example_batch` for the same seed;
  * the flagship forward at the tiny config equals the JAX model's eval
    forward on carried weights (atol=rtol=5e-5);
  * `dryrun_multichip(4, device="cpu")`: four gloo ranks at (2, 2) with
    --seq_shard. Given the JAX tiny parameters and queue with every
    dropout off, its loss and grad norm equal the JAX package's unsharded
    update of the same two microbatches at the tolerances that
    tests/test_torch_port_seq_pp.py holds its (2, 2) --seq_shard update to
    (tests/test_multichip.py pins the JAX sharded step to the unsharded
    one); its sharded metrics equal the gathered ones within 1e-5, its
    AUC and top score the JAX package's on the same posts, and the
    pipeline the sequential encoder (pp_delta < 1e-4). Seeded, with the
    dropouts on, it prints the JAX summary line; a failing rank raises.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fancyrec_tpu.eval.metrics import cosine_sim_matrix, ranking_metrics_jax
from fancyrec_tpu.losses import contrastive_loss as jax_contrastive_loss
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.ops.similarity import retrieval_topk as jax_retrieval_topk
from fancyrec_tpu.train.state import init_state as jax_init_state
from fancyrec_tpu_torch import entry
from tests.test_torch_port_parallel import LOSS_REL, NORM_REL

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__ as graft  # noqa: E402

F32_TOL = dict(atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_config_matches_jax(tiny):
    got, want = entry.flagship_config(tiny), graft._flagship_cfg(tiny)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert ({f.name for f in dataclasses.fields(got)}
            == {f.name for f in dataclasses.fields(want)})


@pytest.mark.parametrize("tiny", [True, False])
def test_example_batch_matches_jax(tiny):
    cfg = entry.flagship_config(tiny)
    got = entry.example_batch(cfg, 5, np.random.RandomState(3))
    want = graft._example_batch(graft._flagship_cfg(tiny), 5,
                                np.random.RandomState(3))
    assert set(got) == set(want) == set(entry.BATCH_KEYS)
    for k in entry.BATCH_KEYS:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the default generator is RandomState(0), as in JAX
    again = entry.example_batch(cfg, 5)
    first = graft._example_batch(graft._flagship_cfg(tiny), 5)
    np.testing.assert_array_equal(again["frames"].numpy(),
                                  np.asarray(first["frames"]))


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX tiny model with every dropout off, its initial variables as
    numpy, and the two example microbatches of the dry run."""
    cfg = graft._flagship_cfg(tiny=True)
    cfg.dropout = cfg.bert_dropout = 0.0
    model, state = jax_init_state(cfg)
    rng = np.random.RandomState(0)
    micro = [{k: np.asarray(v) for k, v in graft._example_batch(
        cfg, cfg.batch_size, rng).items()}
        for _ in range(cfg.accumulation_step)]
    return {"cfg": cfg, "model": model, "micro": micro,
            "variables": {"params": jax.device_get(state.params),
                          "batch_stats": jax.device_get(state.batch_stats),
                          "queue": np.asarray(state.queue.queue)},
            "queue": state.queue}


def test_flagship_forward_matches_jax_at_tiny(jax_tiny):
    fn, args = entry.entry(device="cpu", tiny=True,
                           variables=jax_tiny["variables"])
    assert len(args) == len(entry.BATCH_KEYS)
    got_b, got_p = fn(*args)
    model, var = jax_tiny["model"], jax_tiny["variables"]
    batch = graft._example_batch(graft._flagship_cfg(tiny=True), 8)
    v = JVisualBatch(frames=batch["frames"], mean_origin=batch["origin"],
                     mask=batch["vmask"])
    t = JTextBatch(bows=batch["bows"], tokens=batch["tokens"],
                   type_ids=batch["type_ids"], mask=batch["tmask"])
    want_b, want_p = model.apply(
        {"params": var["params"], "batch_stats": var["batch_stats"]},
        batch["brand_ids"], v, t, deterministic=True)
    assert got_b.shape == (8, 64) and got_p.shape == (8, 64)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **F32_TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **F32_TOL)


def _jax_unsharded_update(jax_tiny):
    """The JAX package's unsharded update of the dry run's two microbatches
    with every dropout off (the brand tower deterministic, the post towers
    in training mode at rate 0, so BatchNorm uses the batch's statistics)
    -> (mean loss, the summed grads' global norm)."""
    model, var = jax_tiny["model"], jax_tiny["variables"]

    def micro(p, bs, q, mb):
        v = JVisualBatch(jnp.asarray(mb["frames"]), jnp.asarray(mb["origin"]),
                         jnp.asarray(mb["vmask"]))
        t = JTextBatch(jnp.asarray(mb["bows"]), jnp.asarray(mb["tokens"]),
                       jnp.asarray(mb["type_ids"]), jnp.asarray(mb["tmask"]))
        post, mut = model.apply(
            {"params": p, "batch_stats": bs}, v, t, deterministic=False,
            mutable=["batch_stats"], method=model.embed_post,
            rngs={"dropout": jax.random.PRNGKey(0)})
        brand = model.apply({"params": p}, jnp.asarray(mb["brand_ids"]),
                            deterministic=True, method=model.embed_brand)
        loss, q = jax_contrastive_loss(brand, post, q, cost_style="mean")
        return loss, (mut["batch_stats"], q)

    grad_fn = jax.jit(jax.value_and_grad(micro, has_aux=True))
    bs, q, gsum, losses = var["batch_stats"], jax_tiny["queue"], None, []
    for mb in jax_tiny["micro"]:
        (loss, (bs, q)), g = grad_fn(var["params"], bs, q, mb)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        losses.append(float(loss))
    return float(np.mean(losses)), float(optax.global_norm(gsum))


def _jax_eval(data_axis=2):
    """`_dryrun_multichip_impl`'s evaluation data through the JAX
    functions, unsharded -> (AUC, the top score of brand 0)."""
    n_posts = 30 * data_axis + 3
    erng = np.random.RandomState(1)
    brands = erng.randn(4, 16).astype(np.float32)
    posts = erng.randn(n_posts, 16).astype(np.float32)
    labels = erng.randint(0, 4, n_posts).astype(np.int32)
    m = ranking_metrics_jax(cosine_sim_matrix(jnp.asarray(brands),
                                              jnp.asarray(posts)),
                            jnp.asarray(labels), 4)
    topv, _ = jax_retrieval_topk(jnp.asarray(brands), jnp.asarray(posts), 4)
    return float(m.auc), float(topv[0, 0])


@pytest.fixture(scope="module")
def dry_off(jax_tiny):
    return entry.dryrun_multichip(4, device="cpu",
                                  variables=jax_tiny["variables"],
                                  dropout=False)


def test_dryrun_update_equals_the_jax_unsharded_update(jax_tiny, dry_off):
    loss, norm = _jax_unsharded_update(jax_tiny)
    s = dry_off["summary"]
    assert s["mesh"] == {"data": 2, "model": 2}
    assert s["loss"] == pytest.approx(loss, rel=LOSS_REL)
    assert s["grad_norm"] == pytest.approx(norm, rel=NORM_REL)
    # every rank took the same update
    for r in dry_off["ranks"]:
        assert r["summary"] == s


def test_dryrun_evaluation_and_pipeline(dry_off):
    """The sharded metrics within 1e-5 of the gathered ones on every rank,
    the AUC and the top score the JAX functions' on the same posts, no
    pad row ranked, and the pipeline the sequential encoder."""
    auc, top = _jax_eval()
    s = dry_off["summary"]
    assert s["eval_auc"] == pytest.approx(auc, abs=1e-6)
    assert s["topk_max"] == pytest.approx(top, abs=1e-6)
    assert s["pp_delta"] < 1e-4
    for r in dry_off["ranks"]:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        for k, v in r["metrics"].items():
            assert abs(v - r["sharded_metrics"][k]) < 1e-5, k
        # kernel wrappers count only on the card: the CPU takes the plain
        # versions
        assert not any(r["launches"].values())


def test_dryrun_seeded_prints_the_jax_summary_line(capsys):
    got = entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    line = [x for x in out.splitlines()
            if x.startswith("dryrun_multichip(4): ")]
    assert len(line) == 1, out
    for field in ("mesh={'data': 2, 'model': 2}", "loss=", "grad_norm=",
                  "eval_auc=", "topk_max=", "pp_delta="):
        assert field in line[0]
    s = got["summary"]
    assert np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
    assert 0.0 <= s["eval_auc"] <= 1.0 and s["pp_delta"] < 1e-4


def test_dryrun_a_failing_rank_raises():
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        entry.dryrun_multichip(2, device="cpu",
                               variables={"params": {}, "batch_stats": {}})

