"""The port's train step, optimizer, BatchNorm and ranking metrics against
the JAX package's, on the CPU.

The train step is held against a JAX reference composed in the test from
the JAX package's public functions (its own `_micro_loss` always draws the
brand dropout, so it cannot be the reference at p = 0). Tolerances:
float32 atol = rtol = 5e-5 unless a test states another.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fancyrec_tpu.config import Config as JaxConfig
from fancyrec_tpu.eval.metrics import (
    ranking_metrics_jax, ranking_metrics_oracle as jax_oracle)
from fancyrec_tpu.losses import contrastive_loss as jax_contrastive_loss
from fancyrec_tpu.losses import init_queue_state as jax_init_queue_state
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.models.layers import BatchNorm1dTorch as JaxBatchNorm
from fancyrec_tpu.train.state import TrainState as JaxTrainState
from fancyrec_tpu.train.state import make_optimizer as jax_make_optimizer
from fancyrec_tpu.train.state import scale_lr as jax_scale_lr
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.eval.metrics import (
    ranking_metrics, ranking_metrics_oracle)
from fancyrec_tpu_torch.interop import torch_state_from_jax
from fancyrec_tpu_torch.losses import init_queue_state
from fancyrec_tpu_torch.models.layers import BatchNorm1dTorch
from fancyrec_tpu_torch.train.state import (
    TrainState, clip_grad_norm, current_lr, make_optimizer, scale_lr)
from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
from tests.test_torch_port_model import (
    jax_variables, port_model, ragged_batch, tiny_cfg_kwargs)

TOL = dict(atol=5e-5, rtol=5e-5)


def test_batchnorm_training_mode_matches_jax():
    """Batch statistics (biased variance) in the output, the unbiased
    variance into the running statistics, momentum 0.1; grads too."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5).astype(np.float32) * 2 + 1
    cot = rng.randn(6, 5).astype(np.float32)
    mean0 = rng.randn(5).astype(np.float32)
    var0 = rng.rand(5).astype(np.float32) + 0.5
    scale = rng.rand(5).astype(np.float32) + 0.5
    bias = rng.randn(5).astype(np.float32)
    jbn = JaxBatchNorm(5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}

    def f(xx, p):
        out, mut = jbn.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             xx, use_running_average=False,
                             mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot)), (out, mut["batch_stats"])

    (_, (want, stats)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])

    bn = BatchNorm1dTorch(5)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0.copy()),
                        "running_var": torch.from_numpy(var0.copy())})
    bn.train()
    xt = torch.tensor(x, requires_grad=True)
    out = bn(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(gp["scale"]), **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **TOL)


def _microbatches(jcfg, a, b, seed):
    out = []
    for i in range(a):
        mb = ragged_batch(jcfg, b, seed=seed + i)
        ids = np.random.RandomState(seed + 100 + i).randint(
            0, jcfg.brand_num, b).astype(np.int32)
        ids[-1] = ids[0]                          # a duplicate brand id
        mb["brand_ids"] = ids
        out.append(mb)
    return out


def test_train_step_matches_composed_jax_reference():
    """train_step at A = 2 on a small ph + transformers model with every
    dropout off: per-microbatch losses, the summed grads, their global
    norm, the BatchNorm statistics and the queue after the step."""
    kw = dict(tiny_cfg_kwargs("transformers", "ph", True), dropout=0.0,
              bert_dropout=0.0, loss_fun="cl", cost_style="mean",
              accumulation_step=2, grad_clip=0.0, queue_size=16)
    jcfg, jmodel, params, stats = jax_variables(kw, seed=3)
    mbs = _microbatches(jcfg, 2, 4, seed=30)

    def micro(p, bs, q, mb):
        v = JVisualBatch(jnp.asarray(mb["frames"]), jnp.asarray(mb["origin"]),
                         jnp.asarray(mb["vmask"]))
        t = JTextBatch(jnp.asarray(mb["bows"]), jnp.asarray(mb["tokens"]),
                       jnp.asarray(mb["type_ids"]), jnp.asarray(mb["tmask"]))
        post, mut = jmodel.apply({"params": p, "batch_stats": bs}, v, t,
                                 deterministic=False, mutable=["batch_stats"],
                                 method=jmodel.embed_post,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        brand = jmodel.apply({"params": p}, jnp.asarray(mb["brand_ids"]),
                             deterministic=True, method=jmodel.embed_brand)
        loss, q = jax_contrastive_loss(brand, post, q, cost_style="mean")
        return loss, (mut["batch_stats"], q)

    grad_fn = jax.value_and_grad(micro, has_aux=True)
    bs, q = stats, jax_init_queue_state(16, kw["common_embedding_size"])
    gsum, losses = None, []
    for mb in mbs:
        (loss, (bs, q)), g = grad_fn(params, bs, q, mb)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        losses.append(float(loss))

    model = port_model(kw, params, stats)
    model.brand_encoding.p = 0.0
    model.seed_dropout(0)
    cfg = Config(**kw).finalize()
    opt = make_optimizer(cfg, model.parameters())
    state = TrainState(queue=init_queue_state(16, kw["common_embedding_size"]))
    superbatch = {k: torch.from_numpy(v)
                  for k, v in stack_microbatches(mbs).items()}
    state, metrics = train_step(model, opt, cfg, state, superbatch)

    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), **TOL)
    np.testing.assert_allclose(float(metrics["last_loss"]), losses[-1], **TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(gsum)), **TOL)
    want_grads = torch_state_from_jax(jax.tree.map(np.array, gsum))
    grads = dict(model.named_parameters())
    assert set(want_grads) == set(grads)
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOL)
    sd = model.state_dict()
    for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(
            sd["fusion_encoding.bn." + key].numpy(),
            np.asarray(bs["fusion_encoding"]["bn"][leaf]), **TOL)
    np.testing.assert_allclose(state.queue.queue.numpy(),
                               np.asarray(q.queue), **TOL)
    assert state.queue.ptr == int(q.ptr)
    assert state.step == 2


@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_optimizer_matches_optax_with_the_clip(name):
    """The same grads for 3 steps (the first two above the clip's limit of
    2, the third below it), then the lr scaled by 0.5 and a fourth step.
    Params agree within atol 1e-7: the updates are about lr = 1e-3 and
    differ only by rounding."""
    rng = np.random.RandomState(1)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: (0.1 * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (f * rng.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for f in (3.0, 2.0, 0.05, 1.0)]
    jcfg = JaxConfig(optimizer=name, learning_rate=1e-3, grad_clip=2.0)
    tx = jax_make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = JaxTrainState(params=jparams, batch_stats={},
                           opt_state=tx.init(jparams), queue=None, step=0,
                           rng=None)

    cfg = Config(optimizer=name, learning_rate=1e-3, grad_clip=2.0)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = make_optimizer(cfg, list(params.values()))
    for i, g in enumerate(grads):
        if i == 3:
            jstate = jax_scale_lr(jstate, 0.5)
            scale_lr(opt, 0.5)
            assert current_lr(opt) == pytest.approx(5e-4)
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       jstate.opt_state, jstate.params)
        jstate = jstate.replace(params=optax.apply_updates(jstate.params,
                                                           updates),
                                opt_state=opt_state)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_grad_norm([params[k].grad for k in shapes], 2.0)
        assert (float(norm) > 2.0) == (i in (0, 1, 3))
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jstate.params[k]),
                                       atol=1e-7, rtol=0)


def test_clip_matches_optax_formula():
    """(g / norm) * max above the limit, untouched below it, no epsilon."""
    rng = np.random.RandomState(2)
    gs = [rng.randn(7).astype(np.float32) * 3, rng.randn(2, 3).astype(
        np.float32)]
    for limit in (1.0, 100.0):
        want = optax.clip_by_global_norm(limit).update(
            [jnp.asarray(g) for g in gs], None)[0]
        got = [torch.from_numpy(g.copy()) for g in gs]
        clip_grad_norm(got, limit)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_ranking_metrics_match_jax_and_the_oracle(seed):
    """Scores rounded to one decimal (ties in every row), a brand with no
    posts, and pad posts labelled -1."""
    rng = np.random.RandomState(seed)
    nb, n = 7, 80
    scores = np.round(rng.randn(nb, n), 1).astype(np.float32)
    brands = rng.randint(0, nb - 1, n).astype(np.int32)   # brand 6: none
    brands[-4:] = -1
    got = ranking_metrics(torch.from_numpy(scores), brands, nb)
    want_jax = ranking_metrics_jax(jnp.asarray(scores), jnp.asarray(brands),
                                   nb)
    live = brands >= 0
    want = ranking_metrics_oracle(scores[:, live], brands[live], nb)
    assert want == jax_oracle(scores[:, live], brands[live], nb)
    for g, j, o in zip(got, want_jax, want):
        assert isinstance(g, float)
        np.testing.assert_allclose(g, float(j), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, o, rtol=1e-12, atol=1e-12)
