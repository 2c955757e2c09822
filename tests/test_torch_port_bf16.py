"""The JAX package's throughput mode in the port, on the CPU: bf16 towers
(--dtype bfloat16), bf16 host staging (--transfer_dtype bfloat16),
--bert_remat and --profile_dir.

Same weights and seeded numpy inputs through each package's module with
the compute dtype bfloat16. Both keep parameters in float32 and cast
where flax's `dtype=` casts, but XLA and torch sum in other orders, so a
value on a bfloat16 rounding boundary may land one ulp (2^-8 relative)
apart, and the next layers carry that on. Tolerance of a bfloat16
output, compared in float32: |port - JAX| <= 2^-7 x max |JAX| (two ulps
of the largest element); measured at most one ulp of it for each module
and 2^-8 x max for the whole model (the six text-net x fusion pairs).
The bi-GRU computes in its input's dtype, float32 in both towers, as in
the JAX package (`test_bigru_stays_float32_under_bf16_towers`).
"""

import gzip
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fancyrec_tpu.losses import contrastive_loss as jax_contrastive_loss
from fancyrec_tpu.losses import init_queue_state as jax_init_queue_state
from fancyrec_tpu.models import bert as jbert
from fancyrec_tpu.models import fusion as jfusion
from fancyrec_tpu.models import gru as jgru
from fancyrec_tpu.models import layers as jlayers
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.eval import tester
from fancyrec_tpu_torch.interop import torch_state_from_jax
from fancyrec_tpu_torch.losses import init_queue_state
from fancyrec_tpu_torch.models import bert as tbert
from fancyrec_tpu_torch.models import fusion as tfusion
from fancyrec_tpu_torch.models import layers as tlayers
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
from fancyrec_tpu_torch.serving import index as sindex
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.train.state import TrainState, make_optimizer
from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_model import (
    jax_variables, port_model, ragged_batch, tiny_cfg_kwargs)
from tests.test_torch_port_train import _microbatches
from tests.test_torch_port_trainer import TINY

BF16 = jnp.bfloat16


def assert_bf16_close(got, want, ulps=2):
    """got (torch) against want (JAX), in float32, within `ulps` bfloat16
    ulps (2^-8 each) of the largest |want|; dtypes must match."""
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.detach().float().numpy()
    bound = ulps * 2.0 ** -8 * np.abs(w).max()
    err = np.abs(g - w).max()
    assert err <= bound, "max |port - JAX| %.3g > %.3g" % (err, bound)
    return err / np.abs(w).max()


def _load(module, params, stats=None):
    module.load_state_dict(torch_state_from_jax(params, stats))
    return module


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


# ------------------------------------------------------------ the modules

def test_mfc_bf16_matches_jax():
    rng = np.random.RandomState(0)
    x = _rand(rng, 5, 24)
    jm = jlayers.MFC(16, dtype=BF16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(tlayers.MFC(24, 16, dtype=torch.bfloat16), params).eval()
    assert_bf16_close(tm(torch.from_numpy(x)), want)


def test_attention_pool_bf16_matches_jax():
    """float32 frames: the scores and weights in bfloat16, the pooled
    output float32 (weight x frames promotes)."""
    rng = np.random.RandomState(1)
    x = _rand(rng, 4, 7, 12)
    mask = (np.arange(7)[None] < np.array([7, 3, 5, 1])[:, None]).astype(
        np.float32)
    jm = jlayers.AttentionPool(hidden=3, heads=3, dtype=BF16)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                     jnp.asarray(mask))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x),
                    jnp.asarray(mask).astype(BF16))
    tm = _load(tlayers.AttentionPool(12, 3, 3, dtype=torch.bfloat16), params)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert_bf16_close(got, np.asarray(want), ulps=2)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_conv_bank_bf16_matches_jax(x_dtype):
    rng = np.random.RandomState(2)
    x = _rand(rng, 3, 9, 10)
    jx = jnp.asarray(x).astype(x_dtype)
    jm = jlayers.ConvBank(6, (2, 3, 4), dtype=BF16)
    params = jm.init(jax.random.PRNGKey(2), jx, jnp.asarray(6))["params"]
    want = jm.apply({"params": params}, jx, jnp.asarray(6))
    tm = _load(tlayers.ConvBank(10, 6, (2, 3, 4), dtype=torch.bfloat16),
               params)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    assert_bf16_close(tm(tx, torch.tensor(6)), want)


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_on_bf16_input_matches_jax(training):
    """bfloat16 statistics and normalized values; the float32 scale,
    bias and running statistics promote the output (and the running
    statistics' update) to float32."""
    rng = np.random.RandomState(3)
    x = jnp.asarray(_rand(rng, 6, 5, scale=2.0) + 1).astype(BF16)
    stats0 = {"mean": _rand(rng, 5), "var": np.abs(_rand(rng, 5)) + 0.5}
    params = {"scale": _rand(rng, 5) + 1, "bias": _rand(rng, 5)}
    jm = jlayers.BatchNorm1dTorch(5)
    want, mut = jm.apply({"params": params, "batch_stats": stats0}, x,
                         use_running_average=not training,
                         mutable=["batch_stats"])
    tm = tlayers.BatchNorm1dTorch(5)
    tm.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats0["mean"]),
                        "running_var": torch.from_numpy(stats0["var"])})
    tm.train(training)
    got = tm(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_bf16_close(got, np.asarray(want), ulps=2)
    for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(tm, key).numpy(),
                                   np.asarray(mut["batch_stats"][leaf]),
                                   atol=2.0 ** -8, rtol=2.0 ** -8)


def _bert_cfgs(**kw):
    base = dict(vocab_size=40, hidden_size=24, num_hidden_layers=2,
                num_attention_heads=3, intermediate_size=32,
                max_position_embeddings=16, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return jbert.BertConfig(**base), tbert.BertConfig(**base)


def _bert_inputs(seed=4, b=3, t=9):
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, t + 1, b)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(1, 40, (b, t)) * mask).astype(np.int32)
    return ids, np.zeros_like(ids), mask


@pytest.mark.parametrize("layers", [0, 1, 2])
def test_bert_bf16_matches_jax(layers):
    """compute_dtype bfloat16: the LayerNorms' float32 scale makes every
    layer's output float32; with no layer the embeddings leave in
    bfloat16."""
    jcfg, tcfg = _bert_cfgs(num_hidden_layers=layers,
                            compute_dtype="bfloat16")
    ids, typ, mask = _bert_inputs()
    jm = jbert.BertEncoder(jcfg)
    params = jm.init(jax.random.PRNGKey(4), ids, typ, mask)["params"]
    params = jax.tree.map(
        lambda p: p + 0.05 * np.random.RandomState(5).randn(*p.shape)
        .astype(np.float32), params)
    want = jm.apply({"params": params}, ids, typ, mask)
    tm = _load(tbert.BertEncoder(tcfg), params).eval()
    got = tm(torch.from_numpy(ids).long(), torch.from_numpy(typ).long(),
             torch.from_numpy(mask))
    assert_bf16_close(got, np.asarray(want), ulps=2)


@pytest.mark.parametrize("style", ["fc", "ph", "ph_train", "attn"])
def test_fusion_heads_bf16_match_jax(style):
    rng = np.random.RandomState(6)
    if style == "attn":
        vis, txt = _rand(rng, 4, 10), _rand(rng, 4, 7)
        jm = jfusion.FusionAttnReduction(common_dim=8, visual_size=10,
                                         text_size=7, dtype=BF16)
        tm = tfusion.FusionAttnReduction(10, 7, 8, dtype=torch.bfloat16)
        jv, jt = jnp.asarray(vis), jnp.asarray(txt)
    else:
        vis, txt = _rand(rng, 6, 8), _rand(rng, 6, 8)
        jv, jt = (jnp.asarray(a).astype(BF16) for a in (vis, txt))
        if style == "fc":
            jm = jfusion.FusionFC(common_dim=8, dtype=BF16)
            tm = tfusion.FusionFC(16, 8, dtype=torch.bfloat16)
        else:
            jm = jfusion.FusionProjectionHead(common_dim=8, hidden=12,
                                              dtype=BF16)
            tm = tfusion.FusionProjectionHead(16, 8, hidden=12,
                                              dtype=torch.bfloat16)
    training = style == "ph_train"
    variables = jm.init(jax.random.PRNGKey(6), jv, jt)
    params = jax.tree.map(lambda p: p + 0.1, variables["params"])
    stats = jax.tree.map(lambda s: s + 0.2, variables.get("batch_stats", {}))
    want, _ = jm.apply({"params": params, "batch_stats": stats}, jv, jt,
                       deterministic=not training, mutable=["batch_stats"])
    _load(tm, params, stats).train(training)
    tv, tt = (torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)))
              .to(torch.bfloat16 if style != "attn" else torch.float32)
              for a in (jv, jt))
    assert_bf16_close(tm(tv, tt), want)


def test_bigru_stays_float32_under_bf16_towers(monkeypatch):
    """The JAX package's BiGRU computes in its input's dtype (its `dtype`
    field is never read), and both towers hand it float32: under --dtype
    bfloat16 the recurrence, and K1 with it, stays float32. The port
    does the same."""
    seen = {}
    orig = jgru._bigru_recurrence

    def spy(x_fwd, x_bwd, fwd, bwd, use_pallas=None):
        seen.setdefault("jax", set()).add(str(x_fwd.dtype))
        return orig(x_fwd, x_bwd, fwd, bwd, use_pallas)

    monkeypatch.setattr(jgru, "_bigru_recurrence", spy)
    from fancyrec_tpu_torch.models import gru as tgru
    torig = tgru._bigru_recurrence

    def tspy(x_fwd, x_bwd, fwd, bwd):
        seen.setdefault("port", set()).add(str(x_fwd.dtype))
        return torig(x_fwd, x_bwd, fwd, bwd)

    monkeypatch.setattr(tgru, "_bigru_recurrence", tspy)
    for text_net in ("transformers", "bi-gru"):
        kw = dict(tiny_cfg_kwargs(text_net), dtype="bfloat16")
        _forward_both(kw, seed=0)
    assert seen == {"jax": {"float32"}, "port": {"torch.float32"}}


# ------------------------------------------------------- the whole model

def _forward_both(kw, seed):
    jcfg, jmodel, params, stats = jax_variables(kw, seed=seed)
    batch = ragged_batch(jcfg, 5, seed=seed + 20)
    ids = (np.arange(5) % kw["brand_num"]).astype(np.int32)
    jb, jp = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(ids),
        JVisualBatch(*(jnp.asarray(batch[k])
                       for k in ("frames", "origin", "vmask"))),
        JTextBatch(*(jnp.asarray(batch[k])
                     for k in ("bows", "tokens", "type_ids", "tmask"))))
    model = port_model(kw, params, stats)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        pb, pp = model(torch.from_numpy(ids).long(),
                       VisualBatch(tb["frames"], tb["origin"], tb["vmask"]),
                       TextBatch(tb["bows"], tb["tokens"].long(),
                                 tb["type_ids"].long(), tb["tmask"]))
    return (pb, pp), (jb, jp)


@pytest.mark.parametrize("fusion", ["ph", "fc", "attn"])
@pytest.mark.parametrize("text_net", ["transformers", "bi-gru"])
def test_fancyrec_bf16_forward_matches_jax(text_net, fusion):
    """The brand embedding in float32 (equal to 5e-5), the post embedding
    in bfloat16 within two ulps of its largest element (measured: 0 to 2
    ulps; 2^-8 x max at most)."""
    kw = dict(tiny_cfg_kwargs(text_net, fusion), dtype="bfloat16")
    (pb, pp), (jb, jp) = _forward_both(kw, seed=1)
    assert pb.dtype == torch.float32
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=5e-5,
                               rtol=5e-5)
    assert_bf16_close(pp, jp, ulps=2)


def _flat(grads):
    return torch.cat([grads[k].reshape(-1) for k in sorted(grads)])


def _jax_step_grads(kw, mbs, params, stats, jmodel):
    def micro(p, bs, q, mb):
        v = JVisualBatch(*(jnp.asarray(mb[k])
                           for k in ("frames", "origin", "vmask")))
        t = JTextBatch(*(jnp.asarray(mb[k])
                         for k in ("bows", "tokens", "type_ids", "tmask")))
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
    return float(np.mean(losses)), torch_state_from_jax(
        jax.tree.map(np.array, gsum))


@pytest.mark.parametrize("text_net", ["transformers", "bi-gru"])
def test_bf16_train_step_matches_jax(text_net):
    """One bfloat16 train step (A = 2, every dropout off, the 'cl' loss)
    against the JAX package's composed from its public functions. The
    loss agrees within 1e-2 relative (measured 6e-4 and 2.3e-3). A bf16
    step's grads are rounding-sensitive (the loss divides cosines by
    0.03): the JAX package's own bf16 grads sit 12.7% (transformers) and
    9.5% (bi-gru) from its float32 grads in relative L2. The bound: the
    port's bf16 grads lie nearer the JAX bf16 grads (measured 8.7% and
    4.5%) than the JAX bf16 grads lie to the JAX float32 grads, and
    within 15% of them."""
    kw = dict(tiny_cfg_kwargs(text_net, "ph", True), dropout=0.0,
              bert_dropout=0.0, loss_fun="cl", cost_style="mean",
              accumulation_step=2, grad_clip=0.0, queue_size=16,
              dtype="bfloat16")
    jcfg, jmodel, params, stats = jax_variables(kw, seed=3)
    mbs = _microbatches(jcfg, 2, 4, seed=30)
    jloss, jgrads = _jax_step_grads(kw, mbs, params, stats, jmodel)
    kw32 = dict(kw, dtype="float32")
    _, jmodel32, _, _ = jax_variables(kw32, seed=3)
    _, jgrads32 = _jax_step_grads(kw32, mbs, params, stats, jmodel32)

    model = port_model(kw, params, stats)
    model.brand_encoding.p = 0.0
    model.seed_dropout(0)
    cfg = Config(**kw).finalize()
    opt = make_optimizer(cfg, model.parameters())
    state = TrainState(queue=init_queue_state(16, kw["common_embedding_size"]))
    superbatch = {k: torch.from_numpy(v)
                  for k, v in stack_microbatches(mbs).items()}
    _, metrics = train_step(model, opt, cfg, state, superbatch)
    assert abs(float(metrics["loss"]) - jloss) <= 1e-2 * abs(jloss)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in got.values())
    jb, jf = _flat(jgrads), _flat(jgrads32)
    port_err = float((_flat(got) - jb).norm() / jb.norm())
    spread = float((jb - jf).norm() / jf.norm())
    assert port_err < min(spread, 0.15), (port_err, spread)


# ------------------------------------------------------------ the flags

def test_transfer_dtype_rounds_as_ml_dtypes():
    """--transfer_dtype bfloat16 stages the float32 arrays as bfloat16
    tensors rounded as ml_dtypes (the JAX package's cast) rounds them, to
    nearest even, ties and subnormals included; int arrays stay."""
    rng = np.random.RandomState(7)
    f = np.concatenate([
        rng.randn(2000).astype(np.float32) * 10.0 ** rng.randint(-40, 38,
                                                                2000),
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40,
                  3.4e38, 0.0, -0.0], np.float32)]).astype(np.float32)
    batch = {"frames": f.reshape(1, 1, -1), "tokens": np.arange(6, dtype=np.int32)
             .reshape(1, 1, 6)}
    (sb,) = list(trainer._superbatches([{k: v[0] for k, v in batch.items()}],
                                       1, transfer_dtype="bfloat16"))
    assert sb["frames"].dtype == torch.bfloat16
    assert isinstance(sb["tokens"], np.ndarray)
    want = f.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(sb["frames"].float().numpy().reshape(-1),
                                  want)


def _remat_grads(remat, seed=8, p=0.3):
    jcfg, tcfg = _bert_cfgs(hidden_dropout_prob=p,
                            attention_probs_dropout_prob=p, remat=remat)
    ids, typ, mask = _bert_inputs(seed=9)
    params = jbert.BertEncoder(jcfg).init(jax.random.PRNGKey(seed), ids, typ,
                                          mask)["params"]
    tm = _load(tbert.BertEncoder(tcfg), params).train()
    gen = torch.Generator().manual_seed(seed)
    for m in tm.modules():
        if isinstance(m, tlayers.Dropout):
            m.generator = gen
    out = tm(torch.from_numpy(ids).long(), torch.from_numpy(typ).long(),
             torch.from_numpy(mask))
    cot = torch.from_numpy(_rand(np.random.RandomState(10), *out.shape))
    (out * cot).sum().backward()
    after = gen.get_state()
    return out.detach(), {n: q.grad for n, q in tm.named_parameters()}, after


def test_bert_remat_replays_dropout_exactly():
    """--bert_remat at dropout 0.3: the recompute draws the forward's masks
    from the explicit generator, so the output and every grad equal the
    run without remat bit for bit, and the generator ends where it would
    have (the next draws are unchanged)."""
    out0, g0, gen0 = _remat_grads(False)
    out1, g1, gen1 = _remat_grads(True)
    assert torch.equal(out0, out1)
    assert torch.equal(gen0, gen1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_bert_remat_matches_jax_remat_at_p0():
    """At dropout 0 the port's remat BERT gives the JAX package's remat
    BERT's output and grads (float32, atol = rtol = 5e-5)."""
    jcfg, tcfg = _bert_cfgs(remat=True)
    ids, typ, mask = _bert_inputs(seed=11)
    jm = jbert.BertEncoder(jcfg)
    params = jm.init(jax.random.PRNGKey(11), ids, typ, mask)["params"]
    cot = _rand(np.random.RandomState(12), 3, 9, 24)

    def f(p):
        return jnp.sum(jm.apply({"params": p}, ids, typ, mask,
                                deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
                       * cot)

    want = torch_state_from_jax(jax.tree.map(np.array, jax.grad(f)(params)))
    tm = _load(tbert.BertEncoder(tcfg), params).train()
    out = tm(torch.from_numpy(ids).long(), torch.from_numpy(typ).long(),
             torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    for n, q in tm.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), want[n].numpy(),
                                   atol=5e-5, rtol=5e-5, err_msg=n)


# ------------------------------------------------- the CLIs, end to end

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_fast"))
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    return root


def test_fast_mode_trains_profiles_evaluates_and_serves(root, tmp_path):
    """The trainer CLI with --dtype bfloat16 --transfer_dtype bfloat16
    --bert_remat 1 --profile_dir at tiny widths on the CPU: a finite loss,
    a non-empty trace of epoch min(1, num_epochs - 1) = 1, a bf16
    checkpoint whose config keeps the flags; then the tester CLI and
    `serving.index build` on that checkpoint give finite float32
    results."""
    prof = str(tmp_path / "prof")
    args = TINY + ["--rootpath", root, "--postfix", "fast",
                   "--num_epochs", "2", "--dtype", "bfloat16",
                   "--transfer_dtype", "bfloat16", "--bert_remat", "1",
                   "--profile_dir", prof]
    calls = []
    trace = trainer.profiling.trace

    def spy(logdir, device=None):
        calls.append(logdir)
        return trace(logdir, device)

    trainer.profiling.trace = spy
    try:
        best = trainer.main(args)
    finally:
        trainer.profiling.trace = trace
    assert calls == ["", prof]
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json.gz")
    assert os.path.getsize(os.path.join(prof, traces[0])) > 0
    with gzip.open(os.path.join(prof, traces[0]), "rt") as f:
        events = json.load(f)["traceEvents"]
    # the program's spans, as ranges of their names above their kernels
    names = {e.get("name") for e in events}
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer", "data.wait", "train.loss_read"} <= names
    logdir = os.path.join(root, "model", "fast")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["loss"]) for r in recs) and np.isfinite(best)
    ckpt = checkpoints.load_any(os.path.join(logdir, "model_best.pth.tar"))
    cfg = ckpt["config"]
    assert (cfg.dtype, cfg.transfer_dtype, int(cfg.bert_remat)) == (
        "bfloat16", "bfloat16", 1)
    m = tester.main(["insCartest", "--rootpath", root, "--logger_name",
                     logdir, "--batch_size", "4", "--device", "cpu"])
    assert all(np.isfinite(v) for v in m)
    out = str(tmp_path / "index")
    n = sindex.build_index(os.path.join(logdir, "model_best.pth.tar"), root,
                           "insCartest", out, batch_size=4, device="cpu")
    index = sindex.PostIndex(out, device="cpu")
    embs = index.store.read_rows(range(index.n_posts))
    assert n == index.n_posts == 24 and embs.shape == (24, 32)
    assert embs.dtype == np.float32 and np.isfinite(embs).all()
    assert index.brand_embs.dtype == np.float32
