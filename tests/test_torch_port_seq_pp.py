"""Sequence parallelism (--seq_shard) and the GPipe BERT pipeline
(--pp_stages) in the port against the JAX package, on the CPU.

  * in spawned gloo worlds of library calls: `pipeline_apply` on a toy
    stack over 4 stages (and over 3, the middle stages both receiving and
    sending, with 3 and 6 microbatches) against the sequential stack and
    the JAX `pipeline_apply` on its (2, 4) mesh, forward and grads;
    `bert_pipeline_forward` at (2, 2) with padding masks against the JAX
    pipeline and the JAX sequential encoder on the same weights, its
    grads against the sequential encoder's, remat bit-equal (with the
    dropouts off and on), the JAX usage
    errors, the dropout draws (replay, slots and microbatches, p = 0) and
    bfloat16 within the JAX bound; `seq_shard_pool` against the replicated
    masked mean and conv bank at M = 2 and 4, every valid length and
    width, forward and grads;
  * worlds of trainer updates: --seq_shard at (1, 2) and (2, 2) and
    --pp_stages 2 at (2, 2) against the JAX package's unsharded update of
    the same batches (the tolerances of tests/test_torch_port_tp.py), BERT
    and its Adam moments bit-equal over the model ranks after two
    updates, --seq_shard --pp_stages 2 together at (1, 2);
  * the trainer CLI at (2, 2) with --pp_stages 2 and 4 BERT layers
    (tests/test_multichip.py's pipeline case) against the pp-off run, the
    tester at (1, 2) on a pp- and seq-trained checkpoint against one
    process, and the flags' checks.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fancyrec_tpu.models.bert import BertConfig as JBertConfig
from fancyrec_tpu.models.bert import BertEncoder as JBertEncoder
from fancyrec_tpu.parallel import pipeline as jpipeline
from fancyrec_tpu.parallel.mesh import build_mesh as jax_build_mesh
from fancyrec_tpu_torch.interop import torch_params_from_jax
from fancyrec_tpu_torch.models.bert import BertConfig, BertEncoder
from fancyrec_tpu_torch.models.layers import ConvBank, masked_mean
from fancyrec_tpu.config import Config as JaxConfig
from fancyrec_tpu.train import checkpoints as jckpt
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.eval import tester
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_parallel import (
    _CLI, _cli_argv, results, run_world)
from tests.test_torch_port_tp import (
    _check_against_jax, _jax_trees, _run_steps, jax_reference)

# ---------------------------------------------------------------------------
# worlds of library calls
# ---------------------------------------------------------------------------

# the toy stack of tests/test_pipeline.py: tanh(h @ w_i + b_i)
TOY_L, TOY_D, TOY_M, TOY_MB = 8, 16, 4, 4
# the helper's cases: T = 8 time rows, every valid length 1..8 (the last
# ranks' slices wholly past it at the short ones), every width
SEQ_B, SEQ_T, SEQ_D, SEQ_K = 3, 8, 6, 4
SEQ_WIDTHS = {"visual": (2, 3, 4, 5), "text": (2, 3, 4)}
SEQ_TOL = 1e-6
# BERT: tests/test_pipeline.py's tiny encoder, 4 layers; 12 rows of 12
# tokens (6 a data slot at (2, 2), 12 in 3 microbatches at (1, 3))
BERT_KW = dict(vocab_size=120, hidden_size=32, num_hidden_layers=4,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=64)
BERT_B, BERT_T = 12, 12

# One rank of a library world: spec {"in": the inputs (torch.save), "out":
# the dump prefix, "shapes": the (data, model) layouts to run in turn}.
# At each layout: the toy pipeline (model axis 3 or 4), the sequence
# helper's cases, and at (2, 2) or (1, 3) the BERT pipeline; each rank
# dumps what it computed to out.<rank>.
_LIB = r"""
import json, sys
import torch
torch.set_num_threads(1)
from fancyrec_tpu_torch.models.bert import BertConfig, BertEncoder
from fancyrec_tpu_torch.models.layers import ConvBank, seq_shard_pool
from fancyrec_tpu_torch.parallel import collectives, distributed
from fancyrec_tpu_torch.parallel.pipeline import (
    bert_pipeline_forward, pipeline_apply)
spec = json.loads(sys.argv[1])
inp = torch.load(spec["in"])
distributed.initialize_multihost("cpu")
r = collectives.rank()
dump, res = {}, {"rank": r}


def toy(tag, n_layers, n_micro, rows=16):
    w = inp["toy_w"][:n_layers].clone().requires_grad_()
    b = inp["toy_b"][:n_layers].clone().requires_grad_()
    x = inp["toy_x"][:rows].clone().requires_grad_()
    fn = lambda i, h, aux, m: torch.tanh(h @ w[i] + b[i])
    out = pipeline_apply(fn, n_layers, [w, b], x.view(n_micro, -1, x.shape[1]))
    (out ** 2).sum().backward()
    dump[tag] = {"out": out.detach().reshape(x.shape), "gw": w.grad,
                 "gb": b.grad, "gx": x.grad}


def seq(tag):
    m = collectives.model_size()
    for case in inp["seq"]:
        convs = ConvBank(case["x"].shape[2], case["k"], case["widths"])
        convs.load_state_dict(case["convs"])
        x = case["x"].clone().requires_grad_()
        keep = (case["mask"] > 0 if case["kind"] == "visual" else
                (torch.arange(x.shape[1]) < case["bl"])[None])
        mean, con = seq_shard_pool(x, case["mask"], convs,
                                   torch.tensor(case["bl"]), keep)
        ((mean * case["cm"]).sum() + (con * case["cc"]).sum()).backward()
        dump["%s.%s.%d.%d" % (tag, case["kind"], m, case["bl"])] = {
            "mean": mean.detach(), "con": con.detach(), "gx": x.grad,
            **{"g." + n: p.grad for n, p in convs.named_parameters()}}


def bert_grads(enc, rows, ids, types, mask, cot):
    enc.zero_grad()
    out = bert_pipeline_forward(enc, ids[rows], types[rows], mask[rows])
    (out * cot[rows]).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in enc.parameters()])
    # the data slots' grads of their rows, summed as the trainer sums them
    return out.detach(), collectives.all_reduce_sum_(grads)


def bert(tag, n_layers):
    kw = dict(spec["bert"], num_hidden_layers=n_layers,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, types, mask = inp["ids"], inp["types"], inp["mask"]
    cot = inp["bert_cot"]
    d, data = collectives.data_rank(), collectives.data_size()
    n = ids.shape[0] // data
    rows = slice(d * n, (d + 1) * n)
    state = {k: v for k, v in inp["bert_state"].items()
             if not k.startswith("layer_") or int(k.split(".")[0][6:])
             < n_layers}
    enc = BertEncoder(BertConfig(**kw))
    enc.load_state_dict(state)
    with torch.no_grad():
        dump[tag + ".eval"] = bert_pipeline_forward(enc.eval(), ids[rows],
                                                    types[rows], mask[rows])
    enc.train()
    dump[tag + ".out"], dump[tag + ".grads"] = bert_grads(
        enc, rows, ids, types, mask, cot)
    remat = BertEncoder(BertConfig(**kw, remat=True))
    remat.load_state_dict(state)
    remat.train()
    dump[tag + ".remat"] = bert_grads(remat, rows, ids, types, mask, cot)

    def seeded(remat):
        # dropout on, the model's one stream seeded alike -> the output, the
        # grads and where the stream ends after the backward
        enc = BertEncoder(BertConfig(**dict(kw, hidden_dropout_prob=0.1,
                                            attention_probs_dropout_prob=0.1),
                                     remat=remat))
        enc.load_state_dict(state)
        enc.train()
        gen = torch.Generator().manual_seed(11)
        for mod in enc.modules():
            if hasattr(mod, "generator"):
                mod.generator = gen
        out, grads = bert_grads(enc, rows, ids, types, mask, cot)
        return out, grads, gen.get_state()
    dump[tag + ".drop_remat"] = [seeded(False), seeded(True)]
    if n_layers % collectives.model_size() == 0:
        bf16 = BertEncoder(BertConfig(**kw, compute_dtype="bfloat16"))
        bf16.load_state_dict(state)
        with torch.no_grad():
            dump[tag + ".bf16"] = bert_pipeline_forward(
                bf16.eval(), ids[rows], types[rows], mask[rows]).float()
    errors = []
    for call in (lambda: bert_pipeline_forward(enc, ids[rows], types[rows],
                                               mask[rows], n_micro=5),
                 lambda: bert_pipeline_forward(enc, ids[:1], types[:1],
                                               mask[:1])):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    res[tag + ".errors"] = errors
    # dropout: every row the same, so two masks show in two rows' outputs;
    # the slots' streams seeded alike, so only the fold tells them apart
    drop = BertEncoder(BertConfig(**dict(kw, hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.5)))
    drop.load_state_dict(state)
    drop.train()
    same = inp["ids"][:1].expand(n, -1)
    ones = torch.ones_like(same)
    runs = []
    for seed in (7, 7, 8):
        gen = torch.Generator().manual_seed(seed)
        for mod in drop.modules():
            if hasattr(mod, "generator"):
                mod.generator = gen
        with torch.no_grad():
            runs.append(bert_pipeline_forward(drop, same, same * 0, ones))
    dump[tag + ".drop"] = torch.stack(runs)
    # p = 0 in training mode against evaluation mode
    zero = BertEncoder(BertConfig(**dict(kw, hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0)))
    zero.load_state_dict(state)
    with torch.no_grad():
        dump[tag + ".p0"] = torch.stack([
            bert_pipeline_forward(zero.train(), ids[rows], types[rows],
                                  mask[rows]),
            bert_pipeline_forward(zero.eval(), ids[rows], types[rows],
                                  mask[rows])])


for shape in spec["shapes"]:
    collectives.set_layout(*shape)
    tag = "%dx%d" % tuple(shape)
    if shape[1] == 4:
        toy(tag + ".toy", 8, 4)
    if shape[1] == 3:
        toy(tag + ".toy3", 6, 3, 12)
        toy(tag + ".toy6", 6, 6, 12)
        try:                               # 8 layers over 3 stages
            toy(tag + ".toy8", 8, 3, 12)
        except ValueError as e:
            res["layers_error"] = str(e)
        bert(tag + ".bert", 3)
    if shape[1] in (2, 4):
        seq(tag + ".seq")
    if shape == [2, 2]:
        bert(tag + ".bert", 4)
torch.save(dump, "%s.%d" % (spec["out"], r))
print("RESULT " + json.dumps(res))
"""


def _toy_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(TOY_L, TOY_D, TOY_D) * 0.3).astype(np.float32)
    b = (rng.randn(TOY_L, TOY_D) * 0.1).astype(np.float32)
    x = rng.randn(TOY_M * TOY_MB, TOY_D).astype(np.float32)
    return w, b, x


def _seq_cases():
    """Every (tower, valid length): x, the mask (rows of lengths up to
    bl, one of them bl), the conv bank's weights and the cotangents."""
    rng = np.random.RandomState(1)
    g = torch.Generator().manual_seed(1)
    cases = []
    for kind, widths in SEQ_WIDTHS.items():
        for bl in range(1, SEQ_T + 1):
            lens = rng.randint(1, bl + 1, SEQ_B)
            lens[rng.randint(SEQ_B)] = bl
            mask = (np.arange(SEQ_T)[None] < lens[:, None]).astype(np.float32)
            convs = ConvBank(SEQ_D, SEQ_K, widths)
            for p in convs.parameters():
                p.data = torch.randn(p.shape, generator=g) * 0.5
            cases.append({
                "kind": kind, "bl": bl, "widths": widths, "k": SEQ_K,
                "x": torch.randn(SEQ_B, SEQ_T, SEQ_D, generator=g),
                "mask": torch.from_numpy(mask), "convs": convs.state_dict(),
                "cm": torch.randn(SEQ_B, SEQ_D, generator=g),
                "cc": torch.randn(SEQ_B, SEQ_K * len(widths), generator=g)})
    return cases


def _bert_inputs():
    """The JAX encoder's initialized params and a batch with padding."""
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 120, (BERT_B, BERT_T)).astype(np.int32)
    types = np.zeros((BERT_B, BERT_T), np.int32)
    lens = rng.randint(3, BERT_T + 1, BERT_B)
    mask = (np.arange(BERT_T)[None] < lens[:, None]).astype(np.int32)
    enc = JBertEncoder(JBertConfig(**BERT_KW))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                      jnp.asarray(types), jnp.asarray(mask))["params"]
    params = jax.tree.map(np.array, jax.device_get(params))
    cot = rng.randn(BERT_B, BERT_T, BERT_KW["hidden_size"]).astype(
        np.float32)
    return ids, types, mask, params, cot


@pytest.fixture(scope="module")
def lib_inputs(tmp_path_factory):
    w, b, x = _toy_inputs()
    ids, types, mask, params, cot = _bert_inputs()
    inp = {"toy_w": torch.from_numpy(w), "toy_b": torch.from_numpy(b),
           "toy_x": torch.from_numpy(x), "seq": _seq_cases(),
           "ids": torch.from_numpy(ids).long(),
           "types": torch.from_numpy(types).long(),
           "mask": torch.from_numpy(mask).long(),
           "bert_state": torch_params_from_jax(params),
           "bert_cot": torch.from_numpy(cot)}
    path = str(tmp_path_factory.mktemp("seq_pp_lib") / "inputs.pt")
    torch.save(inp, path)
    return {"path": path, "inp": inp, "params": params}


def _lib_world(lib_inputs, tmp_path_factory, shapes, ranks):
    out = str(tmp_path_factory.mktemp("seq_pp_world") / "dump")
    spec = {"in": lib_inputs["path"], "out": out, "shapes": shapes,
            "bert": BERT_KW}
    got = results(run_world(_LIB, [json.dumps(spec)], ranks=ranks))
    return got, [torch.load("%s.%d" % (out, r)) for r in range(ranks)]


@pytest.fixture(scope="module")
def world4(lib_inputs, tmp_path_factory):
    """Four ranks: the layouts (1, 4), then (2, 2)."""
    return _lib_world(lib_inputs, tmp_path_factory, [[1, 4], [2, 2]], 4)


@pytest.fixture(scope="module")
def world3(lib_inputs, tmp_path_factory):
    """Three ranks at (1, 3): the middle stage receives and sends."""
    return _lib_world(lib_inputs, tmp_path_factory, [[1, 3]], 3)


def _toy_sequential(w, b, x):
    w, b, x = (torch.from_numpy(a).clone().requires_grad_()
               for a in (w, b, x))
    h = x
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i] + b[i])
    (h ** 2).sum().backward()
    return {"out": h.detach(), "gw": w.grad, "gb": b.grad, "gx": x.grad}


def _toy_jax(w, b, x):
    """The JAX package's pipeline_apply on its (2, 4) mesh: out and the
    grads of the same loss."""
    mesh = jax_build_mesh("2,4")

    def layer(p, h, aux):
        return jnp.tanh(h @ p["w"] + p["b"])

    def piped(params, xf):
        return jpipeline.pipeline_apply(
            layer, params, xf.reshape(TOY_M, TOY_MB, TOY_D), mesh=mesh,
            axis="model").reshape(-1, TOY_D)

    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    out = jax.jit(piped)(params, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda p, v: jnp.sum(piped(p, v) ** 2),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    return {"out": np.asarray(out), "gw": np.asarray(gp["w"]),
            "gb": np.asarray(gp["b"]), "gx": np.asarray(gx)}


def test_toy_pipeline_over_4_stages_matches_sequential_and_jax(world4):
    """`pipeline_apply` of 8 layers over 4 stages, 4 microbatches of 4:
    the output (replicated on every stage) and the grads of the stacked
    weights (summed over the stages) and of the input equal the sequential
    stack's and the JAX pipeline's on its (2, 4) mesh."""
    w, b, x = _toy_inputs()
    seq = _toy_sequential(w, b, x)
    ref = _toy_jax(w, b, x)
    _, dumps = world4
    for d in dumps:
        got = d["1x4.toy"]
        assert torch.equal(got["out"], dumps[0]["1x4.toy"]["out"])
        np.testing.assert_allclose(got["out"].numpy(), ref["out"], atol=1e-6)
        np.testing.assert_allclose(got["out"].numpy(), seq["out"].numpy(),
                                   atol=1e-6)
        for k in ("gw", "gb", "gx"):
            np.testing.assert_allclose(got[k].numpy(), seq[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k].numpy(), ref[k], atol=1e-4,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("tag,n_micro", [("toy3", 3), ("toy6", 6)])
def test_toy_pipeline_over_3_stages(world3, tag, n_micro):
    """Three stages (the middle one receives and sends every tick), 6
    layers, 12 rows in 3 microbatches and in 6 (more than stages: every
    stage busy in the steady state): the sequential stack's output and
    grads."""
    w, b, x = _toy_inputs()
    seq = _toy_sequential(w[:6], b[:6], x[:12])
    _, dumps = world3
    for d in dumps:
        got = d["1x3." + tag]
        np.testing.assert_allclose(got["out"].numpy(), seq["out"].numpy(),
                                   atol=1e-6)
        for k in ("gw", "gb", "gx"):
            np.testing.assert_allclose(got[k].numpy(), seq[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)


def _seq_replicated(case):
    convs = ConvBank(SEQ_D, SEQ_K, case["widths"])
    convs.load_state_dict(case["convs"])
    x = case["x"].clone().requires_grad_()
    mean = masked_mean(x, case["mask"])
    if case["kind"] == "visual":
        conv_in = x * case["mask"][..., None]
    else:
        keep = (torch.arange(SEQ_T) < case["bl"])[None, :, None]
        conv_in = torch.where(keep, x, torch.zeros_like(x))
    con = convs(conv_in, torch.tensor(case["bl"]))
    ((mean * case["cm"]).sum() + (con * case["cc"]).sum()).backward()
    return {"mean": mean.detach(), "con": con.detach(), "gx": x.grad,
            **{"g." + n: p.grad for n, p in convs.named_parameters()}}


@pytest.mark.parametrize("kind", ["visual", "text"])
@pytest.mark.parametrize("model_axis", [2, 4])
def test_seq_shard_pool_matches_the_replicated_pools(world4, lib_inputs,
                                                     kind, model_axis):
    """`seq_shard_pool` at M model ranks (T = 8, so 4 or 2 rows a rank),
    for every valid length 1..8 (the short ones leave the last ranks'
    slices wholly invalid: finfo.min, not NaN) and every width of the
    tower (visual 2-5, text 2-4, so the halo and tail positions of each):
    the masked mean and the conv bank's max-pool equal the replicated
    ones on every rank, and so do the grads of the input and of the conv
    weights, within 1e-6."""
    _, dumps = world4
    tag = "1x4.seq" if model_axis == 4 else "2x2.seq"
    for case in lib_inputs["inp"]["seq"]:
        if case["kind"] != kind:
            continue
        want = _seq_replicated(case)
        for d in dumps:
            got = d["%s.%s.%d.%d" % (tag, kind, model_axis, case["bl"])]
            assert set(got) == set(want)
            for k, v in want.items():
                assert torch.isfinite(got[k]).all(), (case["bl"], k)
                np.testing.assert_allclose(
                    got[k].numpy(), v.numpy(), atol=SEQ_TOL, rtol=SEQ_TOL,
                    err_msg="bl %d %s" % (case["bl"], k))


def _bert_references(lib_inputs, n_layers):
    """The JAX sequential encoder (deterministic) on the fixture's batch,
    and the port's sequential encoder's output and parameter grads of
    sum(out * cot), from the same weights."""
    ids, types, mask, params, cot = _bert_inputs()
    jcfg = JBertConfig(**dict(BERT_KW, num_hidden_layers=n_layers))
    sub = {k: v for k, v in params.items()
           if not k.startswith("layer_") or int(k[6:]) < n_layers}
    jseq = np.asarray(JBertEncoder(jcfg).apply(
        {"params": sub}, jnp.asarray(ids), jnp.asarray(types),
        jnp.asarray(mask), deterministic=True))
    enc = BertEncoder(BertConfig(**dict(
        BERT_KW, num_hidden_layers=n_layers, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)))
    enc.load_state_dict(torch_params_from_jax(sub))
    enc.train()
    out = enc(*(torch.from_numpy(a).long() for a in (ids, types, mask)))
    (out * torch.from_numpy(cot)).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in enc.parameters()])
    return {"jax_seq": jseq, "seq": out.detach().numpy(), "grads": grads,
            "sub": sub, "jcfg": jcfg, "ids": ids, "types": types,
            "mask": mask}


@pytest.fixture(scope="module")
def bert4(lib_inputs):
    ref = _bert_references(lib_inputs, 4)
    mesh = jax_build_mesh("2,2")
    ref["jax_pp"] = np.asarray(jax.jit(
        lambda p: jpipeline.bert_pipeline_forward(
            p, ref["jcfg"], jnp.asarray(ref["ids"]),
            jnp.asarray(ref["types"]), jnp.asarray(ref["mask"]), mesh=mesh,
            axis="model"))(ref["sub"]))
    return ref


def _slot_rows(dumps, key, data):
    """The data slots' rows of `key`, in slot order, from each slot's first
    model rank; every model rank of a slot must hold the same bits."""
    model = len(dumps) // data
    for slot in range(data):
        for d in dumps[slot * model + 1:(slot + 1) * model]:
            assert torch.equal(d[key], dumps[slot * model][key]), key
    return torch.cat([dumps[slot * model][key] for slot in range(data)])


def test_bert_pipeline_at_2x2_matches_jax(world4, bert4):
    """`bert_pipeline_forward` of 4 layers over 2 stages, each data slot on
    its 4 rows in 2 microbatches, with padding masks: the output equals
    the JAX `bert_pipeline_forward` on a (2, 2) mesh and the JAX
    sequential encoder on the same weights (atol 2e-5, rtol 1e-5, as
    tests/test_pipeline.py), bit-equal over each slot's model ranks."""
    _, dumps = world4
    got = _slot_rows(dumps, "2x2.bert.eval", 2).numpy()
    for want in (bert4["jax_pp"], bert4["jax_seq"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_bert_pipeline_grads_at_2x2_match_the_sequential_encoder(world4,
                                                                 bert4):
    """The training path (dropouts at 0) through the schedule's backward:
    the output, and the parameter grads (each stage's layers' grads summed
    over the model group, the embeddings' through the input's
    model_copy, the slots' summed over the data group), equal the
    sequential encoder's; every rank holds the same grads bit for bit."""
    _, dumps = world4
    got = _slot_rows(dumps, "2x2.bert.out", 2).numpy()
    np.testing.assert_allclose(got, bert4["seq"], atol=2e-5, rtol=1e-5)
    for d in dumps:
        assert torch.equal(d["2x2.bert.grads"], dumps[0]["2x2.bert.grads"])
    np.testing.assert_allclose(dumps[0]["2x2.bert.grads"].numpy(),
                               bert4["grads"].numpy(), atol=2e-5, rtol=1e-4)


def test_bert_pipeline_remat_is_bit_equal(world4, world3):
    """--bert_remat inside a stage (each layer recomputed in the backward,
    its dropout generators replayed): the same output and grads, bit for
    bit, at (2, 2) and at (1, 3)."""
    for dumps, tag in ((world4[1], "2x2.bert"), (world3[1], "1x3.bert")):
        for d in dumps:
            out, grads = d[tag + ".remat"]
            assert torch.equal(out, d[tag + ".out"])
            assert torch.equal(grads, d[tag + ".grads"])


def test_bert_pipeline_remat_with_dropout_is_bit_equal(world4, world3):
    """--bert_remat with the dropouts on (0.1), a seeded stream: the same
    output and grads as the seeded run without remat, bit for bit, at
    (2, 2) and at (1, 3), and the stream ends in the same state (each
    layer's recompute in the backward binds its microbatch's generator
    again and replays its masks, as jax.checkpoint replays its key, and
    draws nothing from the shared stream)."""
    for dumps, tag in ((world4[1], "2x2.bert"), (world3[1], "1x3.bert")):
        for d in dumps:
            plain, remat = d[tag + ".drop_remat"]
            assert not torch.equal(plain[0], d[tag + ".out"])
            assert torch.equal(remat[0], plain[0])
            assert torch.equal(remat[1], plain[1])
            assert torch.equal(remat[2], plain[2])


def test_bert_pipeline_over_3_stages(world3, lib_inputs):
    """3 layers over 3 stages (the recipe's depth at --pp_stages 3): the
    output and grads equal the sequential encoder's; 8 layers over 3
    stages is the JAX package's error."""
    got, dumps = world3
    ref = _bert_references(lib_inputs, 3)
    np.testing.assert_allclose(_slot_rows(dumps, "1x3.bert.eval", 1).numpy(),
                               ref["jax_seq"], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(dumps[0]["1x3.bert.out"].numpy(), ref["seq"],
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(dumps[0]["1x3.bert.grads"].numpy(),
                               ref["grads"].numpy(), atol=2e-5, rtol=1e-4)
    for r in got:
        assert "not divisible by 3 pipeline stages" in r["layers_error"]


def test_bert_pipeline_usage_errors_are_the_jax_ones(world4, world3):
    """A microbatch count that does not divide the batch, and a microbatch
    that does not divide over the data axis, raise the JAX package's
    ValueErrors, on every rank, before any message is sent."""
    for r in world4[0]:
        split, micro = r["2x2.bert.errors"]
        assert "batch 12 not divisible into 5 microbatches" in split
        assert "microbatch size 1 not divisible by the 2-wide" in micro
    for r in world3[0]:
        assert all("not divisible into" in e for e in r["1x3.bert.errors"])


def test_bert_pipeline_dropout_draws(world4):
    """Attention dropout 0.5 on identical rows, the data slots' streams
    seeded alike: a seed replays bit for bit, another seed draws other
    masks; rows in different microbatches of a slot and the same rows of
    different data slots draw different masks (the (slot, layer,
    microbatch) fold); each slot's model ranks hold the same output."""
    _, dumps = world4
    runs = _slot_rows(dumps, "2x2.bert.drop", 2)     # (3 runs stacked) x2
    slot0, slot1 = runs[:3], runs[3:]
    for s in (slot0, slot1):
        assert torch.equal(s[0], s[1])
        assert (s[0] - s[2]).abs().max() > 1e-3
        # 6 rows a slot in 2 microbatches of 3: row r and row r + 3
        for r in range(3):
            assert (s[0][r] - s[0][r + 3]).abs().max() > 1e-4
    assert (slot0[0] - slot1[0]).abs().max() > 1e-4
    assert torch.isfinite(runs).all()


def test_bert_pipeline_p0_is_the_deterministic_path(world4, world3):
    """Dropout probabilities 0 in training mode: the pipelined output is
    the evaluation-mode output bit for bit (no draw is made)."""
    for dumps, tag in ((world4[1], "2x2.bert.p0"), (world3[1], "1x3.bert.p0")):
        for d in dumps:
            assert torch.equal(d[tag][0], d[tag][1])


def test_bert_pipeline_bf16_within_the_jax_bound(world4, bert4, lib_inputs):
    """bfloat16 compute at (2, 2): the stream between layers is bfloat16,
    as in the JAX pipeline; the output stays within
    tests/test_pipeline.py's bound (0.1) of the JAX sequential bfloat16
    encoder on the same weights."""
    _, dumps = world4
    got = _slot_rows(dumps, "2x2.bert.bf16", 2).numpy()
    jcfg = JBertConfig(**dict(BERT_KW, compute_dtype="bfloat16"))
    want = np.asarray(JBertEncoder(jcfg).apply(
        {"params": bert4["sub"]}, jnp.asarray(bert4["ids"]),
        jnp.asarray(bert4["types"]), jnp.asarray(bert4["mask"]),
        deterministic=True), np.float32)
    delta = np.abs(got - want).max()
    assert np.isfinite(got).all() and delta < 0.1, delta


# ---------------------------------------------------------------------------
# worlds of trainer updates
# ---------------------------------------------------------------------------

# tests/test_multichip.py's pipeline case: 4 BERT layers, 2 stages
LAYERS = ["--bert_num_layers", "4"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_seq_pp"))
    # 3 brands x (4 videos + 4 images) = 24 posts a split: 6 batches of 4
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    return root


@pytest.fixture(scope="module")
def jax_ref(root, tmp_path_factory):
    """The JAX package's unsharded update (tests/test_torch_port_tp.py's)
    with 4 BERT layers."""
    return jax_reference(root, tmp_path_factory, LAYERS, bf16=False)


def _variants(jax_ref, **named):
    """{name: the JAX weights, the brand dropout off, and `set`}."""
    base = {"weights": jax_ref["weights"], "no_brand_dropout": True}
    return {k: dict(base, **v) for k, v in named.items()}


@pytest.fixture(scope="module")
def world_2x2(root, jax_ref, tmp_path_factory):
    """Four ranks at (2, 2): --pp_stages 2 (two updates), --seq_shard."""
    out = str(tmp_path_factory.mktemp("seq_pp_2x2") / "w")
    return _run_steps(root, jax_ref, out, "2,2", 4, _variants(
        jax_ref, pp={"set": {"pp_stages": 2}, "steps": 2},
        seq={"set": {"seq_shard": True}}))


@pytest.fixture(scope="module")
def world_1x2(root, jax_ref, tmp_path_factory):
    """Two ranks at (1, 2): --seq_shard; --seq_shard with --pp_stages 2
    (two updates after the first's dump, its checkpoint saved)."""
    tmp = tmp_path_factory.mktemp("seq_pp_1x2")
    logdir = tmp / "model" / "pp_seq"
    os.makedirs(logdir)
    got = _run_steps(root, jax_ref, str(tmp / "w"), "1,2", 2, _variants(
        jax_ref, seq={"set": {"seq_shard": True}},
        pp_seq={"set": {"pp_stages": 2, "seq_shard": True}, "steps": 2,
                "save": str(logdir / "model_best.pth.tar")}))
    return got, str(logdir)


def _check_split_calls(got, name):
    """Every rank's first update split the pools' time axes twice a
    microbatch (the visual and the text tower) under --seq_shard, and ran
    BERT's pipeline once a microbatch under --pp_stages, neither
    otherwise: the comparison is of the split code, not of the replicated
    pools it falls back to where the model axis does not divide T."""
    for r in got:
        micro, calls = r[name]["rows"][0], r[name]["calls"]
        assert calls == {
            "seq_shard_pool": 2 * micro if "seq" in name else 0,
            "bert_pipeline_forward": micro if "pp" in name else 0}, calls


@pytest.mark.parametrize("name", ["pp", "seq"])
def test_update_at_2x2_equals_the_jax_unsharded_update(jax_ref, world_2x2,
                                                       name):
    """--pp_stages 2 (BERT's 4 layers over the 2 model ranks of each slot,
    whole on each) or --seq_shard at (2, 2): the loss, grad norm (BERT's
    grads counted once), gathered grads, updated params, BatchNorm
    statistics and queue of one update equal the JAX package's unsharded
    update of the same batches, at tests/test_torch_port_tp.py's
    tolerances; replicated tensors bit-equal over each slot's model
    ranks; the split code ran (`_check_split_calls`)."""
    got, dumps = world_2x2
    assert [r["mesh"] for r in got] == [[2, 2]] * 4
    _check_split_calls(got, name)
    _check_against_jax(jax_ref, got, dumps[name], [2, 2], name)


@pytest.mark.parametrize("name", ["seq", "pp_seq"])
def test_update_at_1x2_equals_the_jax_unsharded_update(jax_ref, world_1x2,
                                                       name):
    """--seq_shard, and --seq_shard with --pp_stages 2, at (1, 2): the JAX
    package's unsharded update (tests/test_multichip.py's sharded-step
    test, on the port's model axis)."""
    (got, dumps), _ = world_1x2
    _check_split_calls(got, name)
    _check_against_jax(jax_ref, got, dumps[name], [2, 4], name)


def _bit_equal_over_model_ranks(dumps, model):
    for slot in range(len(dumps) // model):
        ranks = dumps[slot * model:(slot + 1) * model]
        assert any(k.startswith("text_encoding.bert.layer_")
                   for k in ranks[0]["after"])
        for d in ranks[1:]:
            assert d["after"].keys() == ranks[0]["after"].keys()
            for k, t in ranks[0]["after"].items():
                assert torch.equal(t, d["after"][k]), (slot, k)


def test_bert_bit_equal_over_model_ranks_after_two_updates(world_2x2,
                                                           world_1x2):
    """Under --pp_stages each model rank holds BERT whole: after two
    updates every replicated parameter (BERT's layers among them) and its
    Adam moments are bit-equal over the model ranks of each slot, at
    (2, 2) and at (1, 2) with --seq_shard (each stage's layer grads summed
    over the model group by one all-reduce, whose sum every rank gets)."""
    _bit_equal_over_model_ranks(world_2x2[1]["pp"], 2)
    _bit_equal_over_model_ranks(world_1x2[0][1]["pp_seq"], 2)


def test_pp_keeps_bert_whole_under_the_rules(world_2x2):
    """At (2, 2) under --pp_stages 2 no BERT tensor is split (the JAX
    `skip_bert`), while the brand tables and the mapping FCs still are;
    without pp the rules split BERT's FFN as before."""
    from fancyrec_tpu_torch.parallel import mesh
    _, dumps = world_2x2
    shapes = {k: t.shape for k, t in dumps["pp"][0]["full"].items()}
    m = mesh.Mesh(data=2, model=2)
    pp = mesh.param_shardings(m, shapes, pp=True)
    tp = mesh.param_shardings(m, shapes)
    split_pp = {k for k, d in pp.items() if d is not None}
    split_tp = {k for k, d in tp.items() if d is not None}
    assert not any(".bert." in k for k in split_pp)
    assert split_pp == {k for k in split_tp if ".bert." not in k}
    assert {"brand_encoding.aspects_embeddings",
            "brand_encoding.brand_embeddings"} <= split_pp
    assert any(".bert." in k for k in split_tp)
    # every rank's own BERT tensors are the whole ones (`local` holds the
    # unsplit state)
    for d in dumps["pp"]:
        for k in shapes:
            if ".bert." in k:
                assert torch.equal(d["local"][k], d["full"][k]), k


def test_pp_checkpoint_is_whole_and_loads_in_one_process_and_in_jax(
        jax_ref, world_1x2, tmp_path):
    """The checkpoint a (1, 2) world writes under --pp_stages 2
    --seq_shard holds the whole model (BERT as every rank holds it, the
    split tables gathered): it loads strictly in one port process, equal
    to the world's gathered tensors, and its trees, written by the JAX
    package as FRTPU1, load in the JAX package and back in the port."""
    (_, dumps), logdir = world_1x2
    ck = checkpoints.load_checkpoint(os.path.join(logdir,
                                                  "model_best.pth.tar"))
    assert ck["config"].pp_stages == 2 and ck["config"].seq_shard
    full = dumps["pp_seq"][0]["full"]
    assert set(ck["state_dict"]) == set(full)
    for k, t in full.items():
        assert torch.equal(ck["state_dict"][k], t), k
    FancyRec(ck["config"]).load_state_dict(ck["state_dict"])
    params, stats = _jax_trees(ck["state_dict"], jax_ref["params"],
                               jax_ref["stats"])
    path = str(tmp_path / "from_pp.pth.tar")
    jckpt.save_checkpoint(path, jax_ref["jcfg"], params, stats, 1, 0.0, 2)
    back = jckpt.load_any(path)["model"]
    got = jax.tree_util.tree_leaves(back["params"])
    want = jax.tree_util.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)
    port = checkpoints.load_any(path)["state_dict"]
    for k, t in full.items():
        assert torch.equal(port[k], t), k


def test_tester_at_1x2_on_a_pp_and_seq_checkpoint(root, world_1x2, capsys):
    """The tester CLI at (1, 2) on the --pp_stages 2 --seq_shard checkpoint
    (BERT pipelined over the two model ranks, the pools' time axes split
    over them) reports the metrics of the one-process tester on the same
    checkpoint, which runs BERT in sequence and says so."""
    _, logdir = world_1x2
    targv = ["insCartest", "--rootpath", root, "--logger_name", logdir,
             "--batch_size", "4", "--device", "cpu", "--overwrite", "1"]
    tested = results(run_world(_CLI, [root, tester.__name__, json.dumps(
        targv + ["--mesh_shape", "1,2"])], ranks=2))
    assert tested[0]["first"] == tested[1]["first"]
    capsys.readouterr()
    single = tester.main(targv)._asdict()
    assert "BERT runs its layers in sequence" in capsys.readouterr().out
    for k, v in single.items():
        assert tested[0]["first"][k] == pytest.approx(v, abs=1e-6), k


TRANSFORMERS = ["--text_net", "transformers", "--bert_dropout", "0"] + LAYERS


@pytest.fixture(scope="module")
def one_process_cli(root):
    """The trainer CLI in this process, 4 BERT layers, pp off (the brand
    dropout off, as the worlds' ranks have it)."""
    from fancyrec_tpu_torch.models import brand
    init = brand.BrandAspects.__init__

    def no_brand_dropout(self, *a, **k):
        init(self, *a, **k)
        self.p = 0.0
    brand.BrandAspects.__init__ = no_brand_dropout
    try:
        return trainer.main(_cli_argv(root, "pp_1proc") + TRANSFORMERS
                            + ["--mesh_shape", "1,1"])
    finally:
        brand.BrandAspects.__init__ = init


def test_trainer_cli_pp_at_2x2_matches_pp_off(root, one_process_cli):
    """`fancyrec-train ... --mesh_shape 2,2 --pp_stages 2` with 4 BERT
    layers and --bert_dropout 0 (tests/test_multichip.py's pipeline case):
    every rank reports the same best, within rel 1e-3 of the pp-off run
    in one process; only rank 0 writes."""
    argv = (_cli_argv(root, "pp_2x2") + TRANSFORMERS
            + ["--mesh_shape", "2,2", "--pp_stages", "2"])
    got = results(run_world(_CLI, [root, trainer.__name__, json.dumps(argv)],
                            ranks=4))
    best = [r["first"] for r in got]
    assert len(set(best)) == 1 and best[0] > 0
    assert best[0] == pytest.approx(one_process_cli, rel=1e-3)
    assert [r["again"] for r in got] == [None] * 4
    logdir = os.path.join(root, "model", "pp_2x2")
    ck = checkpoints.load_checkpoint(os.path.join(logdir,
                                                  "model_best.pth.tar"))
    assert (ck["config"].pp_stages, ck["config"].mesh_shape) == (2, "2,2")


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------

# tests/test_multichip.py's --pp_stages misconfigurations, and one that holds
PP_CASES = [
    ({"pp_stages": 3}, "not divisible by --pp_stages"),
    ({"text_net": "bi-gru", "pp_stages": 2}, "needs --text_net transformers"),
    ({"pp_stages": 2, "mesh_shape": "2,4"}, "must equal the model mesh axis"),
    ({"pp_stages": 2, "mesh_shape": "8,2"}, "pipeline microbatch"),
    ({"pp_stages": 2, "mesh_shape": "2,2"}, None),
]


@pytest.mark.parametrize("kw,match", PP_CASES,
                         ids=[m or "valid" for _, m in PP_CASES])
def test_pp_stages_validation_is_the_jax_packages(kw, match):
    """`Config.finalize` checks --pp_stages as the JAX package's does, with
    its message, word for word."""
    kw = dict({"text_net": "transformers", "bert_num_layers": 4,
               "batch_size": 8}, **kw)
    if match is None:
        Config(**kw).finalize()
        JaxConfig(**kw).finalize()
        return
    with pytest.raises(ValueError, match=match) as got:
        Config(**kw).finalize()
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw).finalize()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("world,batch,want", [
    (4, 8, "2,2"), (2, 8, "1,2"), (3, 8, "does not divide the 3"),
    (4, 6, "pipeline microbatch 3"), (1, 8, "does not divide the 1")])
def test_pp_stages_without_mesh_shape_derives_the_mesh(world, batch, want):
    """--pp_stages 2 without --mesh_shape: the mesh is (world / 2, 2), as
    the JAX trainer derives it from its devices, with its errors where 2
    does not divide the world or a microbatch the data axis."""
    cfg = Config(text_net="transformers", bert_num_layers=4,
                 batch_size=batch, pp_stages=2)
    if "," in want:
        trainer.derive_pp_mesh(cfg, world)
        assert cfg.mesh_shape == want
        cfg.finalize()
    else:
        with pytest.raises(ValueError, match=want):
            trainer.derive_pp_mesh(cfg, world)
