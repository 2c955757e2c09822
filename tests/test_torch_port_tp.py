"""Tensor parallelism in the port (the model mesh axis) against the JAX
package, on the CPU.

  * the sharding rules against the JAX package's `param_shardings` on a
    (4, 2) mesh, the odd-size fallback included; a model rank's modules at
    the widths of the shards of the full state dict;
  * K2's plain versions on aspect shards: the shards' outputs sum to the
    one-table output, their keep bits concatenate to its bits bit for bit
    and their grads to its grads;
  * in spawned gloo worlds (the ranks of tests/test_torch_port_parallel.py):
    one update at --mesh_shape 1,2 and 2,2 against the JAX package's
    unsharded update of the same global batches, at the two-rank
    tolerances of tests/test_torch_port_parallel.py;
    the model ranks of a slot holding the same bits on every replicated
    tensor; (1, 2) with every dropout on against one process; --bert_remat
    bit-equal to no remat; the bf16 update within the bf16 step test's
    bound; the clip's norm over shards; the checkpoints a (1, 2) world
    writes and resumes, across packages;
  * the trainer and tester CLIs at --mesh_shape 1,2 and 2,2.
"""

import copy
import json
import os
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fancyrec_tpu.config import build_train_parser as jax_parser
from fancyrec_tpu.config import config_from_args as jax_config_from_args
from fancyrec_tpu.data.loader import BatchLoader as JaxBatchLoader
from fancyrec_tpu.losses import contrastive_loss as jax_contrastive_loss
from fancyrec_tpu.losses import init_queue_state as jax_init_queue_state
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.parallel import mesh as jmesh
from fancyrec_tpu.train import checkpoints as jckpt
from fancyrec_tpu.train import trainer as jtrainer
from fancyrec_tpu.train.state import init_state as jax_init_state
from fancyrec_tpu.train.state import make_optimizer as jax_make_optimizer
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.eval import tester
from fancyrec_tpu_torch.interop import torch_state_from_jax
from fancyrec_tpu_torch.models import FancyRec, brand
from fancyrec_tpu_torch.ops import brand_dropout as bd
from fancyrec_tpu_torch.parallel import mesh
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.train.state import (
    load_optimizer_state, make_optimizer)
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_checkpoints import _adam_state_after
from tests.test_torch_port_model import tiny_cfg_kwargs
from tests.test_torch_port_parallel import (
    ARGS, GRAD_TOL, LOSS_REL, NORM_REL, PARAM_TOL, _CLI, _cli_argv, results,
    run_world)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_tp"))
    # 3 brands x (4 videos + 4 images) = 24 posts a split: 6 batches of 4
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    return root


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

# (the JAX leaf path, its shape): tests/test_multichip.py's cases on the
# recipe's widths, the BERT FFN's, and the fallback of sizes the model axis
# does not divide
RULE_CASES = [
    ("brand_encoding/aspects_embeddings", (2000, 1024)),
    ("brand_encoding/brand_embeddings", (52, 2000)),
    ("text_encoding/text_mapping/fc1/kernel", (9000, 1024)),
    ("text_encoding/text_mapping/fc1/bias", (1024,)),
    ("vid_encoding/visual_mapping/fc1/kernel", (4864, 1024)),
    ("text_encoding/bert/layer_0/intermediate/kernel", (768, 3072)),
    ("text_encoding/bert/layer_2/intermediate/bias", (3072,)),
    ("text_encoding/bert/layer_1/output/kernel", (3072, 768)),
    ("text_encoding/bert/layer_1/output/bias", (768,)),
    ("text_encoding/bert/layer_1/attention/query/kernel", (768, 768)),
    ("misc/w", (7,)),
    ("brand_encoding/aspects_embeddings", (2001, 1024)),
    ("vid_encoding/visual_mapping/fc1/kernel", (4865, 1024)),
]


def _jax_tree(path, shape):
    tree = leaf = {}
    keys = path.split("/")
    for k in keys[:-1]:
        leaf = leaf.setdefault(k, {})
    leaf[keys[-1]] = np.zeros(shape, np.float32)
    return tree


@pytest.mark.parametrize("path,shape", RULE_CASES,
                         ids=["%s-%s" % (p.replace("/", "."), "x".join(
                             map(str, s))) for p, s in RULE_CASES])
def test_param_rules_match_jax(path, shape):
    """The port's rule for a tensor, on its name and torch layout, splits
    the dim that the JAX package's rule splits on a (4, 2) mesh of the
    tests' 8 CPU devices, and leaves replicated what it leaves."""
    tree = _jax_tree(path, shape)
    spec = jax.tree_util.tree_leaves(
        jmesh.param_shardings(jmesh.build_mesh("4,2"), tree),
        is_leaf=lambda x: hasattr(x, "spec"))[0].spec
    jax_dim = next((d for d, ax in enumerate(spec) if ax == "model"), None)
    (name, value), = torch_state_from_jax(tree).items()
    got = mesh.param_shardings(mesh.Mesh(data=4, model=2), {name: value})
    # a flax kernel (in, out) is a torch weight (out, in)
    want = (None if jax_dim is None
            else (1 - jax_dim if path.endswith("kernel") else jax_dim))
    assert got == {name: want}


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("text_net", ["transformers", "bi-gru"])
def test_model_rank_widths_are_the_shards(text_net, model_axis):
    """Each model rank's FancyRec holds the shards of the full model's
    state dict (`shard_state_dict`), its `split_dims` are the rules on the
    full shapes, and the ranks' shards of a tensor concatenate to it."""
    cfg = Config(**dict(tiny_cfg_kwargs(text_net),
                        brand_aspect=16)).finalize()
    full = FancyRec(cfg).state_dict()
    for k, v in full.items():
        full[k] = torch.randn(v.shape, generator=torch.Generator(
        ).manual_seed(len(k)))
    split = mesh.param_shardings(mesh.Mesh(1, model_axis), full)
    assert {k for k, d in split.items() if d is not None} >= {
        "brand_encoding.aspects_embeddings", "brand_encoding.brand_embeddings"}
    parts = []
    for r in range(model_axis):
        m = mesh.Mesh(data=1, model=model_axis, rank=r)
        local = FancyRec(cfg, m)
        shard = mesh.shard_state_dict(full, m)
        assert {k: tuple(v.shape) for k, v in local.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in shard.items()}
        assert local.split_dims() == split
        local.load_full_state_dict(full)
        parts.append(local.state_dict())
    for k, dim in split.items():
        if dim is None:
            assert all(torch.equal(p[k], full[k]) for p in parts), k
        else:
            assert torch.equal(torch.cat([p[k] for p in parts], dim),
                               full[k]), k


def test_optimizer_state_shards_follow_their_parameters():
    """A whole model's Adam state (a torch state_dict, as the port's
    checkpoints hold it) loads into a model rank's optimizer as the
    shards of each split parameter's moments, the replicated moments and
    every step count whole."""
    cfg = Config(**dict(tiny_cfg_kwargs(), brand_aspect=16)).finalize()
    full = FancyRec(cfg)
    opt = make_optimizer(cfg, full.parameters())
    g = torch.Generator().manual_seed(1)
    for p in full.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    saved = opt.state_dict()
    names = [n for n, _ in full.named_parameters()]
    for r in range(2):
        local = FancyRec(cfg, mesh.Mesh(data=1, model=2, rank=r))
        local.load_full_state_dict(full.state_dict())
        lopt = make_optimizer(cfg, local.parameters())
        load_optimizer_state(lopt, local, saved)
        got = lopt.state_dict()["state"]
        split = local.split_dims()
        for i, n in enumerate(names):
            for m, v in saved["state"][i].items():
                want = v
                if split[n] is not None and v.dim():
                    k = v.shape[split[n]] // 2
                    want = v.narrow(split[n], r * k, k)
                assert torch.equal(got[i][m], want), (n, m)


# ---------------------------------------------------------------------------
# K2 on aspect shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("keep", [0.5, 1.0])
@pytest.mark.parametrize("c", [16, 18])
def test_k2_plain_on_shards_is_the_one_table_k2(model_axis, keep, c):
    """The M shards (aspects [a_off, a_off + A/M) of A = 16, C = 16 or 18:
    one Philox block for 4 columns, or one an element) drawn with the
    table's A and their first aspect: outputs sum to the one-table output,
    keep bits concatenate to its keep bits bit for bit, grads (from the
    bits, and from the seed) concatenate to its grads."""
    b, a = 3, 16
    g = torch.Generator().manual_seed(c * 10 + model_axis)
    w = torch.randn(b, a, generator=g)
    asp = torch.randn(a, c, generator=g)
    gr = torch.randn(b, c, generator=g)
    seed = (0x2545F491, 0x9E3779B9 + c)
    out, bits = bd.aspect_dropout_fwd_ref(w, asp, seed, keep, with_bits=True)
    dw, dasp = bd.aspect_dropout_bwd_bits_ref(w, asp, gr, bits, keep)
    n = a // model_axis
    outs, sbits, dws, dasps = [], [], [], []
    for r in range(model_axis):
        cols = slice(r * n, (r + 1) * n)
        o, bb = bd.aspect_dropout_fwd_ref(w[:, cols], asp[cols], seed, keep,
                                          with_bits=True, a_total=a,
                                          a_off=r * n)
        d1 = bd.aspect_dropout_bwd_bits_ref(w[:, cols], asp[cols], gr, bb,
                                            keep, a_total=a)
        d2 = bd.aspect_dropout_bwd_ref(w[:, cols], asp[cols], gr, seed, keep,
                                       a_total=a, a_off=r * n)
        assert all(torch.equal(x, y) for x, y in zip(d1, d2))
        outs.append(o)
        sbits.append(bb)
        dws.append(d1[0])
        dasps.append(d1[1])
    assert torch.equal(torch.cat(sbits, dim=1), bits)
    np.testing.assert_allclose(sum(outs).numpy(), out.numpy(), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(torch.cat(dws, 1).numpy(), dw.numpy(),
                               atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(torch.cat(dasps, 0).numpy(), dasp.numpy(),
                               atol=5e-5, rtol=5e-5)


def test_k2_refuses_a_shard_outside_its_table():
    w, asp = torch.zeros(2, 4), torch.zeros(4, 8)
    for a_total, a_off in ((6, 3), (4, -1), (3, 0)):
        with pytest.raises(ValueError, match="outside"):
            bd.aspect_dropout_mean(w, asp, (1, 2), 0.5, a_total, a_off)


# ---------------------------------------------------------------------------
# worlds of gloo ranks: one update
# ---------------------------------------------------------------------------

# One rank (or a process outside any world) of the update tests: the
# trainer's process-sharded loader and super-batch stream, then one
# train_step for each variant of spec["variants"] ({name: {"set": config
# overrides, "weights": a full state dict to load, "resume": a checkpoint
# to load with its optimizer state, "no_brand_dropout", "save": a
# checkpoint to write}}), each dumped gathered (the full params, grads and
# buffers) and local (this rank's replicated tensors) to out.<name>.<rank>;
# "steps": 2 runs a second update on the next super-batch and dumps this
# rank's replicated parameters and their Adam moments after it ("after")
_TP_STEP = """
import copy, json, sys
import torch
torch.set_num_threads(1)
from fancyrec_tpu_torch.config import build_train_parser, config_from_args
from fancyrec_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from fancyrec_tpu_torch.parallel import collectives, distributed
from fancyrec_tpu_torch.parallel.mesh import (
    build_mesh, gather_state_dict, process_batch_shard)
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.train.state import (
    global_norm, init_state, load_optimizer_state, sharded_params)
from fancyrec_tpu_torch.models import encoders
spec = json.loads(sys.argv[1])
base = config_from_args(build_train_parser().parse_args(spec["argv"]))
device = distributed.initialize_multihost("cpu")
# the towers' calls of the sequence split and the pipeline, counted
calls = dict.fromkeys(("seq_shard_pool", "bert_pipeline_forward"), 0)
def counted(name):
    fn = getattr(encoders, name)
    def call(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    setattr(encoders, name, call)
for n in list(calls):
    counted(n)
mesh = build_mesh(base.mesh_shape)
ds = trainer.build_datasets(base)["train"]
r = collectives.rank()
res = {"rank": r, "mesh": [mesh.data, mesh.model]}
for name, v in spec["variants"].items():
    cfg = copy.deepcopy(base)
    for k, val in dict(spec.get("set", {}), **v.get("set", {})).items():
        setattr(cfg, k, val)
    cfg.finalize()
    loader = BatchLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                         final_batch="drop",
                         process_shard=process_batch_shard(mesh,
                                                           cfg.batch_size))
    model, opt, state = init_state(cfg, device, mesh=mesh)
    if "weights" in v:
        model.load_full_state_dict(torch.load(v["weights"]))
    if "resume" in v:
        ck = checkpoints.load_any(v["resume"])
        model.load_full_state_dict(ck["state_dict"])
        load_optimizer_state(opt, model, ck["optimizer"])
    if v.get("no_brand_dropout"):
        model.brand_encoding.p = 0.0
    stream = prefetch_to_device(trainer._superbatches(
        loader, cfg.accumulation_step, cfg.token_buckets_list,
        cfg.frame_buckets_list, cfg.transfer_dtype), device,
        trainer._TRAIN_KEYS)
    _, sb = next(stream)
    sb2 = next(stream)[1] if v.get("steps", 1) > 1 else None
    stream.close()
    calls.update(dict.fromkeys(calls, 0))
    state, metrics = trainer.train_step(model, opt, cfg, state, sb)
    first_calls = dict(calls)
    split = model.split_dims()
    params = dict(model.named_parameters())
    grads = {n: p.grad for n, p in params.items()}
    full_grads = gather_state_dict(grads, split)
    local = {k: t for k, t in model.state_dict().items() if split[k] is None}
    local.update({"grad." + n: g for n, g in grads.items()
                  if split[n] is None})
    if "save" in v:
        checkpoints.save_checkpoint(v["save"], cfg, model, opt,
                                    write=distributed.is_primary(), epoch=1)
    dump = {"full": model.full_state_dict(), "grads": full_grads,
            "local": local, "queue": state.queue.queue,
            "ptr": state.queue.ptr,
            # the norm of the clipped grads, from the shards and whole
            "norm_shards": global_norm(list(grads.values()),
                                       sharded_params(model)),
            "norm_full": global_norm(list(full_grads.values()))}
    dump["after"] = {}
    if sb2 is not None:
        dump = copy.deepcopy(dump)
        trainer.train_step(model, opt, cfg, state, sb2)
        moments = opt.state_dict()["state"]
        for i, (n, p) in enumerate(model.named_parameters()):
            if split[n] is None:
                dump["after"][n] = p.detach().clone()
                for k in ("exp_avg", "exp_avg_sq"):
                    dump["after"][k + "." + n] = moments[i][k].clone()
    torch.save(dump, "%s.%s.%d" % (spec["out"], name, r))
    res[name] = {"rows": list(sb["frames"].shape[:2]), "step": state.step,
                 "calls": first_calls,
                 **{k: float(x) for k, x in metrics.items()}}
print("RESULT " + json.dumps(res))
"""


def _argv(root, tiny_bert):
    """The recipe's towers (transformers, ph fusion with its BatchNorm, the
    cl loss with its queue, the clip) at the fixture's tiny widths, every
    dropout off."""
    return (ARGS + ["--rootpath", root, "--text_net", "transformers",
                    "--dropout", "0", "--bert_dropout", "0",
                    "--grad_clip", "0.5", "--queue_size", "16"],
            tiny_bert)


@pytest.fixture(scope="module")
def jax_ref(root, tmp_path_factory):
    """The JAX package's unsharded update of the JAX loader's first two
    microbatches of 4 posts, from perturbed weights (as the two-rank
    test computes it), and its raw float32 and bfloat16 grad sums of the
    same microbatches without the clip."""
    return jax_reference(root, tmp_path_factory)


def jax_reference(root, tmp_path_factory, extra=(), bf16=True):
    """`jax_ref` for `_argv`'s flags followed by `extra`; bf16=False
    leaves out the bfloat16 grad sum."""
    with open(os.path.join(root, "bert_vocab.txt")) as f:
        tiny_bert = dict(bert_vocab_size=len(f.read().split()),
                         bert_intermediate_size=32, bert_max_position=32)
    argv, _ = _argv(root, tiny_bert)
    argv = argv + list(extra)
    jcfg = jax_config_from_args(jax_parser().parse_args(argv))
    jds = jtrainer.build_datasets(jcfg)["train"]
    for k, v in tiny_bert.items():
        setattr(jcfg, k, v)
    jcfg.finalize()
    jloader = JaxBatchLoader(jds, jcfg.batch_size, shuffle=True,
                             seed=jcfg.seed, final_batch="drop")
    mbs = [b for b, _ in zip(jloader, range(jcfg.accumulation_step))]
    jmodel, jstate = jax_init_state(jcfg, seed=5)
    rng = np.random.RandomState(6)
    noisy = lambda x: (np.asarray(x)                          # noqa: E731
                       + 0.05 * rng.randn(*np.shape(x))).astype(np.float32)
    params = jax.tree.map(noisy, jax.device_get(jstate.params))
    stats = jax.tree.map(lambda x: np.abs(noisy(x)),
                         jax.device_get(jstate.batch_stats))

    def grad_sum(model):
        def micro(p, bs, q, mb):
            v = JVisualBatch(jnp.asarray(mb["frames"]),
                             jnp.asarray(mb["origin"]),
                             jnp.asarray(mb["vmask"]))
            t = JTextBatch(jnp.asarray(mb["bows"]), jnp.asarray(mb["tokens"]),
                           jnp.asarray(mb["type_ids"]),
                           jnp.asarray(mb["tmask"]))
            post, mut = model.apply(
                {"params": p, "batch_stats": bs}, v, t, deterministic=False,
                mutable=["batch_stats"], method=model.embed_post,
                rngs={"dropout": jax.random.PRNGKey(0)})
            brand_emb = model.apply({"params": p},
                                    jnp.asarray(mb["brand_ids"]),
                                    deterministic=True,
                                    method=model.embed_brand)
            loss, q = jax_contrastive_loss(brand_emb, post, q,
                                           cost_style="mean")
            return loss, (mut["batch_stats"], q)

        grad_fn = jax.jit(jax.value_and_grad(micro, has_aux=True))
        bs, q = stats, jax_init_queue_state(16, jcfg.common_embedding_size)
        gsum, losses = None, []
        for mb in mbs:
            (loss, (bs, q)), g = grad_fn(params, bs, q, mb)
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
            losses.append(float(loss))
        return gsum, losses, bs, q

    gsum, losses, bs, q = grad_sum(jmodel)
    tx = jax_make_optimizer(jcfg)
    updates, _ = jax.jit(tx.update)(gsum, tx.init(params), params)
    bf_cfg = copy.deepcopy(jcfg)
    bf_cfg.dtype = "bfloat16"
    bf16_gsum = (grad_sum(jax_init_state(bf_cfg, seed=5)[0])[0] if bf16
                 else gsum)
    weights = str(tmp_path_factory.mktemp("tp_weights") / "w.pt")
    torch.save(torch_state_from_jax(params, stats), weights)
    clipped = optax.clip_by_global_norm(jcfg.grad_clip).update(gsum, None)[0]
    flat = lambda t: torch.cat([v.reshape(-1) for _, v in  # noqa: E731
                                sorted(torch_state_from_jax(jax.tree.map(
                                    np.array, t)).items())])
    return {"tiny_bert": tiny_bert, "extra": list(extra), "jcfg": jcfg,
            "params": params,
            "stats": stats, "weights": weights, "losses": losses,
            "norm": float(optax.global_norm(gsum)), "bs": bs, "q": q,
            "params_after": torch_state_from_jax(jax.tree.map(
                np.array, optax.apply_updates(params, updates))),
            "grads": torch_state_from_jax(jax.tree.map(np.array, clipped)),
            "flat32": flat(gsum), "flat16": flat(bf16_gsum)}


def _run_steps(root, jax_ref, out, mesh_shape, ranks, variants, extra=()):
    argv, tiny_bert = _argv(root, jax_ref["tiny_bert"])
    spec = {"argv": argv + jax_ref.get("extra", []) + list(extra) + (
        ["--mesh_shape", mesh_shape] if mesh_shape else []),
        "set": tiny_bert, "variants": variants, "out": out}
    got = results(run_world(_TP_STEP, [json.dumps(spec)], ranks=ranks))
    dumps = {name: [torch.load("%s.%s.%d" % (out, name, r["rank"]))
                    for r in got] for name in variants}
    return got, dumps


@pytest.fixture(scope="module")
def world_1x2(root, jax_ref, tmp_path_factory):
    """A (1, 2) world's updates: from the JAX weights with every dropout
    off (float32, float32 under --bert_remat 1, and bfloat16 without the
    clip; the first one also saved as a checkpoint), from the seed with
    every dropout on, and resumed from a JAX FRTPU1 file; and the same
    updates in one process outside any world."""
    tmp = tmp_path_factory.mktemp("tp_1x2")
    jcfg = jax_ref["jcfg"]
    _, opt_state = _adam_state_after(jcfg, jax_ref["params"], seed=8)
    frtpu1 = str(tmp / "jax.pth.tar")
    jckpt.save_checkpoint(frtpu1, jcfg, jax_ref["params"], jax_ref["stats"],
                          1, 0.0, 2, opt_state=jax.device_get(opt_state))
    off = {"weights": jax_ref["weights"], "no_brand_dropout": True}
    variants = {
        "off": dict(off, save=str(tmp / "tp.pth.tar")),
        "remat": dict(off, set={"bert_remat": 1}),
        "bf16": dict(off, set={"dtype": "bfloat16", "grad_clip": 0.0}),
        "on": {"set": {"dropout": 0.2, "bert_dropout": 0.1}},
        "resume": {"resume": frtpu1, "no_brand_dropout": True},
    }
    one = {k: variants[k] for k in ("on", "resume")}
    return {"world": _run_steps(root, jax_ref, str(tmp / "w"), "1,2", 2,
                                variants),
            "one": _run_steps(root, jax_ref, str(tmp / "o"), "", 0, one),
            "ckpt": str(tmp / "tp.pth.tar"), "frtpu1": frtpu1}


def _check_against_jax(jax_ref, got, dumps, rows, name="off"):
    """One dropout-off update (variant `name`) against the JAX package's
    unsharded one, at the two-rank test's tolerances, and the replicated
    tensors of the model ranks of each data slot equal bit for bit."""
    for r in got:
        m = r[name]
        assert m["step"] == 2 and m["rows"] == rows
        assert m["loss"] == pytest.approx(np.mean(jax_ref["losses"]),
                                          rel=LOSS_REL)
        assert m["last_loss"] == pytest.approx(jax_ref["losses"][-1],
                                               rel=LOSS_REL)
        assert m["grad_norm"] == pytest.approx(jax_ref["norm"], rel=NORM_REL)
    data, model = got[0]["mesh"]
    d0 = dumps[0]
    for slot in range(data):
        ranks = dumps[slot * model:(slot + 1) * model]
        for d in ranks[1:]:
            for k, t in ranks[0]["local"].items():
                assert torch.equal(t, d["local"][k]), (slot, k)
            assert torch.equal(ranks[0]["queue"], d["queue"])
    for d in dumps[1:]:                 # every rank gathers the same model
        for part in ("full", "grads"):
            for k, t in d0[part].items():
                assert torch.equal(t, d[part][k]), (part, k)
    # as the two-rank test holds it: the grads against the JAX package's, and
    # the params against Adam's first step on the port's own grads
    p0 = torch_state_from_jax(jax_ref["params"])
    lr = jax_ref["jcfg"].learning_rate
    assert set(d0["grads"]) == set(jax_ref["grads"])
    for name, g in d0["grads"].items():
        np.testing.assert_allclose(g.numpy(), jax_ref["grads"][name].numpy(),
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(
            d0["full"][name].numpy(),
            (p0[name] - lr * g / (g.abs() + 1e-8)).numpy(), err_msg=name,
            **PARAM_TOL)
        np.testing.assert_allclose(
            (p0[name] - lr * jax_ref["grads"][name] / (
                jax_ref["grads"][name].abs() + 1e-8)).numpy(),
            jax_ref["params_after"][name].numpy(), err_msg=name, **PARAM_TOL)
    for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(
            d0["full"]["fusion_encoding.bn." + key].numpy(),
            np.asarray(jax_ref["bs"]["fusion_encoding"]["bn"][leaf]),
            **GRAD_TOL)
    np.testing.assert_allclose(d0["queue"].numpy(),
                               np.asarray(jax_ref["q"].queue), **GRAD_TOL)
    assert d0["ptr"] == int(jax_ref["q"].ptr)


def test_update_at_1x2_equals_the_jax_unsharded_update(jax_ref, world_1x2):
    """Two model ranks on one data slot: the loss, grad norm, gathered
    grads, updated params, BatchNorm statistics and queue of one update of
    two microbatches of 4 posts equal the JAX package's unsharded update."""
    got, dumps = world_1x2["world"]
    assert [r["mesh"] for r in got] == [[1, 2]] * 2
    _check_against_jax(jax_ref, got, dumps["off"], [2, 4])


def test_update_at_2x2_equals_the_jax_unsharded_update(root, jax_ref,
                                                       tmp_path):
    """Two data slots of two model ranks each, every slot loading its half
    of each microbatch: the same update as the JAX package's unsharded
    one."""
    got, dumps = _run_steps(root, jax_ref, str(tmp_path / "w"), "2,2", 4, {
        "off": {"weights": jax_ref["weights"], "no_brand_dropout": True}})
    assert [r["mesh"] for r in got] == [[2, 2]] * 4
    _check_against_jax(jax_ref, got, dumps["off"], [2, 2])


def test_dropouts_on_at_1x2_equal_one_process(world_1x2):
    """Every dropout on (towers 0.2, BERT 0.1, the brand dropout 0.5 in
    K2): the model ranks draw their slot's streams, and K2 on each aspect
    shard draws the table's global counters, so the (1, 2) update is one
    process's update with the same seed."""
    got, dumps = world_1x2["world"]
    one, one_dumps = world_1x2["one"]
    want = one_dumps["on"][0]
    assert got[0]["on"]["loss"] == pytest.approx(one[0]["on"]["loss"],
                                                  rel=LOSS_REL)
    assert got[0]["on"]["grad_norm"] == pytest.approx(
        one[0]["on"]["grad_norm"], rel=NORM_REL)
    for d in dumps["on"]:
        assert set(d["full"]) == set(want["full"])
        for k, t in want["full"].items():
            np.testing.assert_allclose(d["full"][k].numpy(), t.numpy(),
                                       err_msg=k, **GRAD_TOL)
        for k, t in want["grads"].items():
            np.testing.assert_allclose(d["grads"][k].numpy(), t.numpy(),
                                       err_msg=k, **GRAD_TOL)


def test_bert_remat_at_1x2_is_bit_equal(world_1x2):
    """--bert_remat 1 recomputes each BERT layer with its collectives in the
    backward: the update equals the one without, bit for bit, on both
    model ranks."""
    got, dumps = world_1x2["world"]
    for r in got:
        assert r["remat"] == r["off"]
    for a, b in zip(dumps["off"], dumps["remat"]):
        for part in ("full", "grads", "local"):
            for k, t in a[part].items():
                assert torch.equal(t, b[part][k]), (part, k)


def test_bf16_update_at_1x2_within_the_bf16_step_bound(jax_ref, world_1x2):
    """--dtype bfloat16 at (1, 2), the clip off: the gathered grads lie
    nearer the JAX package's bfloat16 grads than those lie to its float32
    grads, and within 15% (tests/test_torch_port_bf16.py's bound)."""
    _, dumps = world_1x2["world"]
    jb, jf = jax_ref["flat16"], jax_ref["flat32"]
    spread = float((jb - jf).norm() / jf.norm())
    for d in dumps["bf16"]:
        got = torch.cat([v.reshape(-1) for _, v in sorted(d["grads"].items())])
        err = float((got - jb).norm() / jb.norm())
        assert err < min(spread, 0.15), (err, spread)


def test_clip_norm_over_shards_is_the_full_norm(world_1x2):
    """`global_norm` of a model rank's grads (the split ones summed over
    the model group, the replicated ones once) equals the norm of the
    gathered full grads, on both ranks."""
    _, dumps = world_1x2["world"]
    for name in ("off", "on", "bf16"):
        for d in dumps[name]:
            np.testing.assert_allclose(float(d["norm_shards"]),
                                       float(d["norm_full"]), rtol=1e-6)


def _jax_trees(state, params, stats):
    """A port state dict -> the JAX package's params and batch_stats trees
    shaped like the templates `params` and `stats` (the inverse of
    interop's layouts)."""
    names = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
             "var": "running_var"}

    def tree(template, prefix):
        out = {}
        for k, v in template.items():
            if isinstance(v, Mapping):
                out[k] = tree(v, prefix + k + ".")
                continue
            t = state[prefix + names.get(k, k)].numpy()
            if k == "kernel":
                t = t.T if t.ndim == 2 else t.transpose(2, 1, 0)
            assert t.shape == np.shape(v), prefix + k
            out[k] = t
        return out
    return tree(params, ""), tree(stats, "")


def test_checkpoint_from_1x2_loads_in_jax_and_in_one_process(jax_ref,
                                                             world_1x2,
                                                             tmp_path):
    """The (1, 2) world's checkpoint holds the whole model, gathered, and
    its Adam moments: it loads in one port process (strictly, equal to
    the world's gathered tensors), and its trees, written by the JAX
    package as FRTPU1, load in the JAX package and back in the port."""
    _, dumps = world_1x2["world"]
    ck = checkpoints.load_checkpoint(world_1x2["ckpt"])
    full = dumps["off"][0]["full"]
    assert set(ck["state_dict"]) == set(full)
    for k, t in full.items():
        assert torch.equal(ck["state_dict"][k], t), k
    model = FancyRec(ck["config"])
    model.load_state_dict(ck["state_dict"])
    names = [n for n, _ in model.named_parameters()]
    moments = ck["optimizer"]["state"]
    assert sorted(moments) == list(range(len(names)))
    for i, n in enumerate(names):
        assert moments[i]["exp_avg"].shape == full[n].shape, n
    params, stats = _jax_trees(ck["state_dict"], jax_ref["params"],
                               jax_ref["stats"])
    path = str(tmp_path / "from_tp.pth.tar")
    jckpt.save_checkpoint(path, jax_ref["jcfg"], params, stats, 1, 0.0, 2)
    back = jckpt.load_any(path)["model"]
    for got, want in ((back["params"], params),
                      (back["batch_stats"], stats)):
        got, want = (jax.tree_util.tree_leaves(t) for t in (got, want))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)
    port = checkpoints.load_any(path)["state_dict"]
    for k, t in full.items():
        assert torch.equal(port[k], t), k


def test_jax_checkpoint_resumes_under_1x2_as_in_one_process(world_1x2):
    """A JAX FRTPU1 file with Adam moments, resumed at (1, 2) (each rank
    its shards of the weights and moments): the update equals one
    process's resumed update."""
    got, dumps = world_1x2["world"]
    one, one_dumps = world_1x2["one"]
    want = one_dumps["resume"][0]
    assert got[0]["resume"]["loss"] == pytest.approx(
        one[0]["resume"]["loss"], rel=LOSS_REL)
    for d in dumps["resume"]:
        for k, t in want["full"].items():
            np.testing.assert_allclose(d["full"][k].numpy(), t.numpy(),
                                       err_msg=k, **PARAM_TOL)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_cli(root):
    """The trainer and the tester CLIs in this process at --mesh_shape 1,1
    (the brand dropout off, as the worlds' ranks have it)."""
    init = brand.BrandAspects.__init__

    def no_brand_dropout(self, *a, **k):
        init(self, *a, **k)
        self.p = 0.0
    brand.BrandAspects.__init__ = no_brand_dropout
    try:
        best = trainer.main(_cli_argv(root, "tp_1proc")
                            + ["--mesh_shape", "1,1"])
    finally:
        brand.BrandAspects.__init__ = init
    return best


@pytest.mark.parametrize("shape,ranks", [("1,2", 2), ("2,2", 4)])
def test_trainer_and_tester_clis_on_a_model_axis(root, one_process_cli,
                                                 shape, ranks):
    """The trainer CLI, then the tester CLI, at --mesh_shape 1,2 and 2,2:
    every rank reports the same best, within rel 1e-3 of --mesh_shape 1,1
    (tests/test_multichip.py's bound for the JAX trainer at (4, 2)); only
    rank 0 writes (the others fail on any write under the tree); the
    tester's metrics equal one process's on the same checkpoint."""
    postfix = "tp_" + shape.replace(",", "x")
    argv = _cli_argv(root, postfix) + ["--mesh_shape", shape]
    trained = results(run_world(_CLI, [root, trainer.__name__,
                                       json.dumps(argv)], ranks=ranks))
    best = [r["first"] for r in trained]
    assert len(set(best)) == 1 and best[0] > 0
    assert best[0] == pytest.approx(one_process_cli, rel=1e-3)
    assert [r["again"] for r in trained] == [None] * ranks
    logdir = os.path.join(root, "model", postfix)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1 and recs[0]["updates"] == 3
    # posts/s counts each post of the global batches once (3 updates of
    # 2 microbatches of 4), not once a model rank
    assert recs[0]["posts_per_s"] == pytest.approx(
        24 / recs[0]["train_seconds"], rel=1e-6)
    targv = ["insCartest", "--rootpath", root, "--logger_name", logdir,
             "--batch_size", "4", "--device", "cpu", "--overwrite", "1"]
    tested = results(run_world(_CLI, [root, tester.__name__, json.dumps(
        targv + ["--mesh_shape", shape])], ranks=ranks))
    assert all(r["first"] == tested[0]["first"] for r in tested)
    with open(os.path.join(logdir, "mean_metrics.json")) as f:
        assert json.load(f) == tested[0]["first"]
    single = tester.main(targv)._asdict()
    for k, v in single.items():
        assert tested[0]["first"][k] == pytest.approx(v, abs=1e-6), k
