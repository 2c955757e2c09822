"""Data parallelism in the port against the JAX package, on the CPU.

  * the process-sharded loading (`collate_order`, `length_maxima`,
    `bucket_batch(maxima=)`, `BatchLoader(process_shard=)`): each rank's
    batches equal the JAX loader's for the same rank, bit for bit, and the
    ranks' slices together are the one-process batch;
  * the mesh helpers refuse and accept the shapes the JAX ones do, and
    the backend follows the layout;
  * in a spawned world of two gloo ranks: the exact sharded ranking
    metrics against the JAX oracle; one update of two microbatches from
    the trainer's process-sharded loader against the JAX package's
    unsharded update of the same global batch, with the tolerances of its
    own sharded-step test (tests/test_multichip.py: loss rel 1e-5, grad
    norm rel 1e-4, params atol 5e-6 rtol 5e-5); each rank's own dropout
    streams;
  * the trainer and tester CLIs at --mesh_shape 2,1 over two ranks.

Each world's ranks are `python -c` processes that import torch only, one
thread each, with a timeout on every wait and a free port a world.
"""

import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fancyrec_tpu.config import build_train_parser as jax_parser
from fancyrec_tpu.config import config_from_args as jax_config_from_args
from fancyrec_tpu.data.loader import BatchLoader as JaxBatchLoader
from fancyrec_tpu.data.loader import bucket_batch as jax_bucket_batch
from fancyrec_tpu.eval.metrics import ranking_metrics_oracle
from fancyrec_tpu.losses import contrastive_loss as jax_contrastive_loss
from fancyrec_tpu.losses import init_queue_state as jax_init_queue_state
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.parallel import mesh as jmesh
from fancyrec_tpu.train import trainer as jtrainer
from fancyrec_tpu.train.state import init_state as jax_init_state
from fancyrec_tpu.train.state import make_optimizer as jax_make_optimizer
from fancyrec_tpu_torch.config import build_train_parser, config_from_args
from fancyrec_tpu_torch.data.loader import BatchLoader, bucket_batch
from fancyrec_tpu_torch.eval import tester
from fancyrec_tpu_torch.interop import (
    load_jax_variables, torch_state_from_jax)
from fancyrec_tpu_torch.models import FancyRec, brand
from fancyrec_tpu_torch.parallel import distributed, mesh
from fancyrec_tpu_torch.train import trainer
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_model import tiny_cfg_kwargs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240           # seconds a world may take before it counts as hung
LOSS_REL, NORM_REL = 1e-5, 1e-4
PARAM_TOL = dict(atol=5e-6, rtol=5e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)     # float32, as the one-rank step test

ARGS = [
    "insCartrain", "insCarval", "insCartest",
    "--brand_num", "3", "--brand_aspect", "16",
    "--video_feature", "resnet152_dim_16", "--img_feature", "imgfeat_dim_16",
    "--common_embedding_size", "32", "--visual_rnn_size", "16",
    "--text_rnn_size", "16", "--visual_kernel_num", "8",
    "--text_kernel_num", "8", "--text_mapping_size", "32",
    "--visual_mapping_size", "32", "--word_dim", "16",
    "--text_transformers_hidden_size", "24", "--bert_num_layers", "2",
    "--batch_size", "4", "--accumulation_step", "2",
    "--learning_rate", "0.001", "--overwrite", "1",
    "--max_frames", "8", "--max_tokens", "24", "--max_words", "16",
    "--fusion_style", "ph", "--loss_fun", "cl", "--cost_style", "mean",
    "--text_norm", "--visual_norm", "--text_net", "bi-gru",
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_parallel"))
    # 3 brands x (4 videos + 4 images) = 24 posts a split: 6 batches of 4
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    return root


@pytest.fixture(scope="module")
def datasets(root):
    """The train split's dataset in both packages, from the same flags."""
    argv = ARGS + ["--rootpath", root]
    jcfg = jax_config_from_args(jax_parser().parse_args(argv))
    cfg = config_from_args(build_train_parser().parse_args(argv))
    return (trainer.build_datasets(cfg)["train"],
            jtrainer.build_datasets(jcfg)["train"])


# ---------------------------------------------------------------------------
# process-sharded loading
# ---------------------------------------------------------------------------

def test_collate_order_and_length_maxima_match_jax(datasets):
    ds, jds = datasets
    rng = np.random.RandomState(0)
    for n, pad_to in ((4, None), (3, 4), (7, 8), (1, 4), (24, None)):
        idx = rng.permutation(len(ds))[:n]
        order = ds.collate_order(idx, pad_to=pad_to)
        assert order == jds.collate_order(idx, pad_to=pad_to)
        assert ds.length_maxima(order) == jds.length_maxima(order)
        # the one-process batch is the collate order's rows
        want = ds.gather_batch(idx, pad_to=pad_to)
        got = ds.gather_batch(order, presort=False)
        assert want["idxs"].tolist() == order
        for k in ("frames", "tokens", "tmask", "vmask", "brand_ids"):
            np.testing.assert_array_equal(got[k], want[k])
        maxima = ds.length_maxima(order)
        assert maxima == {"flen_max": int(want["vmask"].sum(1).max()),
                          "tlen_max": int(want["tmask"].sum(1).max())}


def test_bucket_batch_with_global_maxima_matches_jax(datasets):
    """A rank's slice cut to the buckets of the GLOBAL maxima, not of its
    own rows."""
    ds, _ = datasets
    order = ds.collate_order(np.arange(8))
    part = ds.gather_batch(order[6:], presort=False)
    maxima = ds.length_maxima(order)
    assert int(part["tmask"].sum(1).max()) < maxima["tlen_max"]
    for tb, fb in (([2, 4, 8], [1, 2]), ([4], None), (None, [1, 2, 4])):
        got = bucket_batch(part, tb, fb, maxima=maxima)
        want = jax_bucket_batch(part, tb, fb, maxima=maxima)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        own = bucket_batch(part, tb, fb)
        if tb:
            assert got["tokens"].shape[-1] >= own["tokens"].shape[-1]


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=2, final_batch="drop", grouped="off"),
    dict(shuffle=True, seed=5, final_batch="drop", grouped="window"),
    dict(final_batch="pad", grouped="sort"),
], ids=["train", "train-window", "eval-sort"])
def test_process_sharded_loader_matches_jax(datasets, kw):
    ds, jds = datasets
    bs = 4 if kw["final_batch"] == "drop" else 10       # "pad": a short tail
    whole = list(BatchLoader(ds, bs, **kw))
    ranks = [list(BatchLoader(ds, bs, process_shard=(r, 2), **kw))
             for r in range(2)]
    jranks = [list(JaxBatchLoader(jds, bs, process_shard=(r, 2), **kw))
              for r in range(2)]
    assert all(len(x) == len(whole) for x in ranks + jranks)
    for i, full in enumerate(whole):
        for r in range(2):
            got, want = ranks[r][i], jranks[r][i]
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # the ranks' rows, concatenated, are the one-process batch; the
        # bookkeeping is the global batch's on both
        for k in ("frames", "origin", "vmask", "bows", "tokens", "tmask",
                  "brand_ids"):
            np.testing.assert_array_equal(
                np.concatenate([ranks[0][i][k], ranks[1][i][k]]), full[k])
        for r in range(2):
            assert ranks[r][i]["idxs"].tolist() == full["idxs"].tolist()
            assert ranks[r][i]["n_valid"] == full["n_valid"]
            np.testing.assert_array_equal(ranks[r][i]["brand_ids_global"],
                                          full["brand_ids"])
            assert ranks[r][i]["flen_max"] == int(full["vmask"].sum(1).max())
            assert ranks[r][i]["tlen_max"] == int(full["tmask"].sum(1).max())


def test_process_sharded_loader_refuses_what_jax_refuses(datasets):
    ds, jds = datasets
    with pytest.raises(ValueError, match="batch_size % ranks"):
        BatchLoader(ds, 5, process_shard=(0, 2))
    with pytest.raises(ValueError):
        JaxBatchLoader(jds, 5, process_shard=(0, 2))
    with pytest.raises(ValueError, match="outside"):
        BatchLoader(ds, 4, process_shard=(2, 2))


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def _jax_world(monkeypatch, data, pid):
    """A stand-in JAX mesh of `data` devices, one a process (what the JAX
    helpers read of it), seen from process `pid`."""
    monkeypatch.setattr(jax, "process_count", lambda: data)
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    devices = np.empty((data, 1), object)
    for p in range(data):
        devices[p, 0] = types.SimpleNamespace(process_index=p)
    return types.SimpleNamespace(devices=devices)


def test_process_batch_shard_and_divisibility_match_jax(monkeypatch):
    for data in (1, 2, 3, 4):
        for pid in range(data):
            jm = _jax_world(monkeypatch, data, pid)
            m = mesh.Mesh(data=data, rank=pid)
            for b in range(1, 13):
                assert mesh.process_batch_shard(m, b) == \
                    jmesh.process_batch_shard(jm, b), (data, pid, b)
                refused = []
                for fn, mm in ((mesh.require_divisible_batch, m),
                               (jmesh.require_divisible_batch, jm)):
                    try:
                        fn(mm, b)
                        refused.append(False)
                    except ValueError:
                        refused.append(True)
                assert refused[0] == refused[1] == (data > 1 and b % data > 0)


@pytest.mark.parametrize("shape", ["", "8", "8,1", "16,1", "9", "12"])
def test_build_mesh_refuses_what_jax_refuses(shape):
    """Over 8 ranks (the tests' 8 JAX CPU devices): a shape that needs
    more ranks than the world is refused by both."""
    try:
        jm = jmesh.build_mesh(shape)
        want = dict(zip(jm.axis_names, jm.devices.shape))
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="needs"):
            mesh.build_mesh(shape, world=8)
    else:
        m = mesh.build_mesh(shape, world=8)
        assert {"data": m.data, "model": 1} == want


def test_build_mesh_refuses_what_the_port_does_not_run():
    # idle ranks: the JAX package takes a leading subset of its devices
    with pytest.raises(ValueError, match="idle"):
        mesh.build_mesh("4,1", world=8)
    for shape in ("4,2", "1,2", "2,4"):
        with pytest.raises(NotImplementedError, match="later slice"):
            mesh.build_mesh(shape, world=8)
    for shape in ("a,1", "0,1", "2,1,1"):
        with pytest.raises(ValueError):
            mesh.build_mesh(shape, world=8)


@pytest.mark.parametrize("dev,local_world,named,want", [
    ("cpu", 1, False, "gloo"),
    ("cpu", 4, False, "gloo"),
    ("cuda", 1, False, "nccl"),       # a world of one on its card
    ("cuda", 4, False, "nccl"),       # a card a local rank
    ("cuda", 5, False, "gloo"),       # more local ranks than cards
    ("cuda:0", 1, True, "nccl"),      # one rank on the card it named
    ("cuda:0", 2, True, "gloo"),      # named cards may be one card
])
def test_backend_follows_the_layout(monkeypatch, dev, local_world, named,
                                    want):
    """NCCL only where every local rank is sure to have a card of its own:
    it refuses two ranks on one device ("Duplicate GPU")."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.backend_for(torch.device(dev), local_world,
                                   named) == want


# ---------------------------------------------------------------------------
# worlds of two gloo ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(code, args, ranks=2):
    """Run `python -c code args...` as the ranks of one gloo world on the
    CPU -> each rank's stdout; ranks=0: one process outside any world.
    Fails (killing every rank) if a rank exits non-zero or the world
    outlives TIMEOUT."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]))
    if ranks:
        env.update(WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                   MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if ranks else env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(max(ranks, 1))]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rest = [p.communicate()[0] or "" for p in procs]
        pytest.fail("the world of %d ranks hung:\n%s" % (ranks, "\n\n".join(
            o[-3000:] for o in outs + rest)))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d exited %s:\n%s" % (
            r, p.returncode, out[-6000:])
    return outs


def results(outs):
    """The RESULT json line each rank printed, by rank."""
    got = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                got[r["rank"]] = r
    assert sorted(got) == list(range(len(outs))), outs[0][-3000:]
    return [got[r] for r in sorted(got)]


_METRICS = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from fancyrec_tpu_torch.eval.metrics import ranking_metrics_sharded
from fancyrec_tpu_torch.parallel import collectives, distributed
distributed.initialize_multihost("cpu")
data = np.load(sys.argv[1])
r, ranks = collectives.rank(), collectives.world_size()
out = []
for scores, brands in zip(data["scores"], data["brands"]):
    n_l = scores.shape[1] // ranks
    cols = slice(r * n_l, (r + 1) * n_l)
    m = ranking_metrics_sharded(torch.from_numpy(scores[:, cols]),
                                brands[cols], scores.shape[0])
    out.append(m._asdict())
print("RESULT " + json.dumps({"rank": r, "metrics": out}))
"""


def test_sharded_metrics_over_two_ranks_equal_the_jax_oracle(tmp_path):
    """Exact ties (scores rounded to two decimals), a brand with no posts
    and pad posts labelled -1, each rank with half the posts: every metric
    equals the JAX oracle's on the live posts, on both ranks."""
    scores, labels = [], []
    for seed in range(3):
        rng = np.random.RandomState(seed)
        b, n = 8, 400
        scores.append(np.round(rng.randn(b, n), 2).astype(np.float32))
        lab = rng.randint(0, b, n).astype(np.int64)
        lab[lab == 5] = 2                    # brand 5 has no posts
        lab[-16:] = -1                       # pad posts
        labels.append(lab)
    path = str(tmp_path / "scores.npz")
    np.savez(path, scores=np.stack(scores), brands=np.stack(labels))
    got = results(run_world(_METRICS, [path]))
    for i, (s, lab) in enumerate(zip(scores, labels)):
        live = lab >= 0
        want = ranking_metrics_oracle(s[:, live], lab[live], 8)._asdict()
        for r in range(2):
            assert got[r]["metrics"][i] == {k: float(v)
                                            for k, v in want.items()}


_STEP = """
import json, sys
import torch
torch.set_num_threads(1)
from fancyrec_tpu_torch.config import build_train_parser, config_from_args
from fancyrec_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from fancyrec_tpu_torch.parallel import collectives, distributed
from fancyrec_tpu_torch.parallel.mesh import build_mesh, process_batch_shard
from fancyrec_tpu_torch.train import trainer
from fancyrec_tpu_torch.train.state import init_state
cfg = config_from_args(build_train_parser().parse_args(json.loads(
    sys.argv[1])))
device = distributed.initialize_multihost("cpu")
mesh = build_mesh(cfg.mesh_shape)
ds = trainer.build_datasets(cfg)["train"]
for k, v in json.loads(sys.argv[4]).items():
    setattr(cfg, k, v)
cfg.finalize()
# the trainer's train loader and super-batch stream
loader = BatchLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                     final_batch="drop",
                     process_shard=process_batch_shard(mesh, cfg.batch_size))
model, opt, state = init_state(cfg, device)
model.load_state_dict(torch.load(sys.argv[2]))
model.brand_encoding.p = 0.0
stream = prefetch_to_device(trainer._superbatches(
    loader, cfg.accumulation_step, cfg.token_buckets_list,
    cfg.frame_buckets_list, cfg.transfer_dtype), device, trainer._TRAIN_KEYS)
_, sb = next(stream)
stream.close()
state, metrics = trainer.train_step(model, opt, cfg, state, sb)
r = collectives.rank()
torch.save({"params": {n: p.detach() for n, p in model.named_parameters()},
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "buffers": dict(model.named_buffers()),
            "queue": state.queue.queue, "ptr": state.queue.ptr},
           "%s.%d" % (sys.argv[3], r))
print("RESULT " + json.dumps({"rank": r, "step": state.step,
      "rows": list(sb["frames"].shape[:2]),
      **{k: float(v) for k, v in metrics.items()}}))
"""


def test_two_rank_update_equals_the_jax_unsharded_update(root, tmp_path):
    """One update of two microbatches of 4 posts, 2 a rank, from the
    trainer's process-sharded loader and super-batch stream on the
    fixture, on the recipe's towers (transformers, ph fusion with its
    BatchNorm, the cl loss with its queue, the clip), every dropout off:
    the loss, the grad norm, the summed and clipped grads, the updated
    params, the BatchNorm running statistics and the queue equal the JAX
    package's unsharded update of the JAX loader's same global batches,
    and the two ranks hold the same bits. The captions' lengths differ, so
    rank 1's own batch-max lengths are below the global ones the model
    must use."""
    argv = ARGS + ["--rootpath", root, "--text_net", "transformers",
                   "--dropout", "0", "--bert_dropout", "0",
                   "--grad_clip", "0.5", "--queue_size", "16"]
    jcfg = jax_config_from_args(jax_parser().parse_args(argv))
    jds = jtrainer.build_datasets(jcfg)["train"]
    # BERT at tiny widths too: its vocabulary is the fixture's
    with open(os.path.join(root, "bert_vocab.txt")) as f:
        tiny_bert = dict(bert_vocab_size=len(f.read().split()),
                         bert_intermediate_size=32, bert_max_position=32)
    for k, v in tiny_bert.items():
        setattr(jcfg, k, v)
    jcfg.finalize()
    jloader = JaxBatchLoader(jds, jcfg.batch_size, shuffle=True,
                             seed=jcfg.seed, final_batch="drop")
    mbs = [b for b, _ in zip(jloader, range(jcfg.accumulation_step))]
    assert any(mb["tmask"][2:].sum(1).max() < mb["tmask"].sum(1).max()
               for mb in mbs)
    jmodel, jstate = jax_init_state(jcfg, seed=5)
    rng = np.random.RandomState(6)
    noisy = lambda x: (np.asarray(x)                          # noqa: E731
                       + 0.05 * rng.randn(*np.shape(x))).astype(np.float32)
    params = jax.tree.map(noisy, jax.device_get(jstate.params))
    stats = jax.tree.map(lambda x: np.abs(noisy(x)),
                         jax.device_get(jstate.batch_stats))

    def micro(p, bs, q, mb):
        v = JVisualBatch(jnp.asarray(mb["frames"]), jnp.asarray(mb["origin"]),
                         jnp.asarray(mb["vmask"]))
        t = JTextBatch(jnp.asarray(mb["bows"]), jnp.asarray(mb["tokens"]),
                       jnp.asarray(mb["type_ids"]), jnp.asarray(mb["tmask"]))
        post, mut = jmodel.apply({"params": p, "batch_stats": bs}, v, t,
                                 deterministic=False, mutable=["batch_stats"],
                                 method=jmodel.embed_post,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        brand_emb = jmodel.apply({"params": p}, jnp.asarray(mb["brand_ids"]),
                                 deterministic=True,
                                 method=jmodel.embed_brand)
        loss, q = jax_contrastive_loss(brand_emb, post, q, cost_style="mean")
        return loss, (mut["batch_stats"], q)

    grad_fn = jax.jit(jax.value_and_grad(micro, has_aux=True))
    bs, q = stats, jax_init_queue_state(16, jcfg.common_embedding_size)
    gsum, losses = None, []
    for mb in mbs:
        (loss, (bs, q)), g = grad_fn(params, bs, q, mb)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        losses.append(float(loss))
    tx = jax_make_optimizer(jcfg)
    updates, _ = jax.jit(tx.update)(gsum, tx.init(params), params)
    want_params = torch_state_from_jax(jax.tree.map(
        np.array, optax.apply_updates(params, updates)))
    clipped = optax.clip_by_global_norm(jcfg.grad_clip).update(gsum, None)[0]
    want_grads = torch_state_from_jax(jax.tree.map(np.array, clipped))

    cfg = config_from_args(build_train_parser().parse_args(argv))
    trainer.build_datasets(cfg)
    for k, v in tiny_bert.items():
        setattr(cfg, k, v)
    model = FancyRec(cfg.finalize())
    load_jax_variables(model, params, stats)
    weights, out = str(tmp_path / "w.pt"), str(tmp_path / "out")
    torch.save(model.state_dict(), weights)
    got = results(run_world(_STEP, [json.dumps(argv + ["--mesh_shape", "2,1"]),
                                    weights, out, json.dumps(tiny_bert)]))
    for r in got:
        assert r["step"] == 2
        assert r["rows"] == [2, 2]        # 2 microbatches of 2 rows a rank
        assert r["loss"] == pytest.approx(np.mean(losses), rel=LOSS_REL)
        assert r["last_loss"] == pytest.approx(losses[-1], rel=LOSS_REL)
        assert r["grad_norm"] == pytest.approx(
            float(optax.global_norm(gsum)), rel=NORM_REL)
    s0, s1 = (torch.load("%s.%d" % (out, r)) for r in range(2))
    for part in ("params", "grads", "buffers"):
        for name, t in s0[part].items():
            assert torch.equal(t, s1[part][name]), (part, name)
    assert torch.equal(s0["queue"], s1["queue"])
    # Adam's first step moves a param by lr g / (|g| + eps): where a summed
    # grad is near eps (1e-8, a few BERT and fusion weights here), grads
    # that agree within GRAD_TOL still move it by different amounts. So the
    # update is held as two links: the port's grads against the JAX
    # package's, and the port's params against that step on the port's own
    # grads, a step that on the JAX grads gives the JAX package's params.
    p0 = torch_state_from_jax(params)

    def adam_first_step(name, g):
        return p0[name] - jcfg.learning_rate * g / (g.abs() + 1e-8)
    assert set(s0["params"]) == set(want_params)
    for name, t in s0["params"].items():
        np.testing.assert_allclose(s0["grads"][name].numpy(),
                                   want_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(
            adam_first_step(name, want_grads[name]).numpy(),
            want_params[name].numpy(), err_msg=name, **PARAM_TOL)
        np.testing.assert_allclose(
            t.numpy(), adam_first_step(name, s0["grads"][name]).numpy(),
            err_msg=name, **PARAM_TOL)
    for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(
            s0["buffers"]["fusion_encoding.bn." + key].numpy(),
            np.asarray(bs["fusion_encoding"]["bn"][leaf]), **GRAD_TOL)
    np.testing.assert_allclose(s0["queue"].numpy(), np.asarray(q.queue),
                               **GRAD_TOL)
    assert s0["ptr"] == int(q.ptr)


_DROPOUT = """
import json, sys
import torch
torch.set_num_threads(1)
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.models import brand, layers
from fancyrec_tpu_torch.ops.brand_dropout import aspect_dropout_fwd_ref
from fancyrec_tpu_torch.parallel import collectives, distributed
from fancyrec_tpu_torch.train.state import init_state
device = distributed.initialize_multihost("cpu")
cfg = Config(**json.loads(sys.argv[1])).finalize()
model = init_state(cfg, device)[0].train()
bits = []
_mean = brand.aspect_dropout_mean
def keep_bits(w, asp, seed, keep):
    bits.append(aspect_dropout_fwd_ref(w.detach(), asp.detach(), seed, keep,
                                       with_bits=True)[1].tolist())
    return _mean(w, asp, seed, keep)
brand.aspect_dropout_mean = keep_bits
model.embed_brand(torch.arange(cfg.brand_num))
drop = next(m for m in model.modules()
            if isinstance(m, layers.Dropout) and m.p > 0)
print("RESULT " + json.dumps({"rank": collectives.rank(), "k2": bits[0],
      "tower": (drop(torch.ones(8, 32)) != 0).int().tolist()}))
"""


def test_each_rank_draws_its_own_dropout_masks():
    """With the dropouts on, the trainer's init_state seeds each rank's
    tower dropout masks and brand-dropout (K2) keep bits from a stream of
    its own, since its rows are other posts; rank 0's stream is the one of
    a process outside any world."""
    kw = json.dumps(dict(tiny_cfg_kwargs(), dropout=0.3))
    ranks = results(run_world(_DROPOUT, [kw]))
    alone = results(run_world(_DROPOUT, [kw], ranks=0))[0]
    for part in ("tower", "k2"):
        assert ranks[0][part] != ranks[1][part], part
        assert ranks[0][part] == alone[part], part
    for r in ranks:                       # each drops some and keeps some
        assert 0 < np.sum(r["tower"]) < np.size(r["tower"])


_CLI = """
import builtins, importlib, json, os, sys
import torch
torch.set_num_threads(1)
root, module, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
from fancyrec_tpu_torch.models import brand
_init = brand.BrandAspects.__init__
def _no_brand_dropout(self, *a, **k):
    _init(self, *a, **k)
    self.p = 0.0
brand.BrandAspects.__init__ = _no_brand_dropout
rank = int(os.environ["RANK"])
if rank != 0:
    _open = builtins.open
    def _trap(file, mode="r", *a, **k):
        if (set(mode) & set("wax+")
                and os.path.abspath(str(file)).startswith(root)):
            raise AssertionError("rank %d opened %s to write" % (rank, file))
        return _open(file, mode, *a, **k)
    builtins.open = _trap
main = importlib.import_module(module).main
first = main(argv)
again = (main(argv + ["--overwrite", "0"]) if module.endswith("trainer")
         else None)
if hasattr(first, "_asdict"):
    first = first._asdict()
print("RESULT " + json.dumps({"rank": rank, "first": first, "again": again}))
"""


def _cli_argv(root, postfix):
    return ARGS + ["--rootpath", root, "--postfix", postfix, "--dropout", "0",
                   "--num_epochs", "1", "--token_buckets", "8,16",
                   "--frame_buckets", "2,4", "--device", "cpu"]


def test_trainer_and_tester_clis_over_two_ranks(root, monkeypatch):
    """The trainer CLI, then the tester CLI, at --mesh_shape 2,1 over two
    ranks, the dropouts off: both ranks report the same best and the same
    metrics, only the primary wrote (rank 1 fails on any write under the
    tree), a second --auto_resume run skips on both ranks together, and
    the best and the metrics equal the one-process runs'."""
    argv = _cli_argv(root, "run_2rank") + ["--mesh_shape", "2,1",
                                           "--auto_resume"]
    trained = results(run_world(_CLI, [root, trainer.__name__,
                                       json.dumps(argv)]))
    best = [r["first"] for r in trained]
    assert best[0] == best[1] and best[0] > 0
    assert [r["again"] for r in trained] == [None, None]
    logdir = os.path.join(root, "model", "run_2rank")
    for name in ("model_best.pth.tar", "val_metric.txt", "metrics.jsonl",
                 "checkpoint_epoch_0.pth.tar"):
        assert os.path.exists(os.path.join(logdir, name)), name
    with open(os.path.join(logdir, "val_metric.txt")) as f:
        assert float(f.read()) == best[0]
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1 and recs[0]["updates"] == 3
    assert recs[0]["Eiters"] == 6          # microbatches, as one process

    targv = ["insCartest", "--rootpath", root, "--logger_name", logdir,
             "--batch_size", "4", "--device", "cpu", "--overwrite", "1"]
    tested = results(run_world(_CLI, [root, tester.__name__, json.dumps(
        targv + ["--mesh_shape", "2,1"])]))
    assert tested[0]["first"] == tested[1]["first"]
    with open(os.path.join(logdir, "mean_metrics.json")) as f:
        assert json.load(f) == tested[0]["first"]

    # the same run in one process, then the one-process tester on the
    # two ranks' checkpoint
    init = brand.BrandAspects.__init__

    def no_brand_dropout(self, *a, **k):
        init(self, *a, **k)
        self.p = 0.0
    monkeypatch.setattr(brand.BrandAspects, "__init__", no_brand_dropout)
    single = trainer.main(_cli_argv(root, "run_1proc"))
    assert best[0] == pytest.approx(single, rel=1e-4)
    m = tester.main(targv)._asdict()
    for k, v in m.items():
        assert tested[0]["first"][k] == pytest.approx(v, abs=1e-6), k
