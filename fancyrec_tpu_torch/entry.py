"""The flagship forward and the multi-rank dry run: the port's
counterparts of the root `__graft_entry__.py` of the JAX package.

  * `flagship_config(tiny)`: `_flagship_cfg`'s configuration, field by
    field: bin/instance.sh's model at full width (BERT text tower,
    projection-head fusion, 51 brands of 2000 aspects), or its tiny
    version for the dry run;
  * `example_batch(cfg, b, rng, device)`: `_example_batch`'s numpy draws,
    in the same order, as tensors on `device`;
  * `entry(device)`: the flagship forward, `entry()`'s counterpart: the
    port's `FancyRec` in eval mode at the full config, weights from a
    seeded generator, on the card -> (fn, args), fn(*args) ->
    (brand_emb, post_emb);
  * `dryrun_multichip(n, device)`: the multi-rank dry run,
    `dryrun_multichip` / `_dryrun_multichip_impl`'s counterpart. Outside
    a world it starts n rank processes (NCCL, a card a rank, where the
    host has n cards; gloo ranks sharing the card where it has fewer;
    gloo CPU ranks for device="cpu"); inside a world of n it runs the
    body: one update of the tiny config with --seq_shard over a
    (max(1, n // 2), n // that) mesh, the sharded ranking metrics against
    the gathered ones, the sharded top-k over the data slots, and the
    GPipe BERT pipeline over the model axis against the sequential
    encoder. Rank 0 prints the JAX summary line; a failing rank makes
    the call raise.

    python -c "from fancyrec_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.device import resolve_device
from fancyrec_tpu_torch.ops import kernel_wrappers

SEED = 0
# seconds a world of dry-run ranks may take
TIMEOUT = 600
# the order of the flagship forward's batch arguments, as JAX's entry()
BATCH_KEYS = ("brand_ids", "frames", "origin", "vmask", "bows", "tokens",
              "type_ids", "tmask")


def flagship_config(tiny: bool = False) -> Config:
    """`_flagship_cfg`: the tiny dry-run configuration, or the
    bin/instance.sh recipe at full width."""
    if tiny:
        return Config(
            brand_num=4, brand_aspect=32, common_embedding_size=64,
            visual_rnn_size=16, text_rnn_size=16, visual_kernel_num=8,
            text_kernel_num=8, visual_feat_dim=32, bow_vocab_size=40,
            vocab_size=64, text_transformers_hidden_size=48,
            text_net="transformers", fusion_style="ph", loss_fun="cl",
            cost_style="mean", queue_size=64, text_mapping_size=64,
            visual_mapping_size=64, max_frames=8, max_tokens=16,
            batch_size=8, accumulation_step=2).finalize()
    return Config(
        brand_num=51, brand_aspect=2000, common_embedding_size=1024,
        visual_feat_dim=2048, bow_vocab_size=7807,
        text_net="transformers", fusion_style="ph", loss_fun="cl",
        cost_style="mean", text_mapping_size=1024, visual_mapping_size=1024,
        max_frames=64, max_tokens=128, batch_size=8).finalize()


def _example_arrays(cfg: Config, b: int, rng: np.random.RandomState
                    ) -> Dict[str, np.ndarray]:
    """`_example_batch`'s draws, in its order, as numpy."""
    lengths = rng.randint(1, cfg.max_frames + 1, b)
    tlen = rng.randint(3, cfg.max_tokens, b)
    tpos = np.arange(cfg.max_tokens)[None] < tlen[:, None]
    out = {"brand_ids": rng.randint(0, cfg.brand_num, b).astype(np.int64),
           "frames": rng.randn(b, cfg.max_frames, cfg.visual_feat_dim
                               ).astype(np.float32),
           "origin": rng.randn(b, cfg.visual_feat_dim).astype(np.float32),
           "vmask": (np.arange(cfg.max_frames)[None] < lengths[:, None]
                     ).astype(np.float32),
           "bows": rng.randn(b, cfg.bow_vocab_size).astype(np.float32)}
    out["tokens"] = (rng.randint(1, 1000, (b, cfg.max_tokens))
                     * tpos).astype(np.int64)
    out["type_ids"] = np.zeros((b, cfg.max_tokens), np.int64)
    out["tmask"] = tpos.astype(np.int32)
    return out


def example_batch(cfg: Config, b: int, rng: Optional[np.random.RandomState]
                  = None, device="cpu") -> Dict[str, torch.Tensor]:
    """`_example_batch(cfg, b, rng)`: the same draws from `rng` (default
    RandomState(0)) in the same order, as tensors on `device`."""
    rng = np.random.RandomState(0) if rng is None else rng
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in _example_arrays(cfg, b, rng).items()}


def _load_jax(model, variables) -> None:
    """Fill a FancyRec from the JAX package's numpy trees ({"params",
    "batch_stats"}), cut to its model rank's shard."""
    from fancyrec_tpu_torch.interop import load_jax_variables

    load_jax_variables(model, variables["params"],
                       variables.get("batch_stats"))


def entry(device="cuda", tiny: bool = False, variables=None):
    """The flagship forward (JAX `entry()`): the port's FancyRec in eval
    mode at `flagship_config(tiny)`, its weights drawn from a generator
    seeded with SEED (or the JAX package's `variables`, {"params",
    "batch_stats"} as numpy trees), on `device` -> (fn, args): fn(*args)
    -> (brand_emb, post_emb), args the example batch of cfg.batch_size
    in BATCH_KEYS order."""
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
    from fancyrec_tpu_torch.models.fancyrec import init_fancyrec

    cfg = flagship_config(tiny)
    dev = resolve_device(device)
    model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(SEED))
    if variables is not None:
        _load_jax(model, variables)
    model.to(dev).eval()
    batch = example_batch(cfg, cfg.batch_size, device=dev)

    def forward(brand_ids, frames, origin, vmask, bows, tokens, type_ids,
                tmask):
        v = VisualBatch(frames=frames, mean_origin=origin, mask=vmask)
        t = TextBatch(bows=bows, tokens=tokens, type_ids=type_ids,
                      mask=tmask)
        with torch.no_grad():
            return model(brand_ids, v, t)

    return forward, tuple(batch[k] for k in BATCH_KEYS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda", variables=None,
                     dropout: bool = True) -> dict:
    """The multi-rank dry run (JAX `dryrun_multichip`) over n ranks.

    Inside a world of n (WORLD_SIZE set) this process is one rank and runs
    the body. Outside, it starts n rank processes on this host (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; the backend follows
    from the layout: NCCL where each rank has a card of its own, else
    gloo), prints rank 0's output and raises if a rank fails or the world
    outlives TIMEOUT. variables: the JAX package's {"params",
    "batch_stats", "queue"} as numpy, in place of the seeded weights and
    the empty queue; dropout=False turns every dropout off (the tower,
    BERT and brand ones), which the JAX comparison needs.
    -> {"summary": rank 0's summary fields, "ranks": each rank's record:
    its launches of each kernel during the body, its backend and mesh}."""
    if "WORLD_SIZE" in os.environ:
        return _dryrun_body(n_devices, device, variables, dropout)
    spec = {"n": n_devices, "device": str(device), "dropout": dropout,
            "variables": None}
    with tempfile.TemporaryDirectory() as tmp:
        if variables is not None:
            spec["variables"] = os.path.join(tmp, "variables.pkl")
            with open(spec["variables"], "wb") as f:
                pickle.dump(variables, f)
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env.update(WORLD_SIZE=str(n_devices),
                   LOCAL_WORLD_SIZE=str(n_devices),
                   MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   PYTHONPATH=os.pathsep.join(
                       [here] + [p for p in [env.get("PYTHONPATH")] if p]),
                   OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1)
                                           // n_devices)))
        code = ("import json, sys; from fancyrec_tpu_torch import entry; "
                "entry._rank_main(json.loads(sys.argv[1]))")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(spec)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise RuntimeError("dryrun_multichip(%d) did not finish in %d s"
                               % (n_devices, TIMEOUT)) from None
    records = {}
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError("dryrun_multichip(%d): rank %d exited %d:\n%s"
                               % (n_devices, r, p.returncode, out[-6000:]))
        for line in out.splitlines():
            if line.startswith("DRYRUN_RANK "):
                records[r] = json.loads(line[len("DRYRUN_RANK "):])
            elif r == 0:
                print(line, flush=True)
    if sorted(records) != list(range(n_devices)):
        raise RuntimeError("dryrun_multichip(%d): missing rank records:\n%s"
                           % (n_devices, outs[0][-6000:]))
    return {"summary": records[0]["summary"],
            "ranks": [records[r] for r in range(n_devices)]}


def _rank_main(spec: dict) -> None:
    """One rank of `dryrun_multichip`'s world: the body, then this rank's
    record on a DRYRUN_RANK line."""
    variables = None
    if spec["variables"]:
        with open(spec["variables"], "rb") as f:
            variables = pickle.load(f)
    rec = _dryrun_body(spec["n"], spec["device"], variables, spec["dropout"])
    print("DRYRUN_RANK " + json.dumps(rec), flush=True)


def _slot_superbatch(cfg: Config, micro, slot: int, slots: int, dev):
    """This data slot's contiguous rows of each global microbatch, with
    the global batch's length maxima (as a process-sharded loader gives
    them), stacked into the trainer's super-batch on `dev`."""
    from fancyrec_tpu_torch.train.step import stack_microbatches

    n = cfg.batch_size // slots
    rows = slice(slot * n, (slot + 1) * n)
    parts = [dict({k: v[rows] for k, v in mb.items()},
                  flen_max=int(mb["vmask"].sum(1).max()),
                  tlen_max=int(mb["tmask"].sum(1).max())) for mb in micro]
    return {k: torch.from_numpy(v).to(dev)
            for k, v in stack_microbatches(parts).items()}


def _bert_for_pipeline(model_axis: int):
    """`_dryrun_multichip_impl`'s BERT: 2 layers a stage, width 16, from a
    seeded generator (every rank the same weights), eval mode."""
    from fancyrec_tpu_torch.models.bert import BertConfig, BertEncoder

    enc = BertEncoder(BertConfig(
        vocab_size=64, hidden_size=16, num_hidden_layers=2 * model_axis,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32))
    g = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith("ln.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=g)
    return enc.eval()


def _dryrun_body(n: int, device, variables, dropout: bool) -> dict:
    """`_dryrun_multichip_impl(n)` on this rank of a world of n."""
    from fancyrec_tpu_torch.eval.metrics import (
        ranking_metrics, ranking_metrics_sharded)
    from fancyrec_tpu_torch.models.brand import BrandAspects
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores, ranked_retrieval_topk)
    from fancyrec_tpu_torch.parallel import collectives, distributed
    from fancyrec_tpu_torch.parallel.mesh import build_mesh
    from fancyrec_tpu_torch.parallel.pipeline import bert_pipeline_forward
    from fancyrec_tpu_torch.train.state import init_state
    from fancyrec_tpu_torch.train.step import train_step

    dev = distributed.initialize_multihost(device)
    if collectives.world_size() != n:
        raise ValueError("dryrun_multichip(%d) in a world of %d ranks"
                         % (n, collectives.world_size()))
    cfg = flagship_config(tiny=True)
    cfg.seq_shard = True                 # dp x tp x sp in one update
    data_axis = max(1, n // 2)
    model_axis = n // data_axis
    cfg.mesh_shape = "%d,%d" % (data_axis, model_axis)
    if not dropout:
        cfg.dropout = cfg.bert_dropout = 0.0
    mesh = build_mesh(cfg.mesh_shape)
    slot = mesh.data_rank

    rng = np.random.RandomState(0)
    micro = [_example_arrays(cfg, cfg.batch_size, rng)
             for _ in range(cfg.accumulation_step)]
    sb = _slot_superbatch(cfg, micro, slot, data_axis, dev)
    model, opt, state = init_state(cfg, dev, mesh=mesh)
    if variables is not None:
        _load_jax(model, variables)
        if variables.get("queue") is not None:
            state.queue = state.queue._replace(queue=torch.from_numpy(
                np.asarray(variables["queue"], np.float32)).to(dev))
    if not dropout:
        for m in model.modules():
            if isinstance(m, BrandAspects):
                m.p = 0.0
    for fn in kernel_wrappers().values():
        fn.launches = 0

    state, metrics = train_step(model, opt, cfg, state, sb)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])

    # the sharded evaluation: the post axis over the data slots (pad rows
    # labelled -1), the exact sharded metrics against the gathered ones
    n_posts = 30 * data_axis + 3
    erng = np.random.RandomState(1)
    brand_embs = erng.randn(cfg.brand_num, 16).astype(np.float32)
    post_embs = erng.randn(n_posts, 16).astype(np.float32)
    labels = erng.randint(0, cfg.brand_num, n_posts).astype(np.int64)
    pad = (-n_posts) % data_axis
    posts_p = np.concatenate([post_embs, np.ones((pad, 16), np.float32)])
    labels_p = np.concatenate([labels, np.full(pad, -1, np.int64)])
    per = posts_p.shape[0] // data_axis
    rows = slice(slot * per, (slot + 1) * per)
    brands_t = torch.from_numpy(brand_embs).to(dev)
    posts_l = torch.from_numpy(posts_p[rows]).to(dev)
    with torch.no_grad():
        scores_l = cosine_scores(brands_t, posts_l)
        ms = ranking_metrics_sharded(scores_l, labels_p[rows],
                                     cfg.brand_num)
        gathered = collectives.all_gather(scores_l.T.contiguous()).T
        m = ranking_metrics(gathered, labels_p, cfg.brand_num)
        for a, b in zip(m, ms):
            if not abs(float(a) - float(b)) < 1e-5:
                raise AssertionError("sharded metrics %s != gathered %s"
                                     % (ms, m))
        topv, topi = ranked_retrieval_topk(brands_t, posts_l, 4,
                                           n_valid=n_posts, block=16)
    if not int(topi.max()) < n_posts:
        raise AssertionError("a pad row ranked: %s" % topi.tolist())

    # the GPipe pipeline over the model axis against the sequential encoder
    enc = _bert_for_pipeline(model_axis).to(dev)
    prng = np.random.RandomState(2)
    ids = torch.from_numpy(prng.randint(
        0, 64, (2 * data_axis * model_axis, 8))).to(dev)
    nb = ids.shape[0] // data_axis
    ids = ids[slot * nb:(slot + 1) * nb]
    tids, tmask = torch.zeros_like(ids), torch.ones_like(ids)
    with torch.no_grad():
        piped = bert_pipeline_forward(enc, ids, tids, tmask)
        seq = enc(ids, tids, tmask)
        delta = (piped - seq).abs().max().reshape(1).float()
        pp_delta = float(collectives.all_gather(delta).max())
    if not pp_delta < 1e-4:
        raise AssertionError("pipeline != sequential (%g)" % pp_delta)
    if not np.isfinite(loss) or not np.isfinite(grad_norm):
        raise AssertionError("the multi-rank update produced a non-finite "
                             "loss %r or grad norm %r" % (loss, grad_norm))
    if not (np.isfinite(ms.auc) and 0.0 <= ms.auc <= 1.0):
        raise AssertionError("eval AUC %r" % ms.auc)
    summary = {"mesh": {"data": data_axis, "model": model_axis},
               "loss": loss, "grad_norm": grad_norm,
               "eval_auc": float(ms.auc), "topk_max": float(topv[0, 0]),
               "pp_delta": pp_delta}
    if collectives.rank() == 0:
        print("dryrun_multichip(%d): mesh=%s loss=%.4f grad_norm=%.4f "
              "eval_auc=%.3f topk_max=%.3f pp_delta=%.2e"
              % (n, summary["mesh"], loss, grad_norm, summary["eval_auc"],
                 summary["topk_max"], pp_delta), flush=True)
    return {"rank": collectives.rank(), "summary": summary,
            "launches": {k: fn.launches
                         for k, fn in kernel_wrappers().items()},
            "backend": torch.distributed.get_backend(),
            "device": str(dev),
            "sharded_metrics": dict(ms._asdict()),
            "metrics": dict(m._asdict())}
