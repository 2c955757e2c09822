"""Training cells with a DeepSeek-V2 caption tower: the recipe trained by
the program's `train_epoch`, with `--text_net deepseek_v2`.

As `drivers/train.py` (whose collection writer, recording loader and
comparison this driver imports), with three differences. The caption
words are drawn Zipf(s) over the tower's whole vocabulary (the traffic's
`token_zipf`), on a stream of their own, so that the routing is as
uneven as natural text makes it; the caption lengths and every other
draw are `generate.posts`'. The weights are the trunk's (the recipe's
brand and visual towers, text conv bank, mappings and fusion) and the
tower's, all drawn from the seed. And the check adds the routing: over
the set-up's updates and the window's, each MoE layer's counter must
hold k rows for each valid token and k pad slots for each pad token
(`routing_rows_off`, limit 0), besides the first loss, the first
gradient by the median leaf and each leaf's change over the set-up's
three updates against `reference/deepseek_v2_ref.py`.

The program's model and optimizer (about 42 GB at the cell's size) are
freed before the reference runs.

    python3 benchmark/drivers/train_moe.py --workload dsv2.train \\
        --seeds 1 2 3 --seconds 4

prints, for each seed, the numbers the cell compares as the program gives
them and as each control gives them: the reference with TF32 on, with
half of each microbatch left out, and routing top-(k - 1), each judged
against the float32 reference (the readings the limits come from).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import generate  # noqa: E402
import harness  # noqa: E402
import weights as bench_weights  # noqa: E402
from reference import batches as ref_batches  # noqa: E402
from reference import deepseek_v2_ref  # noqa: E402

train = harness.import_file(os.path.join(BENCH, "drivers", "train.py"),
                            "driver_train")

# the configuration file's keys that are not the tower's config.json keys
NOT_TOWER = ("source", "reduced", "deployment", "recipe", "departures",
             "assumed", "model", "data", "initializer_range")
ZIPF_STREAM = 21


def tower_keys(conf: dict) -> dict:
    """The tower's config.json keys, as the configuration file holds them
    at its top level."""
    return {k: v for k, v in conf.items() if k not in NOT_TOWER}


def zipf_words(lengths, n_words: int, s: float, seed: int):
    """A caption of each length, its word ids drawn Zipf(s) over
    `n_words` ids (id i has rank i + 1), from the seed's own stream."""
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -s)
    cdf /= cdf[-1]
    r = generate.rng_for(seed, ZIPF_STREAM)
    return [np.minimum(np.searchsorted(cdf, r.random(int(k)), side="right"),
                       n_words - 1).astype(np.int64) for k in lengths]


def trunk_model(model: dict, hidden: int) -> dict:
    """The recipe's model keys with the tower's hidden width in BERT's
    place and no BERT layer: what `weights.fancyrec_spec` and
    `train_mfu.post_forward_ops` read for the trunk around the tower."""
    return dict(model, text_net="transformers", bert_num_layers=0,
                text_transformers_hidden_size=hidden,
                bert_intermediate_size=0, bert_vocab_size=0,
                bert_max_position=0, bert_type_vocab=0)


def tower_spec(tc: dict, std: float) -> bench_weights.Spec:
    """Every parameter of the tower, in the program's names."""
    d, h = tc["hidden_size"], tc["num_attention_heads"]
    nope, rope, vd = (tc["qk_nope_head_dim"], tc["qk_rope_head_dim"],
                      tc["v_head_dim"])
    rank, e = tc["kv_lora_rank"], tc["n_routed_experts"]
    f = tc["moe_intermediate_size"]
    pre = deepseek_v2_ref.PRE
    spec = [(pre + "embed_tokens", (tc["vocab_size"], d), "normal", std)]

    def normal(name, *shape):
        spec.append((name, shape, "normal", std))

    def ones(name, n):
        spec.append((name, (n,), "ones", 1.0))

    def swiglu(name, width):
        normal(name + "gate_proj.weight", width, d)
        normal(name + "up_proj.weight", width, d)
        normal(name + "down_proj.weight", d, width)

    for i in range(tc["num_hidden_layers"]):
        lay = "%slayers.%d." % (pre, i)
        ones(lay + "input_layernorm.weight", d)
        ones(lay + "post_attention_layernorm.weight", d)
        a = lay + "self_attn."
        normal(a + "q_proj.weight", h * (nope + rope), d)
        normal(a + "kv_a_proj_with_mqa.weight", rank + rope, d)
        ones(a + "kv_a_layernorm.weight", rank)
        normal(a + "kv_b_proj.weight", h * (nope + vd), rank)
        normal(a + "o_proj.weight", d, h * vd)
        if i < tc["first_k_dense_replace"]:
            swiglu(lay + "mlp.", tc["intermediate_size"])
        else:
            normal(lay + "mlp.gate.weight", e, d)
            normal(lay + "mlp.experts.w13", e, 2 * f, d)
            normal(lay + "mlp.experts.w2", e, d, f)
            if tc.get("n_shared_experts"):
                swiglu(lay + "mlp.shared_experts.",
                       f * tc["n_shared_experts"])
    ones(pre + "norm.weight", d)
    return spec


def weight_spec(conf: dict) -> bench_weights.Spec:
    tc = tower_keys(conf)
    trunk = bench_weights.fancyrec_spec(
        trunk_model(conf["model"], tc["hidden_size"]), conf["data"])
    trunk = [s for s in trunk if not s[0].startswith("text_encoding.bert.")]
    return trunk + tower_spec(tc, conf["initializer_range"])


def reference_config(conf: dict) -> dict:
    tc = tower_keys(conf)
    out = train.reference_config(
        trunk_model(conf["model"], tc["hidden_size"]), conf["data"])
    out["text_net"] = conf["model"]["text_net"]
    out["tower"] = tc
    return out


def routing_off(counts, lengths, k: int, n_experts: int, t_pad: int) -> int:
    """How far the routing counters (a list a layer of E + 1 counts,
    summed over the updates) stand from k rows a valid token and k pad
    slots a pad token of the recorded batches: the largest difference."""
    valid = sum(int(t.sum()) for _, t in lengths)
    pads = sum(len(t) * t_pad for _, t in lengths) - valid
    return max(abs(sum(c[:n_experts]) - k * valid) + abs(c[n_experts]
                                                         - k * pads)
               for c in counts)


def _add(total, counts):
    if total is None:
        return [list(c) for c in counts]
    return [[a + b for a, b in zip(x, y)] for x, y in zip(total, counts)]


def make_posts(conf: dict, traffic: dict, seed: int):
    """-> (posts, words): `generate.posts`, its caption words Zipf-drawn
    over the tower's vocabulary less the WordPiece specials."""
    model_cfg, data = conf["model"], conf["data"]
    n_words = conf["vocab_size"] - len(ref_batches.BERT_SPECIALS)
    words = generate.vocabulary(n_words)
    posts = generate.posts(traffic, model_cfg["brand_num"],
                           data["bow_vocab_size"], seed)
    posts["words"] = zipf_words([len(w) for w in posts["words"]], n_words,
                                traffic["token_zipf"], seed)
    return posts, words


def run(ctx) -> dict:
    cell, dev, seed = ctx["cell"], ctx["device"], int(ctx["seed"])
    conf, traffic = cell.config, cell.traffic
    model_cfg, data = conf["model"], conf["data"]
    tc = tower_keys(conf)
    limits = harness.load_json(os.path.join(
        harness.BENCH, "limits", cell.name + ".json"))
    loader_seed = seed % (2 ** 31)
    drop_seed = seed + 11
    work = ctx["work"]
    os.makedirs(work, exist_ok=True)

    posts, words = make_posts(conf, traffic, seed)
    feats = generate.frame_features(posts, data["feat_dim"],
                                    model_cfg["brand_num"], seed, dev).cpu()
    root = os.path.join(work, "root")
    train.write_collection(root, posts, feats.numpy(), words, data,
                           model_cfg["brand_num"])

    from fancyrec_tpu_torch.config import Config
    from fancyrec_tpu_torch.data.loader import BatchLoader
    from fancyrec_tpu_torch.losses import init_queue_state
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.train.state import TrainState, make_optimizer
    from fancyrec_tpu_torch.train.trainer import build_datasets, train_epoch

    cfg = Config(**model_cfg, text_tower=tc, rootpath=root,
                 trainCollection=train.COLL, valCollection=train.COLL,
                 testCollection=train.COLL, video_feature=train.VIDEO_FEATURE,
                 img_feature=train.IMG_FEATURE,
                 bert_vocab=os.path.join(root, "bert_vocab.txt"),
                 seed=loader_seed, max_frames=data["max_frames"],
                 max_tokens=data["max_tokens"], max_words=data["max_words"])
    datasets = build_datasets(cfg)
    cfg.finalize()
    weights = bench_weights.make(weight_spec(conf), seed, dev)
    with torch.device(dev):
        model = FancyRec(cfg)
    model.load_state_dict(weights)
    model.seed_dropout(drop_seed)
    weights = {k: v.cpu() for k, v in weights.items()}
    opt = make_optimizer(cfg, model.parameters())
    loader = BatchLoader(datasets["train"], cfg.batch_size, shuffle=True,
                         seed=cfg.seed, final_batch="drop")
    a = cfg.accumulation_step
    it = iter(loader)
    first = [next(it) for _ in range(train.SETUP_UPDATES * a)]
    del it

    def fresh(step=0):
        return TrainState(queue=init_queue_state(
            cfg.queue_size, cfg.common_embedding_size, device=dev), step=step)

    state, losses, routed, fewest = fresh(), [], None, []
    for u in range(train.SETUP_UPDATES):
        state, st = train_epoch(model, opt, cfg, state,
                                first[u * a:(u + 1) * a],
                                u - train.SETUP_UPDATES, dev)
        losses += st["losses"]
        routed = _add(routed, st["routing"])
        fewest.append([min(c[:tc["n_routed_experts"]]) for c in st["routing"]])
        if u == 0:
            grad1 = {n: float(opt.state[p]["exp_avg"].norm()) / 0.1
                     for n, p in model.named_parameters()}
    # on the device: a float32 sum of 369 M tiny squares on the host (an
    # expert leaf) stalls far below its value
    change3 = {n: float((p.detach() - weights[n].to(dev)).norm())
               for n, p in model.named_parameters()}
    set_up = [(b["vmask"].sum(1), b["tmask"].sum(1)) for b in first]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - ctx["t_start"]

    rec = train.RecordingLoader(loader)
    posts_done = updates = bad = 0
    epoch, window_routed = 0, None
    with harness.Window(ctx["trace"], dev) as win:
        while True:
            state = fresh(state.step)
            with win.span("train_epoch %d" % epoch):
                state, st = train_epoch(model, opt, cfg, state, rec, epoch,
                                        dev)
            posts_done += st["posts"]
            updates += len(st["losses"])
            bad += sum(not np.isfinite(x) for x in st["losses"])
            window_routed = _add(window_routed, st["routing"])
            epoch += 1
            if time.perf_counter() - win.t0 >= ctx["seconds"]:
                break
    device = harness.device_record(dev, cell.chips)
    graphs = getattr(opt, "_update_graphs", None)
    replays = graphs.replays if graphs is not None else 0
    del model, opt, state, datasets, loader, rec.loader, graphs
    gc.collect()          # the update's graphs and the optimizer hold each other
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    k, e = tc["num_experts_per_tok"], tc["n_routed_experts"]
    off = max(routing_off(routed, set_up, k, e, data["max_tokens"]),
              routing_off(window_routed, rec.lengths, k, e,
                          data["max_tokens"]))
    print("routing: set-up %s rows a MoE layer, the fewest an expert had "
          "in each update %s; window %d updates, %d replayed from the "
          "update's graph" % ([sum(c[:e]) for c in routed], fewest, updates,
                              replays), file=sys.stderr)

    ups = reference_updates(posts, words, feats, cfg, data, loader_seed, dev)
    ref_cfg = reference_config(conf)
    ref = deepseek_v2_ref.train(weights, ref_cfg, ups, drop_seed, dev)
    shutil.rmtree(work, ignore_errors=True)
    checks = train.compare(losses, grad1, change3, ref, limits)
    checks["routing_rows_off"] = (float(off), limits["routing_rows_off"])
    controls = {}
    if ctx.get("control"):
        controls = run_controls(ref, ref_cfg, weights, ups, drop_seed, dev,
                                limits)
    return {"e2e": {"train_posts_per_s": posts_done / win.seconds,
                    "setup_s": setup_s},
            "correct": all(v <= lim for v, lim in checks.values()),
            "attempted": updates, "failed": bad, "device": device,
            "checks": checks, "card": harness.smi(), "controls": controls,
            "observed": {"window": win, "config": conf,
                         "batches": rec.lengths, "updates": updates,
                         "routing": window_routed}}


def reference_updates(posts, words, feats, cfg, data, loader_seed, dev):
    """The set-up's three updates as the reference takes them: the first
    epoch's batches in the loader's order, BERT's token path."""
    keys = ref_batches.sort_keys(posts, words, "transformers")
    order = ref_batches.epoch_batches(posts["n"], cfg.batch_size,
                                      loader_seed, 0, keys)
    feats_dev = feats.to(dev)
    a = cfg.accumulation_step
    return [[ref_batches.tensors(posts, feats_dev, idx, data, "transformers")
             for idx in order[u * a:(u + 1) * a]]
            for u in range(train.SETUP_UPDATES)]


def run_controls(ref, ref_cfg, weights, ups, drop_seed, dev, limits):
    """The readings the limits' upper ends come from: the reference with
    TF32 on (the precision below the configuration's float32), with half
    of each microbatch left out, and routing one expert fewer a token
    (the top-(k - 1) fault), each judged against the float32 reference."""
    def judged(run):
        return {k: v for k, (v, _) in train.compare(
            run["losses"], run["grad_norms"], run["change_norms"], ref,
            limits).items()}

    out = {}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["tf32"] = judged(deepseek_v2_ref.train(weights, ref_cfg, ups,
                                                   drop_seed, dev))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    half = [[{k: v[:v.shape[0] // 2] for k, v in mb.items()} for mb in up]
            for up in ups]
    out["half_batch"] = judged(deepseek_v2_ref.train(weights, ref_cfg, half,
                                                     drop_seed, dev))
    fewer = dict(ref_cfg, tower=dict(
        ref_cfg["tower"],
        num_experts_per_tok=ref_cfg["tower"]["num_experts_per_tok"] - 1))
    out["top_k_minus_1"] = judged(deepseek_v2_ref.train(weights, fewer, ups,
                                                        drop_seed, dev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="dsv2.train")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    a = p.parse_args(argv)
    import run as bench_run
    bench_run._environment()
    cell = harness.Cell(harness.spec(), a.workload)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in a.seeds:
        t0 = time.time()
        r = run(dict(cell=cell, seed=seed, seconds=a.seconds, trace=False,
                     device=dev, t_start=time.time(), control=True,
                     work=bench_run.work_dir(cell.name)))
        rec = {"workload": a.workload, "seed": seed,
               "program": {k: v for k, (v, _) in r["checks"].items()},
               "controls": r["controls"], "seconds": time.time() - t0,
               "posts_per_s": r["e2e"]["train_posts_per_s"],
               "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
