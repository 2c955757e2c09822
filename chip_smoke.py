#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths on one
NVIDIA GPU and check them, and its offline preprocessing.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the paths, from fancyrec_tpu_torch/csrc,
     one nvcc per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes of its main path, with times, the library yardstick and
     the bound of the same work; the GRU forward at both of its batches
     and the backward at the training batch with each number of batch
     rows a block, with and without programmatic dependent launch, and the
     backward with each number of slices of its carry contraction (two
     backward calls must give the same bits); the cosine at the test
     split's 816 posts (split over D) and at 1M posts (one pass); the
     brand dropout's keep bits, as its forward writes them, bit for bit
     against the packed plain Philox mask, its backward from those bits,
     and its forward's integer work counted from the SASS of its per-block
     step beside a timed Philox probe; K3 at 51 x 1M x 1024 (two calls
     bit-identical, the quantization inside its C entry against the plain
     one, its kernels in one profiled call); edge shapes of every kernel
     (K3 up to 33,024 wide, its brands through its ring), and int8 indexes
     30 wide (which K3 does not take) and 4096 wide (which it does) served
     on the card as on the CPU; then the throughput mode's shapes: K1 in
     float32 at B=64 (its training path), K1 in bfloat16 at B=64 (forward
     and backward) and B=128 (forward), which no main path runs, each
     beside cuDNN's GRU in the same dtype, and K2 at B=64; K5 (the routed
     experts' grouped GEMMs, forward and backward) at the dsv2.train
     cell's shape and at ragged edges, and replayed from a CUDA graph over
     new segment offsets, logged on a line of its own (no phase here runs
     its path);
  4. serving, at the full width of the recipe model (bin/instance.sh)
     with random weights from a seed: build an index of a synthetic
     collection through `fancyrec_tpu_torch.serving.index build`, append
     random embeddings up to 1,000,000 posts (the /v1/add path), serve it
     int8 over HTTP and ask /v1/topk for all 51 brands. The served posts
     must equal the plain top-k, and a batch encoded on the card must
     match the same batch encoded on the CPU;
  4b. IVF over that index: `serving.index ivf-build --quantize int8` (its
     stages timed), then /v1/topk for single brands at nprobe 8 (the
     service's default), 64 and nlist over HTTP: every answer must equal a
     plain scan of the same probed lists; the sidecar must hold each post
     once, its rows the index's int8 rows but for rounding, and at
     nprobe = nlist the answers must equal the served exact path's; every
     single-brand exact query (K3 at B=1) must equal the plain top-k; an
     append through /v1/add must make the next IVF query refuse as stale;
  4c. IVF recall@10 and single-query time on a clustered 1M x 1024 corpus
     made on the card (1,024 topics, noise 0.5; nlist 2048), against the
     exact int8 top-k;
  4d. phase 4's checkpoint exported by `serving.export` on the card and on
     the CPU, both run on the card without the model code: encode_post
     equals the index rows and the CPU model (B=128, 1, 2) with one GRU
     kernel launch a call, embed_brand the index's brand embeddings; then
     served with --artifact: /v1/encode and /v1/recommend;
  5. training, at the same width: one train step of 2 microbatches on the
     card against the same step on the CPU; one update of 8 microbatches
     timed and profiled (device time by kernel group); then the trainer
     CLI for one epoch with bin/instance.sh's flags on a synthetic
     train/val/test tree, and an index built from the checkpoint it wrote;
  6. evaluation: the tester CLI (`fancyrec_tpu_torch.eval.tester`) on the
     checkpoint that 5's trainer wrote, over the test split; its eight
     metrics must be finite and equal those of the plain cosine of the
     same embeddings;
  7. the JAX package's documented throughput mode (tools/recipe_tpu_run.py
     fast: batch 64, accumulation 1, --dtype bfloat16 --transfer_dtype
     bfloat16): one bf16 update on the card against the CPU's; one float32
     update with and without --bert_remat 1 (equal, peak memory of each);
     the trainer CLI for three epochs with --profile_dir (posts/s and ms
     per update an epoch, epoch 1 traced and the trace checked), then the
     tester CLI on its
     checkpoint as in 6;
  8. a checkpoint the JAX package wrote (tests/data/frtpu1_tiny.pth.tar)
     read by `load_any` onto the card: its encode equals the CPU's;
  9. offline preprocessing: (a) the ResNet-152 extractor at full depth
     (random weights from a seed, 224 x 224) on 4 images: float32 on the
     card equals the CPU's with either stem, bf16 on the card within
     RESNET_BF16_TOL of the CPU's float32; (b) the bf16 extractor's
     frames/s at B=128 (on a batch on the card, and from a pinned host
     batch), each stem, cuDNN's autotuner off and on, against the bound of
     its convolutions' operations; (c) `extract_features` on the card over
     4,096 synthetic frames into a BigFile (one batch's rows bit for bit
     the extractor's, frameinfo and format_check pass); (d) where cv2
     imports, the JAX package's bench_preprocess videos decoded on threads
     into `extract_features`;
  The rank worlds of phases 10c-e, 11b, 11d and 13a-c train and test on a
  second, smaller tree of the same width (2048-d features, 64 frames, 51
  brands; 2 videos and 2 images a brand in each split: 204 posts, 3
  updates an epoch at 8 x 8, 2 at 13b's 12 x 8): their checks read the
  first one or two updates and a checkpoint. Phases 5-7 and 10a keep phase
  5's 816-post tree.
  10. data parallelism (--mesh_shape R,1): (a) on phase 5's tree, the
     trainer's BigFile readers gather natively (g++ is on the card's host;
     the phase fails otherwise), and the host side of one recipe epoch
     timed with the native gather and the memmap; (b) K1-fwd, K1-bwd and K2
     at a rank's batch (B=4, full width) and K4 at a rank's post shard
     (51 x 102) against their plain versions; (c) the trainer CLI for one recipe epoch
     outside a world and in a world of one over NCCL, each in a process of
     its own: the first update and the checkpoint equal bit for bit; (d)
     the same recipe over two ranks sharing the card (gloo): the first
     update within phase 5's tolerances of (c)'s one-process update of the
     same global batch, and each rank launches K1-fwd, K1-bwd, K2-fwd,
     K2-bwd and K4; (e) the tester CLI over two ranks on (d)'s checkpoint:
     its eight metrics equal the one-process tester's. The phase's trainer
     runs have every dropout off and deterministic algorithms on; each
     rank prints its ms per update, device peak and launches.
  11. tensor parallelism (--mesh_shape R,M), on the small tree: (a) K2 on
     aspect shards of the 2000-aspect table at M = 2 and 4, B = 8 and 4:
     each shard's C entries against their plain versions (times and bounds
     at the shard's A), every shard's keep bits equal to the one-table
     kernel's bits of its aspects and the shards' outputs summing to its
     output; (b) the trainer CLI for one recipe epoch at --mesh_shape 1,2
     (two ranks sharing the card, gloo, dropouts off): its first update,
     gathered over the model group, within phase 5's tolerances of 10c's
     one-process update, and each rank launches K1-fwd, K1-bwd, K2 on its
     1000 aspects and K4; then one update with every dropout on at (1, 2)
     against one process from the same seed; (c) one update at
     --mesh_shape 2,2 (four ranks) against one process's update of the
     same batch, on phase 5's tree (the small tree's first batch holds a
     two-ulp near-tie in the text conv bank's max-pool, which the (2, 2)
     sum order flips); (d) the tester CLI at
     (1, 2) on b's checkpoint: its metrics equal the one-process tester's.
  12. sharded serving, on phase 4's index (1,000,001 int8 rows of 1024
     after 4b's append): (a) `distributed_retrieval_topk` over 2 and 4
     post shards on the card: K3 launched once a shard a call, the answer
     bit-equal to one K3 call over the whole index and equal to the plain
     per-shard version; each shard's K3 ms beside its bytes bound, the
     merge's and the whole call's ms; edges (a shard without a valid row
     with k > N, 132-byte rows with N % S != 0, k = 128); (b) the int8
     service over 4 shards: /v1/topk for the 51 brands 21 times over
     HTTP (p50, p99), every answer equal to phase 4's service's and to
     one K3 call's, then /v1/add, after which the next query ranks the
     new post first; (c) phase 4b's IVF sidecar with its lists over 4
     shards: 8 brands at nprobe 8 and 64, both probe modes, equal to the
     unsharded sidecar's answers, a query's ms; (d) `index build` over two
     ranks sharing the card (gloo, --mesh_shape 2,1) on phase 4's
     collection: phase 4's cap ids in its order, the rows within
     RANK_BUILD_TOL of its rows, K1 launched on each rank; (e, run after
     a, before b's append) `index query --quantize int8 --mesh_shape 2,1`
     for the 51 brands over two ranks sharing the card (gloo), each
     holding its 500,001 rows and launching K3 once: every rank's answer
     bit-equal to a's one K3 call (and so to a's S=2 answer), only the
     primary printing; then, on the sidecar built again, --nprobe 8 over
     the same ranks equal to the unsharded sidecar's answer; each rank's
     K3 ms beside its bytes bound and its gather's ms.
  13. sequence parallelism and the BERT pipeline over the model axis, on
     the small tree (ranks sharing the card, gloo, dropouts off): K1-fwd,
     K1-bwd and K2 at (b)'s batch of 12, K1-fwd at (c)'s of 96 and K4 at
     (c)'s 51 x 204 against their plain versions; (a)
     the trainer CLI for one recipe epoch at --mesh_shape 1,2 --seq_shard:
     its first update within phase 5's tolerances of 10c's; (b) the trainer
     CLI for one epoch at --mesh_shape 1,3 --pp_stages 3 --batch_size 12
     (one BERT layer a stage): its first update against a one-process
     update of the same batch, BERT and its Adam moments bit-equal on the
     three ranks after two updates, the tensors the rules split at 3; (c)
     the tester at (1, 3) on (b)'s checkpoint: its metrics equal the
     one-process tester's. Each rank prints its ms per update, device
     peak and launches.
  14. (a) the flagship forward, `fancyrec_tpu_torch.entry.entry()` (the
     full-width model in eval mode on the example batch of 8), on the card
     against the same forward on the CPU within ENC_TOL, K1-fwd launched;
     (b) the multi-rank dry run, `entry.dryrun_multichip(4)`: four ranks
     sharing the card (gloo) at (2, 2), one update of the tiny config with
     --seq_shard and its dropouts on, the sharded metrics against the
     gathered ones, the top-k over the data slots, the BERT pipeline
     against the sequential encoder (pp_delta < 1e-4); each rank launches
     K1-fwd, K1-bwd, K2 and K4, held first against their plain versions at
     the dry run's tiny shapes.
The kernels' launch counts are zeroed just before each of the nine paths
(4, 4b, 4d, 5c, 6, 7's trainer, 7's tester, 12b and 12d) and read just
after: each kernel must have run on its path (K1-fwd on 4, 4d and 12d's
ranks, K3 on 4, 4b and 12b), and around 14a (K1-fwd).
Phase 10's, 11's, 12e's, 13's and 14b's ranks zero and read their own
counts around their CLI's main (or their one update, or the dry run's
body); the records of phase 10 (K1, K2 at B=4,
K4 at a shard) count the launches summed over the ranks of 10d (training)
and 10e (evaluation), those of K2 on aspect shards over 11b's ranks (B=8,
the trainer at (1, 2)) and 11c's (B=4, the update at (2, 2)). K2 at M=4
runs on no main path: its records are printed on a line of their own.
Phase 9 runs cuDNN's convolutions and none of the six kernels: its counts
are printed, not required.

Prints a `kernels` JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. `python3 chip_smoke.py seq_pp` runs phase 13
alone on a host of 3 or more cards, a card a rank over NCCL. Any failed phase exits non-zero; without a
CUDA device, or without the package beside this script, it exits
non-zero before printing any result.
"""

import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# serving shapes: the index build's batch and the recipe's GRU; the 51
# brands of insCar against the 1M-post index of bench.py's serving cell
T, B_ENC, H, D_IN = 64, 128, 1024, 2048
N_POSTS, N_BRANDS, DIM, TOPK = 1_000_000, 51, 1024, 10
N_REQUESTS = 21   # /v1/topk calls on the main path, the first a warm-up
# synthetic collection: 40 videos of 64 frames and 40 images per brand
VIDEOS_PER_BRAND, IMGS_PER_BRAND, FRAMES = 40, 40, 64
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BPS, F32_FLOPS, INT8_OPS = 3.35e12, 67e12, 1979e12
INT32_OPS = F32_FLOPS / 4   # 64 integer operations a clock an SM, not 256
BF16_FLOPS = 989e12   # H100 SXM bf16 tensor cores, dense
K1_TOL = 1e-4     # float32; sum order over H=1024 and 64 recurrent steps
# bf16 h: a float32 sum-order difference that crosses a bf16 rounding
# boundary moves h by one ulp (2^-8 relative), as check_edges allows
K1_BF16_TOL, K1B_BF16_TOL = 2e-2, 5e-2
# training shapes: bin/instance.sh's batch of 8 and 2000 brand aspects; the
# brand dropout's keep probability and fixed seed words for the checks
B_TRAIN, N_ASPECTS, KEEP, K2_SEED = 8, 2000, 0.5, (0x2545F491, 0x9E3779B9)
ACCUM, LR = 8, 1e-4        # bin/instance.sh: 8 summed microbatches, Adam lr
# the JAX package's validated throughput mode (tools/recipe_tpu_run.py fast):
# bin/instance.sh's model with these flags
B_FAST = 64
FAST_FLAGS = ["--batch_size", str(B_FAST), "--accumulation_step", "1",
              "--dtype", "bfloat16", "--transfer_dtype", "bfloat16"]
# the training fixture: 8 videos of 64 frames and 8 images per brand in
# each of train, val and test (816 posts each: 12 updates an epoch)
TRAIN_VIDEOS_PER_BRAND, TRAIN_IMGS_PER_BRAND = 8, 8
# the smaller tree of the rank worlds of phases 10c-e, 11b-d and 13a-c, at
# the same width: 2 videos and 2 images per brand in each split (204 posts:
# 3 updates an epoch at 8 x 8, 2 at 13b's 12 x 8, 26 validation batches)
SMALL_VIDEOS_PER_BRAND, SMALL_IMGS_PER_BRAND = 2, 2
# card vs CPU train step: grads per tensor relative to the tensor's largest
# (floored at 1e-4 of the model's largest), float32 through BERT, the GRU
# and the conv banks in other sum orders.
# Params: Adam's first step moves each by about lr * sign(grad), so a grad
# near zero that rounds to the other sign leaves them 2 lr apart
STEP_TOL = 1e-3
K1B_TOL = 1e-4    # float32; sum order over 3H=3072 and 64 reverse steps
K2_TOL = 1e-5     # float32 sums over 2000 aspects or 1024 columns; a single
                  # dropped element moves an output by |w asp|/1000 ~ 1e-3
K3_TOL = 1e-6     # the same float32 products; only the sort differs
K3_QTOL = 1e-6    # relative: the brand scale is rsqrtf of the same exact sum
K5_TOL = 1e-4     # float32 sums over D=2048 or 2F=2816 rows of products in
                  # another order than cuBLAS's, relative to the largest
K4_TOL = 2e-5     # float32 sums over D=1024 in another order; the JAX
                  # package's tolerance for its kernel (test_similarity_ops)
N_EVAL = N_BRANDS * (TRAIN_VIDEOS_PER_BRAND + TRAIN_IMGS_PER_BRAND)  # test
N_SMALL = N_BRANDS * (SMALL_VIDEOS_PER_BRAND + SMALL_IMGS_PER_BRAND)
ENC_TOL = dict(atol=1e-4, rtol=1e-3)   # card vs CPU, float32, no TF32
# preprocessing: the ResNet-152 extractor at 224 x 224 and the JAX
# package's batch of 128; a stream of 32 such batches
RESNET_HW, B_EXTRACT, N_RESNET_CHECK, N_STREAM = 224, 128, 4, 4096
# bf16 extractor on the card vs the float32 one on the CPU, relative L2 an
# image: twice the JAX package's own bf16-vs-float32 spread, 3.5696e-3 (its
# make_extractor at full depth on its init_random_params() tree, 4 uint8
# images from numpy seed 0, the largest of the 4; measured once on a CPU
# with jax 0.9.0, outside this script)
RESNET_BF16_TOL = 2 * 3.5696e-3
# the decode leg: the JAX package's bench_preprocess videos
N_DECODE_VIDEOS, DECODE_FRAMES, DECODE_SIZE, DECODE_WORKERS = 8, 450, (
    640, 360), 4


# the rank processes running (`start_jobs`), which a failure kills
_LIVE = []


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    for p in _LIVE:
        p.kill()
    sys.exit(1)


def log(msg):
    print("chip_smoke: %s" % msg, flush=True)


def cuda_ms(fn, iters, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_gru(dev):
    """K1 at the index build's shape: kernel vs plain vs cuDNN."""
    import torch
    from fancyrec_tpu_torch.models.gru import _input_proj
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda, gru_scan_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    bound = 1.0 / math.sqrt(H)
    u = lambda *s: (torch.rand(*s, generator=g, device=dev) * 2 - 1) * bound  # noqa: E731
    p = {d: {"w_ih": u(3 * H, D_IN), "w_hh": u(3 * H, H), "b_ih": u(3 * H),
             "b_hh": u(3 * H)} for d in ("fwd", "bwd")}
    x = torch.randn(T, B_ENC, D_IN, generator=g, device=dev)
    with torch.no_grad():
        xw = _input_proj(x, x.flip(0), p["fwd"], p["bwd"]).contiguous()
        w_hh = torch.stack([p["fwd"]["w_hh"], p["bwd"]["w_hh"]])
        b_hh = torch.stack([p["fwd"]["b_hh"], p["bwd"]["b_hh"]])
        out_k = gru_scan_cuda(xw, w_hh, b_hh)
        out_p = gru_scan_ref(xw, w_hh, b_hh)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        log("gru_scan: max |kernel - plain| = %.3g (tolerance %g)"
            % (err, K1_TOL))
        if not math.isfinite(err) or err > K1_TOL:
            fail("gru_scan kernel disagrees with its plain version")
        # yardstick: cuDNN's bidirectional GRU on the same weights; it also
        # computes the input projection, which the kernel receives done
        rnn = torch.nn.GRU(D_IN, H, bidirectional=True).to(dev)
        for d, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
            for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                              ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                getattr(rnn, "%s_%s" % (name, sfx)).copy_(p[d][key])
        ref_out = rnn(x)[0]
        ours = torch.cat([out_k[:, 0], out_k[:, 1].flip(0)], dim=-1)
        log("gru_scan: max |kernel - cuDNN GRU| = %.3g (information)"
            % (ours - ref_out).abs().max().item())
        ms = cuda_ms(lambda: gru_scan_cuda(xw, w_hh, b_hh), 20)
        plain_ms = cuda_ms(lambda: gru_scan_ref(xw, w_hh, b_hh), 5)
        library_ms = cuda_ms(lambda: rnn(x), 20)
        layer_ms = cuda_ms(lambda: gru_scan_cuda(
            _input_proj(x, x.flip(0), p["fwd"], p["bwd"]), w_hh, b_hh), 20)
    log("gru_scan: kernel %.3f ms, plain %.3f ms, cuDNN GRU %.3f ms, "
        "input projection + kernel (the whole layer) %.3f ms"
        % (ms, plain_ms, library_ms, layer_ms))
    check_gru_bwd_b128(rnn, x, xw, out_k, w_hh, b_hh, g)
    ops = 2 * (T - 1) * 2 * B_ENC * 3 * H * H        # h0 = 0: no product at t=0
    nbytes = 4 * (xw.numel() + w_hh.numel() + b_hh.numel() + out_k.numel())
    return {"name": "gru_scan", "route": "cuda",
            "source": "fancyrec_tpu_torch/csrc/gru_scan.cu",
            "replaces": "fancyrec_tpu/ops/gru_scan.py:157",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **roofline(nbytes, ops, F32_FLOPS), "library_ms": library_ms}


def check_gru_bwd_b128(rnn, x, xw, out, w_hh, b_hh, g):
    """K1-bwd at B=128 (the trainer's default batch) against its plain
    version, timed beside the backward of cuDNN's GRU on the same recurrent
    weights (which also forms the input and weight grads)."""
    import torch
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_bwd_ref)

    with torch.no_grad():
        h_prev = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
        dout = torch.randn(out.shape, generator=g, device=out.device)
        got = gru_scan_bwd_cuda(xw, h_prev, dout, w_hh, b_hh)
        want = gru_scan_bwd_ref(xw, h_prev, dout, w_hh, b_hh)
        err = max((x_ - y).abs().max().item() for x_, y in zip(got, want))
        if not err <= K1B_TOL:
            fail("gru_scan_bwd at B=%d: max err %.3g > %g" % (B_ENC, err,
                                                             K1B_TOL))
        ms = statistics.median(cuda_ms(lambda: gru_scan_bwd_cuda(
            xw, h_prev, dout, w_hh, b_hh), 5) for _ in range(3))
        del got, want
    xg = x.detach().requires_grad_(True)
    y = rnn(xg)[0]
    dy = torch.randn(y.shape, generator=g, device=y.device)
    params = [xg] + list(rnn.parameters())
    library_ms = statistics.median(cuda_ms(lambda: torch.autograd.grad(
        y, params, dy, retain_graph=True), 5) for _ in range(3))
    log("gru_scan_bwd at B=%d: kernel %.3f ms (max err %.3g), cuDNN GRU "
        "backward %.3f ms (medians of 3 windows of 5)"
        % (B_ENC, ms, err, library_ms))


def check_topk(dev):
    """K3 at the serving shape: kernel vs plain (indices equal), two calls
    bit-equal, the quantization inside the C entry against
    `quantize_rows_int8`; the wrapper call, the C entry alone and the
    device time of the call's kernels, which must be the C entry's own."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import (
        quantize_rows_int8, topk_int8_cuda, topk_int8_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    brands = torch.randn(N_BRANDS, DIM, generator=g, device=dev)
    posts_q = torch.empty(N_POSTS, DIM, dtype=torch.int8, device=dev)
    posts_inv = torch.empty(N_POSTS, device=dev)
    for lo in range(0, N_POSTS, 1 << 17):
        hi = min(lo + (1 << 17), N_POSTS)
        posts_q[lo:hi], posts_inv[lo:hi] = quantize_rows_int8(
            torch.randn(hi - lo, DIM, generator=g, device=dev))
    with torch.no_grad():
        vk, ik = topk_int8_cuda(brands, posts_q, posts_inv, TOPK)
        again = topk_int8_cuda(brands, posts_q, posts_inv, TOPK)
        vp, ip = topk_int8_ref(brands, posts_q, posts_inv, TOPK)
        torch.cuda.synchronize()
        if not torch.equal(ik, ip):
            fail("topk_int8 kernel indices differ from the plain version "
                 "in %d of %d slots" % (int((ik != ip).sum()), ik.numel()))
        err = (vk - vp).abs().max().item()
        same = torch.equal(vk, again[0]) and torch.equal(ik, again[1])
        log("topk_int8: indices equal; max |kernel - plain| = %.3g "
            "(tolerance %g); two calls bit-identical: %s" % (err, K3_TOL, same))
        if not math.isfinite(err) or err > K3_TOL:
            fail("topk_int8 kernel values disagree with its plain version")
        if not same:
            fail("two calls of the topk_int8 kernel differ")
        check_topk_quantization(brands, posts_q, posts_inv)
        entry = topk_entry(brands, posts_q, posts_inv, TOPK)[0]
        ms = statistics.median(cuda_ms(lambda: topk_int8_cuda(
            brands, posts_q, posts_inv, TOPK), 20) for _ in range(5))
        entry_ms = statistics.median(cuda_ms(entry, 20) for _ in range(5))
        dev_ms = device_ms(lambda: topk_int8_cuda(brands, posts_q, posts_inv,
                                                  TOPK), 5)
        names = call_kernels(lambda: topk_int8_cuda(brands, posts_q,
                                                    posts_inv, TOPK))
        plain_ms = cuda_ms(lambda: topk_int8_ref(brands, posts_q, posts_inv,
                                                 TOPK), 3)
    log("topk_int8: one profiled wrapper call launches %d kernels: %s"
        % (len(names), ", ".join(names)))
    if not names or any(not n.startswith("topk_") for n in names):
        fail("a topk_int8 call launched kernels besides its C entry's own")
    log("topk_int8 %d x %d x %d, k=%d: wrapper call %.4f ms (median of 5 "
        "windows of 20), C entry alone %.4f ms, device time of a call's "
        "kernels %.4f ms (profiler union), plain %.3f ms"
        % (N_BRANDS, N_POSTS, DIM, TOPK, ms, entry_ms, dev_ms, plain_ms))
    ops = 2 * N_BRANDS * N_POSTS * DIM
    nbytes = (4 * brands.numel() + posts_q.numel() + 4 * posts_inv.numel()
              + 8 * N_BRANDS * TOPK)
    return {"name": "topk_int8", "route": "cuda",
            "source": "fancyrec_tpu_torch/csrc/topk_int8.cu",
            "replaces": "fancyrec_tpu/ops/similarity.py:242",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "entry_ms": entry_ms, "device_ms": dev_ms,
            **roofline(nbytes, ops, INT8_OPS), "library_ms": None}


def topk_entry(brands, posts_q, posts_inv, k, n_valid=None):
    """K3's C entry on buffers made once, as the wrapper would call it:
    (a call of it, vals, idxs, scratch, plan). Not counted as a launch of
    the wrapper."""
    import torch
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops.similarity import (
        _topk_fn, topk_int8_args, topk_int8_plan)

    (b, d), dev = brands.shape, brands.device
    n_valid = posts_q.shape[0] if n_valid is None else n_valid
    plan = topk_int8_plan(b, n_valid, d, k, _build.sm_count(dev))
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    vals = torch.empty((b, k), device=dev)
    idxs = torch.empty((b, k), dtype=torch.int32, device=dev)
    args = topk_int8_args(brands, posts_q, posts_inv, scratch, vals, idxs, k,
                          n_valid, plan)
    fn = _topk_fn()
    if fn(*args):
        fail("the topk_int8 C entry failed")
    return (lambda: fn(*args)), vals, idxs, scratch, plan


def check_topk_quantization(brands, posts_q, posts_inv):
    """The brands' quantization inside K3's C entry: the q bytes it leaves
    in scratch equal `quantize_rows_int8`'s exactly, and its scales are
    within K3_QTOL of the plain rsqrt's (the same rsqrtf of the same exact
    sum, so equal in practice)."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import quantize_rows_int8

    _, _, _, scratch, plan = topk_entry(brands, posts_q, posts_inv, TOPK)
    torch.cuda.synchronize()
    (b, d) = brands.shape
    dq = -(-d // 256) * 256                # q's rows: round_up(D, 256)
    q_at, inv_at = plan.parts[:2]
    q = scratch[q_at:q_at + b * dq].view(b, dq).view(torch.int8)
    b_inv = scratch[inv_at:inv_at + 4 * b].view(torch.float32)
    q_want, inv_want = quantize_rows_int8(brands)
    if not torch.equal(q[:, :d], q_want) or q[:, d:].any():
        fail("the quantization inside topk_int8 differs from "
             "quantize_rows_int8 in %d of %d bytes"
             % (int((q[:, :d] != q_want).sum()), q_want.numel()))
    rel = ((b_inv - inv_want).abs() / inv_want.abs().clamp(min=1e-30)).max()
    log("topk_int8: quantized brands equal quantize_rows_int8's bytes; "
        "their scales max relative |diff| %.3g (tolerance %g), bit-equal: "
        "%s" % (rel.item(), K3_QTOL, torch.equal(b_inv, inv_want)))
    if not rel.item() <= K3_QTOL:
        fail("the brand scales inside topk_int8 differ from the plain ones")


def device_ms(fn, calls, tries=2):
    """The union of the intervals of the kernels that `calls` calls of fn
    launch, in torch.profiler, a call; NaN where the profiler returned no
    kernel record or a number that is not a whole number a call in each of
    `tries` sessions. Late in a long process it drops records (of K2's
    forward C entry at B=12: all of them in this script's phase 13, one a
    session in a short process that had run K1 and K2 before, none in a
    fresh one), and a union over the rest would read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.time_range.end > e.time_range.start]
        if spans and len(spans) % calls == 0:
            return _union_ms(spans) / calls
    return float("nan")


def json_record(rec, keys):
    """rec's `keys` that it has, every non-finite float in them, nested
    ones too, as None (JSON null): a device time where the profiler saw no
    kernel."""
    def finite(v):
        if isinstance(v, float):
            return v if math.isfinite(v) else None
        if isinstance(v, dict):
            return {k: finite(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [finite(x) for x in v]
        return v
    return {k: finite(rec[k]) for k in keys if k in rec}


def call_kernels(fn):
    """The names of the kernels one call of fn launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name.replace("(anonymous namespace)::", "")
            .replace("void ", "").split("<")[0].split("(")[0]
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.end > e.time_range.start]


def _cosine_case(g, dev, b, n, d, zero_post=None):
    import torch
    brands = torch.randn(b, d, generator=g, device=dev)
    posts = torch.randn(n, d, generator=g, device=dev)
    if zero_post is not None:
        posts[zero_post] = 0.0
    return brands, posts


def _cosine_err(got, want):
    """max |kernel - plain| over the finite entries; fails unless the NaNs
    (all-zero rows) stand in the same places."""
    import torch
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("nan")
    return (got[~nan] - want[~nan]).abs().max().item() if (~nan).any() else 0.0


def check_cosine(dev):
    """K4 at the 1M-post evaluation (51 x 1,000,000 x 1024), at the tester's
    shape (51 x N_EVAL) and at edge shapes: kernel vs plain vs the one-call
    PyTorch cosine (cuBLAS, float32). Few posts take the D-split path
    (`cosine_slices` > 1); two calls there give the same bits."""
    import torch
    import torch.nn.functional as F
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores_cuda, cosine_scores_ref, cosine_slices)

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = _build.sm_count(dev)
    # edges: one brand, a ragged post tile, D not a multiple of the stage,
    # an all-zero post row (NaN in the same column), two brand tiles; then
    # the few-post shapes of the split path: the test split, one post, D
    # within one stage (which leaves nothing to split: S = 1), a ragged
    # post tile with a ragged last D stage
    for b, n, d, zero in ((1, 777, 130, 5), (6, 4096, 1024, 4095),
                          (70, 1000, 33, 0), (51, 128, 1, None),
                          (N_BRANDS, N_EVAL, DIM, 3), (N_BRANDS, 1, DIM, None),
                          (3, 5, 7, 1), (64, 129, 1000, 128)):
        brands, posts = _cosine_case(g, dev, b, n, d, zero)
        got = cosine_scores_cuda(brands, posts)
        err = _cosine_err(got, cosine_scores_ref(brands, posts))
        same = torch.equal(torch.nan_to_num(got),
                           torch.nan_to_num(cosine_scores_cuda(brands, posts)))
        if not (err <= K4_TOL and same):
            fail("cosine_scores B=%d N=%d D=%d zero row %s (%d slices): max "
                 "err %.3g (NaN where the plain version has none, or > %g); "
                 "two calls equal: %s" % (b, n, d, zero,
                                          cosine_slices(b, n, d, sms), err,
                                          K4_TOL, same))
    times = {}
    for n in (N_EVAL, N_POSTS):
        brands, posts = _cosine_case(g, dev, N_BRANDS, n, DIM)
        with torch.no_grad():
            out_k = cosine_scores_cuda(brands, posts)
            out_p = cosine_scores_ref(brands, posts)
            torch.cuda.synchronize()
            err = _cosine_err(out_k, out_p)
            log("cosine_scores %d x %d x %d, %d D slices: max |kernel - "
                "plain| = %.3g (tolerance %g)"
                % (N_BRANDS, n, DIM, cosine_slices(N_BRANDS, n, DIM, sms),
                   err, K4_TOL))
            if not err <= K4_TOL:
                fail("cosine_scores kernel disagrees with its plain version")
            # the kernel and cuBLAS in five pairs, which goes first
            # alternating; the medians, since at few posts both calls are
            # host-bound and the host's time spreads
            runs = {"kernel": [], "lib": []}
            calls = {"kernel": lambda: cosine_scores_cuda(brands, posts),
                     "lib": lambda: F.normalize(brands) @ F.normalize(posts).T}
            for r in range(5):
                for name in (("kernel", "lib") if r % 2 == 0
                             else ("lib", "kernel")):
                    runs[name].append(cuda_ms(calls[name], 50))
            times[n] = (statistics.median(runs["kernel"]),
                        cuda_ms(lambda: cosine_scores_ref(brands, posts), 5),
                        statistics.median(runs["lib"]))
            entry = cosine_entry_ms(brands, posts)
        log("cosine_scores %d x %d x %d: kernel %.4f ms (median of 5, %.4f "
            "to %.4f), plain %.4f ms, F.normalize @ F.normalize.T (cuBLAS) "
            "%.4f ms (%.4f to %.4f); the C entry alone %.4f ms"
            % (N_BRANDS, n, DIM, times[n][0], min(runs["kernel"]),
               max(runs["kernel"]), times[n][1], times[n][2],
               min(runs["lib"]), max(runs["lib"]), entry))
    ms, plain_ms, library_ms = times[N_POSTS]
    ops = 2 * N_BRANDS * N_POSTS * DIM
    nbytes = 4 * (brands.numel() + posts.numel() + out_k.numel())
    small = roofline(4 * N_BRANDS * (DIM + N_EVAL) + 4 * N_EVAL * DIM,
                     2 * N_BRANDS * N_EVAL * DIM, F32_FLOPS)
    log("cosine_scores %d x %d x %d: bound %.4f ms (%s)"
        % (N_BRANDS, N_EVAL, DIM, small["bound_ms"], small["bound_by"]))
    del out_k, out_p, posts
    return {"name": "cosine_scores", "route": "cuda",
            "source": "fancyrec_tpu_torch/csrc/cosine_scores.cu",
            "replaces": "fancyrec_tpu/ops/similarity.py:108",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **roofline(nbytes, ops, F32_FLOPS), "library_ms": library_ms}


def _moe_case(g, dev, e, d, f, counts, pads):
    """Rows sorted by expert (`counts` a segment, then `pads` pad rows),
    weights at DeepSeek-V2's std of 0.02, and the offsets."""
    import torch
    r = sum(counts) + pads
    off = torch.tensor([0] + list(itertools.accumulate(counts)),
                       dtype=torch.int64, device=dev)
    xs = torch.randn(r, d, generator=g, device=dev)
    w13 = torch.randn(e, 2 * f, d, generator=g, device=dev) * 0.02
    w2 = torch.randn(e, d, f, generator=g, device=dev) * 0.02
    dys = torch.randn(r, d, generator=g, device=dev)
    dys[sum(counts):] = 0.0
    return xs, off, w13, w2, dys


def _moe_pass(fns, xs, off, w13, w2, dys, dw13, dw2):
    """K5's forward and backward through `fns` (the kernels or the plain
    versions): -> (ys, dxs), dW added into dw13, dw2."""
    from fancyrec_tpu_torch.ops import moe
    rows, wgrad = fns
    gu, act = rows(xs, w13, off, moe.NT_SWIGLU)
    ys = rows(act, w2, off, moe.NT_STORE)
    dgu = rows(dys, w2, off, moe.NN_DSWIGLU, gu)
    dxs = rows(dgu, w13, off, moe.NN_STORE)
    wgrad(dys, act, off, dw2)
    wgrad(dgu, xs, off, dw13)
    return ys, dxs


def _moe_err(got, want):
    """max |kernel - plain| over max |plain|, each output in turn."""
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


def check_moe(dev):
    """K5 against its plain version, forward and backward (dW added into a
    gradient that already holds a value), at the dsv2.train cell's shapes
    (64 experts of 1408 at D=2048, a microbatch's 8 x 128 tokens x 6 slots,
    about 51 rows an expert) and at ragged edges (empty experts, one expert
    holding every row, segments that are not whole tiles, no pad rows);
    two calls give the same bits; a CUDA graph captured over one routing
    and replayed over another gives the eager call's bits. Then the times
    at the cell's shape against the bound. Its main path is the DeepSeek-V2
    caption tower, which the benchmark's dsv2.train cell runs."""
    import torch
    from fancyrec_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    kernel = (moe.moe_rows_cuda, moe.moe_wgrad_cuda)
    plain = (moe.moe_rows_ref, moe.moe_wgrad_ref)
    edges = [(3, 32, 8, [0, 130, 5], 7), (4, 64, 16, [0, 0, 0, 70], 0),
             (5, 48, 24, [1, 64, 65, 0, 127], 64), (2, 16, 4, [0, 0], 9)]
    for e, d, f, counts, pads in edges:
        case = _moe_case(g, dev, e, d, f, counts, pads)
        xs, off, w13, w2, dys = case
        start = [torch.randn(e, 2 * f, d, generator=g, device=dev),
                 torch.randn(e, d, f, generator=g, device=dev)]
        outs = {}
        for name, fns in (("kernel", kernel), ("plain", plain),
                          ("again", kernel)):
            dws = [t.clone() for t in start]
            ys, dxs = _moe_pass(fns, *case, *dws)
            outs[name] = (ys, dxs, *dws)
        torch.cuda.synchronize()
        err = _moe_err(outs["kernel"], outs["plain"])
        same = all(torch.equal(a, b)
                   for a, b in zip(outs["kernel"], outs["again"]))
        zero = (not outs["kernel"][0][sum(counts):].any()
                and not outs["kernel"][1][sum(counts):].any())
        if not (err <= K5_TOL and same and zero):
            fail("moe_gemm E=%d D=%d F=%d rows %s + %d pads: relative err "
                 "%.3g (> %g?), two calls equal: %s, pad rows zero: %s"
                 % (e, d, f, counts, pads, err, K5_TOL, same, zero))
    # the cell's shape: about 51 rows an expert (544 of 1024 tokens valid)
    e, d, f, k, n_tok, n_valid = 64, 2048, 1408, 6, 1024, 544
    shares = torch.rand(e, generator=g, device=dev).cpu() + 0.5
    counts = (shares / shares.sum() * n_valid * k).floor().long()
    counts[0] += n_valid * k - int(counts.sum())
    counts[5] = 0                                   # one expert left out
    counts[6] += n_valid * k - int(counts.sum())
    case = _moe_case(g, dev, e, d, f, counts.tolist(), (n_tok - n_valid) * k)
    xs, off, w13, w2, dys = case
    dws = [torch.zeros_like(w13), torch.zeros_like(w2)]
    got = _moe_pass(kernel, *case, *dws) + tuple(dws)
    dws_p = [torch.zeros_like(w13), torch.zeros_like(w2)]
    want = _moe_pass(plain, *case, *dws_p) + tuple(dws_p)
    torch.cuda.synchronize()
    err = _moe_err(got, want)
    log("moe_gemm at E=%d D=%d F=%d, %d rows (%d valid): relative err %.3g "
        "(tolerance %g)" % (e, d, f, xs.shape[0], n_valid * k, err, K5_TOL))
    if not err <= K5_TOL:
        fail("moe_gemm disagrees with its plain version at the cell's shape")
    # capture over this routing, replay over another: the eager bits
    other = counts.roll(7)
    off2 = torch.tensor([0] + list(itertools.accumulate(other.tolist())),
                        dtype=torch.int64, device=dev)
    gdw = [torch.zeros_like(w13), torch.zeros_like(w2)]
    off_in = off.clone()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _moe_pass(kernel, xs, off_in, w13, w2, dys, *gdw)   # warm-up
        with torch.cuda.graph(graph, stream=stream):
            g_out = _moe_pass(kernel, xs, off_in, w13, w2, dys, *gdw)
    torch.cuda.current_stream().wait_stream(stream)
    for dw in gdw:
        dw.zero_()
    off_in.copy_(off2)
    graph.replay()
    edw = [torch.zeros_like(w13), torch.zeros_like(w2)]
    e_out = _moe_pass(kernel, xs, off2, w13, w2, dys, *edw)
    torch.cuda.synchronize()
    replayed = all(torch.equal(a, b) for a, b in
                   zip(tuple(g_out) + tuple(gdw), tuple(e_out) + tuple(edw)))
    if not replayed:
        fail("moe_gemm replayed from a CUDA graph over new offsets differs "
             "from the eager call")
    del graph, g_out, e_out, gdw, edw, dws_p, want
    rows = n_valid * k
    # operations: gate/up, down forward, each twice backward (dX, dW);
    # bytes: the experts' weights read forward and for dX, their gradients
    # read and written by dW, and each launch's rows in and out
    ops = 18 * rows * d * f
    nbytes = 4 * (4 * e * 3 * f * d + rows * (7 * d + 13 * f))
    kernel_dws = [torch.zeros_like(w13), torch.zeros_like(w2)]
    ms = cuda_ms(lambda: _moe_pass(kernel, *case, *kernel_dws), 20)
    fwd_ms = cuda_ms(lambda: _moe_pass_fwd(kernel, xs, off, w13, w2), 20)
    # the plain version is a loop of cuBLAS float32 matmuls over experts
    plain_ms = cuda_ms(lambda: _moe_pass(plain, *case, *kernel_dws), 3)
    rec = {"name": "moe_gemm", "route": "cuda",
           "source": "fancyrec_tpu_torch/csrc/moe_gemm.cu",
           "replaces": "none (the JAX package has no routed layer)",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "forward_ms": fwd_ms, "launches": 6, "shape": [e, d, f, rows],
           **roofline(nbytes, ops, F32_FLOPS)}
    log("moe_gemm at the cell's shape (E=%d, D=%d, F=%d, %d rows): forward "
        "and backward %.3f ms (forward %.3f), 6 launches; plain %.3f ms; "
        "bound %.3f ms (%s); %.1f%% of the bound"
        % (e, d, f, rows, ms, fwd_ms, plain_ms, rec["bound_ms"],
           rec["bound_by"], 100.0 * rec["bound_ms"] / ms))
    del case, xs, w13, w2, dys, kernel_dws, dws
    torch.cuda.empty_cache()
    return rec


def _moe_pass_fwd(fns, xs, off, w13, w2):
    from fancyrec_tpu_torch.ops import moe
    rows = fns[0]
    _, act = rows(xs, w13, off, moe.NT_SWIGLU)
    return rows(act, w2, off, moe.NT_STORE)


def cosine_entry_ms(brands, posts):
    """K4's launches through its C entry on buffers made once, back to
    back: the call without the wrapper's Python (its checks, allocations,
    stream lookup and, for the single pass, the brands' normalization),
    which holds the card at few posts. Not counted as a launch of the
    wrapper."""
    import torch
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops.similarity import (
        _cosine_fn, cosine_scratch_len, cosine_slices)

    (b, d), n, dev = brands.shape, posts.shape[0], brands.device
    s = cosine_slices(b, n, d, _build.sm_count(dev))
    if s == 1:
        brands = brands / torch.linalg.norm(brands, dim=1, keepdim=True)
    out = torch.empty((b, n), device=dev)
    scratch = torch.empty(max(1, cosine_scratch_len(b, n, s)), device=dev)
    args = (brands.data_ptr(), posts.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, n, d, s,
            torch.cuda.current_stream(dev).cuda_stream)
    fn = _cosine_fn()
    if fn(*args):
        fail("the cosine_scores C entry failed")
    return cuda_ms(lambda: fn(*args), 50)


def _gru_inputs(g, dev, t, b, h):
    import torch
    bound = 1.0 / math.sqrt(h)
    u = lambda *s: (torch.rand(*s, generator=g, device=dev) * 2 - 1) * bound  # noqa: E731
    w_hh = u(2, 3 * h, h)
    b_hh = u(2, 3 * h)
    xw = torch.randn(t, 2, b, 3 * h, generator=g, device=dev) * 0.5
    return xw, w_hh, b_hh


def check_gru_train(dev):
    """K1 at the training shape (T=64, B=8, H=1024): the forward kernel
    against its plain version, timed beside cuDNN's GRU forward; the
    backward kernel against its plain version and cuDNN's GRU backward."""
    import torch
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_bwd_ref, gru_scan_cuda, gru_scan_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    xw, w_hh, b_hh = _gru_inputs(g, dev, T, B_TRAIN, H)
    with torch.no_grad():
        out = gru_scan_cuda(xw, w_hh, b_hh)
        fwd_err = (out - gru_scan_ref(xw, w_hh, b_hh)).abs().max().item()
        log("gru_scan at B=%d: max |kernel - plain| = %.3g (tolerance %g)"
            % (B_TRAIN, fwd_err, K1_TOL))
        if not math.isfinite(fwd_err) or fwd_err > K1_TOL:
            fail("gru_scan kernel disagrees with its plain version at B=%d"
                 % B_TRAIN)
        h_prev = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
        dout = torch.randn(out.shape, generator=g, device=dev)
        dxw_k, danp_k = gru_scan_bwd_cuda(xw, h_prev, dout, w_hh, b_hh)
        dxw_p, danp_p = gru_scan_bwd_ref(xw, h_prev, dout, w_hh, b_hh)
        again = gru_scan_bwd_cuda(xw, h_prev, dout, w_hh, b_hh)
        torch.cuda.synchronize()
        err = max((dxw_k - dxw_p).abs().max().item(),
                  (danp_k - danp_p).abs().max().item())
        scale = max(dxw_p.abs().max().item(), danp_p.abs().max().item())
        same = torch.equal(dxw_k, again[0]) and torch.equal(danp_k, again[1])
        log("gru_scan_bwd: max |kernel - plain| = %.3g over dxw and danp "
            "(|plain| max %.3g; tolerance %g); two calls bit-identical: %s"
            % (err, scale, K1B_TOL, same))
        if not math.isfinite(err) or err > K1B_TOL:
            fail("gru_scan backward kernel disagrees with its plain version")
        if not same:
            fail("two calls of the gru_scan backward kernel differ")
        ms = cuda_ms(lambda: gru_scan_bwd_cuda(xw, h_prev, dout, w_hh, b_hh),
                     20)
        # rows a gate block and programmatic dependent launch, forced
        cells = []
        for rows in GRU_ROWS:
            for pdl in (True, False):
                got = gru_bwd_forced(xw, h_prev, dout, w_hh, b_hh, rows, pdl)
                e = max((got[0] - dxw_p).abs().max().item(),
                        (got[1] - danp_p).abs().max().item())
                if not e <= K1B_TOL:
                    fail("gru_scan_bwd rows=%d pdl=%d: max err %.3g > %g"
                         % (rows, pdl, e, K1B_TOL))
                cells.append("R=%d %s %.3f ms" % (
                    rows, "PDL" if pdl else "plain launches",
                    cuda_ms(lambda: gru_bwd_forced(
                        xw, h_prev, dout, w_hh, b_hh, rows, pdl), 20)))
        log("gru_scan_bwd at B=%d by rows a gate block (max err within %g): "
            "%s" % (B_TRAIN, K1B_TOL, ", ".join(cells)))
        # the carry kernel's slices of 3H, forced (0: the launcher's pick)
        cells = []
        for parts in (0, 1, 2, 3, 4, 5, 6, 8, 12):
            got = gru_bwd_forced(xw, h_prev, dout, w_hh, b_hh, 0, True, parts)
            e = max((got[0] - dxw_p).abs().max().item(),
                    (got[1] - danp_p).abs().max().item())
            if not e <= K1B_TOL:
                fail("gru_scan_bwd parts=%d: max err %.3g > %g"
                     % (parts, e, K1B_TOL))
            cells.append("P=%s %.3f ms" % (
                parts or "picked", cuda_ms(lambda: gru_bwd_forced(
                    xw, h_prev, dout, w_hh, b_hh, 0, True, parts), 20)))
        log("gru_scan_bwd at B=%d by slices of 3H a carry block: %s"
            % (B_TRAIN, ", ".join(cells)))
        plain_ms = cuda_ms(lambda: gru_scan_bwd_ref(xw, h_prev, dout, w_hh,
                                                    b_hh), 3)
        fwd = {"ms": cuda_ms(lambda: gru_scan_cuda(xw, w_hh, b_hh), 20),
               "plain_ms": cuda_ms(lambda: gru_scan_ref(xw, w_hh, b_hh), 3),
               **roofline(4 * (xw.numel() + w_hh.numel() + b_hh.numel()
                               + out.numel()),
                          2 * (T - 1) * 2 * B_TRAIN * 3 * H * H, F32_FLOPS)}
    # yardstick: the backward of cuDNN's bidirectional GRU with the same
    # recurrent weights; it also forms the input projection's and the
    # weights' grads, which the kernel leaves to one einsum outside it
    rnn = torch.nn.GRU(D_IN, H, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in ((0, "l0"), (1, "l0_reverse")):
            getattr(rnn, "weight_hh_" + sfx).copy_(w_hh[d])
            getattr(rnn, "bias_hh_" + sfx).copy_(b_hh[d])
    x = torch.randn(T, B_TRAIN, D_IN, generator=g, device=dev,
                    requires_grad=True)
    with torch.no_grad():      # cuDNN's forward, input projection included
        fwd["library_ms"] = cuda_ms(lambda: rnn(x), 20)
    y = rnn(x)[0]
    dy = torch.randn(y.shape, generator=g, device=dev)
    params = [x] + list(rnn.parameters())
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        y, params, dy, retain_graph=True), 20)
    log("gru_scan_bwd: kernel %.3f ms, plain %.3f ms, cuDNN GRU backward "
        "%.3f ms" % (ms, plain_ms, library_ms))
    log("gru_scan at B=%d: kernel %.3f ms, plain %.3f ms, cuDNN GRU forward "
        "%.3f ms, bound %.4f ms (%s)" % (B_TRAIN, fwd["ms"], fwd["plain_ms"],
                                         fwd["library_ms"], fwd["bound_ms"],
                                         fwd["bound_by"]))
    # gate recompute and carry contraction, each B x 3H x H a direction and
    # step; h_{-1} = 0 makes the t=0 recompute a zero product, and the carry
    # past t=0 is not formed
    ops = 2 * 2 * (T - 1) * 2 * B_TRAIN * 3 * H * H
    nbytes = 4 * (xw.numel() + h_prev.numel() + dout.numel() + w_hh.numel()
                  + b_hh.numel() + dxw_k.numel() + danp_k.numel())
    return {"name": "gru_scan_bwd", "route": "cuda",
            "source": "fancyrec_tpu_torch/csrc/gru_scan.cu",
            "replaces": "fancyrec_tpu/ops/gru_scan.py:211",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **roofline(nbytes, ops, F32_FLOPS),
            "library_ms": library_ms}, fwd


def k1_records(dev, b, dtype, backward, seed, t=T, h=H, d_in=D_IN,
               sfx=None):
    """K1 at T=64, H=1024 (or t, h; d_in cuDNN's input width) and batch b in
    `dtype` against its plain version
    (float32 at K1_TOL / K1B_TOL; bfloat16 within check_edges' bf16
    tolerances, since h is stored in bfloat16 and a float32 sum-order
    difference that crosses a rounding boundary moves h by one bf16 ulp),
    timed beside the plain version and cuDNN's bidirectional GRU in the
    same dtype (its forward includes the input projection; its backward
    also forms the input and weight grads). Bounds: each input read once
    and each output written once (xw, h and the grads in `dtype`, the
    recurrent weights and biases float32 as the wrapper takes them), and
    the recurrent products at the dtype's peak (bfloat16: the tensor cores'
    989 TFLOP/s). -> [forward record] or [forward, backward]."""
    import torch
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_bwd_ref, gru_scan_cuda, gru_scan_ref)

    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    peak = BF16_FLOPS if bf16 else F32_FLOPS
    tol, tol_b = (K1_BF16_TOL, K1B_BF16_TOL) if bf16 else (K1_TOL, K1B_TOL)
    tag = "%s B=%d" % ("bf16" if bf16 else "f32", b)
    if (t, h) != (T, H):
        tag += " T=%d H=%d" % (t, h)
    sfx = sfx or ("_bf16" if bf16 else "") + "_b%d" % b
    g = torch.Generator(device=dev).manual_seed(seed)
    xw, w_hh, b_hh = _gru_inputs(g, dev, t, b, h)
    xw = xw.to(dtype)
    rnn = torch.nn.GRU(d_in, h, bidirectional=True).to(dev, dtype)
    with torch.no_grad():
        for d, sfx_ in ((0, "l0"), (1, "l0_reverse")):
            getattr(rnn, "weight_hh_" + sfx_).copy_(w_hh[d])
            getattr(rnn, "bias_hh_" + sfx_).copy_(b_hh[d])
    x = torch.randn(t, b, d_in, generator=g, device=dev).to(dtype)
    with torch.no_grad():
        out = gru_scan_cuda(xw, w_hh, b_hh)
        err = (out.float() - gru_scan_ref(xw, w_hh, b_hh).float()
               ).abs().max().item()
        log("gru_scan %s: max |kernel - plain| = %.3g (tolerance %g)"
            % (tag, err, tol))
        if not err <= tol:
            fail("gru_scan %s disagrees with its plain version" % tag)
        fwd = {"name": "gru_scan" + sfx, "counter": "gru_scan",
               "route": "cuda", "source": "fancyrec_tpu_torch/csrc/gru_scan.cu",
               "replaces": "fancyrec_tpu/ops/gru_scan.py:157",
               "max_abs_err": err,
               "ms": cuda_ms(lambda: gru_scan_cuda(xw, w_hh, b_hh), 20),
               "plain_ms": cuda_ms(lambda: gru_scan_ref(xw, w_hh, b_hh), 2),
               "library_ms": cuda_ms(lambda: rnn(x), 20),
               **roofline(size * (xw.numel() + out.numel())
                          + 4 * (w_hh.numel() + b_hh.numel()),
                          2 * (t - 1) * 2 * b * 3 * h * h, peak)}
    log("gru_scan %s: kernel %.3f ms, plain %.3f ms, cuDNN GRU forward %.3f "
        "ms, bound %.4f ms (%s)" % (tag, fwd["ms"], fwd["plain_ms"],
                                    fwd["library_ms"], fwd["bound_ms"],
                                    fwd["bound_by"]))
    if not backward:
        return [fwd]
    with torch.no_grad():
        h_prev = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
        dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
        got = gru_scan_bwd_cuda(xw, h_prev, dout, w_hh, b_hh)
        want = gru_scan_bwd_ref(xw, h_prev, dout, w_hh, b_hh)
        err_b = max((p.float() - q.float()).abs().max().item()
                    for p, q in zip(got, want))
        scale = max(q.float().abs().max().item() for q in want)
        log("gru_scan_bwd %s: max |kernel - plain| = %.3g over dxw and danp "
            "(|plain| max %.3g; tolerance %g)" % (tag, err_b, scale, tol_b))
        if not err_b <= tol_b:
            fail("gru_scan_bwd %s disagrees with its plain version" % tag)
        ms = statistics.median(cuda_ms(lambda: gru_scan_bwd_cuda(
            xw, h_prev, dout, w_hh, b_hh), 10) for _ in range(3))
        plain_ms = cuda_ms(lambda: gru_scan_bwd_ref(xw, h_prev, dout, w_hh,
                                                    b_hh), 1)
        nbytes = (size * (xw.numel() + h_prev.numel() + dout.numel()
                          + got[0].numel() + got[1].numel())
                  + 4 * (w_hh.numel() + b_hh.numel()))
        del got, want
    xg = x.detach().requires_grad_(True)
    y = rnn(xg)[0]
    dy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
    params = [xg] + list(rnn.parameters())
    library_ms = statistics.median(cuda_ms(lambda: torch.autograd.grad(
        y, params, dy, retain_graph=True), 10) for _ in range(3))
    bwd = {"name": "gru_scan_bwd" + sfx, "counter": "gru_scan_bwd",
           "route": "cuda", "source": "fancyrec_tpu_torch/csrc/gru_scan.cu",
           "replaces": "fancyrec_tpu/ops/gru_scan.py:211",
           "max_abs_err": err_b, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           **roofline(nbytes, 2 * 2 * (t - 1) * 2 * b * 3 * h * h, peak)}
    log("gru_scan_bwd %s: kernel %.3f ms (median of 3 windows of 10), plain "
        "%.3f ms, cuDNN GRU backward %.3f ms, bound %.4f ms (%s)"
        % (tag, ms, plain_ms, library_ms, bwd["bound_ms"], bwd["bound_by"]))
    return [fwd, bwd]


def check_k1_fast(dev):
    """K1 at the throughput mode's shapes. Its training path runs K1 in
    float32 at B=64 (the microbatch): the JAX package's bi-GRU takes the
    dtype of its input, and both towers hand it float32 under --dtype
    bfloat16. The bfloat16 kernels, which no main path reaches, are
    checked and timed at the recipe width too: forward and backward at
    B=64, forward at B=128. -> (records of the training path's K1, records
    of the bf16 K1)."""
    import torch
    on_path = k1_records(dev, B_FAST, torch.float32, True, SEED + 8)
    bf16 = (k1_records(dev, B_FAST, torch.bfloat16, True, SEED + 9)
            + k1_records(dev, B_ENC, torch.bfloat16, False, SEED + 10))
    for r in on_path:
        r["path"] = "fast training"
    for r in bf16:
        r["path"] = "none: the fast path runs K1 in float32"
    torch.cuda.empty_cache()
    return on_path, bf16


GRU_ROWS = (8, 16, 32)      # the K1 kernels' batch rows a block


def gru_fwd_forced(xw, w_hh, b_hh, rows, pdl=True):
    """The forward kernel with its rows a block forced (and programmatic
    dependent launch on or off), through its C entry point; not counted as
    a launch of the wrapper."""
    import ctypes
    import torch
    from fancyrec_tpu_torch.ops import _build

    fn = _build.load("gru_scan").gru_scan_fwd_rows
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    t, _, b, g3 = xw.shape
    w = w_hh.to(xw.dtype).contiguous()
    bias = b_hh.float().contiguous()
    out = torch.empty((t, 2, b, g3 // 3), dtype=xw.dtype, device=xw.device)
    err = fn(xw.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
             t, b, g3 // 3, int(xw.dtype == torch.bfloat16), rows, int(pdl),
             torch.cuda.current_stream(xw.device).cuda_stream)
    if err:
        raise RuntimeError("gru_scan_fwd_rows(rows=%d, pdl=%d) failed: CUDA "
                           "error %d" % (rows, pdl, err))
    return out


def gru_bwd_forced(xw, h_prev, dout, w_hh, b_hh, rows, pdl=True, parts=0):
    """The backward kernels with the gate kernel's rows a block forced (and
    programmatic dependent launch on or off, and the carry kernel's slices
    of 3H where `parts` > 0), through their C entry point, with the
    wrapper's scratch; not counted as a launch of the wrapper."""
    import ctypes
    import torch
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops.gru_scan import bwd_scratch

    fn = _build.load("gru_scan").gru_scan_bwd_cfg
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    t, _, b, g3 = xw.shape
    dt, dev = xw.dtype, xw.device
    ins = [xw.contiguous(), h_prev.to(dt).contiguous(),
           dout.to(dt).contiguous(), w_hh.to(dt).contiguous(),
           b_hh.float().contiguous()]
    dxw = torch.empty_like(ins[0])
    danp = torch.empty((t, 2, b, g3 // 3), dtype=dt, device=dev)
    carry, da = bwd_scratch(b, g3 // 3, dev)
    err = fn(*(x.data_ptr() for x in ins + [dxw, danp, carry, da]),
             t, b, g3 // 3, int(dt == torch.bfloat16), rows, parts,
             int(pdl), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("gru_scan_bwd_cfg(rows=%d, parts=%d, pdl=%d) "
                           "failed: CUDA error %d" % (rows, parts, pdl, err))
    return dxw, danp


def sweep_gru_rows(dev):
    """The forward kernel at each number of rows a block at both main-path
    batches (T=64, H=1024; B=8 and B=128), with programmatic dependent
    launch of the steps and with plain launches: time and agreement with
    the plain version, beside the launcher's own pick."""
    import torch
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda, gru_scan_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    for b in (B_TRAIN, B_ENC):
        xw, w_hh, b_hh = _gru_inputs(g, dev, T, b, H)
        with torch.no_grad():
            want = gru_scan_ref(xw, w_hh, b_hh)
            cells = []
            for rows in GRU_ROWS:
                ms = []
                for pdl in (True, False):
                    err = (gru_fwd_forced(xw, w_hh, b_hh, rows, pdl)
                           - want).abs().max().item()
                    if not err <= K1_TOL:
                        fail("gru_scan rows=%d pdl=%d at B=%d: max err %.3g "
                             "> %g" % (rows, pdl, b, err, K1_TOL))
                    ms.append(cuda_ms(lambda: gru_fwd_forced(
                        xw, w_hh, b_hh, rows, pdl), 20))
                cells.append("R=%d %.3f ms (plain launches %.3f)"
                             % (rows, ms[0], ms[1]))
            picked = uncounted(lambda: cuda_ms(
                lambda: gru_scan_cuda(xw, w_hh, b_hh), 20))
        log("gru_scan at B=%d by rows a block (max err within %g): %s; as "
            "picked %.3f ms" % (b, K1_TOL, ", ".join(cells), picked))


def check_aspect_dropout(dev, b=B_TRAIN, sass=None, model_axis=1,
                         a_total=N_ASPECTS, c=DIM, sfx=None):
    """K2 at a training shape (B=8, bin/instance.sh's microbatch, or B=64,
    the throughput mode's; A=2000, C=1024, keep 0.5): the keep bits the
    forward writes equal the packed plain Philox mask bit for bit; the
    forward (with and without bits) and the backward from those bits agree
    with the plain versions, and two calls give the same bits. Times: the
    wrapper calls, the C entries alone on buffers made once, and the
    device time of their kernels. Bounds: the forward's from the SASS of
    its per-block step (`k2_sass_ops`, passed in where it was counted
    already), the backward's from its bytes. model_axis M > 1: the same
    on the last of M aspect shards (A/M aspects of the table's 2000, whose
    counters are the table's largest), the bounds at the shard's A. a_total
    and c: another table (the dry run's 32 x 64); sfx: the records' name
    suffix. -> (the two records, sass)."""
    import torch
    from fancyrec_tpu_torch.ops import brand_dropout as bd
    from fancyrec_tpu_torch.ops import _build

    a = a_total // model_axis
    a_off = a_total - a
    shard = dict(a_total=a_total, a_off=a_off)
    tag = ("B=%d" % b if model_axis == 1 else "B=%d on aspects [%d, %d) of %d"
           % (b, a_off, a_total, a_total))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    w = torch.randn(b, a, generator=g, device=dev)
    asp = torch.randn(a, c, generator=g, device=dev)
    gr = torch.randn(b, c, generator=g, device=dev)
    thr, _ = bd.keep_threshold(a_total, KEEP)
    plan = bd.aspect_dropout_plan(b, a, c, _build.sm_count(dev))
    log("aspect_dropout plan %s%s: the forward's grid (C / 128, splits, "
        "B / 8) of 256 threads, then the split sum (PDL); the backward's %s"
        % (plan, "" if model_axis == 1 else " (aspects [%d, %d) of %d)"
           % (a_off, a_total, a_total), "persistent blocks of 256 threads "
           "taking A's groups of 4 aspects in turn" if plan.bwd_blocks
           else "block a group of 4 aspects"))
    with torch.no_grad():
        # the plain mask a span of aspects at a time, packed as it comes
        chunks = [bd.dropout_mask(K2_SEED, thr, b, a_total, c, a_off + lo,
                                  a_off + min(lo + 250, a), dev)
                  for lo in range(0, a, 250)]
        kept = sum(int(m.sum()) for m in chunks)
        want_bits = torch.cat([bd.pack_keep_bits(m) for m in chunks], dim=1)
        del chunks
        out_k, bits_k = bd.aspect_dropout_fwd_cuda(w, asp, K2_SEED, KEEP,
                                                   with_bits=True, **shard)
        out_k2, bits_k2 = bd.aspect_dropout_fwd_cuda(w, asp, K2_SEED, KEEP,
                                                     with_bits=True, **shard)
        out_nb = bd.aspect_dropout_fwd_cuda(w, asp, K2_SEED, KEEP, **shard)
        torch.cuda.synchronize()
        if not torch.equal(bits_k, want_bits):
            diff = (bits_k != want_bits)
            fail("aspect dropout: the forward's keep bits differ from the "
                 "packed plain mask in %d of %d words"
                 % (int(diff.sum()), diff.numel()))
        if not (torch.equal(out_k, out_k2) and torch.equal(bits_k, bits_k2)
                and torch.equal(out_k, out_nb)):
            fail("aspect dropout: two forward calls (with and without bits) "
                 "differ")
        log("aspect_dropout at %s: the forward's keep bits equal the "
            "packed plain mask bit for bit (%d elements, %d words, kept share "
            "%.5f); two calls and the call without bits give the same output "
            "bits" % (tag, b * a * c, want_bits.numel(), kept / (b * a * c)))
        out_p = bd.aspect_dropout_fwd_ref(w, asp, K2_SEED, KEEP, **shard)
        dw_k, dasp_k = bd.aspect_dropout_bwd_cuda(w, asp, gr, bits_k, KEEP,
                                                  a_total)
        dw_k2, dasp_k2 = bd.aspect_dropout_bwd_cuda(w, asp, gr, bits_k, KEEP,
                                                    a_total)
        dw_p, dasp_p = bd.aspect_dropout_bwd_ref(w, asp, gr, K2_SEED, KEEP,
                                                 **shard)
        torch.cuda.synchronize()
        err_f = (out_k - out_p).abs().max().item()
        err_b = max((dw_k - dw_p).abs().max().item(),
                    (dasp_k - dasp_p).abs().max().item())
        log("aspect_dropout at %s: max |kernel - plain| forward %.3g, "
            "backward from the bits against the plain backward from the seed "
            "%.3g (tolerance %g)" % (tag, err_f, err_b, K2_TOL))
        if not (err_f <= K2_TOL and err_b <= K2_TOL):
            fail("aspect dropout kernels disagree with their plain versions")
        if not (torch.equal(dw_k, dw_k2) and torch.equal(dasp_k, dasp_k2)):
            fail("aspect dropout: two backward calls differ")
        # a wrapper call is host-bound here: the median of 5 windows, as for
        # K3 and K4
        fwd_ms = statistics.median(cuda_ms(lambda: bd.aspect_dropout_fwd_cuda(
            w, asp, K2_SEED, KEEP, with_bits=True, **shard), 50)
            for _ in range(5))
        bwd_ms = statistics.median(cuda_ms(lambda: bd.aspect_dropout_bwd_cuda(
            w, asp, gr, bits_k, KEEP, a_total), 50) for _ in range(5))
        entry = k2_entries(w, asp, gr, K2_SEED, KEEP, **shard)
        entry_ms = {k: cuda_ms(fn, 50) for k, fn in entry.items()}
        dev_ms = {k: device_ms(fn, 20) for k, fn in entry.items()}
        reps = 3 if b <= B_TRAIN else 1         # the plain versions are slow
        fwd_plain = cuda_ms(lambda: bd.aspect_dropout_fwd_ref(
            w, asp, K2_SEED, KEEP, with_bits=True, **shard), reps)
        bwd_plain = cuda_ms(lambda: bd.aspect_dropout_bwd_bits_ref(
            w, asp, gr, bits_k, KEEP, a_total), reps)
    log("aspect_dropout at %s: wrapper call (median of 5) forward (with "
        "bits) %.4f ms, backward %.4f ms, forward + backward %.4f ms; C entry "
        "alone forward %.4f, backward %.4f, forward + backward %.4f ms; "
        "device time (profiler union a call) forward %.4f, backward %.4f, "
        "both %.4f ms; plain forward %.3f ms, plain backward from the bits "
        "%.3f ms"
        % (tag, fwd_ms, bwd_ms, fwd_ms + bwd_ms, entry_ms["fwd"],
           entry_ms["bwd"],
           entry_ms["both"], dev_ms["fwd"], dev_ms["bwd"], dev_ms["both"],
           fwd_plain, bwd_plain))
    # the forward's integer work: the SASS of its per-block step (one
    # Philox4x32-10 block, its 4 keep compares, the kept products and the
    # nibble), as compiled in the loop, by pipe: IMAD* on the FMA pipe, the
    # rest of the integer instructions on the ALU pipe, each 64 a clock an
    # SM (the CUDA C Programming Guide's throughput table for compute
    # capability 9.0), the float products at 128 a clock; the uniform
    # datapath apart. The pipes issue side by side: the busiest bounds the
    # time. An integer instruction counts as F32_FLOPS / INT32_OPS flops,
    # an FFMA as 2
    sass = sass or k2_sass_ops(dev)
    step = sass["step"]
    blocks = b * a * c // 4
    fwd_ops = max(blocks * max(step["alu"], step["fma"]) * F32_FLOPS
                  / INT32_OPS, blocks * 2 * step["float"], 2 * kept)
    bounds = [roofline(4 * (w.numel() + asp.numel() + out_k.numel()
                            + bits_k.numel()), fwd_ops, F32_FLOPS),
              roofline(4 * (w.numel() + asp.numel() + gr.numel()
                            + bits_k.numel() + dw_k.numel()
                            + dasp_k.numel()), 4 * kept, F32_FLOPS)]
    log("aspect_dropout at %s: bounds %.4f ms forward (%s), %.4f ms "
        "backward (%s); the wrapper calls at %.0f%% and %.0f%% of them, the C "
        "entries alone at %.0f%% and %.0f%%"
        % (tag, bounds[0]["bound_ms"], bounds[0]["bound_by"],
           bounds[1]["bound_ms"], bounds[1]["bound_by"],
           100 * bounds[0]["bound_ms"] / fwd_ms,
           100 * bounds[1]["bound_ms"] / bwd_ms,
           100 * bounds[0]["bound_ms"] / entry_ms["fwd"],
           100 * bounds[1]["bound_ms"] / entry_ms["bwd"]))
    common = {"route": "cuda",
              "source": "fancyrec_tpu_torch/csrc/aspect_dropout.cu",
              "library_ms": None,
              "path": "training" if b == B_TRAIN else "fast training"}
    if model_axis > 1:
        common.update(shape=[b, a, c], a_total=a_total, a_off=a_off)
    sfx = sfx or ("_tp%d_b%d" % (model_axis, b) if model_axis > 1
                  else "" if b == B_TRAIN else "_b%d" % b)
    # `ms` is the wrapper call, as for every kernel; beside it the C entry
    # alone on buffers made once and the device time of its kernels
    return [
        {"name": "aspect_dropout_fwd" + sfx, "counter": "aspect_dropout_fwd",
         "replaces": "fancyrec_tpu/ops/brand_pallas.py:130",
         "max_abs_err": err_f, "ms": fwd_ms, "plain_ms": fwd_plain,
         "entry_ms": entry_ms["fwd"], "device_ms": dev_ms["fwd"],
         **bounds[0], **common},
        {"name": "aspect_dropout_bwd" + sfx, "counter": "aspect_dropout_bwd",
         "replaces": "fancyrec_tpu/ops/brand_pallas.py:175",
         "max_abs_err": err_b, "ms": bwd_ms, "plain_ms": bwd_plain,
         "entry_ms": entry_ms["bwd"], "device_ms": dev_ms["bwd"],
         **bounds[1], **common},
    ], sass


def k2_entries(w, asp, g, seed, keep, a_total=None, a_off=0):
    """K2's C entries on buffers made once: {"fwd": the forward with bits,
    "bwd": the backward from those bits, "both": one then the other}, each
    a call without the wrappers' Python (checks, allocations, the stream
    lookup); w and asp may be aspects [a_off, a_off + A) of a_total. Not
    counted as launches of the wrappers."""
    import torch
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops import brand_dropout as bd

    (b, a), c, dev = w.shape, asp.shape[1], w.device
    plan = bd.aspect_dropout_plan(b, a, c, _build.sm_count(dev))
    out = torch.empty((b, c), device=dev)
    bits = torch.empty((b, a, -(-c // 32)), dtype=torch.int32, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    dw, dasp = torch.empty_like(w), torch.empty_like(asp)
    key = bd.key_words(seed, dev)
    fwd_args = bd.aspect_dropout_fwd_args(w, asp, out, bits, scratch, key,
                                          keep, plan, a_total, a_off)
    bwd_args = bd.aspect_dropout_bwd_args(w, asp, g, bits, dw, dasp, keep,
                                          plan, a_total)
    fwd_fn, bwd_fn = bd._fwd_fn(), bd._bwd_fn()
    if fwd_fn(*fwd_args) or bwd_fn(*bwd_args):
        fail("the aspect_dropout C entries failed")
    keep_alive = (out, bits, scratch, dw, dasp, key)

    def both():
        fwd_fn(*fwd_args)
        bwd_fn(*bwd_args)
    both.buffers = keep_alive
    return {"fwd": lambda: fwd_fn(*fwd_args), "bwd": lambda: bwd_fn(*bwd_args),
            "both": both}


# A probe of K2's forward: N calls of its per-block step (`fwd_block`) as
# its loop makes them, and N Philox blocks XOR-folded into one word, each
# for N = 8 and 9 (the difference is one block's instructions); and the
# Philox blocks of a training-shape call XOR-folded at full occupancy, timed
K2_PROBE_N = r"""
extern "C" __global__ void k2_step_%(n)d(const float4* av_in,
    const float* w_in, float* out, unsigned* nib_out, uint2 key,
    uint32_t thr, uint32_t stride) {
  const RoundKeys rk = round_keys(key);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float4 av = av_in[i];
  float wv[8], acc[8][4];
  for (int r = 0; r < 8; ++r) {
    wv[r] = w_in[8 * i + r];
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  }
  uint32_t nib = 0;
%(steps)s
  float s = 0.0f;
  for (int r = 0; r < 8; ++r)
    s += acc[r][0] + acc[r][1] + acc[r][2] + acc[r][3];
  out[i] = s;
  nib_out[i] = nib;
}
extern "C" __global__ void k2_philox_%(n)d(unsigned* out, uint2 key,
                                           uint32_t stride) {
  const RoundKeys rk = round_keys(key);
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < %(n)d; ++k) {
    const uint4 r = philox4x32_10(make_uint4(i + k * stride, 0u, 0u, 0u),
                                  rk);
    x ^= r.x ^ r.y ^ r.z ^ r.w;
  }
  out[i] = x;
}
"""
K2_PROBE_RUN = r"""
extern "C" __global__ void k2_philox_run(unsigned* out, uint2 key,
                                         int per_thread) {
  const RoundKeys rk = round_keys(key);
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t n = gridDim.x * blockDim.x;
  uint32_t x = 0;
#pragma unroll 8
  for (int k = 0; k < per_thread; ++k) {
    const uint4 r = philox4x32_10(make_uint4(i + k * n, 0u, 0u, 0u), rk);
    x ^= r.x ^ r.y ^ r.z ^ r.w;
  }
  out[i] = x;
}
extern "C" int k2_philox_probe(void* out, int grid, int per_thread,
                               unsigned k0, unsigned k1, void* stream) {
  k2_philox_run<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), make_uint2(k0, k1), per_thread);
  return static_cast<int>(cudaGetLastError());
}
"""


def _sass_pipe(op):
    """The issue path of a SASS opcode, as the bound counts it."""
    if op.startswith("U"):
        return "uniform"
    if op.startswith("IMAD"):
        return "fma"
    if op.split(".")[0] in ("FFMA", "FADD", "FMUL"):
        return "float"
    if op.split(".")[0] in ("LDG", "STG", "LDS", "STS", "LDC", "SHFL", "S2R",
                            "S2UR", "BRA", "EXIT", "BAR", "BSSY", "BSYNC",
                            "WARPSYNC", "RET", "CALL"):
        return "other"
    return "alu"


def k2_sass_ops(dev):
    """K2-fwd's integer work, read from the SASS of a probe built from the
    checkout's `aspect_dropout.cu` with the kernels' nvcc flags: {"step":
    one per-block step of the forward's loop, "philox": one Philox block
    XOR-folded}, each {pipe: instructions}, the difference of the probes
    with N + 1 and N calls. Also times the Philox blocks of a call at the
    training shape, XOR-folded at full occupancy, against the bound their
    count gives: a probe faster than its counted bound would mean the count
    is wrong."""
    import ctypes
    import re
    import torch
    from fancyrec_tpu_torch.ops import _build

    work = os.path.join(HERE, "build", "k2_probe")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "probe.cu")
    with open(src, "w") as f:
        f.write('#include "%s"\n' % os.path.join(_build.CSRC,
                                                   "aspect_dropout.cu")
                + "".join(K2_PROBE_N % {"n": n, "steps": "".join(
                    "  nib |= fwd_block<%d>(i + %d * stride, rk, thr, wv[%d], "
                    "av, acc[%d]);\n" % (4 * (k % 8), k, k % 8, k % 8)
                    for k in range(n))} for n in (8, 9))
                + K2_PROBE_RUN)
    lib_path = os.path.join(work, "libk2probe.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path,
                    src], check=True, capture_output=True, text=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
         "-sass", lib_path], check=True, capture_output=True,
        text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn and m and m.group(1) != "NOP":
            pipe = _sass_pipe(m.group(1))
            counts[fn][pipe] = counts[fn].get(pipe, 0) + 1
            if m.group(1).startswith("IMAD.WIDE"):     # of the FMA pipe's
                counts[fn]["wide"] = counts[fn].get("wide", 0) + 1
    want = ["k2_step_8", "k2_step_9", "k2_philox_8", "k2_philox_9"]
    if not set(want) <= set(counts):
        fail("the K2 probe's SASS lacks its kernels: %s" % sorted(counts))
    pipes = ("fma", "alu", "float", "uniform", "other", "wide")
    ops = {kind: {p: counts["k2_%s_9" % kind].get(p, 0)
                  - counts["k2_%s_8" % kind].get(p, 0) for p in pipes}
           for kind in ("step", "philox")}
    # the Philox blocks of one training-shape call, 16 a thread
    blocks = B_TRAIN * N_ASPECTS * DIM // 4
    per_thread = 16
    grid = blocks // (256 * per_thread)
    lib = ctypes.CDLL(lib_path)
    probe = lib.k2_philox_probe
    probe.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                      + [ctypes.c_uint] * 2 + [ctypes.c_void_p])
    probe.restype = ctypes.c_int
    out = torch.empty(grid * 256, dtype=torch.int32, device=dev)
    args = (out.data_ptr(), grid, per_thread, K2_SEED[0], K2_SEED[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if probe(*args):
        fail("the K2 Philox probe did not launch")
    probe_ms = cuda_ms(lambda: probe(*args), 50)
    ph = ops["philox"]
    n = grid * 256 * per_thread
    counted = n * max(ph["alu"], ph["fma"]) / INT32_OPS * 1e3
    # the same count with each IMAD.WIDE (a 64-bit product) taking two
    # issues of the FMA pipe
    counted_wide = n * max(ph["alu"], ph["fma"] + ph["wide"]) / INT32_OPS * 1e3
    for kind in ("step", "philox"):
        log("aspect_dropout SASS, one %s: %s (of the fma, IMAD.WIDE %d)" % (
            "per-block step of the forward's loop (Philox block, 4 compares, "
            "4 kept products, nibble)" if kind == "step"
            else "Philox block XOR-folded",
            ", ".join("%s %d" % (p, ops[kind][p]) for p in pipes[:-1]),
            ops[kind]["wide"]))
    log("aspect_dropout: Philox-only probe, %d blocks (%d a thread, %d "
        "blocks of 256), %.4f ms; its counted bound %.4f ms (the busier "
        "integer pipe): %s; with IMAD.WIDE at half rate the count gives "
        "%.4f ms" % (n, per_thread, grid, probe_ms, counted,
                     "the probe is slower than the count, as it must be"
                     if probe_ms >= counted else
                     "THE PROBE BEATS THE COUNT: the count is wrong",
                     counted_wide))
    return {**ops, "probe_ms": probe_ms, "probe_bound_ms": counted}


def check_edges(dev):
    """K1, K2 and K3 against their plain versions on the card at small
    shapes that the main paths do not reach: ragged tiles, bf16, exact
    ties, k above the valid rows, several brand tiles, odd D, odd aspect
    counts and column counts (K4's edges are in check_cosine)."""
    import torch
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_bwd_ref, gru_scan_cuda, gru_scan_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    # the forward: B across the row-group sizes 8, 16 and 32, H not a
    # multiple of 4 (the scalar path), of the 8 units a round or of the
    # 64-vector stage; each shape as the launcher picks and with each
    # number of rows a block forced, with and without programmatic
    # dependent launch.
    # bf16: the two differ where a float32 sum-order difference crosses a
    # bf16 rounding boundary, one bf16 ulp of h (2^-8 relative)
    for t, b, h, dt, tol in ((5, 3, 40, torch.float32, K1_TOL),
                             (3, 130, 1000, torch.float32, K1_TOL),
                             (3, 1, 64, torch.float32, K1_TOL),
                             (3, 9, 300, torch.float32, K1_TOL),
                             (3, 17, 128, torch.float32, K1_TOL),
                             (3, 33, 96, torch.float32, K1_TOL),
                             (4, 11, 37, torch.float32, K1_TOL),
                             (4, 7, 64, torch.bfloat16, 2e-2),
                             (3, 9, 64, torch.bfloat16, 2e-2),
                             (3, 20, 40, torch.bfloat16, 2e-2),
                             (3, 5, 37, torch.bfloat16, 2e-2)):
        xw = torch.randn(t, 2, b, 3 * h, generator=g, device=dev).to(dt)
        w = torch.randn(2, 3 * h, h, generator=g, device=dev) / math.sqrt(h)
        bias = torch.randn(2, 3 * h, generator=g, device=dev) * 0.1
        want = gru_scan_ref(xw, w, bias).float()
        runs = [("picked", gru_scan_cuda(xw, w, bias))] + [
            ("rows=%d pdl=%d" % (r, p), gru_fwd_forced(xw, w, bias, r, p))
            for r in GRU_ROWS for p in (True, False)]
        for how, got in runs:
            err = (got.float() - want).abs().max().item()
            if not err <= tol:
                fail("gru_scan T=%d B=%d H=%d %s %s: max err %.3g > %g"
                     % (t, b, h, dt, how, err, tol))
    # the backward: the forward's edge shapes and one step of a small H,
    # float32 at K1B_TOL and bf16 within a bf16 ulp of the larger grads
    # (the two round where a float32 sum-order difference crosses a bf16
    # boundary, and the carry passes it on); each as the launcher picks
    # and with each number of gate rows a block forced, with and without
    # programmatic dependent launch
    for t, b, h, dt, tol in ((5, 3, 40, torch.float32, K1B_TOL),
                             (3, 130, 1000, torch.float32, K1B_TOL),
                             (3, 1, 64, torch.float32, K1B_TOL),
                             (3, 9, 300, torch.float32, K1B_TOL),
                             (3, 17, 128, torch.float32, K1B_TOL),
                             (3, 33, 96, torch.float32, K1B_TOL),
                             (4, 11, 37, torch.float32, K1B_TOL),
                             (1, 2, 16, torch.float32, K1B_TOL),
                             (4, 7, 64, torch.bfloat16, 5e-2),
                             (3, 9, 64, torch.bfloat16, 5e-2),
                             (3, 20, 40, torch.bfloat16, 5e-2),
                             (3, 5, 37, torch.bfloat16, 5e-2)):
        xw, w, bias = _gru_inputs(g, dev, t, b, h)
        xw = xw.to(dt)
        out = gru_scan_cuda(xw, w, bias)
        h_prev = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
        dout = torch.randn(out.shape, generator=g, device=dev).to(dt)
        want = gru_scan_bwd_ref(xw, h_prev, dout, w, bias)
        runs = [("picked", gru_scan_bwd_cuda(xw, h_prev, dout, w, bias))] + [
            ("rows=%d pdl=%d" % (r, p),
             gru_bwd_forced(xw, h_prev, dout, w, bias, r, p))
            for r in GRU_ROWS for p in (True, False)]
        for how, got in runs:
            err = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(got, want))
            if not err <= tol:
                fail("gru_scan_bwd T=%d B=%d H=%d %s %s: max err %.3g > %g"
                     % (t, b, h, dt, how, err, tol))
    check_k2_edges(g, dev)
    torch.cuda.synchronize()
    check_topk_edges(dev)
    check_int8_routing(dev)
    log("edge shapes: every kernel agrees with its plain version")


def check_k2_edges(g, dev):
    """K2 against its plain versions at shapes the training path does not
    reach, inputs drawn from the generator g."""
    import torch
    from fancyrec_tpu_torch.ops.brand_dropout import (
        aspect_dropout_bwd_cuda, aspect_dropout_bwd_ref,
        aspect_dropout_fwd_cuda, aspect_dropout_fwd_ref)

    # aspect dropout: aspects not a multiple of the tile or of the
    # forward's split (301: 37 splits of 8 and one of 5), columns not a
    # multiple of 4 (the path that draws a block an element) and past one
    # 1024-column chunk, batch rows past one 8-row tile, keep = 1 against
    # the deterministic mean; the streamed backward (C <= 1024, B <= 8)
    # with several aspect groups a block and A not a multiple of 4 (2001);
    # the keep bits against the plain packed mask
    for b, a, c, keep in ((3, 37, 130, 0.7), (5, 50, 2050, 0.5),
                          (2, 16, 64, 1.0), (9, 33, 1027, 0.3),
                          (12, 301, 96, 0.5), (7, 2001, 96, 0.5)):
        w = torch.randn(b, a, generator=g, device=dev)
        asp = torch.randn(a, c, generator=g, device=dev)
        gr = torch.randn(b, c, generator=g, device=dev)
        seed = (b * 7919, c * 104729)
        out_k, bits_k = aspect_dropout_fwd_cuda(w, asp, seed, keep,
                                                with_bits=True)
        out_p, bits_p = aspect_dropout_fwd_ref(w, asp, seed, keep,
                                               with_bits=True)
        if not torch.equal(bits_k, bits_p):
            fail("aspect_dropout B=%d A=%d C=%d keep=%g: keep bits differ "
                 "from the plain ones in %d of %d words"
                 % (b, a, c, keep, int((bits_k != bits_p).sum()),
                    bits_p.numel()))
        pairs = [(out_k, out_p),
                 (aspect_dropout_fwd_cuda(w, asp, seed, keep), out_p)]
        pairs += list(zip(aspect_dropout_bwd_cuda(w, asp, gr, bits_k, keep),
                          aspect_dropout_bwd_ref(w, asp, gr, seed, keep)))
        if keep == 1.0:
            pairs.append((out_k, (w @ asp) / a))
        err = max((x - y).abs().max().item() for x, y in pairs)
        if not err <= K2_TOL:
            fail("aspect_dropout B=%d A=%d C=%d keep=%g: max err %.3g > %g"
                 % (b, a, c, keep, err, K2_TOL))


def check_topk_edges(dev):
    """K3 against its plain version at shapes the main path does not reach;
    two calls at each give the same bits."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import (
        quantize_rows_int8, topk_int8_cuda, topk_int8_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    # K3: D whose rows are not whole 16 bytes (4-byte copies: 132, 36),
    # whole 16 bytes short of a stage (48), exact ties, k above the valid
    # rows, three brand tiles with data past n_valid; rows too wide for the
    # brands in shared memory, which come through the ring (2048 and 4096
    # at k = 128 and k = 10, 4100 with 4-byte copies, two brand tiles, and
    # 33,024, too wide for the quantization kernel's seed thresholds); an
    # all-zero post row and an all-zero brand row, n_valid one short of a
    # tile and 0, k = 128 over fewer posts
    for b, n, d, k, n_valid, mod in (
            (3, 1000, 132, 10, None, None), (4, 300, 128, 8, 5, None),
            (5, 2000, 256, 12, None, "ties"), (130, 700, 1024, 128, 650, None),
            (51, 900, 2048, 128, None, None), (3, 1000, 36, 10, None, None),
            (7, 333, 48, 10, 300, None),
            (51, 3000, 4096, 128, None, None), (51, 3000, 4096, 10, 2900, None),
            (5, 700, 4100, 10, 650, None), (70, 600, 4096, 128, None, "zeros"),
            (3, 200, 33024, 128, None, None),
            (6, 1000, 256, 10, None, "zeros"), (4, 256, 64, 10, 255, None),
            (4, 256, 64, 10, 0, None), (3, 100, 128, 128, None, None),
            (2, 64, 16, 128, 40, None)):
        brands = torch.randn(b, d, generator=g, device=dev)
        rows = torch.randn(n, d, generator=g, device=dev)
        if mod == "ties":              # exact ties: copies of one row
            rows[500:520] = rows[40]
            rows[40] = rows[500:520] = brands[0] * 3
        elif mod == "zeros":           # inv 0, score 0; q 0, scale 0
            rows[7] = 0.0
            brands[1] = 0.0
        posts_q, posts_inv = quantize_rows_int8(rows)
        vk, ik = topk_int8_cuda(brands, posts_q, posts_inv, k, n_valid)
        vk2, ik2 = topk_int8_cuda(brands, posts_q, posts_inv, k, n_valid)
        vp, ip = topk_int8_ref(brands, posts_q, posts_inv, k, n_valid)
        if not torch.equal(ik, ip) or not torch.allclose(
                vk, vp, rtol=0, atol=K3_TOL, equal_nan=False):
            fail("topk_int8 B=%d N=%d D=%d k=%d n_valid=%s %s differs from "
                 "the plain version" % (b, n, d, k, n_valid, mod or ""))
        if not (torch.equal(vk, vk2) and torch.equal(ik, ik2)):
            fail("two topk_int8 calls at B=%d N=%d D=%d k=%d differ"
                 % (b, n, d, k))
    torch.cuda.synchronize()
    log("topk_int8 edge shapes: indices equal the plain version's, values "
        "within %g, two calls bit-identical" % K3_TOL)


def check_int8_routing(dev):
    """Int8 indexes 30 wide, which K3 does not take (its rows are read in
    4-byte words), and 4096 wide, which it takes with its brands through its
    ring, at k = 10 and k = 128. `PostIndex.query` must answer on the card by
    the route `fused_eligible` picks, launching K3 only where it picks it,
    and serve the posts the CPU serves."""
    import numpy as np
    from fancyrec_tpu_torch.io.bigfile import BigFileWriter
    from fancyrec_tpu_torch.ops.similarity import topk_int8_cuda
    from fancyrec_tpu_torch.serving.index import PostIndex, fused_eligible

    n, brands = 5000, 7
    rng = np.random.default_rng(SEED)
    for d, ks in ((30, (TOPK,)), (4096, (TOPK, 128))):
        work = os.path.join(HERE, "build", "chip_smoke_int8_d%d" % d)
        shutil.rmtree(work, ignore_errors=True)
        try:
            with BigFileWriter(work, ndims=d, delimiter="\t") as w:
                w.write_batch(["post%05d#enc#0" % i for i in range(n)],
                              rng.standard_normal((n, d), dtype=np.float32))
            np.save(os.path.join(work, "brands.npy"),
                    rng.integers(0, brands, n).astype(np.int32))
            np.save(os.path.join(work, "brand_embeddings.npy"),
                    rng.standard_normal((brands, d), dtype=np.float32))
            with open(os.path.join(work, "index_meta.json"), "w") as f:
                json.dump({"collection": "synthetic", "checkpoint": "",
                           "brand_num": brands, "dim": d, "n_posts": n}, f)
            card = PostIndex(work, quantize="int8", device=str(dev))
            host = PostIndex(work, quantize="int8", device="cpu")
            for k in ks:
                launches = topk_int8_cuda.launches
                vc, nc = card.query(list(range(brands)), k=k)
                vh, nh = host.query(list(range(brands)), k=k)
                fused = fused_eligible("int8", k, d)
                if topk_int8_cuda.launches - launches != int(fused):
                    fail("an int8 query at D=%d k=%d launched topk_int8 %d "
                         "times (fused_eligible: %s)"
                         % (d, k, topk_int8_cuda.launches - launches, fused))
                if nc != nh or not np.allclose(vc, vh, rtol=0, atol=K3_TOL):
                    fail("the int8 query at D=%d k=%d on the card differs "
                         "from the CPU's" % (d, k))
                log("int8 PostIndex.query at D=%d k=%d: %s on the card, the "
                    "CPU's posts for all %d brands"
                    % (d, k, "topk_int8" if fused else "retrieval_topk",
                       brands))
        finally:
            shutil.rmtree(work, ignore_errors=True)


def _wrappers():
    """{kernel name: its wrapper, whose `launches` counts its launches}."""
    from fancyrec_tpu_torch.ops import kernel_wrappers
    return kernel_wrappers()


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def uncounted(fn):
    """Run a measurement without adding its launches to the main path's."""
    saved = read_counts()
    try:
        return fn()
    finally:
        for name, w in _wrappers().items():
            w.launches = saved[name]


def ptxas_lines(report):
    """(kernel, line) for each register and spill line of a ptxas -v
    report, the kernel's name demangled where c++filt is found."""
    fn, pairs = "?", []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            pairs.append((fn, line.split(":", 1)[-1].strip()
                          if line.startswith("ptxas") else line.strip()))
    if shutil.which("c++filt"):
        names = sorted({fn for fn, _ in pairs})
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout.split("\n")
        if len(out) >= len(names):
            full = dict(zip(names, out))
            pairs = [(full[fn].replace("(anonymous namespace)::", "")
                      .split("(")[0].replace("void ", ""), line)
                     for fn, line in pairs]
    return pairs


def smi_name_power():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def roofline(nbytes, ops, peak):
    """The least time for the work: bytes over HBM rate vs ops over peak."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def recipe_config(info, bow_size, rnn_size):
    """bin/instance.sh's model at full width (f32, transformers text)."""
    from fancyrec_tpu_torch.config import Config
    return Config(
        trainCollection="insCartrain", video_feature=info["video_feature"],
        img_feature=info["img_feature"], brand_num=N_BRANDS,
        brand_aspect=2000, text_net="transformers", fusion_style="ph",
        concate="full", text_norm=True, visual_norm=True,
        visual_rnn_size=H, visual_kernel_num=512, visual_kernel_sizes="2-3-4-5",
        text_kernel_num=512, text_kernel_sizes="2-3-4",
        text_mapping_size=DIM, visual_mapping_size=DIM,
        common_embedding_size=DIM, visual_feat_dim=D_IN, max_frames=T,
        bow_vocab_size=bow_size, vocab_size=rnn_size).finalize()


def http(port, method, path, body=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    if resp.status != 200:
        fail("%s %s -> %d %s" % (method, path, resp.status, data))
    return data


def main_path(work, dev):
    """Phase 4: the index build, the appends and the int8 service."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.eval.evaluator import encode_batch, _MODEL_KEYS
    from fancyrec_tpu_torch.io.bigfile import BigFileReader
    from fancyrec_tpu_torch.io.vocab import load_vocab
    from fancyrec_tpu_torch.models import FancyRec, init_fancyrec
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda
    from fancyrec_tpu_torch.ops.similarity import topk_int8_ref
    from fancyrec_tpu_torch.serving import index as sindex
    from fancyrec_tpu_torch.serving.server import FancyRecService
    from fancyrec_tpu_torch.train.checkpoints import (
        load_checkpoint, save_checkpoint)
    from fancyrec_tpu_torch.utils.fixture import make_fixture

    t0 = time.time()
    root = os.path.join(work, "insCar")
    info = make_fixture(root, brand_num=N_BRANDS,
                        videos_per_brand=VIDEOS_PER_BRAND,
                        imgs_per_brand=IMGS_PER_BRAND, feat_dim=D_IN,
                        frames_per_video=FRAMES, seed=SEED,
                        collections={"train": "insCartrain"})
    vdir = os.path.join(root, "insCartrain", "TextData", "vocabulary")
    cfg = recipe_config(
        info, len(load_vocab(os.path.join(vdir, "bow", "word_vocab_5.pkl"))),
        len(load_vocab(os.path.join(vdir, "rnn", "word_vocab_5.pkl"))))
    model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(work, "model.pth.tar")
    save_checkpoint(ckpt, cfg, model, seed=SEED)
    del model
    log("fixture + %d-parameter checkpoint: %.1f s" % (n_params,
                                                        time.time() - t0))

    idx = os.path.join(work, "index")
    t0 = time.time()
    sindex.main(["build", idx, "--checkpoint", ckpt, "--rootpath", root,
                 "--collection", "insCartrain", "--batch_size", str(B_ENC),
                 "--device", str(dev)])
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_built = BigFileReader(idx, delimiter="\t").nr_of_rows
    n_batches = -(-n_built // B_ENC)
    log("index build: %d posts in %d batches, %.2f s, gru_scan launches %d"
        % (n_built, n_batches, build_s, gru_scan_cuda.launches))
    if gru_scan_cuda.launches != n_batches:
        fail("gru_scan launched %d times for %d encode batches"
             % (gru_scan_cuda.launches, n_batches))

    # one batch again: on the card (kernel) and on the CPU (plain version)
    loaded = load_checkpoint(ckpt)
    cfg_l, dataset = sindex.load_collection(loaded, root, "insCartrain")
    first = dataset.gather_batch(list(range(B_ENC)), pad_to=B_ENC)
    cpu_model = FancyRec(cfg_l)
    cpu_model.load_state_dict(loaded["state_dict"])
    cpu_model.eval()
    with torch.no_grad():
        want = encode_batch(cpu_model, {k: torch.from_numpy(first[k])
                                        for k in _MODEL_KEYS}).numpy()
    rows = BigFileReader(idx, delimiter="\t").read_rows(first["idxs"])
    if not np.isfinite(rows).all():
        fail("non-finite post embeddings in the index")
    enc_err = float(np.abs(rows - want).max())
    log("index rows vs the CPU encode of batch 0: max abs err %.3g "
        "(|ref| max %.3g)" % (enc_err, float(np.abs(want).max())))
    np.testing.assert_allclose(rows, want, **ENC_TOL)
    # how much of the build is the model on the card: one staged batch
    card_model = FancyRec(cfg_l)
    card_model.load_state_dict(loaded["state_dict"])
    card_model.to(dev).eval()
    staged = {k: torch.from_numpy(first[k]).to(dev) for k in _MODEL_KEYS}
    with torch.no_grad():
        fwd_ms = uncounted(
            lambda: cuda_ms(lambda: encode_batch(card_model, staged), 5))
    log("model forward of one %d-post batch on the card: %.2f ms (x %d "
        "batches = %.2f s of the %.2f s build)"
        % (B_ENC, fwd_ms, n_batches, fwd_ms * n_batches / 1e3, build_s))
    del card_model, staged
    b_embs = np.load(os.path.join(idx, "brand_embeddings.npy"))
    if b_embs.shape != (N_BRANDS, DIM) or not np.isfinite(b_embs).all():
        fail("bad brand embeddings %s" % (b_embs.shape,))

    t0 = time.time()
    rng = np.random.default_rng(SEED)
    step = 200_000
    for lo in range(n_built, N_POSTS, step):
        hi = min(lo + step, N_POSTS)
        sindex.append_to_index(
            idx, ["synthetic%07d#enc#0" % i for i in range(lo, hi)],
            rng.standard_normal((hi - lo, DIM), dtype=np.float32),
            rng.integers(0, N_BRANDS, hi - lo))
    log("append to %d posts: %.1f s" % (N_POSTS, time.time() - t0))

    t0 = time.time()
    service = FancyRecService(idx, quantize="int8", device=str(dev))
    server, thread = serve(service)
    log("int8 service up: %.1f s" % (time.time() - t0))
    try:
        body = {"brand_ids": list(range(N_BRANDS)), "k": TOPK}
        lat, replies = [], []
        for _ in range(N_REQUESTS):
            t0 = time.perf_counter()
            replies.append(http(server.server_port, "POST", "/v1/topk", body))
            lat.append((time.perf_counter() - t0) * 1e3)
        health = http(server.server_port, "GET", "/healthz")
        metrics = http(server.server_port, "GET", "/metrics")
    finally:
        stop(server, thread)
    if (health["n_posts"] != N_POSTS
            or metrics["routes"]["/v1/topk"]["count"] != N_REQUESTS):
        fail("unexpected /healthz or /metrics: %s %s" % (health, metrics))
    steady = np.array(lat[1:])           # the first request warms up
    log("/v1/topk, %d brands x k=%d over %d int8 posts: first %.2f ms; "
        "next %d: p50 %.2f ms, p90 %.2f ms, max %.2f ms"
        % (N_BRANDS, TOPK, N_POSTS, lat[0], len(steady),
           float(np.percentile(steady, 50)), float(np.percentile(steady, 90)),
           float(steady.max())))

    index = service.index

    def query_ms():
        t0 = time.perf_counter()
        for _ in range(N_REQUESTS - 1):
            index.query(list(range(N_BRANDS)), k=TOPK)
        return (time.perf_counter() - t0) * 1e3 / (N_REQUESTS - 1)
    log("PostIndex.query alone (no HTTP): %.2f ms a call" % uncounted(query_ms))
    q = torch.from_numpy(index.brand_embs).to(dev)
    with torch.no_grad():
        vp, ip = topk_int8_ref(q, index.posts(), index._posts_inv, TOPK,
                               n_valid=index.n_posts)
    vp, ip = vp.cpu().numpy(), ip.cpu().numpy()
    for reply in replies:
        for b, res in enumerate(reply["results"]):
            names = [p["cap_id"] for p in res["posts"]]
            if names != [index.cap_ids[i] for i in ip[b]]:
                fail("served posts for brand %d differ from the plain top-k"
                     % b)
            np.testing.assert_allclose([p["score"] for p in res["posts"]],
                                       vp[b], rtol=0, atol=K3_TOL)
    log("served posts equal the plain top-k for all %d brands" % N_BRANDS)
    return {"idx": idx, "ckpt": ckpt, "root": root, "first": first,
            "cpu_model": cpu_model, "rows": rows, "fwd_ms": fwd_ms,
            "n_built": n_built, "reply": replies[-1]}


def http_status(port, method, path, body=None):
    """(status, JSON reply) of one request, whatever the status."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def serve(service):
    """Start `service` on an ephemeral port -> (server, thread)."""
    from fancyrec_tpu_torch.serving.server import make_server
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop(server, thread):
    server.shutdown()
    thread.join(timeout=30)
    server.server_close()
    if thread.is_alive():
        fail("the HTTP server thread did not stop")


def cli_json(main_fn, argv):
    """Run a CLI's main in this process -> the JSON of its last line."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def quantize_query(q):
    """The IVF query's int8 form, written apart from serving/ivf.py: max-abs
    scaling by one division, round half to even, clip; 1/||q8|| from the
    exact sum of squares, floored at 1 as the JAX package does."""
    import torch
    amax = q.abs().max()
    scale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                        torch.zeros_like(amax))
    q8 = torch.clamp(torch.round(q * scale), -127, 127).to(torch.int32)
    inv_q = torch.rsqrt(torch.clamp((q8 * q8).sum().float(), min=1.0))
    return q8, inv_q


def plain_ivf_scan(ivf, q, nprobe, k):
    """The top-k of one query over the lists it probes, computed apart from
    the IVF query: the centroids ranked by a stable sort, the probed rows'
    int32 dots summed in int32, a stable sort of the scores -> (ids, vals)
    as numpy."""
    import torch
    qn = q / torch.clamp(q.norm(), min=1e-12)
    order = torch.sort(ivf.centroids @ qn, descending=True,
                       stable=True).indices[:nprobe]
    lists = torch.cat([order, torch.arange(
        ivf.nlist, ivf.nlist + ivf.overflow_lists, device=q.device)])
    q8, inv_q = quantize_query(q)
    scores = []
    for lo in range(0, lists.shape[0], 256):
        part = lists[lo:lo + 256]
        blk = ivf.packed[part].reshape(-1, ivf.packed.shape[-1]).to(
            torch.int32)
        acc = (blk * q8).sum(dim=1, dtype=torch.int32)
        scores.append(acc.float() * inv_q * ivf.inv_norms[part].reshape(-1))
    s = torch.cat(scores)
    ids = ivf.packed_idx[lists].reshape(-1)
    s = torch.where(ids < 0, torch.full_like(s, float("-inf")), s)
    vals, pos = torch.sort(s, descending=True, stable=True)
    return ids[pos[:k]].cpu().numpy(), vals[:k].cpu().numpy()


def differs_but_for_rounding(got, want, moved, tol):
    """Why two top-k answers {post: score} over the same posts differ, or
    None. A post in both must score the same within `tol`, unless its int8
    row was rounded apart between the two (`moved`). A post in one answer
    only must tie within `tol` at the other's cut, or have been pushed out
    by a moved post of the other answer."""
    for p in got.keys() & want.keys():
        if p not in moved and abs(got[p] - want[p]) > tol:
            return "post %d scores %r and %r" % (p, got[p], want[p])
    for a, b in ((got, want), (want, got)):
        cut = min(b.values())
        only = [p for p in a.keys() - b.keys() if p not in moved]
        above = [p for p in only if a[p] > cut + tol]
        if above:
            return "post %d (%r) beats the other's cut %r" % (
                above[0], a[above[0]], cut)
        below = sum(a[p] < cut - tol for p in only)
        if below > sum(p in moved for p in b.keys() - a.keys()):
            return "%d posts missing from the other answer" % below
    return None


def ivf_path(idx, dev):
    """Phase 4b: the IVF sidecar of phase 4's 1M-post index, built through
    the `ivf-build` CLI and served over HTTP (int8, default nprobe 8)."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.ops.similarity import topk_int8_ref
    from fancyrec_tpu_torch.serving import index as sindex
    from fancyrec_tpu_torch.serving.server import FancyRecService

    t0 = time.time()
    info = cli_json(sindex.main, ["ivf-build", idx, "--quantize", "int8",
                                  "--device", str(dev)])
    build_s = time.time() - t0
    side = os.path.join(idx, "ivf")
    side_bytes = sum(os.path.getsize(os.path.join(side, f))
                     for f in os.listdir(side))
    log("ivf-build over %d posts: %.2f s; nlist %d, cap %d, overflow lists "
        "%d, spill fraction %.6f, sidecar %d bytes; stages (s): %s"
        % (info["posts"], build_s, info["nlist"], info["cap"],
           info["overflow_lists"], info["spill_frac"], side_bytes,
           json.dumps({k: round(v, 3) for k, v in info["seconds"].items()})))
    if info["posts"] != N_POSTS:
        fail("ivf-build indexed %d posts, not %d" % (info["posts"], N_POSTS))

    t0 = time.time()
    service = FancyRecService(idx, quantize="int8", default_nprobe=8,
                              device=str(dev))
    ivf = service.index.ivf()
    log("int8 service with the sidecar up: %.1f s" % (time.time() - t0))
    nlist = ivf.nlist
    brand_embs = torch.from_numpy(service.index.brand_embs).to(dev)
    server, thread = serve(service)
    served = {}
    try:
        port = server.server_port
        for npb in (8, 64, nlist):
            lat, replies = [], []
            for i in range(N_REQUESTS):
                body = {"brand_ids": [i % N_BRANDS], "k": TOPK}
                if npb != 8:                   # 8: the service's default
                    body["nprobe"] = npb
                t0 = time.perf_counter()
                replies.append(http(port, "POST", "/v1/topk", body))
                lat.append((time.perf_counter() - t0) * 1e3)
            steady = np.array(lat[1:])
            log("/v1/topk, 1 brand x k=%d, IVF nprobe %d of %d lists: first "
                "%.2f ms; next %d: p50 %.3f ms, p90 %.3f ms"
                % (TOPK, npb, nlist, lat[0], len(steady),
                   float(np.percentile(steady, 50)),
                   float(np.percentile(steady, 90))))
            served[npb] = replies
        # each answer against a plain scan of the same probed lists
        for npb, replies in served.items():
            for i, reply in enumerate(replies):
                b = i % N_BRANDS
                ids, vals = plain_ivf_scan(ivf, brand_embs[b], npb, TOPK)
                res = reply["results"][0]["posts"]
                if ([p["cap_id"] for p in res]
                        != [service.index.cap_ids[j] for j in ids]):
                    fail("IVF answer for brand %d at nprobe %d differs from "
                         "the plain scan of its lists" % (b, npb))
                np.testing.assert_allclose([p["score"] for p in res], vals,
                                           rtol=0, atol=K3_TOL)
        log("every IVF answer (%d) equals the plain scan of its probed lists"
            % sum(len(r) for r in served.values()))

        # the sidecar holds every post once, each row the index's int8 row
        # but for rounding: the sidecar quantizes a row after its unit norm,
        # the index before it, which moves an element by one now and then
        index = service.index
        posts = index.posts()
        slots = ivf.packed_idx.reshape(-1)
        valid = slots >= 0
        post_of = slots[valid].long()
        if (post_of.numel() != N_POSTS or not torch.equal(
                torch.sort(post_of).values, torch.arange(N_POSTS, device=dev))):
            fail("the sidecar's %d filled slots are not a permutation of the "
                 "%d posts" % (post_of.numel(), N_POSTS))
        unpacked = torch.empty_like(posts)
        unpacked[post_of] = ivf.packed.reshape(-1, DIM)[valid]
        moved, worst = [], 0
        for lo in range(0, N_POSTS, 1 << 16):
            d = (unpacked[lo:lo + (1 << 16)].short()
                 - posts[lo:lo + (1 << 16)].short()).abs().amax(dim=1)
            worst = max(worst, int(d.max()))
            moved.append(torch.nonzero(d).reshape(-1) + lo)
        moved = set(torch.cat(moved).tolist())
        del unpacked, post_of, valid
        if worst > 1:
            fail("a sidecar row differs from the index's int8 row by %d in an "
                 "element (rounding moves it by 1 at most)" % worst)
        log("the sidecar holds each of the %d posts once; %d rows differ "
            "from the index's int8 rows, each element by 1 at most"
            % (N_POSTS, len(moved)))

        # at nprobe = nlist: the served exact path's answer (K3 over the
        # index), up to posts tied at the cut and rows rounded apart
        pos = {name: i for i, name in enumerate(index.cap_ids)}
        ev, en = uncounted(lambda: index.query(list(range(N_BRANDS)),
                                               k=TOPK))
        for i, reply in enumerate(served[nlist]):
            b = i % N_BRANDS
            got = {pos[p["cap_id"]]: p["score"]
                   for p in reply["results"][0]["posts"]}
            want = {pos[n]: float(v) for n, v in zip(en[b], ev[b])}
            why = differs_but_for_rounding(got, want, moved, K3_TOL)
            if why:
                fail("IVF at nprobe = nlist differs from the exact path for "
                     "brand %d: %s" % (b, why))
        log("IVF at nprobe = nlist (%d) equals the served exact path over "
            "all %d posts for every request" % (nlist, N_POSTS))

        def per_call_ms(fn, n=N_REQUESTS - 1):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) * 1e3 / n
        for npb in (8, 64, nlist):
            ms = per_call_ms(lambda: index.query([3], k=TOPK, nprobe=npb))
            _, ivf_names = index.query(list(range(N_BRANDS)), k=TOPK,
                                       nprobe=npb)
            _, exact_names = uncounted(lambda: index.query(
                list(range(N_BRANDS)), k=TOPK))
            overlap = np.mean([len(set(a) & set(b)) / TOPK
                               for a, b in zip(ivf_names, exact_names)])
            log("PostIndex.query, 1 brand, IVF nprobe %d: %.3f ms a call; "
                "recall@%d against the exact path over %d brands %.4f "
                "(i.i.d. rows: no neighbour structure, not a gate)"
                % (npb, ms, TOPK, N_BRANDS, overlap))
        exact = []                     # every counted K3 call is checked

        def exact_one():
            b = len(exact) % N_BRANDS
            exact.append((b, index.query([b], k=TOPK)))
        ms = per_call_ms(exact_one)
        for b, (vals, names) in exact:
            with torch.no_grad():
                rv, ri = topk_int8_ref(brand_embs[b:b + 1], posts,
                                       index._posts_inv, TOPK,
                                       n_valid=index.n_posts)
            if names[0] != [index.cap_ids[j] for j in ri[0].tolist()]:
                fail("the exact query at B=1 for brand %d differs from the "
                     "plain top-k" % b)
            np.testing.assert_allclose(vals[0], rv[0].cpu().numpy(), rtol=0,
                                       atol=K3_TOL)
        log("PostIndex.query, 1 brand, exact (K3 at B=1 over %d posts): "
            "%.3f ms a call; all %d calls equal the plain top-k"
            % (N_POSTS, ms, len(exact)))

        # an append makes the next IVF query refuse: the sidecar is stale
        rng = np.random.default_rng(SEED + 1)
        http(port, "POST", "/v1/add", {
            "cap_ids": ["late0000000#enc#0"],
            "embeddings": rng.standard_normal((1, DIM)).tolist(),
            "brands": [0]})
        status, err = http_status(port, "POST", "/v1/topk",
                                  {"brand_ids": [0], "k": TOPK})
        if status != 400 or "stale" not in err.get("error", ""):
            fail("after /v1/add the IVF query answered %d %s, not a stale "
                 "refusal" % (status, err))
        log("after /v1/add the IVF query refuses: %s" % err["error"][:60])
    finally:
        stop(server, thread)
    del service, ivf


def ivf_clustered(dev):
    """Phase 4c: IVF recall and single-query latency on a clustered corpus
    (bench.py's measurement): 1,024 topics, noise 0.5, 1M x 1024, made on
    the card from a seeded generator; `IVFIndex.build` with nlist 2048."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.ops.similarity import (
        quantize_rows_int8, topk_int8)
    from fancyrec_tpu_torch.serving.ivf import IVFIndex

    nc, nlist = 1024, 2048
    per = N_POSTS // nc
    g = torch.Generator(device=dev).manual_seed(SEED)
    centers = torch.randn(nc, DIM, generator=g, device=dev)
    posts = (centers[:, None, :] + 0.5 * torch.randn(
        nc, per, DIM, generator=g, device=dev)).reshape(-1, DIM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = IVFIndex.build(posts, nlist=nlist, iters=10, quantize="int8",
                         device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q8, qinv = quantize_rows_int8(posts)
    del posts
    torch.cuda.empty_cache()
    pick = torch.randint(0, nc, (8,), generator=g, device=dev)
    queries = centers[pick] + 0.5 * torch.randn(8, DIM, generator=g,
                                                device=dev)
    _, e_idx = uncounted(lambda: topk_int8(queries, q8, qinv, TOPK))
    e_idx = e_idx.cpu().numpy()
    log("clustered corpus: %d posts x %d, %d topics; IVFIndex.build nlist "
        "%d: %.2f s, cap %d, overflow lists %d, spill fraction %.6f"
        % (nc * per, DIM, nc, nlist, build_s, ivf.cap, ivf.overflow_lists,
           ivf.spill_frac))
    q1 = queries[:1]
    for npb in (8, 64, 256):
        _, i_idx = ivf.query(queries, k=TOPK, nprobe=npb)
        recall = float(np.mean([len(set(a) & set(b)) / TOPK
                                for a, b in zip(e_idx, i_idx)]))
        log("clustered recall@%d at nprobe %d: %.4f (8 queries near topic "
            "centres, against the exact int8 top-k)" % (TOPK, npb, recall))

    def host_ms(fn, n=50):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    with torch.no_grad():
        ivf_ms = host_ms(lambda: ivf.query(q1, k=TOPK, nprobe=64))
        ivf_dev = cuda_ms(lambda: ivf._query_one(q1[0], TOPK, 64, "cosine"),
                          20)
        exact_ms = uncounted(lambda: host_ms(
            lambda: topk_int8(q1, q8, qinv, TOPK)[1].cpu()))
        exact_dev = uncounted(lambda: cuda_ms(
            lambda: topk_int8(q1, q8, qinv, TOPK), 20))
    lists = 64 + ivf.overflow_lists
    bound = lists * ivf.cap * DIM / HBM_BPS * 1e3
    exact_bound = (nc * per) * DIM / HBM_BPS * 1e3
    log("single query, k=%d: IVF nprobe 64 (%d lists) %.3f ms (median of "
        "50, host clock), %.3f ms (CUDA events, no host copy), bytes bound "
        "%.4f ms; exact K3 at B=1 %.3f ms (host clock), %.3f ms (CUDA "
        "events), bytes bound %.4f ms"
        % (TOPK, lists, ivf_ms, ivf_dev, bound, exact_ms, exact_dev,
           exact_bound))
    del ivf, q8, qinv


def export_path(work, main, dev):
    """Phase 4d: phase 4's checkpoint exported through the export CLI on the
    card (and a second time on the CPU, loaded on the card), run without
    the model code, and served with --artifact."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.eval.evaluator import encode_batch, _MODEL_KEYS
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda
    from fancyrec_tpu_torch.serving import export as sexport
    from fancyrec_tpu_torch.serving.server import FancyRecService

    first, idx = main["first"], main["idx"]
    batch = {k: first[k] for k in _MODEL_KEYS}
    arts = {}
    for where in (str(dev), "cpu"):
        out = os.path.join(work, "artifact_" + where.split(":")[0])
        t0 = time.time()
        rec = cli_json(sexport.main, [out, "--checkpoint", main["ckpt"],
                                      "--batch", "0", "--device", where])
        size = sum(os.path.getsize(os.path.join(out, f))
                   for f in os.listdir(out))
        log("export on %s: %.1f s, %d bytes (weights.pt %d); seconds an "
            "entry: %s" % (where, time.time() - t0, size,
                           os.path.getsize(os.path.join(out, "weights.pt")),
                           json.dumps({k: round(v, 2) for k, v in
                                       rec["seconds"].items()})))
        arts[where] = out
    ckpt_bytes = os.path.getsize(main["ckpt"])
    log("checkpoint %d bytes" % ckpt_bytes)

    def live_cpu(sub):
        with torch.no_grad():
            return encode_batch(main["cpu_model"], {
                k: torch.from_numpy(v) for k, v in sub.items()}).numpy()
    b_embs = np.load(os.path.join(idx, "brand_embeddings.npy"))
    for where, out in arts.items():
        t0 = time.time()
        model = sexport.ExportedModel(out, device=str(dev))
        log("artifact exported on %s, loaded on the card: %.1f s; seconds "
            "an entry: %s" % (where, time.time() - t0, json.dumps(
                {k: round(v, 2) for k, v in model.load_seconds.items()})))
        before = gru_scan_cuda.launches
        got = model.encode_post(batch).cpu().numpy()
        if gru_scan_cuda.launches != before + 1:
            fail("encode_post of the artifact exported on %s launched "
                 "gru_scan %d times, not once"
                 % (where, gru_scan_cuda.launches - before))
        err = float(np.abs(got - main["rows"]).max())
        log("artifact (%s) encode_post, %d posts: max abs err %.3g against "
            "the index rows" % (where, B_ENC, err))
        np.testing.assert_allclose(got, main["rows"], **ENC_TOL)
        np.testing.assert_allclose(got, live_cpu(batch), **ENC_TOL)
        for b in (1, 2):
            sub = {k: v[:b] for k, v in batch.items()}
            before = gru_scan_cuda.launches
            got_b = model.encode_post(sub).cpu().numpy()
            if gru_scan_cuda.launches != before + 1:
                fail("encode_post at B=%d did not launch gru_scan once" % b)
            np.testing.assert_allclose(got_b, live_cpu(sub), **ENC_TOL)
        vis = model.embed_vis(batch)
        if vis.shape != (B_ENC, DIM) or not torch.isfinite(vis).all():
            fail("bad embed_vis %s" % (tuple(vis.shape),))
        np.testing.assert_allclose(model.embed_brand().cpu().numpy(), b_embs,
                                   **ENC_TOL)
        log("artifact (%s): encode_post at B=%d, 1 and 2 equals the CPU "
            "model, embed_brand the index's brand embeddings, gru_scan once "
            "a call" % (where, B_ENC))
    staged = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    art_ms = uncounted(lambda: cuda_ms(lambda: model.encode_post(staged), 5))
    log("artifact encode_post of one %d-post batch on the card: %.2f ms "
        "(the live model's forward: %.2f ms)"
        % (B_ENC, art_ms, main["fwd_ms"]))
    del model, staged

    service = FancyRecService(idx, artifact_dir=arts[str(dev)],
                              quantize="int8", device_resident=False,
                              device=str(dev))
    server, thread = serve(service)
    try:
        port = server.server_port
        health = http(port, "GET", "/healthz")
        if health["artifact_entries"] != sorted(
                ("encode_post", "embed_brand", "embed_vis", "embed_txt")):
            fail("healthz lists %s" % health["artifact_entries"])
        body = {k: v[:2].tolist() for k, v in batch.items()}
        lat, reply = [], None
        for _ in range(N_REQUESTS):
            t0 = time.perf_counter()
            reply = http(port, "POST", "/v1/encode", body)
            lat.append((time.perf_counter() - t0) * 1e3)
        embs = np.asarray(reply["embeddings"], np.float32)
        direct = service.model.encode_post(
            {k: v[:2] for k, v in batch.items()}).cpu().numpy()
        np.testing.assert_allclose(embs, direct, **ENC_TOL)
        rec = http(port, "POST", "/v1/recommend", dict(body, k=5))
        bn = b_embs / np.linalg.norm(b_embs, axis=1, keepdims=True)
        en = embs / np.linalg.norm(embs, axis=1, keepdims=True)
        want = np.argsort(-(en @ bn.T), axis=1)[:, :5]
        if [[r["brand"] for r in row] for row in rec["results"]] != \
                want.tolist():
            fail("/v1/recommend differs from the host cosine top-k")
        steady = np.array(lat[1:])
        log("--artifact service: /v1/encode, 2 posts: first %.1f ms; next "
            "%d: p50 %.1f ms, p90 %.1f ms; /v1/recommend equals the host "
            "cosine top-5" % (lat[0], len(steady),
                              float(np.percentile(steady, 50)),
                              float(np.percentile(steady, 90))))
    finally:
        stop(server, thread)
    del service


def instance_args(root, postfix, epochs):
    """bin/instance.sh's trainer flags, for `epochs` epochs on `root`."""
    return ["insCartrain", "insCarval", "insCartest", "--rootpath", root,
            "--brand_num", str(N_BRANDS), "--overwrite", "1",
            "--text_norm", "--visual_norm",
            "--video_feature", "resnet152_dim_%d" % D_IN,
            "--img_feature", "imgfeat_dim_%d" % D_IN,
            "--n_caption", "1", "--concate", "full", "--loss_fun", "cl",
            "--num_epochs", str(epochs), "--text_net", "transformers",
            "--batch_size", str(B_TRAIN), "--accumulation_step",
            str(ACCUM), "--metric", "auc", "--learning_rate", str(LR),
            "--common_embedding_size", str(DIM),
            "--text_mapping_size", str(DIM),
            "--visual_mapping_size", str(DIM), "--margin", "0.2",
            "--fusion_style", "ph", "--max_violation", "--postfix", postfix,
            "--measure", "cosine", "--cost_style", "mean",
            "--brand_aspect", str(N_ASPECTS)]


def train_step_card_vs_cpu(root, dev):
    """Phase 5a: one train_step at recipe width, A=2 microbatches of 8, the
    tower dropouts at 0 and the brand dropout at 0.5, from the same weights
    and seed words on the card and on the CPU: grads, updated params and
    BatchNorm statistics must agree. The counter-based brand mask makes
    both draws the same."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.config import build_train_parser, config_from_args
    from fancyrec_tpu_torch.losses import init_queue_state
    from fancyrec_tpu_torch.models import FancyRec, init_fancyrec
    from fancyrec_tpu_torch.train.state import TrainState, make_optimizer
    from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
    from fancyrec_tpu_torch.train.trainer import build_datasets

    cfg = config_from_args(build_train_parser().parse_args(
        instance_args(root, "step_check", 1)
        + ["--dropout", "0", "--bert_dropout", "0"]))
    train_set = build_datasets(cfg)["train"]
    cfg.finalize()
    rng = np.random.RandomState(SEED)
    pick = rng.permutation(len(train_set))[:2 * B_TRAIN]
    superbatch = stack_microbatches([
        train_set.gather_batch(pick[i * B_TRAIN:(i + 1) * B_TRAIN])
        for i in range(2)])
    out = []
    for where in (dev, torch.device("cpu")):
        model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(
            SEED)).to(where).seed_dropout(SEED)
        opt = make_optimizer(cfg, model.parameters())
        state = TrainState(queue=init_queue_state(cfg.queue_size, DIM,
                                                  device=where))
        sb = {k: torch.from_numpy(v).to(where) for k, v in superbatch.items()}
        t0 = time.time()
        state, metrics = train_step(model, opt, cfg, state, sb)
        loss = float(metrics["loss"])
        log("train step on %s: %.2f s, loss %.6f, grad norm %.6f"
            % (where, time.time() - t0, loss, float(metrics["grad_norm"])))
        out.append((
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: v.detach().cpu() for n, v in model.state_dict().items()},
            loss))
        del model, opt, state, sb
    (g_card, s_card, l_card), (g_cpu, s_cpu, l_cpu) = out
    if not (math.isfinite(l_card) and abs(l_card - l_cpu) <= STEP_TOL
            * max(1.0, abs(l_cpu))):
        fail("train step loss on the card %r vs the CPU %r" % (l_card, l_cpu))
    # per tensor, relative to its largest grad; a grad that is zero in exact
    # arithmetic (a BERT key bias: softmax ignores a per-query constant)
    # holds rounding noise, so the scale is floored at 1e-4 of the largest
    # grad of the model, float32's rounding over sums of ~1e4 terms
    top = max(g.abs().max().item() for g in g_cpu.values())
    rel = {n: (g_card[n] - g_cpu[n]).abs().max().item()
           / max(g_cpu[n].abs().max().item(), 1e-4 * top) for n in g_cpu}
    worst = sorted(rel, key=rel.get, reverse=True)[:3]
    g_err = rel[worst[0]]
    s_err = max((s_card[n] - s_cpu[n]).abs().max().item() for n in s_cpu)
    flips = sum(int(((s_card[n] - s_cpu[n]).abs() > LR / 2).sum())
                for n in s_cpu)
    log("train step card vs CPU: loss %.3g apart; grads max |diff| / "
        "max |grad| per tensor %.3g (tolerance %g; largest grad %.3g; worst "
        "%s); "
        "params and BN statistics max |diff| %.3g (tolerance %g), %d of %d "
        "values moved apart by more than lr/2"
        % (abs(l_card - l_cpu), g_err, STEP_TOL, top,
           ", ".join("%s %.3g" % (n, rel[n]) for n in worst), s_err,
           2 * LR * 1.001, flips, sum(v.numel() for v in s_cpu.values())))
    if not (g_err <= STEP_TOL and s_err <= 2 * LR * 1.001):
        fail("the card's train step disagrees with the CPU's")
    return {"loss_diff": abs(l_card - l_cpu), "grad_rel_err": g_err,
            "param_err": s_err, "param_flips": flips}


def _kernel_group(name):
    low = name.lower()
    if "gru_step_kernel" in low:
        return "K1 gru_scan forward"
    if "gru_bwd_" in low:
        return "K1 gru_scan backward"
    if "adm_" in low:
        return "K2 aspect_dropout"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "convolutions (cuDNN)"
    if any(s in low for s in ("gemm", "gemv", "xmma", "nvjet")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, copies, optimizer)"


def _union_ms(spans):
    """The length of the union of (start, end) intervals in microseconds,
    in ms."""
    total, reach = 0.0, -math.inf
    for lo, hi in sorted(spans):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total / 1e3


def profile_update(root, dev):
    """Phase 5b: where one update's device time goes at bin/instance.sh's
    shapes (8 microbatches of 8, every dropout on): the step's time on the
    host clock, then the same step under torch.profiler: device time by
    group and the device's busy share (busy time over the unprofiled step
    time), each the union of its kernels' intervals, since the K1 forward's
    steps overlap under programmatic dependent launch and a sum would count
    the overlap twice; and the 12 largest kernels by summed time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fancyrec_tpu_torch.config import build_train_parser, config_from_args
    from fancyrec_tpu_torch.train.state import init_state
    from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
    from fancyrec_tpu_torch.train.trainer import build_datasets

    cfg = config_from_args(build_train_parser().parse_args(
        instance_args(root, "profile", 1)))
    train_set = build_datasets(cfg)["train"]
    cfg.finalize()
    pick = np.random.RandomState(SEED + 1).permutation(len(train_set))
    superbatch = {k: torch.from_numpy(v).to(dev)
                  for k, v in stack_microbatches([
                      train_set.gather_batch(pick[i * B_TRAIN:
                                                  (i + 1) * B_TRAIN])
                      for i in range(ACCUM)]).items()}
    model, opt, state = init_state(cfg, dev, seed=SEED)
    step_ms = []
    for _ in range(3):                        # the first warms up
        t0 = time.perf_counter()
        state, metrics = train_step(model, opt, cfg, state, superbatch)
        float(metrics["loss"])                # waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = train_step(model, opt, cfg, state, superbatch)
        float(metrics["loss"])
    # device-side events, less the ranges of record_function annotations
    # (Optimizer.step), whose kernels are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and e.self_device_time_total > 0]
    spans = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.time_range.end > e.time_range.start):
            spans.setdefault(_kernel_group(e.name), []).append(
                (e.time_range.start, e.time_range.end))
    total = _union_ms([iv for ivs in spans.values() for iv in ivs])
    summed = sum(e.self_device_time_total for e in kernels) / 1e3
    steady = min(step_ms[1:])
    log("one update (%d microbatches of %d): %.1f ms on the host clock "
        "(runs %s); %d kernel launches, device busy %.1f ms (kernel times "
        "summed: %.1f ms), busy share %.3f"
        % (ACCUM, B_TRAIN, steady, ", ".join("%.1f" % t for t in step_ms),
           sum(e.count for e in kernels), total, summed,
           total / steady if total else float("nan")))
    if not kernels:
        log("torch.profiler recorded no device time: breakdown not measured")
        return
    groups = {g: _union_ms(ivs) for g, ivs in spans.items()}
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log("  %-52s %8.2f ms  %5.1f%%" % (g, ms, 100 * ms / total))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log("  kernel %-64.64s x%-5d %8.2f ms" % (
            e.key, e.count, e.self_device_time_total / 1e3))
    del model, opt, state, superbatch


def train_path(root, dev):
    """Phase 5c: the trainer CLI on the card for one epoch with
    bin/instance.sh's flags. The kernels' counts are zeroed just before it
    and read just after (the trainer's last act is to read its losses,
    which waits for the card); its validation ranks the test split with
    the cosine kernel. Then the serving path builds an index from the
    checkpoint it wrote."""
    from fancyrec_tpu_torch.serving import index as sindex
    from fancyrec_tpu_torch.train import trainer

    zero_counts()
    t0 = time.time()
    best = trainer.main(instance_args(root, "chip_smoke", 1)
                        + ["--device", str(dev)])
    wall = time.time() - t0
    counts = read_counts()
    logdir = os.path.join(root, "model", "chip_smoke")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f][-1]
    micro = rec["updates"] * ACCUM
    log("trainer CLI, 1 epoch at recipe width: %.1f s wall; %d updates of "
        "%d x %d posts in %.2f s: %.1f ms per update, %.1f posts/s; loss %.4f;"
        " validation score %.4f (AUC %.4f); device peak %.2f GB"
        % (wall, rec["updates"], ACCUM, B_TRAIN, rec["train_seconds"],
           1e3 * rec["train_seconds"] / max(rec["updates"], 1),
           rec["posts_per_s"], rec["loss"], best, rec["auc"],
           rec.get("device_peak_bytes", 0) / 1e9))
    log("training path launches: %s" % counts)
    if not (rec["updates"] >= 1 and math.isfinite(rec["loss"])):
        fail("the trainer ran no update or its loss is not finite: %s" % rec)
    for name in ("gru_scan_bwd", "aspect_dropout_fwd", "aspect_dropout_bwd"):
        if counts[name] != micro:
            fail("%s launched %d times for %d microbatches"
                 % (name, counts[name], micro))
    if counts["gru_scan"] < micro:
        fail("gru_scan launched %d times for %d microbatches"
             % (counts["gru_scan"], micro))
    if counts["cosine_scores"] != 1:             # one validation an epoch
        fail("cosine_scores launched %d times in one epoch's validation"
             % counts["cosine_scores"])
    ckpt = os.path.join(logdir, "model_best.pth.tar")
    idx = os.path.join(root, "trained_index")
    n = uncounted(lambda: sindex.build_index(
        ckpt, root, "insCartest", idx, batch_size=B_ENC, device=str(dev)))
    log("the serving path built a %d-post index from the trained checkpoint"
        % n)
    return counts, rec


def tester_path(root, dev, postfix="chip_smoke"):
    """Phase 6: the tester CLI on the card on the checkpoint that phase 5c's
    trainer (or, with postfix "fast", phase 7's) wrote, over the test split
    at recipe width. The kernels' counts
    are zeroed just before it and read just after (the metrics are read on
    the host, which waits for the card). Its ranking is recorded as it
    runs, so that the plain cosine of the same embeddings can be ranked
    after it."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.eval import tester
    from fancyrec_tpu_torch.eval.evaluator import brand_embeddings
    from fancyrec_tpu_torch.eval.metrics import ranking_metrics
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores_cuda, cosine_scores_ref)

    logdir = os.path.join(root, "model", postfix)
    seen = {}
    ranking = tester.test_post_ranking

    def record(model, brand_num, post_embs, brands, device):
        seen.update(model=model, post_embs=post_embs, brands=brands)
        return ranking(model, brand_num, post_embs, brands, device)

    tester.test_post_ranking = record
    try:
        zero_counts()
        t0 = time.time()
        m = tester.main(["insCartest", "--rootpath", root, "--logger_name",
                         logdir, "--batch_size", str(B_ENC), "--device",
                         str(dev)])
        wall = time.time() - t0
        counts = read_counts()
    finally:
        tester.test_post_ranking = ranking
    n_batches = -(-N_EVAL // B_ENC)
    log("tester CLI on %s, %d test posts in %d batches at recipe width: "
        "%.2f s wall; AUC %.6f NDCG@10 %.6f NDCG@50 %.6f R@1/5/10 "
        "%.2f/%.2f/%.2f MedR %g MeanR %g"
        % (postfix, N_EVAL, n_batches, wall, m.auc, m.ndcg10, m.ndcg50, m.r1,
           m.r5, m.r10, m.medr, m.meanr))
    log("evaluation path launches: %s" % counts)
    if not all(math.isfinite(v) for v in m):
        fail("the tester's metrics are not finite: %s" % (m,))
    if counts["cosine_scores"] < 1 or counts["gru_scan"] != n_batches:
        fail("the tester launched cosine_scores %d times and gru_scan %d "
             "times for %d encode batches" % (
                 counts["cosine_scores"], counts["gru_scan"], n_batches))
    with open(os.path.join(logdir, "mean_metrics.json")) as f:
        written = json.load(f)
    if written != {k: float(v) for k, v in m._asdict().items()}:
        fail("mean_metrics.json %s differs from the printed metrics"
             % written)
    # the same embeddings ranked by the plain cosine
    with torch.no_grad():
        aspects = brand_embeddings(seen["model"], N_BRANDS, dev)
        posts = torch.as_tensor(seen["post_embs"], device=dev)
        plain = cosine_scores_ref(aspects, posts)
        k4 = uncounted(lambda: cosine_scores_cuda(aspects, posts))
        want = ranking_metrics(plain, np.asarray(seen["brands"]), N_BRANDS)
    err = _cosine_err(k4, plain)
    rank_ok = all(getattr(m, k) == getattr(want, k)
                  for k in ("medr", "meanr", "r1", "r5", "r10"))
    diff = max(abs(getattr(m, k) - getattr(want, k))
               for k in ("auc", "ndcg10", "ndcg50"))
    log("tester metrics vs the plain cosine's: rank metrics %s, AUC/NDCG "
        "max |diff| %.3g (tolerance 1e-6); scores max |K4 - plain| %.3g"
        % ("equal" if rank_ok else "DIFFER", diff, err))
    if not (rank_ok and diff <= 1e-6):
        fail("the tester's metrics %s differ from the plain cosine's %s"
             % (m, want))
    return counts


def fast_path(root, dev):
    """Phase 7c: the JAX package's documented throughput mode through the
    trainer CLI on the card: bin/instance.sh's model flags with
    FAST_FLAGS (batch 64, accumulation 1, bfloat16 towers, bfloat16
    staging) and --profile_dir, for three epochs on the 816-post fixture:
    epoch 0 carries the first calls' set-up, epoch 1 is traced (the
    trainer profiles epoch min(1, num_epochs - 1)) and epoch 2 is the
    steady, unprofiled measurement. The kernels' counts are zeroed
    just before and read just after. The trace must exist, be non-empty
    and hold device kernels (`utils.profiling.trace` raises otherwise)."""
    from fancyrec_tpu_torch.train import trainer

    prof = os.path.join(root, "fast_profile")
    zero_counts()
    t0 = time.time()
    best = trainer.main(instance_args(root, "fast", 3) + FAST_FLAGS
                        + ["--profile_dir", prof, "--device", str(dev)])
    wall = time.time() - t0
    counts = read_counts()
    logdir = os.path.join(root, "model", "fast")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        log("fast mode (batch %d, accumulation 1, bfloat16 towers and "
            "staging) epoch %d%s: %d updates of %d posts in %.2f s: %.1f ms "
            "per update, %.1f posts/s; loss %.4f; validation score %.4f (AUC "
            "%.4f); device peak %.2f GB"
            % (B_FAST, r["epoch"], " (under the profiler)" if r["epoch"] == 1
               else "", r["updates"], B_FAST, r["train_seconds"],
               1e3 * r["train_seconds"] / max(r["updates"], 1),
               r["posts_per_s"], r["loss"], r["score"], r["auc"],
               r.get("device_peak_bytes", 0) / 1e9))
    log("fast mode trainer CLI, 3 epochs: %.1f s wall, best score %.4f"
        % (wall, best))
    log("fast training path launches: %s" % counts)
    traces = os.listdir(prof) if os.path.isdir(prof) else []
    sizes = [os.path.getsize(os.path.join(prof, t)) for t in traces]
    log("--profile_dir: %s" % ", ".join(
        "%s %d bytes" % (t, n) for t, n in zip(traces, sizes)))
    if len(traces) != 1 or not sizes[0] > 0:
        fail("--profile_dir wrote %s" % traces)
    traced = [r for r in recs if r["epoch"] == 1]
    if traced:
        trace_breakdown(os.path.join(prof, traces[0]), traced[0])
    updates = sum(r["updates"] for r in recs)
    if not (len(recs) == 3 and updates >= 3
            and all(math.isfinite(r["loss"]) for r in recs)):
        fail("the fast-mode trainer ran no update or its loss is not "
             "finite: %s" % recs)
    for name in ("gru_scan_bwd", "aspect_dropout_fwd", "aspect_dropout_bwd"):
        if counts[name] != updates:
            fail("%s launched %d times for %d updates of one microbatch"
                 % (name, counts[name], updates))
    if counts["gru_scan"] < updates or counts["cosine_scores"] != 3:
        fail("fast mode: gru_scan launched %d times for %d updates, "
             "cosine_scores %d times in 3 validations"
             % (counts["gru_scan"], updates, counts["cosine_scores"]))
    return counts, recs


def trace_breakdown(path, rec):
    """Where the traced epoch's device time went, read from the Chrome
    trace that --profile_dir wrote: its kernels' count, the union of
    their intervals by group (PDL steps overlap, so a sum would count
    twice) an update, and the busy share: that union over the epoch's
    training time on the host clock, which the profiler itself slows."""
    import gzip
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans, by_name = {}, {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("dur", 0) > 0:
            spans.setdefault(_kernel_group(e["name"]), []).append(
                (e["ts"], e["ts"] + e["dur"]))
            n_us = by_name.setdefault(e["name"], [0, 0.0])
            n_us[0] += 1
            n_us[1] += e["dur"]
    n = sum(len(v) for v in spans.values())
    if not n:
        fail("the --profile_dir trace %s holds no kernel" % path)
    total = _union_ms([iv for ivs in spans.values() for iv in ivs])
    per = max(rec["updates"], 1)
    log("traced epoch %d: %d kernels, device busy %.1f ms (%.2f ms an "
        "update) in %.2f s of training: busy share %.3f under the profiler"
        % (rec["epoch"], n, total, total / per, rec["train_seconds"],
           total / (1e3 * rec["train_seconds"])))
    for g, ivs in sorted(spans.items(), key=lambda kv: -_union_ms(kv[1])):
        ms = _union_ms(ivs)
        log("  %-52s %8.2f ms an update  %5.1f%%"
            % (g, ms / per, 100 * ms / total))
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:10]:
        log("  kernel %-64.64s x%-5d %8.2f ms an update"
            % (name.replace("(anonymous namespace)::", ""), count,
               us / 1e3 / per))


def _flat_grads(grads):
    import torch
    return torch.cat([grads[k].reshape(-1).float() for k in sorted(grads)])


def bf16_step_card_vs_cpu(root, dev):
    """Phase 7a: one update of the throughput mode (bfloat16 towers, the
    batch staged in bfloat16) on the card against the same update on the
    CPU, from the same weights and brand seed words, the tower dropouts at
    0: 16 posts, one microbatch (the CPU side at recipe width sets the
    size). bfloat16 grads are rounding-sensitive (the loss divides cosines
    by 0.03), so the yardstick is the same update in float32 on the card,
    which the card's bfloat16 grads miss by a relative L2 distance d (over
    all parameters). Two bfloat16 runs whose roundings were independent
    would lie about sqrt(2) d apart; the card's and the CPU's bfloat16
    grads, which round the same casts of the same inputs and differ in sum
    order, must lie nearer than that. The losses within 1e-2 relative."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.config import build_train_parser, config_from_args
    from fancyrec_tpu_torch.losses import init_queue_state
    from fancyrec_tpu_torch.models import FancyRec, init_fancyrec
    from fancyrec_tpu_torch.train.state import TrainState, make_optimizer
    from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
    from fancyrec_tpu_torch.train.trainer import _superbatches, build_datasets

    n = 16
    cfg = config_from_args(build_train_parser().parse_args(
        instance_args(root, "bf16_check", 1) + FAST_FLAGS
        + ["--batch_size", str(n), "--dropout", "0", "--bert_dropout", "0"]))
    train_set = build_datasets(cfg)["train"]
    cfg.finalize()
    pick = np.random.RandomState(SEED + 2).permutation(len(train_set))[:n]
    (staged,) = list(_superbatches([train_set.gather_batch(pick)], 1,
                                   transfer_dtype=cfg.transfer_dtype))
    out = {}
    for where, dtype in ((dev, "bfloat16"), (dev, "float32"),
                         (torch.device("cpu"), "bfloat16")):
        cfg.dtype = dtype
        model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(
            SEED)).to(where).seed_dropout(SEED)
        opt = make_optimizer(cfg, model.parameters())
        state = TrainState(queue=init_queue_state(cfg.queue_size, DIM,
                                                  device=where))
        sb = {k: torch.as_tensor(v).to(where) for k, v in staged.items()}
        t0 = time.time()
        _, metrics = train_step(model, opt, cfg, state, sb)
        loss = float(metrics["loss"])
        log("bf16 check: train step in %s on %s: %.2f s, loss %.6f"
            % (dtype, where, time.time() - t0, loss))
        out[where.type, dtype] = (loss, _flat_grads(
            {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
        del model, opt, state, sb
    (l_card, g_card), (_, g_f32), (l_cpu, g_cpu) = (
        out["cuda", "bfloat16"], out["cuda", "float32"],
        out["cpu", "bfloat16"])
    err = float((g_card - g_cpu).norm() / g_cpu.norm())
    spread = float((g_card - g_f32).norm() / g_f32.norm())
    log("bf16 update card vs CPU: losses %.6f and %.6f (%.3g relative; "
        "tolerance 1e-2); grads %.4f apart in relative L2, the card's bf16 "
        "grads %.4f from its float32 grads (bound: sqrt(2) x that, %.4f)"
        % (l_card, l_cpu, abs(l_card - l_cpu) / abs(l_cpu), err, spread,
           math.sqrt(2) * spread))
    if not (abs(l_card - l_cpu) <= 1e-2 * abs(l_cpu)
            and err < math.sqrt(2) * spread):
        fail("the card's bf16 update disagrees with the CPU's")
    return {"loss_rel": abs(l_card - l_cpu) / abs(l_cpu), "grad_rel_l2": err,
            "bf16_vs_f32": spread}


def remat_card(root, dev):
    """Phase 7b: --bert_remat 1 on the card. One float32 update at the
    throughput mode's batch (64, accumulation 1) with bin/instance.sh's
    dropouts on (towers 0.2, BERT 0.1), from the same weights and seeds,
    with and without remat, cuDNN held to its deterministic algorithms
    (with its default ones two runs without remat already differ in the
    last bits of the grads): the recompute replays the dropout
    generators, so the losses and every grad must be bit-identical.
    Reports each run's peak device memory."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.config import build_train_parser, config_from_args
    from fancyrec_tpu_torch.train.state import init_state
    from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
    from fancyrec_tpu_torch.train.trainer import build_datasets

    pick = None
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for remat in (0, 1):
        cfg = config_from_args(build_train_parser().parse_args(
            instance_args(root, "remat", 1)
            + ["--batch_size", str(B_FAST), "--accumulation_step", "1",
               "--bert_remat", str(remat)]))
        train_set = build_datasets(cfg)["train"]
        cfg.finalize()
        if pick is None:
            pick = np.random.RandomState(SEED + 3).permutation(
                len(train_set))[:B_FAST]
        sb = {k: torch.from_numpy(v).to(dev) for k, v in stack_microbatches(
            [train_set.gather_batch(pick)]).items()}
        model, opt, state = init_state(cfg, dev, seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        _, metrics = train_step(model, opt, cfg, state, sb)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        runs[remat] = (loss, {k: p.grad.detach().clone()
                              for k, p in model.named_parameters()},
                       peak, peak - base, ms)
        del model, opt, state, sb
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    (l0, g0, p0, a0, t0_), (l1, g1, p1, a1, t1_) = runs[0], runs[1]
    differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    log("--bert_remat on the card (float32, batch %d, dropout on, cuDNN "
        "deterministic): loss %.6f with remat, %.6f without; %d of %d grads "
        "differ (tolerance: none); peak device memory %.3f GB with remat, "
        "%.3f GB without (above the weights: %.3f and %.3f GB); first update "
        "%.0f and %.0f ms"
        % (B_FAST, l1, l0, len(differ), len(g0), 1e-9 * p1, 1e-9 * p0,
           1e-9 * a1, 1e-9 * a0, t1_, t0_))
    if l1 != l0 or differ:
        fail("--bert_remat changes the update: %s" % differ[:5])
    return {"peak_remat": p1, "peak_plain": p0}


def tiny_batch(cfg, b, seed):
    """A seeded batch at a small model's widths (padded frames and tokens,
    ragged lengths), built with numpy alone."""
    import numpy as np
    rng = np.random.RandomState(seed)
    tok = cfg.max_tokens if cfg.text_net == "transformers" else cfg.max_words
    flen = rng.randint(1, cfg.max_frames, b)
    tlen = rng.randint(1, tok, b)
    vmask = (np.arange(cfg.max_frames)[None] < flen[:, None]).astype(
        np.float32)
    tmask = (np.arange(tok)[None] < tlen[:, None]).astype(np.int32)
    hi = (cfg.bert_vocab_size if cfg.text_net == "transformers"
          else cfg.vocab_size)
    return {
        "frames": (rng.randn(b, cfg.max_frames, cfg.visual_feat_dim)
                   * vmask[..., None]).astype(np.float32),
        "origin": rng.randn(b, cfg.visual_feat_dim).astype(np.float32),
        "vmask": vmask,
        "bows": rng.rand(b, cfg.bow_vocab_size).astype(np.float32),
        "tokens": (rng.randint(1, hi, (b, tok)) * tmask).astype(np.int32),
        "type_ids": np.zeros((b, tok), np.int32),
        "tmask": tmask,
    }


def frtpu1_card(dev):
    """Phase 8: a checkpoint the JAX package wrote (FRTPU1, the committed
    tests/data/frtpu1_tiny.pth.tar, regenerated byte for byte by the CPU
    tests) read by `load_any` onto the card: a seeded batch encoded on the
    card equals the CPU's encode within ENC_TOL, and its Adam moments load
    into a card optimizer unchanged. The model is tiny, so this proves the
    read path, not a width."""
    import torch
    from fancyrec_tpu_torch.eval.evaluator import encode_batch
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.train.checkpoints import load_any
    from fancyrec_tpu_torch.train.state import (
        load_optimizer_state, make_optimizer)

    path = os.path.join(HERE, "tests", "data", "frtpu1_tiny.pth.tar")
    ck = load_any(path)
    cfg = ck["config"]
    batch = tiny_batch(cfg, 5, SEED + 4)
    embs = {}
    for where in (dev, torch.device("cpu")):
        model = FancyRec(cfg)
        model.load_state_dict(ck["state_dict"])
        model.to(where).eval()
        with torch.no_grad():
            embs[where.type] = encode_batch(model, {
                k: torch.from_numpy(v).to(where)
                for k, v in batch.items()}).cpu()
    opt = make_optimizer(cfg, model.to(dev).parameters())
    load_optimizer_state(opt, model, ck["optimizer"])
    names = [n for n, _ in model.named_parameters()]
    moved = all(
        opt.state[p]["exp_avg"].device.type == "cuda"
        and torch.equal(opt.state[p]["exp_avg"].cpu(),
                        ck["optimizer"]["state"][n]["exp_avg"])
        for n, p in zip(names, model.parameters()))
    err = (embs["cuda"] - embs["cpu"]).abs().max().item()
    log("FRTPU1 %s (epoch %s, Eiters %s, %d tensors): card encode vs CPU "
        "max |diff| %.3g (tolerance atol %g rtol %g); Adam moments on the "
        "card equal the file's: %s"
        % (os.path.basename(path), ck["epoch"], ck["Eiters"],
           len(ck["state_dict"]), err, ENC_TOL["atol"], ENC_TOL["rtol"],
           moved))
    if not (torch.allclose(embs["cuda"], embs["cpu"], **ENC_TOL) and moved):
        fail("the FRTPU1 checkpoint on the card disagrees with the CPU")


def resnet_flops(blocks, hw=RESNET_HW):
    """Operations of one image through the extractor's convolutions,
    counted from their shapes: 2 Cout Cin kh kw Hout Wout each, the plain
    7x7/2 stem (the space-to-depth one does the same work over padded
    taps)."""
    def conv(cin, cout, k, out_hw):
        return 2 * cout * cin * k * k * out_hw * out_hw

    hw //= 2
    total = conv(3, 64, 7, hw)
    hw //= 2                      # the 3x3/2 max pool
    cin, width = 64, 64
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            out_hw = hw // 2 if (stage > 0 and b == 0) else hw
            total += (conv(cin, width, 1, hw) + conv(width, width, 3, out_hw)
                      + conv(width, 4 * width, 1, out_hw))
            if b == 0:
                total += conv(cin, 4 * width, 1, out_hw)
            cin, hw = 4 * width, out_hw
        width *= 2
    return total


def resnet_card_vs_cpu(state, dev):
    """Phase 9a: the ResNet-152 extractor at full depth on 4 seeded images:
    the float32 extractor on the card equals the CPU's within ENC_TOL with
    either stem; the bf16 extractor on the card, with either stem, sits
    within RESNET_BF16_TOL of the CPU's float32 features (relative L2 an
    image)."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.models.resnet import make_extractor

    imgs = np.random.RandomState(SEED).randint(
        0, 256, (N_RESNET_CHECK, RESNET_HW, RESNET_HW, 3)).astype(np.uint8)
    t0 = time.time()
    want = make_extractor(state, N_RESNET_CHECK, torch.float32, True,
                          "cpu")(imgs)
    cpu_s = time.time() - t0
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s2d in (True, False):
            extract = make_extractor(state, N_RESNET_CHECK, dtype, s2d, dev)
            out[dtype, s2d] = extract(imgs).cpu()
    errs = {}
    for s2d in (True, False):
        got = out[torch.float32, s2d]
        errs["f32", s2d] = (got - want).abs().max().item()
        if got.shape != (N_RESNET_CHECK, 2048) or not (
                torch.isfinite(got).all()
                and torch.allclose(got, want, **ENC_TOL)):
            fail("ResNet-152 float32 on the card (stem_s2d=%s) disagrees "
                 "with the CPU: max |diff| %.3g" % (s2d, errs["f32", s2d]))
        # relative L2 error of each image
        errs["bf16", s2d] = ((out[torch.bfloat16, s2d] - want).norm(dim=1)
                             / want.norm(dim=1)).max().item()
        if not errs["bf16", s2d] < RESNET_BF16_TOL:
            fail("ResNet-152 bf16 on the card (stem_s2d=%s) is %.3g from "
                 "the CPU's float32 features (relative L2), above %.3g"
                 % (s2d, errs["bf16", s2d], RESNET_BF16_TOL))
    stems = (out[torch.float32, True] - out[torch.float32, False]).abs()
    log("ResNet-152 at %d x %d, %d images (CPU float32 in %.1f s): card "
        "float32 vs CPU max |diff| %.3g (s2d stem) / %.3g (plain stem), "
        "tolerance atol %g rtol %g; the two stems on the card in float32 "
        "max |diff| %.3g; card bf16 vs CPU float32, relative L2 per image, "
        "max %.4g (s2d) / %.4g (plain), tolerance %.4g; largest |feature| "
        "%.1f"
        % (RESNET_HW, RESNET_HW, N_RESNET_CHECK, cpu_s, errs["f32", True],
           errs["f32", False], ENC_TOL["atol"], ENC_TOL["rtol"],
           stems.max().item(), errs["bf16", True], errs["bf16", False],
           RESNET_BF16_TOL, want.abs().max().item()))
    if not torch.allclose(out[torch.float32, True], out[torch.float32, False],
                          **ENC_TOL):
        fail("the two ResNet stems disagree on the card")
    return errs


def resnet_throughput(state, dev):
    """Phase 9b: frames/s of the bf16 extractor at B=128, by CUDA events
    (medians of 5 windows of 5 calls): on a uint8 batch already on the card
    (the extractor's ceiling) and from a pinned host batch (the copy
    included), with each stem, with cuDNN's autotuner
    (torch.backends.cudnn.benchmark) off, as the package runs it, and on;
    the stems alone; against the bound of the convolutions' operations at
    the bf16 peak."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from fancyrec_tpu_torch.models.resnet import (
        RESNET152_BLOCKS, _stem_s2d, make_extractor)

    batch = np.random.RandomState(SEED + 1).randint(
        0, 256, (B_EXTRACT, RESNET_HW, RESNET_HW, 3)).astype(np.uint8)
    host = torch.from_numpy(batch).pin_memory()
    on_card = host.to(dev)
    flops = resnet_flops(RESNET152_BLOCKS) * B_EXTRACT
    nbytes = batch.nbytes + 2 * sum(v.numel() for v in state.values()) \
        + B_EXTRACT * 2048 * 4
    bound = roofline(nbytes, flops, BF16_FLOPS)

    def median_ms(fn):
        return statistics.median(cuda_ms(fn, 5) for _ in range(5))

    rec = {"flops_per_image": flops / B_EXTRACT, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"],
           "bound_fps": B_EXTRACT / bound["bound_ms"] * 1e3}
    saved = torch.backends.cudnn.benchmark
    try:
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for s2d in (True, False):
                torch.cuda.reset_peak_memory_stats(dev)
                extract = make_extractor(state, B_EXTRACT, torch.bfloat16,
                                         s2d, dev)
                tag = "%s_%s" % ("s2d" if s2d else "plain",
                                 "bench" if bench else "default")
                rec["ms_" + tag] = median_ms(lambda: extract(on_card))
                if s2d and not bench:
                    rec["ms_host_" + tag] = median_ms(lambda: extract(host))
                    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                del extract
        torch.backends.cudnn.benchmark = False
        x = (on_card.permute(0, 3, 1, 2).to(torch.bfloat16))
        k = state["conv1.weight"].to(dev, torch.bfloat16)
        rec["stem_ms_s2d"] = median_ms(lambda: _stem_s2d(x, k))
        rec["stem_ms_plain"] = median_ms(
            lambda: F.conv2d(x, k, stride=2, padding=3))
    finally:
        torch.backends.cudnn.benchmark = saved
    ms = rec["ms_s2d_default"]
    rec["fps"] = B_EXTRACT / ms * 1e3
    rec["fps_host"] = B_EXTRACT / rec["ms_host_s2d_default"] * 1e3
    rec["bound_share"] = bound["bound_ms"] / ms
    log("ResNet-152 bf16 extractor, B=%d, %d x %d, cudnn.benchmark off: "
        "%.3f ms a batch on a uint8 batch on the card (%.1f frames/s, the "
        "extractor's ceiling), %.3f ms from a pinned host batch (%.1f "
        "frames/s); bound %.3f ms (%s: %.4g GFLOP an image at %g TFLOP/s "
        "bf16; %.0f frames/s), share %.3f; device peak %.2f GB; %s"
        % (B_EXTRACT, RESNET_HW, RESNET_HW, ms, rec["fps"],
           rec["ms_host_s2d_default"], rec["fps_host"], bound["bound_ms"],
           bound["bound_by"], rec["flops_per_image"] / 1e9,
           BF16_FLOPS / 1e12, rec["bound_fps"], rec["bound_share"],
           rec["peak_gb"], smi_name_power()))
    log("ResNet-152 bf16 stems: whole extractor s2d %.3f / plain %.3f ms "
        "(cudnn.benchmark off), s2d %.3f / plain %.3f ms (on); the stem "
        "alone s2d %.4f / plain %.4f ms"
        % (rec["ms_s2d_default"], rec["ms_plain_default"],
           rec["ms_s2d_bench"], rec["ms_plain_bench"], rec["stem_ms_s2d"],
           rec["stem_ms_plain"]))
    return rec


def stream_frames(pool, n):
    """(name, frame) pairs of n frames drawn from pool in turn: videos of
    32 frames sampled every 15th frame, over the 51 brands."""
    for i in range(n):
        v = i // 32
        yield ("video%d_%d_cls%d" % (v + 1, (i % 32) * 15, v % N_BRANDS),
               pool[i % len(pool)])


def extraction_path(work, state, dev):
    """Phase 9c: `preprocess.features.extract_features` on the card over a
    synthetic stream of N_STREAM uint8 frames (batches of 128) into a
    BigFile; one batch's rows equal the extractor's direct output bit for
    bit; `frameinfo` and `format_check` pass on the result."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.io.bigfile import ImageBigFile
    from fancyrec_tpu_torch.io.format_check import check_feature_dir
    from fancyrec_tpu_torch.models.resnet import make_extractor
    from fancyrec_tpu_torch.preprocess.features import extract_features
    from fancyrec_tpu_torch.preprocess.frameinfo import get_frame_info

    pool = np.random.default_rng(SEED + 2).integers(
        0, 256, (N_STREAM, RESNET_HW, RESNET_HW, 3), np.uint8)
    out = os.path.join(work, "video_features")
    stats = {}
    t0 = time.perf_counter()
    n = extract_features(stream_frames(pool, N_STREAM), out,
                         batch_size=B_EXTRACT, params=state, stats=stats,
                         device=dev)
    wall = time.perf_counter() - t0
    stream_s = stats["wait_s"] + stats["compute_s"] + stats["write_s"]
    if n != N_STREAM:
        fail("extract_features wrote %d rows of %d" % (n, N_STREAM))
    store = ImageBigFile(out)
    b = 5                          # one batch, held bit for bit
    rows = store.read_rows(range(b * B_EXTRACT, (b + 1) * B_EXTRACT))
    extract = make_extractor(state, B_EXTRACT, torch.bfloat16, True, dev)
    direct = extract(pool[b * B_EXTRACT:(b + 1) * B_EXTRACT]).cpu().numpy()
    if not np.array_equal(rows, direct):
        fail("the BigFile's rows of batch %d differ from the extractor's "
             "output (max |diff| %.3g)" % (b, np.abs(rows - direct).max()))
    v2f = get_frame_info(out)
    problems = check_feature_dir(out)
    if problems or len(v2f) != N_STREAM // 32 or store.ndims != 2048:
        fail("the extracted BigFile fails its checks: %s, %d videos"
             % (problems, len(v2f)))
    rec = {"frames": n, "wall_s": wall, "stream_s": stream_s,
           "fps": n / stream_s, "fps_wall": n / wall, **stats}
    log("extract_features on the card: %d frames in %d batches of %d, "
        "%.2f s streaming (%.1f frames/s; %.2f s and %.1f frames/s with "
        "the extractor's build): wait %.3f s, compute %.3f s, write %.3f s;"
        " batch %d bit for bit; frameinfo (%d videos) and format_check pass"
        % (n, stats["batches"], B_EXTRACT, stream_s, rec["fps"], wall,
           rec["fps_wall"], stats["wait_s"], stats["compute_s"],
           stats["write_s"], b, len(v2f)))
    return rec


def decode_path(work, state, dev):
    """Phase 9d, where cv2 imports: the JAX package's bench_preprocess on
    the card (8 synthetic mp4s of 450 frames at 640 x 360, 30 fps),
    decoded by `iter_sampled_frames_parallel` on threads into
    `extract_features`: decode-only, end-to-end decoded frames/s and the
    share of the stream spent waiting on decode."""
    try:
        import cv2
    except ImportError as e:
        log("decode leg (9d) not run: cv2 does not import on this host (%s)"
            % e)
        return None
    import numpy as np
    from fancyrec_tpu_torch.preprocess import videos
    from fancyrec_tpu_torch.preprocess.features import extract_features

    root = os.path.join(work, "videos")
    w, h = DECODE_SIZE
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.zeros((h, w, 3), np.uint8)
    base[..., 0] = (xx * 255 // w).astype(np.uint8)
    base[..., 1] = (yy * 255 // h).astype(np.uint8)
    for v in range(N_DECODE_VIDEOS):
        d = os.path.join(root, "brand%02d" % (v % 4))
        os.makedirs(d, exist_ok=True)
        vw = cv2.VideoWriter(os.path.join(d, "vid%03d.mp4" % v),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        if not vw.isOpened():
            fail("the mp4v codec is unavailable to cv2")
        frame = base.copy()
        frame[..., 2] = (v * 37) % 255
        for i in range(DECODE_FRAMES):
            vw.write(np.roll(frame, i * 3, axis=1))
        vw.release()
    brands = sorted(os.listdir(root))
    decoded = N_DECODE_VIDEOS * DECODE_FRAMES
    t0 = time.perf_counter()
    sampled = sum(1 for _ in videos.iter_sampled_frames(root, brands))
    decode_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    n = extract_features(
        videos.iter_sampled_frames_parallel(root, brands,
                                            workers=DECODE_WORKERS,
                                            backend="thread"),
        os.path.join(work, "decoded"), batch_size=B_EXTRACT, params=state,
        stats=stats, device=dev)
    wall = time.perf_counter() - t0
    if n != sampled:
        fail("decode leg: %d rows written of %d sampled frames"
             % (n, sampled))
    stream_s = stats["wait_s"] + stats["compute_s"] + stats["write_s"]
    rec = {"decoded_frames": decoded, "sampled_frames": sampled,
           "decode_only_fps": decoded / decode_s,
           "e2e_decoded_fps": decoded / stream_s,
           "e2e_decoded_fps_wall": decoded / wall,
           "wait_share": stats["wait_s"] / stream_s}
    log("decode leg: %d mp4s of %d frames at %d x %d, %d sampled; serial "
        "decode %.1f frames/s; decode (%d threads) -> extract -> BigFile "
        "%.1f decoded frames/s streaming (%.1f with the extractor's "
        "build), waiting on decode %.3f of the stream"
        % (N_DECODE_VIDEOS, DECODE_FRAMES, w, h, sampled,
           rec["decode_only_fps"], DECODE_WORKERS, rec["e2e_decoded_fps"],
           rec["e2e_decoded_fps_wall"], rec["wait_share"]))
    return rec


def preprocessing_path(work, dev):
    """Phase 9: offline preprocessing, the ResNet-152 extractor (bf16,
    channels-last, random weights from a seed) and the decode -> extract
    -> BigFile pipeline on the card."""
    import torch
    from fancyrec_tpu_torch.models.resnet import init_random_params

    t0 = time.time()
    state = init_random_params(seed=SEED)
    rec = {"errors": resnet_card_vs_cpu(state, dev)}
    torch.cuda.empty_cache()
    rec["throughput"] = resnet_throughput(state, dev)
    torch.cuda.empty_cache()
    rec["stream"] = extraction_path(work, state, dev)
    torch.cuda.empty_cache()
    rec["decode"] = decode_path(work, state, dev)
    rec["errors"] = {"%s_%s" % (k[0], "s2d" if k[1] else "plain"): v
                     for k, v in rec["errors"].items()}
    log("preprocessing phase in %.1f s: %s"
        % (time.time() - t0, json.dumps(rec)))
    return rec


# ---------------------------------------------------------------------------
# phase 10: data parallelism across ranks
# ---------------------------------------------------------------------------

DP_RANKS = 2                  # ranks of the data-parallel world on one card
B_RANK = B_TRAIN // DP_RANKS  # each rank's rows of a recipe microbatch
DP_TIMEOUT = 420              # seconds a world of ranks may take

# One rank of a phase-10, 11, 12 or 13 world, started as `python -c
# _RANK_MAIN HERE jobs`, jobs a JSON list of [mode, out, argv] that the
# process runs in turn (a world stays joined across them, so that a world's
# start-up, mostly importing torch, is paid once): the trainer (mode
# "train"), the tester ("test") or the index ("build", phase 12d; "query",
# phase 12e, argv a list of the query CLI's argvs) CLI through its main, or
# one update through the library ("step": the trainer's loader, init_state
# and train_step; "step_drop": the same with the brand dropout on).
# Instruments, none of them in the program:
# deterministic algorithms (so that two runs of the same update can agree
# bit for bit), the brand dropout off but in "step_drop" (the tower
# dropouts are off by flag where wanted: each data slot draws its own
# masks, so only dropout-free updates can match across data axes), the
# first update written to `out`.first.pt by rank 0 (whole: a model rank's
# shards gathered over its model group), and a RANK_RESULT line with this
# rank's kernel launches, engine, times and device peak, a job (each job
# zeroes the counts and the peak first); the tester's
# encoded posts and brands written to `out`.enc.<rank>.npz. Under
# --pp_stages, after the second update: a digest of this rank's BERT
# parameters and their Adam moments ("bert_digest"), which every model
# rank must share.
_RANK_MAIN = r"""
import contextlib, hashlib, io, json, os, sys, time
here, jobs = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, here)
import numpy as np
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
import chip_smoke
from fancyrec_tpu_torch.models import brand, encoders
from fancyrec_tpu_torch.ops.similarity import topk_int8_cuda
from fancyrec_tpu_torch.parallel import collectives
from fancyrec_tpu_torch.parallel.mesh import gather_state_dict
from fancyrec_tpu_torch.eval import tester
from fancyrec_tpu_torch.serving import index
from fancyrec_tpu_torch.train import trainer
job = {}
_init = brand.BrandAspects.__init__
def _no_brand_dropout(self, *a, **k):
    _init(self, *a, **k)
    if job["mode"] != "step_drop":
        self.p = 0.0
brand.BrandAspects.__init__ = _no_brand_dropout
seen = {}
_step, _epoch, _datasets = (trainer.train_step, trainer.train_epoch,
                            trainer.build_datasets)
def bert_digest(model, opt):
    h = hashlib.sha256()
    moments = opt.state_dict()["state"]
    for i, (n, p) in enumerate(model.named_parameters()):
        if ".bert." in n:
            for t in (p.detach(), moments[i]["exp_avg"],
                      moments[i]["exp_avg_sq"]):
                h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
def first_update(model, opt, cfg, state, sb):
    state, metrics = _step(model, opt, cfg, state, sb)
    seen["updates"] += 1
    if seen["updates"] == 2 and getattr(model, "pp", False):
        t0 = time.time()
        seen["bert_digest"] = bert_digest(model, opt)
        seen["dump_s"] += time.time() - t0
    if "loss" not in seen:
        t0 = time.time()
        seen.update(loss=float(metrics["loss"]),
                    grad_norm=float(metrics["grad_norm"]))
        # every rank takes part in the gathers of a model axis
        full = model.full_state_dict()
        names = [n for n, _ in model.named_parameters()]
        grads = {n: p.grad for n, p in model.named_parameters()}
        grads = gather_state_dict(grads, model.split_dims())
        if collectives.rank() == 0:
            torch.save({
                "params": {n: full[n].detach().cpu() for n in names},
                "grads": {n: grads[n].cpu() for n in names},
                "buffers": {n: full[n].cpu()
                            for n, _ in model.named_buffers()},
                "queue": state.queue.queue.cpu()}, job["out"] + ".first.pt")
        seen["dump_s"] = time.time() - t0
    return state, metrics
def epoch(*a, **k):
    state, stats = _epoch(*a, **k)
    seen["stats"] = stats
    return state, stats
def datasets(cfg):
    ds = _datasets(cfg)
    seen["engines"] = sorted({r.engine for d in ds.values()
                              for r in (d.video_feat, d.img_feat)})
    return ds
trainer.train_step, trainer.train_epoch = first_update, epoch
trainer.build_datasets = datasets
# the towers' calls of the time split and the pipeline: [in training (grad
# mode), in evaluation]
split_calls = {}
def counted(name):
    fn = getattr(encoders, name)
    def call(*a, **k):
        split_calls[name][0 if torch.is_grad_enabled() else 1] += 1
        return fn(*a, **k)
    setattr(encoders, name, call)
for n in ("seq_shard_pool", "bert_pipeline_forward"):
    counted(n)
_ranking = tester.test_post_ranking
def ranking(model, brand_num, post_embs, brands, device):
    # what the sharded encode left on this rank: every post's embedding
    np.savez("%s.enc.%d.npz" % (job["out"], collectives.rank()),
             post_embs=post_embs, brands=brands)
    return _ranking(model, brand_num, post_embs, brands, device)
tester.test_post_ranking = ranking
held, _query = [], index.PostIndex.query
def query(self, *a, **k):
    vals, names = _query(self, *a, **k)
    held.append((self, vals, names))
    return vals, names
index.PostIndex.query = query
for n_job, (mode, out, argv) in enumerate(jobs):
    job.update(mode=mode, out=out)
    seen.clear()
    seen.update(dump_s=0.0, updates=0)
    split_calls.update({n: [0, 0] for n in ("seq_shard_pool",
                                            "bert_pipeline_forward")})
    chip_smoke.zero_counts()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if mode == "train":
        got = trainer.main(argv)
    elif mode == "build":
        index.main(argv)
        got = {}
    elif mode == "query":
        # `index query` over the world, once an argv of the list, each
        # run's answer (values saved, names kept), printed lines and K3
        # launches recorded; then K3 on this rank's shard timed (CUDA
        # events) and the two all-gathers of its candidates over the data
        # group (host clock)
        got = {"runs": []}
        del held[:]
        for i, one in enumerate(argv):
            buf, before = io.StringIO(), chip_smoke.read_counts()["topk_int8"]
            with contextlib.redirect_stdout(buf):
                index.main(one)
            idx, vals, names = held[-1]
            np.save("%s.%d.%d.npy" % (out, i, collectives.rank()), vals)
            got["runs"].append({
                "names": names, "lines": len(buf.getvalue().splitlines()),
                "k3": chip_smoke.read_counts()["topk_int8"] - before,
                "rows": (None if idx._posts is None
                         else int(idx._posts.shape[0])),
                "lists": (None if idx._ivf is None
                          else int(idx._ivf.packed_idx.shape[0]))})
        idx, vals = held[0][0], held[0][1]
        q = torch.from_numpy(idx.brand_embs).to(idx.device)
        slot, size = collectives.data_rank(), idx.shard_size
        local = min(max(idx.n_posts - slot * size, 0), size)
        b, k, d = q.shape[0], vals.shape[1], q.shape[1]
        posts, inv = idx.posts(), idx._posts_inv
        k3 = lambda: topk_int8_cuda(q, posts, inv, k, local)
        got.update(local_rows=local, k3_ms=chip_smoke.uncounted(
            lambda: chip_smoke.cuda_ms(k3, 20)), **chip_smoke.roofline(
                4 * q.numel() + local * d + 4 * local + 8 * b * k,
                2 * b * local * d, chip_smoke.INT8_OPS))
        v, i = chip_smoke.uncounted(k3)
        gather = lambda: (collectives.all_gather(v[None]),
                          collectives.all_gather(i[None]))
        gather()
        t1 = time.perf_counter()
        for _ in range(20):
            gather()
        torch.cuda.synchronize()
        got["gather_ms"] = (time.perf_counter() - t1) * 1e3 / 20
        del held[:], idx, posts, inv, q
    elif mode.startswith("step"):
        from fancyrec_tpu_torch.config import (
            build_train_parser, config_from_args)
        from fancyrec_tpu_torch.data.loader import (
            BatchLoader, prefetch_to_device)
        from fancyrec_tpu_torch.parallel import distributed
        from fancyrec_tpu_torch.parallel.mesh import (
            build_mesh, process_batch_shard)
        from fancyrec_tpu_torch.train.state import init_state
        args = build_train_parser().parse_args(argv)
        cfg = config_from_args(args)
        device = distributed.initialize_multihost(args.device)
        mesh = build_mesh(cfg.mesh_shape)
        ds = trainer.build_datasets(cfg)["train"]
        cfg.finalize()
        # the trainer's train loader, model and first super-batch
        loader = BatchLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                             final_batch="drop",
                             grouped="window" if cfg.length_grouped else "off",
                             process_shard=process_batch_shard(
                                 mesh, cfg.batch_size))
        model, opt, state = init_state(cfg, device, mesh=mesh)
        stream = prefetch_to_device(trainer._superbatches(
            loader, cfg.accumulation_step, cfg.token_buckets_list,
            cfg.frame_buckets_list, cfg.transfer_dtype), device,
            trainer._TRAIN_KEYS, size=2)
        _, sb = next(stream)
        stream.close()
        t1 = time.time()
        first_update(model, opt, cfg, state, sb)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        got = {"update_s": time.time() - t1 - seen["dump_s"],
               "mesh": [mesh.data, mesh.model]}
        del model, opt, state, sb, loader, ds
    else:
        got = tester.main(argv)._asdict()
        # the exact sharded metrics on the card over a score matrix with
        # ties and pad posts, each rank its contiguous shard of the columns
        from fancyrec_tpu_torch.eval.metrics import ranking_metrics_sharded
        scores, labels = chip_smoke.tie_scores()
        # the data slots split the columns; a slot's model ranks share its
        # block
        n_l = scores.shape[1] // collectives.data_size()
        cols = slice(collectives.data_rank() * n_l,
                     (collectives.data_rank() + 1) * n_l)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
        seen["sharded"] = ranking_metrics_sharded(
            torch.from_numpy(scores[:, cols]).to(dev), labels[cols],
            scores.shape[0])._asdict()
    wall = time.time() - t0
    stats = seen.pop("stats", None)
    res = {"job": n_job, "rank": collectives.rank(),
           "world": collectives.world_size(),
           "backend": (torch.distributed.get_backend()
                       if torch.distributed.is_initialized() else None),
           "device": (str(torch.cuda.current_device())
                      if torch.cuda.is_available() else "cpu"),
           "result": got, "wall_s": wall, "counts": chip_smoke.read_counts(),
           "split_calls": split_calls,
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if torch.cuda.is_available() else 0), **seen}
    if stats:
        res.update(updates=len(stats["losses"]), train_s=stats["seconds"],
                   ms_per_update=1e3 * (stats["seconds"] - seen["dump_s"])
                   / max(len(stats["losses"]), 1))
    print("RANK_RESULT " + json.dumps(res), flush=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
"""


def tie_scores():
    """A seeded (51, 818) score matrix with exact ties (two decimals) and
    labels where brand 50 has no post and the last 2 posts are pads (-1):
    what 10e's ranks rank with ranking_metrics_sharded, against the
    oracle here."""
    import numpy as np
    rng = np.random.RandomState(SEED + 13)
    scores = np.round(rng.randn(51, 818), 2).astype(np.float32)
    labels = rng.randint(0, 50, 818).astype(np.int64)
    labels[-2:] = -1
    return scores, labels


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_jobs(jobs, ranks):
    """`ranks` processes of _RANK_MAIN on this card, each running `jobs`
    ([(mode, out, argv)]) in turn -> for each job its RANK_RESULT records
    by rank (`start_jobs`, then `finish_jobs`)."""
    return finish_jobs(start_jobs(jobs, ranks))


def start_jobs(jobs, ranks, of=0):
    """Start `ranks` processes of _RANK_MAIN running `jobs` in turn, and
    return without waiting: another world may run beside it (their times
    then show results, not speed), `of` the processes on the host then, among
    which its cores are split. ranks=0: one process outside any world (no
    WORLD_SIZE); else a world of `ranks` (MASTER_ADDR localhost, a free
    port). -> a handle for `finish_jobs`."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=HERE, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    if ranks:
        env.update(WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    of = max(of, ranks)
    if of > 1:
        # the host's cores split between the processes, as torchrun splits
        # them between its ranks: host threads that spin while another
        # process holds the cores slow the collectives down
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // of))
    procs, t0 = [], time.time()
    for r in range(max(ranks, 1)):
        renv = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if ranks else env
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_MAIN, HERE, json.dumps(jobs)],
            env=renv, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _LIVE.extend(procs)
    return jobs, ranks, procs, t0


def finish_jobs(handle):
    """Wait for `start_jobs`' processes -> for each job its RANK_RESULT
    records by rank. Every process is killed and the phase fails if one
    exits non-zero or the world outlives DP_TIMEOUT from its start."""
    jobs, ranks, procs, t0 = handle
    modes = "+".join(mode for mode, _, _ in jobs)
    outs, deadline = [], t0 + DP_TIMEOUT
    try:
        for p in procs:
            left = max(1, deadline - time.time())
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        fail("%s over %d rank(s) did not finish in %d s" % (modes, ranks,
                                                            DP_TIMEOUT))
    for p in procs:
        _LIVE.remove(p)
    results = [{} for _ in jobs]
    for p, text in zip(procs, outs):
        if p.returncode != 0:
            fail("a %s rank exited %d:\n%s" % (modes, p.returncode,
                                               text[-4000:]))
        for line in text.splitlines():
            if line.startswith("RANK_RESULT "):
                r = json.loads(line[len("RANK_RESULT "):])
                results[r["job"]][r["rank"]] = r
    if any(sorted(res) != list(range(max(ranks, 1))) for res in results):
        fail("%s: missing rank results:\n%s" % (modes, outs[0][-4000:]))
    own = max(sum(res[r]["wall_s"] for res in results) for r in results[0])
    log("%s over %d rank(s): %.1f s from the start of the processes, the "
        "ranks' own work %.1f s at most (the rest their start-up)"
        % (modes, ranks, time.time() - t0, own))
    return [[res[r] for r in sorted(res)] for res in results]


def run_ranks(mode, out, argv, ranks):
    """One job over `ranks` processes (`run_jobs`) -> its records by
    rank."""
    return run_jobs([(mode, out, argv)], ranks)[0]


def host_data_time(root, dev):
    """10a: the recipe trainer's BigFile readers must gather natively; the
    host side of one recipe epoch (the train loader's gathers and the
    stacking into super-batches of 8 x 8, as the trainer's prefetch thread
    runs them) timed with the native gather and with the memmap, in turns
    native, memmap, memmap, native after a warm-up pass."""
    from fancyrec_tpu_torch.config import build_train_parser, config_from_args
    from fancyrec_tpu_torch.data.loader import BatchLoader
    from fancyrec_tpu_torch.train import trainer

    cfg = config_from_args(build_train_parser().parse_args(
        instance_args(root, "host_data", 1)))
    train = trainer.build_datasets(cfg)["train"]
    cfg.finalize()
    readers = (train.video_feat, train.img_feat)
    engines = [r.engine for r in readers]
    log("10a: the trainer's train readers gather with %s" % engines)
    if engines != ["native", "native"]:
        fail("the trainer's BigFile readers do not use the native gather "
             "(%s): this host has g++" % engines)
    natives = [r._native for r in readers]

    def epoch(native):
        for r, gather in zip(readers, natives):
            r._native = gather if native else None
        loader = BatchLoader(train, B_TRAIN, shuffle=True, seed=cfg.seed)
        t0 = time.perf_counter()
        count = sum(1 for _ in trainer._superbatches(loader, ACCUM))
        return time.perf_counter() - t0, count

    epoch(True)
    times = {"native": [], "memmap": []}
    for native in (True, False, False, True):
        dt, n = epoch(native)
        times["native" if native else "memmap"].append(dt)
    for r, gather in zip(readers, natives):
        r._native = gather
    rec = {k: statistics.mean(v) for k, v in times.items()}
    log("10a: host data time of one recipe epoch (%d super-batches of %d x "
        "%d posts, %d-d frames): native gather %.4f s (%s), memmap %.4f s "
        "(%s)" % (n, ACCUM, B_TRAIN, D_IN, rec["native"],
                  ", ".join("%.4f" % t for t in times["native"]),
                  rec["memmap"],
                  ", ".join("%.4f" % t for t in times["memmap"])))
    return rec


def k4_record(dev, b, n, d, name, path, tag, seed=SEED + 12):
    """K4 at b x n x d (a path's shape: a rank's shard of the test split,
    the small tree's whole split, the dry run's post shard): kernel vs
    plain, timed beside cuBLAS's one-call cosine."""
    import torch
    import torch.nn.functional as F
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores_cuda, cosine_scores_ref)

    g = torch.Generator(device=dev).manual_seed(seed)
    brands, posts = _cosine_case(g, dev, b, n, d)
    with torch.no_grad():
        err = _cosine_err(cosine_scores_cuda(brands, posts),
                          cosine_scores_ref(brands, posts))
        if not err <= K4_TOL:
            fail("cosine_scores at %s disagrees with its plain version: %.3g "
                 "> %g" % (tag, err, K4_TOL))
        rec = {"name": name, "counter": "cosine_scores",
               "route": "cuda",
               "source": "fancyrec_tpu_torch/csrc/cosine_scores.cu",
               "replaces": "fancyrec_tpu/ops/similarity.py:108",
               "max_abs_err": err,
               "ms": statistics.median(cuda_ms(lambda: cosine_scores_cuda(
                   brands, posts), 50) for _ in range(3)),
               "plain_ms": cuda_ms(lambda: cosine_scores_ref(brands, posts),
                                   20),
               "library_ms": statistics.median(cuda_ms(
                   lambda: F.normalize(brands) @ F.normalize(posts).T, 50)
                   for _ in range(3)),
               "path": path,
               **roofline(4 * (b * d + n * d + b * n), 2 * b * n * d,
                          F32_FLOPS)}
    log("cosine_scores %d x %d x %d (%s): kernel %.4f ms, plain %.4f ms, "
        "cuBLAS %.4f ms, bound %.4f ms (%s); max err %.3g"
        % (b, n, d, tag, rec["ms"], rec["plain_ms"], rec["library_ms"],
           rec["bound_ms"], rec["bound_by"], err))
    return rec


def _states_equal(a, b):
    """Tensors of two dumps bit for bit -> the names that differ."""
    import torch
    return [k for k in a if not torch.equal(a[k], b[k])]


def update_diff(one, other, l_one, l_other):
    """Two first-update dumps (`_RANK_MAIN`'s .first.pt) and their losses
    -> (the differences phase 5's card tolerances bound, a log text, within
    them?): grads per tensor relative to the tensor's largest (floored at
    1e-4 of the model's largest), params (Adam's first step: 2 lr apart at
    most), the values that moved apart by more than lr / 2, the BatchNorm
    statistics and the queue."""
    top = max(g.abs().max().item() for g in one["grads"].values())
    rel = {n: (other["grads"][n] - g).abs().max().item()
           / max(g.abs().max().item(), 1e-4 * top)
           for n, g in one["grads"].items()}
    worst = sorted(rel, key=rel.get, reverse=True)[:3]
    p_err = max((other["params"][n] - p).abs().max().item()
                for n, p in one["params"].items())
    b_err = max((other["buffers"][n] - b).abs().max().item()
                for n, b in one["buffers"].items())
    q_err = (other["queue"] - one["queue"]).abs().max().item()
    flips = sum(int(((other["params"][n] - p).abs() > LR / 2).sum())
                for n, p in one["params"].items())
    text = ("loss %.3g apart; grads max |diff| / max |grad| per tensor %.3g "
            "(tolerance %g; worst %s); params max |diff| %.3g, %d values "
            "moved apart by more than lr/2 (tolerance %g); BN statistics "
            "%.3g, queue %.3g apart"
            % (abs(l_other - l_one), rel[worst[0]], STEP_TOL,
               ", ".join("%s %.3g" % (n, rel[n]) for n in worst), p_err,
               flips, 2 * LR * 1.001, b_err, q_err))
    ok = (abs(l_other - l_one) <= STEP_TOL * max(1.0, abs(l_one))
          and rel[worst[0]] <= STEP_TOL and p_err <= 2 * LR * 1.001
          and b_err <= STEP_TOL and q_err <= STEP_TOL)
    return text, ok


def data_parallel_path(root, dev, sass, host_tree, one_jobs=()):
    """Phase 10: data parallelism, --mesh_shape R,1, on the small tree
    `root` (a's timing on phase 5's tree, `host_tree`). c's one process
    then runs `one_jobs`, the one-process runs of later phases, so that
    their start-up is paid once.
      a. the native gather is in use; host data time native vs memmap;
      b. K1-fwd, K1-bwd and K2 at a rank's batch (B=4, full width) and K4
         at a rank's post shard (51 x 102), against their plain versions;
      c. the trainer CLI for one recipe epoch outside a world and in a
         world of one over NCCL: the first update and the checkpoint equal
         bit for bit;
      d. the same recipe over two ranks sharing the card (gloo) at
         --mesh_shape 2,1: its first update within phase 5's card
         tolerances of c's one-process update of the same global batch;
         each rank launches K1-fwd, K1-bwd, K2-fwd, K2-bwd and K4;
      e. the tester CLI over two ranks on d's checkpoint: each rank's
         encoded posts (all of them, after the sharded encode's gather and
         scatter) equal the one-process tester's within ENC_TOL, and its
         eight metrics equal the one-process tester's on the same
         checkpoint; and the ranks' ranking_metrics_sharded over a score
         matrix with ties and pad posts equals the oracle exactly.
    Every trainer run has the dropouts off (each rank draws its own masks)
    and deterministic algorithms on. -> {"records", "train_counts",
    "eval_counts", "one_loss", "ones": one_jobs' records}, the counts
    summed over d's and e's ranks."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.eval import tester
    from fancyrec_tpu_torch.eval.metrics import ranking_metrics_oracle
    from fancyrec_tpu_torch.train import checkpoints

    t_phase = time.time()
    data_time = host_data_time(host_tree, dev)
    records = k1_records(dev, B_RANK, torch.float32, True, SEED + 11)
    records += check_aspect_dropout(dev, B_RANK, sass)[0]
    for r in records:
        r["path"] = "data-parallel training"
    records.append(k4_record(
        dev, N_BRANDS, N_SMALL // DP_RANKS, DIM, "cosine_scores_shard",
        "data-parallel evaluation", "10b, a rank's shard of the test split"))
    torch.cuda.empty_cache()

    flags = ["--dropout", "0", "--bert_dropout", "0", "--device", str(dev)]
    # e's tester runs in d's world, after d's trainer
    logdir = os.path.join(root, "model", "dp_dp2")
    targv = ["insCartest", "--rootpath", root, "--logger_name", logdir,
             "--batch_size", str(B_ENC), "--device", str(dev), "--overwrite",
             "1"]
    mesh = ["--mesh_shape", "%d,1" % DP_RANKS]

    def trainer_job(name, extra=()):
        return ("train", os.path.join(root, "dp_" + name), instance_args(
            root, "dp_" + name, 1) + flags + list(extra))
    # c's two runs side by side (their times then show results, not speed;
    # the bit-for-bit comparison holds either way), then d's world, which
    # runs e's tester after its trainer
    first = start_jobs([trainer_job("one")] + list(one_jobs), 0, of=2)
    world1 = start_jobs([trainer_job("world1")], 1, of=2)
    runs = {}
    runs["one"], *ones = finish_jobs(first)
    runs["world1"] = finish_jobs(world1)[0]
    runs["dp2"], tested = run_jobs([
        trainer_job("dp2", mesh),
        ("test", os.path.join(root, "dp_test"), targv + mesh)], DP_RANKS)
    for name, ranks in (("one", 0), ("world1", 1), ("dp2", DP_RANKS)):
        for r in runs[name]:
            log("10%s: %s rank %d/%d (%s, device %s): %d updates, %.1f ms per "
                "update (the first update's dump excluded), device peak %.2f "
                "GB, %.1f s wall; first update loss %.6f, grad norm %.6f; "
                "engines %s; launches %s"
                % ("c" if ranks < 2 else "d", name, r["rank"], r["world"],
                   r["backend"], r["device"], r["updates"], r["ms_per_update"],
                   r["peak_bytes"] / 1e9, r["wall_s"], r["loss"],
                   r["grad_norm"], r["engines"], r["counts"]))
            if r["engines"] != ["native"]:
                fail("a rank gathered with %s, not the native gather"
                     % r["engines"])
    if not (runs["world1"][0]["world"] == 1
            and runs["world1"][0]["backend"] == (
                "nccl" if dev.type == "cuda" else "gloo")):
        fail("10c did not run in a world of one over NCCL: %s"
             % runs["world1"][0])
    if [r["backend"] for r in runs["dp2"]] != ["gloo"] * DP_RANKS:
        fail("10d's ranks share a card and must use gloo: %s"
             % [r["backend"] for r in runs["dp2"]])
    first = {k: torch.load(os.path.join(root, "dp_%s.first.pt" % k))
             for k in runs}

    # c. a world of one: bit for bit
    diff = {part: _states_equal(first["one"][part], first["world1"][part])
            for part in ("params", "grads", "buffers")}
    diff["queue"] = not torch.equal(first["one"]["queue"],
                                    first["world1"]["queue"])
    ckpt = {k: checkpoints.load_checkpoint(os.path.join(
        root, "model", "dp_" + k, "model_best.pth.tar"))
        for k in ("one", "world1")}
    diff["checkpoint"] = _states_equal(ckpt["one"]["state_dict"],
                                       ckpt["world1"]["state_dict"])
    opt_a, opt_b = (c["optimizer"]["state"] for c in ckpt.values())
    diff["optimizer"] = [k for k in opt_a if any(
        not torch.equal(opt_a[k][m], opt_b[k][m]) for m in opt_a[k])]
    log("10c: world of one over NCCL vs no world: first update and "
        "checkpoint differ in %s" % ({k: v for k, v in diff.items() if v}
                                     or "nothing (bit for bit)"))
    if any(diff.values()):
        fail("a world of one gives another update than no world: %s" % diff)
    if runs["one"][0]["result"] != runs["world1"][0]["result"]:
        fail("10c: best %r in a world of one vs %r without"
             % (runs["world1"][0]["result"], runs["one"][0]["result"]))

    # d. two ranks against one process, the same global batch
    one, dp = first["one"], first["dp2"]
    text, ok = update_diff(one, dp, runs["one"][0]["loss"],
                           runs["dp2"][0]["loss"])
    log("10d: %d ranks vs one process, first update: %s" % (DP_RANKS, text))
    if not ok:
        fail("the %d-rank update disagrees with the one-process update"
             % DP_RANKS)
    bests = [r["result"] for r in runs["dp2"]]
    if len(set(bests)) != 1:
        fail("the ranks report different bests: %s" % bests)
    micro = runs["dp2"][0]["updates"] * ACCUM
    for r in runs["dp2"]:
        c = r["counts"]
        if not (c["gru_scan"] >= micro and c["gru_scan_bwd"] == micro
                and c["aspect_dropout_fwd"] == micro
                and c["aspect_dropout_bwd"] == micro
                and c["cosine_scores"] == 1):
            fail("rank %d launched %s for %d microbatches and one "
                 "validation" % (r["rank"], c, micro))
    del first, one, dp, ckpt

    # e. the tester over two ranks (in d's world) and in this process, d's
    # checkpoint
    seen = {}
    ranking = tester.test_post_ranking

    def record(model, brand_num, post_embs, brands, device):
        seen.update(post_embs=post_embs, brands=brands)
        return ranking(model, brand_num, post_embs, brands, device)

    tester.test_post_ranking = record
    try:
        t0 = time.time()
        single = tester.main(targv)._asdict()
        single_s = time.time() - t0
    finally:
        tester.test_post_ranking = ranking
    # the sharded encode against the one-process encode: every rank holds
    # every post's embedding, at its post
    for r in tested:
        enc = np.load(os.path.join(root, "dp_test.enc.%d.npz" % r["rank"]))
        err = float(np.abs(enc["post_embs"] - seen["post_embs"]).max())
        log("10e: tester rank %d's encoded posts vs one process's: brands "
            "%s, embeddings max |diff| %.3g (tolerance atol %g rtol %g)"
            % (r["rank"], "equal" if np.array_equal(
                enc["brands"], seen["brands"]) else "DIFFER", err,
               ENC_TOL["atol"], ENC_TOL["rtol"]))
        if not np.array_equal(enc["brands"], seen["brands"]):
            fail("tester rank %d scattered the brands to other posts"
                 % r["rank"])
        np.testing.assert_allclose(enc["post_embs"], seen["post_embs"],
                                   **ENC_TOL)
    for r in tested:
        log("10e: tester rank %d/%d: %.2f s wall, device peak %.2f GB; %s; "
            "launches %s" % (r["rank"], r["world"], r["wall_s"],
                             r["peak_bytes"] / 1e9, r["result"], r["counts"]))
        if not all(r["counts"][k] >= 1 for k in ("gru_scan", "cosine_scores")):
            fail("tester rank %d launched %s" % (r["rank"], r["counts"]))
    rank_keys, score_keys = ("medr", "meanr", "r1", "r5", "r10"), (
        "auc", "ndcg10", "ndcg50")
    got = tested[0]["result"]
    diff = max(abs(got[k] - single[k]) for k in score_keys)
    log("10e: the one-process tester on the same checkpoint: %.2f s wall; "
        "%s; rank metrics %s, AUC/NDCG max |diff| %.3g (tolerance 1e-6)"
        % (single_s, single, "equal" if all(got[k] == single[k]
                                            for k in rank_keys) else "DIFFER",
           diff))
    if tested[1]["result"] != got:
        fail("the tester's ranks report different metrics")
    scores, labels = tie_scores()
    live = labels >= 0
    want = {k: float(v) for k, v in ranking_metrics_oracle(
        scores[:, live], labels[live], scores.shape[0])._asdict().items()}
    log("10e: ranking_metrics_sharded over %d ranks on the card, %d x %d "
        "scores with ties and 2 pad posts: %s the oracle's %s"
        % (DP_RANKS, scores.shape[0], scores.shape[1],
           "equal to" if all(r["sharded"] == want for r in tested)
           else "DIFFERENT from", want))
    if not all(r["sharded"] == want for r in tested):
        fail("the sharded metrics %s differ from the oracle's %s"
             % ([r["sharded"] for r in tested], want))
    if not (all(got[k] == single[k] for k in rank_keys) and diff <= 1e-6
            and all(math.isfinite(v) for v in got.values())):
        fail("the %d-rank tester's metrics %s differ from one process's %s"
             % (DP_RANKS, got, single))
    sums = lambda rs: {k: sum(r["counts"][k] for r in rs)  # noqa: E731
                       for k in rs[0]["counts"]}
    log("data-parallel phase in %.1f s; host data time %s"
        % (time.time() - t_phase, json.dumps(data_time)))
    return {"records": records, "train_counts": sums(runs["dp2"]),
            "eval_counts": sums(tested), "one_loss": runs["one"][0]["loss"],
            "ones": ones}


# ---------------------------------------------------------------------------
# phase 11: tensor parallelism, the model mesh axis
# ---------------------------------------------------------------------------

TP_MODEL = 2                  # model ranks of 11b-d (two ranks on the card)


def check_k2_shards(dev, sass):
    """11a: K2 on aspect shards of the 2000-aspect table, at M = 2 and 4
    model ranks, for B = 8 (the recipe's microbatch at (1, M)) and B = 4
    (at (2, M)): each shard's kernels against their plain versions on the
    last shard (`check_aspect_dropout`), and for every shard: its forward's
    keep bits equal the one-table kernel's bits of its aspects bit for bit,
    and the shards' outputs sum to the one-table kernel's output within
    K2_TOL. -> {M: the records at M}."""
    import torch
    from fancyrec_tpu_torch.ops import brand_dropout as bd

    records = {}
    for m in (TP_MODEL, 4):
        records[m] = []
        for b in (B_TRAIN, B_RANK):
            records[m] += check_aspect_dropout(dev, b, sass, model_axis=m)[0]
            g = torch.Generator(device=dev).manual_seed(SEED + 20 + b)
            w = torch.randn(b, N_ASPECTS, generator=g, device=dev)
            asp = torch.randn(N_ASPECTS, DIM, generator=g, device=dev)
            with torch.no_grad():
                out, bits = bd.aspect_dropout_fwd_cuda(w, asp, K2_SEED, KEEP,
                                                       with_bits=True)
                n, total = N_ASPECTS // m, torch.zeros_like(out)
                for r in range(m):
                    cols = slice(r * n, (r + 1) * n)
                    o, sb = bd.aspect_dropout_fwd_cuda(
                        w[:, cols].contiguous(), asp[cols].contiguous(),
                        K2_SEED, KEEP, with_bits=True, a_total=N_ASPECTS,
                        a_off=r * n)
                    if not torch.equal(sb, bits[:, cols]):
                        fail("K2 shard %d of %d at B=%d: keep bits differ "
                             "from the one-table kernel's in %d words"
                             % (r, m, b, int((sb != bits[:, cols]).sum())))
                    total += o
                err = (total - out).abs().max().item()
            log("11a: K2 at M=%d, B=%d: each of the %d shards' keep bits "
                "equal the one-table kernel's bits of its aspects bit for "
                "bit; the shards' outputs sum to the one-table output within "
                "%.3g (tolerance %g)" % (m, b, m, err, K2_TOL))
            if not err <= K2_TOL:
                fail("K2's shard outputs do not sum to the one-table output")
    return records


def tp_one_jobs(root, step_tree, dev):
    """The one-process updates of 11b (every dropout on, from the seed, on
    the small tree `root`) and 11c (dropouts off, on phase 5's tree), as
    `run_jobs` jobs."""
    flags = ["--device", str(dev)]
    return [("step_drop", os.path.join(root, "tpd_one"),
             instance_args(root, "tpd_one", 1) + flags),
            ("step", os.path.join(step_tree, "tp_one"),
             instance_args(step_tree, "tp_one", 1) + flags
             + ["--dropout", "0", "--bert_dropout", "0"])]


def tensor_parallel_path(root, dev, sass, l_one, step_tree, ones, also=()):
    """Phase 11: tensor parallelism, --mesh_shape R,M, on the small tree
    `root` (after phase 10, whose one-process first update it compares
    with), c on phase 5's tree `step_tree`. ones: the records of
    `tp_one_jobs`, run in phase 10's one process; also: jobs of later
    phases at (1, 2), which b's world runs after its own.
      a. K2 on aspect shards (`check_k2_shards`);
      b. the trainer CLI for one recipe epoch at --mesh_shape 1,2, two
         ranks sharing the card (gloo), every dropout off: its first update
         (whole, gathered over the model group) within phase 5's card
         tolerances of phase 10c's one-process update of the same batch,
         K1-fwd, K1-bwd, K2 (at A = 1000) and K4 launched on each rank; then
         one update with every dropout on (the brand dropout through K2 on
         the shards) at (1, 2) against one process from the same seed;
      c. one update at --mesh_shape 2,2, four ranks on the card, against
         a one-process update of the same batch, on phase 5's tree: the
         small tree's first super-batch holds a two-ulp near-tie in the
         text conv bank's max-pool (microbatch 2, row 2, window 3, channel
         131: 1.3612071 against 1.3612068), which the (2, 2) sum order
         flips, moving that channel's weight grad by 0.6%; a step costs
         the same on either tree;
      d. the tester CLI at (1, 2) on b's checkpoint: its metrics equal the
         one-process tester's, and the ranks' sharded metrics of the tie
         matrix the oracle's.
    l_one: the loss of 10c's one-process first update.
    -> {"records": the K2 shard records of the paths, "m4": the K2 records
    at M = 4 (on no main path), "train_counts", "step_counts",
    "eval_counts", "also": also's records}, the counts summed over b's,
    c's and d's ranks."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.eval import tester
    from fancyrec_tpu_torch.eval.metrics import ranking_metrics_oracle

    t_phase = time.time()
    shard_recs = check_k2_shards(dev, sass)
    records = []
    for r in shard_recs[TP_MODEL]:
        r["path"] = ("tensor-parallel training" if r["shape"][0] == B_TRAIN
                     else "tensor-parallel step 2x2")
        records.append(r)
    torch.cuda.empty_cache()
    one = torch.load(os.path.join(root, "dp_one.first.pt"))
    flags = ["--device", str(dev)]
    off = ["--dropout", "0", "--bert_dropout", "0"]
    shape = "1,%d" % TP_MODEL

    # the worlds: the (1, 2) ranks run b's trainer, b's update with every
    # dropout on and d's tester in turn (then `also`); the (2, 2) ranks c's
    # update
    logdir = os.path.join(root, "model", "tp_12")
    targv = ["insCartest", "--rootpath", root, "--logger_name", logdir,
             "--batch_size", str(B_ENC), "--device", str(dev), "--overwrite",
             "1"]
    mesh = ["--mesh_shape", shape]
    # (the two worlds side by side: their times show results, not speed)
    world12 = start_jobs([
        ("train", os.path.join(root, "tp_12"),
         instance_args(root, "tp_12", 1) + flags + off + mesh),
        ("step_drop", os.path.join(root, "tpd_tp"),
         instance_args(root, "tpd_tp", 1) + flags + mesh),
        ("test", os.path.join(root, "tp_test"), targv + mesh)]
        + list(also), TP_MODEL, of=3 * TP_MODEL)
    step = finish_jobs(start_jobs([("step", os.path.join(
        step_tree, "tp_22"), instance_args(step_tree, "tp_22", 1) + flags
        + off + ["--mesh_shape", "2,%d" % TP_MODEL])], 2 * TP_MODEL,
        of=3 * TP_MODEL))[0]
    tp, drop_tp, tested, *later = finish_jobs(world12)
    drop_one, ref = ones

    # b. the trainer CLI at (1, 2), dropouts off
    micro = tp[0]["updates"] * ACCUM
    for r in tp:
        log("11b: trainer at --mesh_shape %s, rank %d/%d (%s, device %s): %d "
            "updates, %.1f ms per update (the first update's dump excluded), "
            "device peak %.2f GB, %.1f s wall; first update loss %.6f, grad "
            "norm %.6f; launches %s"
            % (shape, r["rank"], r["world"], r["backend"], r["device"],
               r["updates"], r["ms_per_update"], r["peak_bytes"] / 1e9,
               r["wall_s"], r["loss"], r["grad_norm"], r["counts"]))
        c = r["counts"]
        if not (c["gru_scan"] >= micro and c["gru_scan_bwd"] == micro
                and c["aspect_dropout_fwd"] == micro
                and c["aspect_dropout_bwd"] == micro
                and c["cosine_scores"] == 1):
            fail("rank %d launched %s for %d microbatches and one "
                 "validation" % (r["rank"], c, micro))
    if len({r["result"] for r in tp}) != 1:
        fail("the model ranks report different bests: %s"
             % [r["result"] for r in tp])
    text, ok = update_diff(one, torch.load(os.path.join(
        root, "tp_12.first.pt")), l_one, tp[0]["loss"])
    log("11b: (1, %d) vs one process (phase 10c), first update: %s"
        % (TP_MODEL, text))
    if not ok:
        fail("the (1, %d) update disagrees with the one-process update"
             % TP_MODEL)
    # the same with every dropout on, one update from the same seed
    drop = {"one": drop_one, "tp": drop_tp}
    text, ok = update_diff(
        torch.load(os.path.join(root, "tpd_one.first.pt")),
        torch.load(os.path.join(root, "tpd_tp.first.pt")),
        drop["one"][0]["loss"], drop["tp"][0]["loss"])
    log("11b: every dropout on (towers 0.2, BERT 0.1, brand 0.5 in K2 on the "
        "shards), (1, %d) vs one process from the same seed: %s; K2 "
        "launches %s; update %.2f s (one) / %.2f s (rank 0, the first "
        "update of a process); device peak %.2f / %.2f GB"
        % (TP_MODEL, text, [r["counts"]["aspect_dropout_fwd"]
                            for r in drop["tp"]],
           drop["one"][0]["result"]["update_s"],
           drop["tp"][0]["result"]["update_s"],
           drop["one"][0]["peak_bytes"] / 1e9,
           drop["tp"][0]["peak_bytes"] / 1e9))
    if not ok:
        fail("the (1, %d) update with dropouts on disagrees with one "
             "process's" % TP_MODEL)

    # c. (2, 2): four ranks, one update, against one process's update of
    # the same batch, both on phase 5's tree
    del one
    text, ok = update_diff(
        torch.load(os.path.join(step_tree, "tp_one.first.pt")),
        torch.load(os.path.join(step_tree, "tp_22.first.pt")),
        ref[0]["loss"], step[0]["loss"])
    log("11c: (2, %d) vs one process (phase 5's tree), first update: %s; per "
        "rank: device peak %s GB, update %s s (the first of a process), "
        "launches %s"
        % (TP_MODEL, text, ["%.2f" % (r["peak_bytes"] / 1e9) for r in step],
           ["%.2f" % r["result"]["update_s"] for r in step],
           [r["counts"] for r in step]))
    if not ok:
        fail("the (2, %d) update disagrees with the one-process update"
             % TP_MODEL)
    for r in step:
        c = r["counts"]
        if not (c["aspect_dropout_fwd"] == ACCUM
                and c["aspect_dropout_bwd"] == ACCUM
                and c["gru_scan_bwd"] == ACCUM):
            fail("(2, %d) rank %d launched %s for %d microbatches"
                 % (TP_MODEL, r["rank"], c, ACCUM))

    # d. the tester at (1, 2) on b's checkpoint, against this process's
    t0 = time.time()
    single = tester.main(targv)._asdict()
    single_s = time.time() - t0
    rank_keys, score_keys = ("medr", "meanr", "r1", "r5", "r10"), (
        "auc", "ndcg10", "ndcg50")
    got = tested[0]["result"]
    diff = max(abs(got[k] - single[k]) for k in score_keys)
    scores, labels = tie_scores()
    live = labels >= 0
    want = {k: float(v) for k, v in ranking_metrics_oracle(
        scores[:, live], labels[live], scores.shape[0])._asdict().items()}
    for r in tested:
        log("11d: tester at --mesh_shape %s, rank %d/%d: %.2f s wall, device "
            "peak %.2f GB; %s; launches %s"
            % (shape, r["rank"], r["world"], r["wall_s"],
               r["peak_bytes"] / 1e9, r["result"], r["counts"]))
        if not all(r["counts"][k] >= 1 for k in ("gru_scan", "cosine_scores")):
            fail("tester rank %d launched %s" % (r["rank"], r["counts"]))
    log("11d: the one-process tester on the same checkpoint: %.2f s wall; %s; "
        "rank metrics %s, AUC/NDCG max |diff| %.3g (tolerance 1e-6); the "
        "ranks' sharded tie-matrix metrics %s the oracle's"
        % (single_s, single, "equal" if all(got[k] == single[k]
                                            for k in rank_keys) else "DIFFER",
           diff, "equal to" if all(r["sharded"] == want for r in tested)
           else "DIFFERENT from"))
    if any(r["result"] != got for r in tested):
        fail("the tester's model ranks report different metrics")
    if not all(r["sharded"] == want for r in tested):
        fail("the sharded metrics at (1, %d) differ from the oracle's"
             % TP_MODEL)
    if not (all(got[k] == single[k] for k in rank_keys) and diff <= 1e-6
            and all(math.isfinite(v) for v in got.values())):
        fail("the (1, %d) tester's metrics %s differ from one process's %s"
             % (TP_MODEL, got, single))
    sums = lambda rs: {k: sum(r["counts"][k] for r in rs)  # noqa: E731
                       for k in rs[0]["counts"]}
    log("tensor-parallel phase in %.1f s" % (time.time() - t_phase))
    return {"records": records, "m4": shard_recs[4],
            "train_counts": sums(tp), "step_counts": sums(step),
            "eval_counts": sums(tested), "also": later}


# ---------------------------------------------------------------------------
# phase 12: sharded serving, one process holding post shards
# ---------------------------------------------------------------------------

SHARDS = (2, 4)      # 12a's shard counts on the card; 12b and 12c take 4
SERVE_SHARDS = 4
# 12a's edges (N, D, S, k): the last shard without a valid row and k > N;
# rows of 132 bytes (4-byte copies) and N % S != 0; k = 128 over 2 shards
SHARD_EDGES = ((9, 1024, 4, 10), (1001, 132, 4, 10), (999, 256, 2, 128))
# the ranked build's rows against the one-process build's: the card's
# encode tolerance (the ranks encode 64-row slices, one process 128 rows)
RANK_BUILD_TOL = ENC_TOL


def shard_plain(q, shards, invs, k, n_valid, size):
    """The plain version of a sharded query: `topk_int8_ref` on each shard
    over its valid rows, the indices made global, one stable sort."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import _topk_desc, topk_int8_ref
    vals, idxs = [], []
    for s, (p, inv) in enumerate(zip(shards, invs)):
        local = min(max(n_valid - s * size, 0), size)
        v, i = topk_int8_ref(q.to(p.device), p, inv, k, local)
        vals.append(v.to(q.device))
        idxs.append((i + s * size).to(q.device))
    v, sel = _topk_desc(torch.cat(vals, 1), k)
    return v, torch.gather(torch.cat(idxs, 1), 1, sel.long())


def sharded_query(q, shards, invs, k, n_valid, size):
    """`distributed_retrieval_topk` on K3 -> (vals, idxs, K3 launches)."""
    from fancyrec_tpu_torch.ops.similarity import (
        distributed_retrieval_topk, topk_int8_cuda)
    before = topk_int8_cuda.launches
    v, i = distributed_retrieval_topk(q, shards, k, n_valid=n_valid,
                                      shard_size=size, posts_inv=invs,
                                      fused=True)
    return v, i, topk_int8_cuda.launches - before


def check_k3_shard_edges(dev):
    """12a's edges: the sharded query against one K3 call over the same
    rows (equal indices, bit-equal values, wherever a post ranks) and
    against the plain per-shard version (every slot)."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.ops.similarity import (
        quantize_rows_int8_np, topk_int8_cuda)
    from fancyrec_tpu_torch.serving.index import shard_rows

    rng = np.random.default_rng(SEED + 12)
    for n, d, n_shards, k in SHARD_EDGES:
        rows, inv = quantize_rows_int8_np(rng.standard_normal(
            (n, d), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((7, d), dtype=np.float32)
                             ).to(dev)
        shards, invs = shard_rows(rows, inv, (dev,) * n_shards)
        size = shards[0].shape[0]
        v, i, launches = sharded_query(q, shards, invs, k, n, size)
        ov, oi = topk_int8_cuda(q, torch.from_numpy(rows).to(dev),
                                torch.from_numpy(inv).to(dev), k)
        pv, pi = shard_plain(q, shards, invs, k, n, size)
        fin = torch.isfinite(ov)
        if launches != n_shards:
            fail("a query over %d shards launched K3 %d times"
                 % (n_shards, launches))
        if not (torch.equal(torch.isfinite(v), fin)
                and torch.equal(i[fin], oi[fin])
                and torch.equal(v[fin], ov[fin])):
            fail("the sharded query N=%d D=%d S=%d k=%d differs from one K3 "
                 "call" % (n, d, n_shards, k))
        if not torch.equal(i, pi) or not torch.allclose(
                v, pv, rtol=0, atol=K3_TOL):
            fail("the sharded query N=%d D=%d S=%d k=%d differs from its "
                 "plain version" % (n, d, n_shards, k))
        log("12a edge N=%d D=%d S=%d (shards of %d rows, valid %s) k=%d: "
            "equal to one K3 call and to the plain per-shard version"
            % (n, d, n_shards, size, [min(max(n - s * size, 0), size)
                                      for s in range(n_shards)], k))


def check_k3_shards(idx, dev):
    """12a: `distributed_retrieval_topk` over phase 4's index in S = 2 and
    4 shards on the card: K3 launched S times a call, the answer bit-equal
    to one K3 call over the whole index and equal to the plain per-shard
    version; the CUDA-event ms of each shard's K3 beside its bytes bound,
    of the merge and of the whole call. -> ([{shards, call_ms, merge_ms,
    shard: [{rows, ms, bound_ms, bound_by}]} an S], one K3 call's answer as
    numpy)."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import _topk_desc, topk_int8_cuda
    from fancyrec_tpu_torch.parallel.mesh import ServingMesh
    from fancyrec_tpu_torch.serving.index import PostIndex

    check_k3_shard_edges(dev)
    one = PostIndex(idx, quantize="int8", device=str(dev))
    n = one.n_posts
    q = torch.from_numpy(one.brand_embs).to(dev)
    b = q.shape[0]
    with torch.no_grad():
        ov, oi = topk_int8_cuda(q, one.posts(), one._posts_inv, TOPK, n)
        one_ms = cuda_ms(lambda: topk_int8_cuda(q, one.posts(),
                                                one._posts_inv, TOPK, n), 20)
    del one
    torch.cuda.empty_cache()
    log("12a: one K3 call over the whole index (%d x %d x %d, k=%d): %.4f "
        "ms (run H: 0.4722)" % (b, n, DIM, TOPK, one_ms))
    records = []
    for n_shards in SHARDS:
        idx_s = PostIndex(idx, quantize="int8",
                          mesh=ServingMesh((dev,) * n_shards))
        shards, invs, size = idx_s.posts(), idx_s._posts_inv, idx_s.shard_size
        valid = [min(max(n - s * size, 0), size) for s in range(n_shards)]
        with torch.no_grad():
            v, i, launches = sharded_query(q, shards, invs, TOPK, n, size)
            pv, pi = shard_plain(q, shards, invs, TOPK, n, size)
            if launches != n_shards:
                fail("a query over %d shards launched K3 %d times"
                     % (n_shards, launches))
            if not (torch.equal(i, oi) and torch.equal(v, ov)):
                fail("the query over %d shards differs from one K3 call"
                     % n_shards)
            if not torch.equal(pi, i) or not torch.allclose(
                    v, pv, rtol=0, atol=K3_TOL):
                fail("the query over %d shards differs from its plain "
                     "version" % n_shards)
            err = (v - pv).abs().max().item()
            call_ms = uncounted(lambda: cuda_ms(lambda: sharded_query(
                q, shards, invs, TOPK, n, size), 20))
            shard_ms, cands = [], []
            for p, inv, nv in zip(shards, invs, valid):
                shard_ms.append(uncounted(lambda: cuda_ms(
                    lambda: topk_int8_cuda(q, p, inv, TOPK, nv), 20)))
                cands.append(uncounted(
                    lambda: topk_int8_cuda(q, p, inv, TOPK, nv)))
            cv = torch.cat([c[0] for c in cands], 1)
            ci = torch.cat([c[1] for c in cands], 1)
            merge_ms = cuda_ms(lambda: torch.gather(
                ci, 1, _topk_desc(cv, TOPK)[1].long()), 20)
        per = []
        for s, (ms, nv) in enumerate(zip(shard_ms, valid)):
            bound = roofline(4 * q.numel() + nv * DIM + 4 * nv
                             + 8 * b * TOPK, 2 * b * nv * DIM, INT8_OPS)
            per.append({"rows": nv, "ms": ms, **bound})
            log("12a: S=%d, shard %d (%d valid rows): K3 %.4f ms, bound "
                "%.4f ms (%s)" % (n_shards, s, nv, ms, bound["bound_ms"],
                                  bound["bound_by"]))
        records.append({"shards": n_shards, "call_ms": call_ms,
                        "merge_ms": merge_ms, "shard": per})
        log("12a: S=%d: K3 launched %d times a call; the answer bit-equal to "
            "one K3 call, indices equal to the plain per-shard version "
            "(max |diff| %.3g, tolerance %g); whole call %.4f ms, the merge "
            "%.4f ms, the shards' K3 summed %.4f ms"
            % (n_shards, launches, err, K3_TOL, call_ms, merge_ms,
               sum(shard_ms)))
        del idx_s, shards, invs, cands
        torch.cuda.empty_cache()
    return records, {"vals": ov.cpu().numpy(), "idxs": oi.cpu().numpy()}


def sharded_service(idx, phase4, single, dev):
    """12b, the main path of the slice: `FancyRecService` over 4 post
    shards on the card, /v1/topk for all 51 brands 21 times over HTTP (the
    first a warm-up): the answers equal phase 4's service's and 12a's one
    K3 call's; then /v1/add and a query that sees the new post."""
    import numpy as np
    from fancyrec_tpu_torch.parallel.mesh import ServingMesh
    from fancyrec_tpu_torch.serving.server import FancyRecService

    t0 = time.time()
    service = FancyRecService(idx, quantize="int8",
                              mesh=ServingMesh((dev,) * SERVE_SHARDS))
    index = service.index
    log("12b: int8 service over %d shards of %d rows up: %.1f s"
        % (SERVE_SHARDS, index.shard_size, time.time() - t0))
    server, thread = serve(service)
    try:
        port = server.server_port
        body = {"brand_ids": list(range(N_BRANDS)), "k": TOPK}
        lat, replies = [], []
        for _ in range(N_REQUESTS):
            t0 = time.perf_counter()
            replies.append(http(port, "POST", "/v1/topk", body))
            lat.append((time.perf_counter() - t0) * 1e3)
        n_before = index.n_posts
        new = (index.brand_embs[0] * 5.0).tolist()
        added = http(port, "POST", "/v1/add", {
            "cap_ids": ["sharded0000000#enc#0"], "embeddings": [new],
            "brands": [0]})
        after = http(port, "POST", "/v1/topk", {"brand_ids": [0], "k": TOPK})
    finally:
        stop(server, thread)
    steady = np.array(lat[1:])
    log("12b: /v1/topk, %d brands x k=%d over %d int8 posts in %d shards: "
        "first %.2f ms; next %d: p50 %.2f ms, p99 %.2f ms"
        % (N_BRANDS, TOPK, n_before, SERVE_SHARDS, lat[0], len(steady),
           float(np.percentile(steady, 50)), float(np.percentile(steady,
                                                                  99))))
    want = [[p["cap_id"] for p in r["posts"]] for r in phase4["results"]]
    for reply in replies:
        got = [[p["cap_id"] for p in r["posts"]] for r in reply["results"]]
        if got != want:
            fail("the sharded service's posts differ from phase 4's")
        for b, r in enumerate(reply["results"]):
            names = [index.cap_ids[i] for i in single["idxs"][b]]
            if [p["cap_id"] for p in r["posts"]] != names or [
                    p["score"] for p in r["posts"]] != [
                        float(v) for v in single["vals"][b]]:
                fail("the sharded service's answer for brand %d differs "
                     "from one K3 call's" % b)
    log("12b: every answer equals phase 4's service's posts and one K3 "
        "call's posts and scores")
    top = after["results"][0]["posts"][0]["cap_id"]
    if (added["n_posts"] != n_before + 1 or top != "sharded0000000#enc#0"
            or index.shard_size != -(-(n_before + 1) // SERVE_SHARDS)
            or len(index.posts()) != SERVE_SHARDS):
        fail("after /v1/add the sharded service answered %s (n_posts %s)"
             % (top, added))
    log("12b: /v1/add -> %d posts, re-sharded into %d shards of %d rows; the "
        "next query ranks the new post first" % (added["n_posts"],
                                                 SERVE_SHARDS,
                                                 index.shard_size))
    return {"p50_ms": float(np.percentile(steady, 50)),
            "p99_ms": float(np.percentile(steady, 99))}


def sharded_ivf(idx, dev):
    """12c: phase 4b's IVF sidecar with its lists over 4 shards on the card
    against the same sidecar unsharded: 8 single-brand queries at nprobe 8
    and 64, both probe modes, equal; a query's ms on the host clock."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch.parallel.mesh import ServingMesh
    from fancyrec_tpu_torch.serving.ivf import IVFIndex

    side = os.path.join(idx, "ivf")
    one = IVFIndex.load(side, device=dev)
    four = IVFIndex.load(side, device=dev).shard_to_mesh(
        ServingMesh((dev,) * SERVE_SHARDS))
    qs = np.load(os.path.join(idx, "brand_embeddings.npy"))[:8]

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    for probe in ("cosine", "bound"):
        for npb in (8, 64):
            v1, i1 = one.query(qs, k=TOPK, nprobe=npb, probe=probe)
            v4, i4 = four.query(qs, k=TOPK, nprobe=npb, probe=probe)
            if not (np.array_equal(i1, i4) and np.array_equal(v1, v4)):
                fail("the IVF query over %d list shards at nprobe %d (%s) "
                     "differs from the unsharded one" % (SERVE_SHARDS, npb,
                                                         probe))
            ms1 = host_ms(lambda: one.query(qs[:1], k=TOPK, nprobe=npb,
                                            probe=probe))
            ms4 = host_ms(lambda: four.query(qs[:1], k=TOPK, nprobe=npb,
                                             probe=probe))
            log("12c: IVF %s nprobe %d, 8 brands: %d list shards equal to "
                "one; 1 brand %.3f ms sharded, %.3f ms unsharded (host "
                "clock, mean of 20)" % (probe, npb, SERVE_SHARDS, ms4, ms1))
    del one, four
    torch.cuda.empty_cache()


def ranked_build_job(phase4, dev):
    """12d's job for `run_jobs`: `index build` at --mesh_shape 2,1 on phase
    4's collection and checkpoint into index_2rank beside phase 4's
    index."""
    work = os.path.dirname(phase4["idx"])
    return ("build", os.path.join(work, "rank_build"), [
        "build", os.path.join(work, "index_2rank"), "--checkpoint",
        phase4["ckpt"], "--rootpath", phase4["root"], "--collection",
        "insCartrain", "--batch_size", str(B_ENC), "--device", dev.type,
        "--mesh_shape", "2,1"])


def ranked_build(phase4, ranks):
    """12d: `index build` over two ranks sharing the card (gloo,
    --mesh_shape 2,1; run in 12e's world, `ranks` its records) on phase
    4's collection and checkpoint: the cap ids of phase 4's one-process
    build in its order, the rows within RANK_BUILD_TOL, K1 launched on
    each rank. -> the ranks' summed launches."""
    import numpy as np
    from fancyrec_tpu_torch.io.bigfile import BigFileReader

    out = os.path.join(os.path.dirname(phase4["idx"]), "index_2rank")
    wall = max(r["wall_s"] for r in ranks)
    n = phase4["n_built"]
    got, want = (BigFileReader(out, delimiter="\t"),
                 BigFileReader(phase4["idx"], delimiter="\t"))
    rows = got.read_rows(np.arange(got.nr_of_rows))
    ref = want.read_rows(np.arange(n))
    for r in ranks:
        log("12d: build rank %d/%d (%s): %.2f s wall, device peak %.2f GB, "
            "launches %s" % (r["rank"], r["world"], r["backend"], r["wall_s"],
                             r["peak_bytes"] / 1e9, r["counts"]))
        if r["counts"]["gru_scan"] != -(-n // B_ENC):
            fail("build rank %d launched gru_scan %d times for %d batches"
                 % (r["rank"], r["counts"]["gru_scan"], -(-n // B_ENC)))
    if got.names != want.names[:n]:
        fail("the ranked build's cap ids differ from one process's")
    err = float(np.abs(rows - ref).max())
    log("12d: index build over %d ranks, %d posts: %.1f s (the ranks' "
        "build); cap ids in the one-process order, rows max |diff| %.3g "
        "(tolerance atol %g, rtol %g)" % (DP_RANKS, got.nr_of_rows, wall,
                                          err, RANK_BUILD_TOL["atol"],
                                          RANK_BUILD_TOL["rtol"]))
    np.testing.assert_allclose(rows, ref, **RANK_BUILD_TOL)
    load = lambda d, f: np.load(os.path.join(d, f))  # noqa: E731
    if not np.array_equal(load(out, "brands.npy"),
                          load(phase4["idx"], "brands.npy")[:n]):
        fail("the ranked build's brand labels differ from one process's")
    np.testing.assert_allclose(load(out, "brand_embeddings.npy"),
                               load(phase4["idx"], "brand_embeddings.npy"),
                               **RANK_BUILD_TOL)
    return {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}


def ranked_query(idx, single, dev, then):
    """12e: `index query --quantize int8 --mesh_shape 2,1` for the 51
    brands (k=10) over two ranks sharing the card (gloo), each holding its
    500,001 of the 1,000,001 rows and launching K3 once: every rank's
    answer bit-equal to 12a's one K3 call over the whole index (which 12a
    found bit-equal to its S = 2 answer), only the primary printing; then
    `--nprobe 8` over the same ranks (each holding its slot's IVF lists)
    equal to the unsharded sidecar's answer. The sidecar, stale since
    4b's append, is built again first. Each rank's K3 ms (CUDA events)
    beside its bytes bound, and the ms of gathering its candidates: the
    ranks share the card, so these show results, not speed. `then`: a job
    the same world runs after the queries. -> (the ranks' summed launches
    of the exact query, then's records)."""
    import numpy as np
    from fancyrec_tpu_torch.io.bigfile import BigFileReader
    from fancyrec_tpu_torch.serving import index as sindex
    from fancyrec_tpu_torch.serving.ivf import IVFIndex

    t0 = time.time()
    info = cli_json(sindex.main, ["ivf-build", idx, "--quantize", "int8",
                                  "--device", str(dev)])
    log("12e: ivf-build over the %d posts again: %.1f s" % (info["posts"],
                                                          time.time() - t0))
    names = BigFileReader(idx, delimiter="\t").names
    brands = list(range(N_BRANDS))
    argv = ["query", idx, "--brands", ",".join(map(str, brands)), "--k",
            str(TOPK), "--quantize", "int8", "--device", dev.type,
            "--mesh_shape", "%d,1" % DP_RANKS]
    out = os.path.join(os.path.dirname(idx), "ranked_query")
    ranks, after = run_jobs([("query", out, [argv, argv + ["--nprobe", "8"]]),
                             then], DP_RANKS)
    want = [[names[i] for i in row] for row in single["idxs"]]
    ivf = IVFIndex.load(os.path.join(idx, "ivf"), device=dev)
    iv, ii = ivf.query(np.load(os.path.join(idx, "brand_embeddings.npy")),
                       k=TOPK, nprobe=8)
    want_ivf = [[names[i] if i >= 0 else None for i in row] for row in ii]
    del ivf
    for r in ranks:
        exact, probed = r["result"]["runs"]
        got = r["result"]
        log("12e: query rank %d/%d (%s): K3 launched %d times, %d rows "
            "held; K3 on its %d valid rows %.4f ms, bound %.4f ms (%s); the "
            "candidates' gather %.3f ms; --nprobe 8: %s lists held; printed "
            "%d and %d lines; %.1f s wall, device peak %.2f GB"
            % (r["rank"], r["world"], r["backend"], exact["k3"],
               exact["rows"], got["local_rows"], got["k3_ms"],
               got["bound_ms"], got["bound_by"], got["gather_ms"],
               probed["lists"], exact["lines"], probed["lines"], r["wall_s"],
               r["peak_bytes"] / 1e9))
        vals = np.load("%s.0.%d.npy" % (out, r["rank"]))
        if exact["k3"] != 1 or exact["rows"] != -(-len(names) // DP_RANKS):
            fail("12e rank %d launched K3 %d times over %s rows"
                 % (r["rank"], exact["k3"], exact["rows"]))
        if not (np.array_equal(vals, single["vals"])
                and exact["names"] == want):
            fail("12e rank %d's answer differs from one K3 call's"
                 % r["rank"])
        pv = np.load("%s.1.%d.npy" % (out, r["rank"]))
        if not (np.array_equal(pv, iv) and probed["names"] == want_ivf):
            fail("12e rank %d's --nprobe 8 answer differs from the "
                 "unsharded sidecar's" % r["rank"])
        lines = N_BRANDS if r["rank"] == 0 else 0
        if (exact["lines"], probed["lines"]) != (lines, lines):
            fail("12e rank %d printed %s lines" % (
                r["rank"], (exact["lines"], probed["lines"])))
    log("12e: query over %d ranks, %d brands x k=%d: every rank's answer "
        "bit-equal to one K3 call's (and so to 12a's S=%d answer), --nprobe "
        "8 equal to the unsharded sidecar's, only the primary printed"
        % (DP_RANKS, N_BRANDS, TOPK, DP_RANKS))
    return ({k: sum(r["counts"][k] for r in ranks)
             for k in ranks[0]["counts"]}, after)


def sharded_serving_path(phase4, dev):
    """Phase 12: sharded serving on phase 4's index (a-e above; e before
    b's append, d in e's world); launch counts zeroed just before 12b and
    read just after (12d's and 12e's ranks count their own)."""
    import torch
    t_phase = time.time()
    idx = phase4["idx"]
    records, single = check_k3_shards(idx, dev)
    torch.cuda.empty_cache()
    # 12e before 12b's append: 12a's answer is over the same rows (each
    # rank counts its own launches)
    # 12e's world runs 12d's build after its queries
    ranked_counts, build_ranks = ranked_query(idx, single, dev,
                                              ranked_build_job(phase4, dev))
    log("12e: ranked serving path launches (summed over the ranks): %s"
        % ranked_counts)
    zero_counts()
    served = sharded_service(idx, phase4["reply"], single, dev)
    serve_counts = read_counts()
    log("12b: sharded serving path launches: %s" % serve_counts)
    torch.cuda.empty_cache()
    sharded_ivf(idx, dev)
    build_counts = ranked_build(phase4, build_ranks)
    log("12d: ranked build path launches (summed over the ranks): %s"
        % build_counts)
    expect = SERVE_SHARDS * (N_REQUESTS + 1)
    if serve_counts["topk_int8"] != expect:
        fail("the sharded service launched K3 %d times, not %d"
             % (serve_counts["topk_int8"], expect))
    log("sharded serving phase in %.1f s" % (time.time() - t_phase))
    return {"per_shard": records, "serve_counts": serve_counts,
            "build_counts": build_counts, "ranked_counts": ranked_counts,
            **served}


# ---------------------------------------------------------------------------
# phase 13: sequence parallelism and the BERT pipeline over the model axis
# ---------------------------------------------------------------------------

PP_STAGES = 3      # the recipe's 3 BERT layers, one a stage
B_PP = 12          # a batch the 3 microbatches divide (bin/instance.sh's 8
                   # does not)
B_PP_TEST = 96     # the tester's batch at (1, 3): 3 microbatches of 32


def _launch_check(ranks, micro, what):
    """Each rank ran K1-fwd on every microbatch and validation batch,
    K1-bwd and K2 once a microbatch, K4 once (the validation)."""
    for r in ranks:
        c = r["counts"]
        if not (c["gru_scan"] >= micro and c["gru_scan_bwd"] == micro
                and c["aspect_dropout_fwd"] == micro
                and c["aspect_dropout_bwd"] == micro
                and c["cosine_scores"] == 1):
            fail("%s rank %d launched %s for %d microbatches and one "
                 "validation" % (what, r["rank"], c, micro))


def _split_check(ranks, micro, what, seq=0, pipe=0):
    """Each rank's towers called `seq_shard_pool` `seq` times and BERT's
    pipeline `pipe` times a training microbatch: the split code ran, not
    the replicated pools or the sequential stack it falls back to."""
    for r in ranks:
        c = r["split_calls"]
        log("%s rank %d: seq_shard_pool %d in training, %d in evaluation; "
            "bert_pipeline_forward %d / %d" % (
                what, r["rank"], *c["seq_shard_pool"],
                *c["bert_pipeline_forward"]))
        if (c["seq_shard_pool"][0] != seq * micro
                or c["bert_pipeline_forward"][0] != pipe * micro):
            fail("%s rank %d split %s for %d microbatches (want the time "
                 "split %d and the pipeline %d a microbatch)"
                 % (what, r["rank"], c, micro, seq, pipe))


def _log_train(tag, what, ranks):
    for r in ranks:
        log("%s: %s, rank %d/%d (%s): %d updates, %.1f ms per update (the "
            "first update's dump excluded), device peak %.2f GB, %.1f s "
            "wall; first update loss %.6f, grad norm %.6f; launches %s (an "
            "update: K1-bwd %.3g, K2-fwd %.3g, K2-bwd %.3g)"
            % (tag, what, r["rank"], r["world"], r["backend"], r["updates"],
               r["ms_per_update"], r["peak_bytes"] / 1e9, r["wall_s"],
               r["loss"], r["grad_norm"], r["counts"],
               *(r["counts"][k] / max(r["updates"], 1) for k in (
                   "gru_scan_bwd", "aspect_dropout_fwd",
                   "aspect_dropout_bwd"))))


def sp_job(root, dev):
    """13a's trainer at --mesh_shape 1,2 --seq_shard, a `run_jobs` job."""
    return ("train", os.path.join(root, "sp_12"), instance_args(
        root, "sp_12", 1) + ["--device", str(dev), "--dropout", "0",
                             "--bert_dropout", "0", "--mesh_shape", "1,2",
                             "--seq_shard"])


def pp_one_job(root, dev):
    """13b's one-process update at batch 12, a `run_jobs` job."""
    return ("step", os.path.join(root, "pp_one"), instance_args(
        root, "pp_one", 1) + ["--device", str(dev), "--dropout", "0",
                              "--bert_dropout", "0", "--batch_size",
                              str(B_PP)])


def seq_pp_path(root, dev, sass, l_one, sp=None, one=None):
    """Phase 13: --seq_shard and --pp_stages over the model axis, on the
    small tree (phase 10's), the ranks sharing the card (gloo), every
    dropout off, deterministic algorithms on. First K1-fwd, K1-bwd and K2
    at b's batch of 12, K1-fwd at c's of 96 and K4 at c's 51 x 204 against
    their plain versions (a's shapes are phase 5's and 11's: B = 8, K2 on
    1000 aspects); then
      a. the trainer CLI for one recipe epoch at --mesh_shape 1,2
         --seq_shard (batch 8): its first update within phase 5's card
         tolerances of phase 10c's one-process update of the same batch,
         the time split run twice a microbatch (visual, text);
      b. the trainer CLI for one epoch at --mesh_shape 1,3 --pp_stages 3
         --batch_size 12 (the recipe's 3 BERT layers, one a stage): its
         first update against a one-process update of the same batch of
         12, the pipeline run once a microbatch, BERT and its Adam
         moments bit-equal on the 3 ranks after two updates; the tensors
         the rules split at 3;
      c. the tester at (1, 3) on b's checkpoint (batch 96, so 3
         microbatches of 32; BERT's pipeline run) against this process's
         tester.
    l_one: the loss of 10c's one-process first update; sp, one: the records
    of `sp_job` and `pp_one_job` where earlier worlds ran them (run here
    when None). -> {"records": the
    kernels at batch 12 and 96 and K4's, "train_counts", "pp_counts",
    "eval_counts"}, the counts summed over a's, b's and c's ranks."""
    import torch
    from fancyrec_tpu_torch.eval import tester
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.parallel.mesh import Mesh
    from fancyrec_tpu_torch.train import checkpoints

    t_phase = time.time()
    records = k1_records(dev, B_PP, torch.float32, True, SEED + 31)
    records += check_aspect_dropout(dev, B_PP, sass)[0]
    for r in records:
        r["path"] = "pipeline training"
    # the tester's batch of c (its last batch padded to it)
    records += k1_records(dev, B_PP_TEST, torch.float32, False, SEED + 32)
    records[-1]["path"] = "pipeline evaluation"
    # K4 on the small tree's whole test split, as each stage of c ranks it
    records.append(k4_record(dev, N_BRANDS, N_SMALL, DIM,
                             "cosine_scores_small", "pipeline evaluation",
                             "13c, the small tree's test split"))
    torch.cuda.empty_cache()
    flags = ["--device", str(dev), "--dropout", "0", "--bert_dropout", "0"]

    # a. --seq_shard at (1, 2)
    if sp is None:
        sp = run_ranks(*sp_job(root, dev), 2)
    _log_train("13a", "trainer at --mesh_shape 1,2 --seq_shard", sp)
    _launch_check(sp, sp[0]["updates"] * ACCUM, "13a")
    _split_check(sp, sp[0]["updates"] * ACCUM, "13a", seq=2)
    if len({r["result"] for r in sp}) != 1:
        fail("13a: the model ranks report different bests")
    text, ok = update_diff(torch.load(os.path.join(root, "dp_one.first.pt")),
                           torch.load(os.path.join(root, "sp_12.first.pt")),
                           l_one, sp[0]["loss"])
    log("13a: (1, 2) --seq_shard vs one process (phase 10c), first update: "
        "%s" % text)
    if not ok:
        fail("the --seq_shard update disagrees with the one-process update")

    # b. --pp_stages 3 at (1, 3), batch 12, against one process
    batch = ["--batch_size", str(B_PP)]
    if one is None:
        one = run_ranks(*pp_one_job(root, dev), 0)
    # the (1, 3) ranks run b's trainer, then c's tester on its checkpoint
    logdir = os.path.join(root, "model", "pp_13")
    targv = ["insCartest", "--rootpath", root, "--logger_name", logdir,
             "--batch_size", str(B_PP_TEST), "--device", str(dev),
             "--overwrite", "1"]
    mesh = ["--mesh_shape", "1,%d" % PP_STAGES]
    pp, tested = run_jobs([
        ("train", os.path.join(root, "pp_13"), instance_args(
            root, "pp_13", 1) + flags + batch + mesh + [
                "--pp_stages", str(PP_STAGES)]),
        ("test", os.path.join(root, "pp_test"), targv + mesh)], PP_STAGES)
    _log_train("13b", "trainer at --mesh_shape 1,%d --pp_stages %d, batch "
               "%d" % (PP_STAGES, PP_STAGES, B_PP), pp)
    _launch_check(pp, pp[0]["updates"] * ACCUM, "13b")
    _split_check(pp, pp[0]["updates"] * ACCUM, "13b", pipe=1)
    if len({r["result"] for r in pp}) != 1:
        fail("13b: the stages report different bests")
    text, ok = update_diff(torch.load(os.path.join(root, "pp_one.first.pt")),
                           torch.load(os.path.join(root, "pp_13.first.pt")),
                           one[0]["loss"], pp[0]["loss"])
    log("13b: (1, %d) --pp_stages %d vs one process at batch %d (%.2f s, "
        "device peak %.2f GB), first update: %s"
        % (PP_STAGES, PP_STAGES, B_PP, one[0]["result"]["update_s"],
           one[0]["peak_bytes"] / 1e9, text))
    if not ok:
        fail("the pipelined update disagrees with the one-process update")
    digests = [r.get("bert_digest") for r in pp]
    log("13b: BERT and its Adam moments after two updates, sha256 a rank: "
        "%s (%s)" % ([d[:16] if d else d for d in digests],
                     "bit-equal" if len(set(digests)) == 1 and digests[0]
                     else "DIFFER"))
    if not digests[0] or len(set(digests)) != 1:
        fail("BERT differs across the pipeline's stages after two updates")
    ck = checkpoints.load_checkpoint(os.path.join(
        root, "model", "pp_13", "model_best.pth.tar"))
    with torch.device("meta"):
        model = FancyRec(ck["config"], Mesh(1, PP_STAGES))
    split = sorted(k for k, d in model.split_dims().items() if d is not None)
    log("13b: the rules at a model axis of %d under --pp_stages split %s; "
        "every other tensor whole on each rank (BERT as the pipeline's: "
        "%s)" % (PP_STAGES, split or "nothing", model.pp))
    del ck, model

    # c. the tester at (1, 3) on b's checkpoint (in b's world)
    t0 = time.time()
    single = tester.main(targv)._asdict()
    single_s = time.time() - t0
    rank_keys, score_keys = ("medr", "meanr", "r1", "r5", "r10"), (
        "auc", "ndcg10", "ndcg50")
    got = tested[0]["result"]
    diff = max(abs(got[k] - single[k]) for k in score_keys)
    for r in tested:
        log("13c: tester at --mesh_shape 1,%d, rank %d/%d: %.2f s wall, "
            "device peak %.2f GB; %s; launches %s"
            % (PP_STAGES, r["rank"], r["world"], r["wall_s"],
               r["peak_bytes"] / 1e9, r["result"], r["counts"]))
        if not all(r["counts"][k] >= 1 for k in ("gru_scan", "cosine_scores")):
            fail("tester rank %d launched %s" % (r["rank"], r["counts"]))
        if r["split_calls"]["bert_pipeline_forward"][1] < 1:
            fail("tester rank %d did not run BERT's pipeline: %s"
                 % (r["rank"], r["split_calls"]))
    log("13c: the one-process tester on the same checkpoint: %.2f s wall; "
        "%s; rank metrics %s, AUC/NDCG max |diff| %.3g (tolerance 1e-6)"
        % (single_s, single, "equal" if all(got[k] == single[k]
                                            for k in rank_keys) else "DIFFER",
           diff))
    if any(r["result"] != got for r in tested):
        fail("the tester's stages report different metrics")
    if not (all(got[k] == single[k] for k in rank_keys) and diff <= 1e-6
            and all(math.isfinite(v) for v in got.values())):
        fail("the (1, %d) tester's metrics %s differ from one process's %s"
             % (PP_STAGES, got, single))
    sums = lambda rs: {k: sum(r["counts"][k] for r in rs)  # noqa: E731
                       for k in rs[0]["counts"]}
    log("sequence-parallel and pipeline phase in %.1f s"
        % (time.time() - t_phase))
    return {"records": records, "train_counts": sums(sp),
            "pp_counts": sums(pp), "eval_counts": sums(tested)}


# ---------------------------------------------------------------------------
# phase 14: the flagship forward and the multi-rank dry run
# ---------------------------------------------------------------------------

DRY_RANKS = 4      # the dry run's world: (2, 2), the ranks sharing the card
# the dry run's tiny shapes on a rank: K1 at its 4 rows of 8 frames, H 16
# (32-d features); K2 on an aspect shard of 16 of 32 aspects, C 64; K4 at
# the 4 brands x a data slot's 32 posts x 16
DRY_B, DRY_T, DRY_H, DRY_D_IN, DRY_A, DRY_C = 4, 8, 16, 32, 32, 64
DRY_BRANDS, DRY_POSTS, DRY_D = 4, 32, 16


def flagship_path(dev, sass):
    """Phase 14: (a) `entry.entry()`, the flagship forward at full width
    (eval mode, the example batch of 8) on the card against the same
    forward on the CPU within ENC_TOL, K1-fwd launched in it (its record
    at B=8); (b) `entry.dryrun_multichip(4)`: four ranks sharing the card
    (gloo) at (2, 2) with --seq_shard and the config's dropouts: finite
    loss and grad norm, every rank's sharded metrics within 1e-5 of the
    gathered ones, pp_delta < 1e-4, and each rank launching K1-fwd,
    K1-bwd, K2-fwd, K2-bwd and K4 (each rank counts its own); K1, K2 and
    K4 at its tiny shapes against their plain versions first.
    -> {"records", "forward_counts", "dry_counts" (summed over the
    ranks)}."""
    import numpy as np
    import torch
    from fancyrec_tpu_torch import entry

    t_phase = time.time()
    records = k1_records(dev, B_TRAIN, torch.float32, False, SEED + 41)
    records[-1]["path"] = "flagship forward"
    zero_counts()
    t0 = time.time()
    fn, args = entry.entry(str(dev))
    brand_card, post_card = fn(*args)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    forward_counts = read_counts()
    t0 = time.time()
    fn, args = entry.entry("cpu")
    brand_cpu, post_cpu = fn(*args)
    cpu_s = time.time() - t0
    errs = [float((a.cpu() - b).abs().max()) for a, b in (
        (brand_card, brand_cpu), (post_card, post_cpu))]
    log("14a: the flagship forward (entry(), batch %d, full width): card "
        "%.1f s, CPU %.1f s (each with its model's set-up); brand %s, post "
        "%s; card vs CPU max |diff| %.3g / %.3g (tolerance atol %g rtol %g); "
        "launches %s" % (len(args[0]), card_s, cpu_s,
                         tuple(brand_card.shape), tuple(post_card.shape),
                         *errs, ENC_TOL["atol"], ENC_TOL["rtol"],
                         forward_counts))
    for a, b in ((brand_card, brand_cpu), (post_card, post_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **ENC_TOL)
    if forward_counts["gru_scan"] < 1:
        fail("the flagship forward did not launch K1: %s" % forward_counts)
    del fn, args, brand_card, post_card, brand_cpu, post_cpu
    torch.cuda.empty_cache()

    dry = k1_records(dev, DRY_B, torch.float32, True, SEED + 42, t=DRY_T,
                     h=DRY_H, d_in=DRY_D_IN, sfx="_dry")
    dry += check_aspect_dropout(dev, DRY_B, sass, model_axis=2,
                                a_total=DRY_A, c=DRY_C, sfx="_dry")[0]
    dry.append(k4_record(dev, DRY_BRANDS, DRY_POSTS, DRY_D,
                         "cosine_scores_dry", "multi-rank dry run",
                         "14b, a data slot's post shard"))
    for r in dry:
        r["path"] = "multi-rank dry run"
    t0 = time.time()
    got = entry.dryrun_multichip(DRY_RANKS)
    wall = time.time() - t0
    s = got["summary"]
    for r in got["ranks"]:
        log("14b: dry-run rank %d (%s, %s): launches %s; sharded metrics %s"
            % (r["rank"], r["backend"], r["device"], r["launches"],
               r["sharded_metrics"]))
        c = r["launches"]
        if not all(c[k] >= 1 for k in ("gru_scan", "gru_scan_bwd",
                                       "aspect_dropout_fwd",
                                       "aspect_dropout_bwd",
                                       "cosine_scores")):
            fail("dry-run rank %d launched %s" % (r["rank"], c))
        if any(abs(v - r["metrics"][k]) >= 1e-5
               for k, v in r["sharded_metrics"].items()):
            fail("dry-run rank %d: sharded metrics differ from the gathered "
                 "ones" % r["rank"])
        if r["summary"] != s:
            fail("the dry run's ranks report different summaries")
    if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
            and s["pp_delta"] < 1e-4
            and s["mesh"] == {"data": 2, "model": 2}):
        fail("the dry run's summary %s" % s)
    log("14b: dryrun_multichip(%d): %s; %.1f s (the world's wall)"
        % (DRY_RANKS, json.dumps(s), wall))
    dry_counts = {k: sum(r["launches"][k] for r in got["ranks"])
                  for k in got["ranks"][0]["launches"]}
    log("flagship and dry-run phase in %.1f s" % (time.time() - t_phase))
    return {"records": records + dry, "forward_counts": forward_counts,
            "dry_counts": dry_counts}


def main():
    t_script = time.time()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, HERE)
    try:
        import fancyrec_tpu_torch
        from fancyrec_tpu_torch.device import resolve_device
        from fancyrec_tpu_torch.ops import _build
        from fancyrec_tpu_torch.utils.fixture import make_fixture
    except ImportError as e:
        fail("the fancyrec_tpu_torch package is not beside this script (%s)"
             % e)
    if not os.path.abspath(fancyrec_tpu_torch.__file__).startswith(HERE):
        fail("fancyrec_tpu_torch imported from outside this checkout")

    # each phase's seconds, logged beside the whole script's
    spans, t_mark = {}, [t_script]

    def mark(phase):
        now = time.time()
        spans[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

    # 1. device
    smi_line = smi_name_power()
    dev = resolve_device("cuda")
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))

    # 2. build
    t0 = time.time()
    reports = _build.build(["gru_scan", "topk_int8", "aspect_dropout",
                            "cosine_scores", "moe_gemm"])
    log("kernels built in %.1f s" % (time.time() - t0))
    for name, rep in reports.items():
        for fn, line in ptxas_lines(rep):
            log("%s ptxas: %s: %s" % (name, fn, line))

    # 3. kernels vs their plain versions
    gru_bwd, fwd_b8 = check_gru_train(dev)
    sweep_gru_rows(dev)
    k2, sass = check_aspect_dropout(dev)
    kernels = [check_gru(dev), check_topk(dev), gru_bwd] + k2 + [
        check_cosine(dev)]
    check_edges(dev)
    k5 = check_moe(dev)
    torch.cuda.empty_cache()
    # the throughput mode's shapes: K1 (float32 on its path; bfloat16 off
    # it) and K2 at batch 64
    k1_fast, k1_bf16 = check_k1_fast(dev)
    kernels += k1_fast + check_aspect_dropout(dev, B_FAST, sass)[0]
    torch.cuda.empty_cache()

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        mark("1-3")
        # 4. the serving path, counts zeroed just before and read just after
        zero_counts()
        served = main_path(work, dev)
        serving = read_counts()
        log("serving path launches: %s" % serving)
        torch.cuda.empty_cache()
        mark("4")
        # 4b. the IVF sidecar of that index, served (K3 at B=1 on its exact
        # single-brand queries)
        zero_counts()
        ivf_path(served["idx"], dev)
        ivf_serving = read_counts()
        log("IVF serving path launches: %s" % ivf_serving)
        torch.cuda.empty_cache()
        mark("4b")
        # 4c. IVF recall and latency on a clustered 1M corpus
        ivf_clustered(dev)
        torch.cuda.empty_cache()
        mark("4c")
        # 4d. the exported artifact of phase 4's checkpoint, served
        zero_counts()
        export_path(work, served, dev)
        artifact = read_counts()
        log("artifact path launches: %s" % artifact)
        # phase 12 serves phase 4's index again
        phase4 = {k: served[k] for k in ("idx", "ckpt", "root", "n_built")}
        phase4["reply"] = served["reply"]
        del served
        torch.cuda.empty_cache()
        mark("4d")
        # 5. training: the card's step against the CPU's, then the trainer
        t0 = time.time()
        root = os.path.join(work, "insCarTrain")
        make_fixture(root, brand_num=N_BRANDS,
                     videos_per_brand=TRAIN_VIDEOS_PER_BRAND,
                     imgs_per_brand=TRAIN_IMGS_PER_BRAND, feat_dim=D_IN,
                     frames_per_video=FRAMES, seed=SEED)
        log("training fixture (train, val and test collections): %.1f s"
            % (time.time() - t0))
        train_step_card_vs_cpu(root, dev)
        torch.cuda.empty_cache()
        profile_update(root, dev)
        torch.cuda.empty_cache()
        # the trainer's device peak is its own, not phase 4c's corpus
        torch.cuda.reset_peak_memory_stats(dev)
        training, _ = train_path(root, dev)
        torch.cuda.empty_cache()
        mark("5")
        # 6. evaluation: the tester CLI on the trained checkpoint
        evaluation = tester_path(root, dev)
        torch.cuda.empty_cache()
        mark("6")
        # 7. the throughput mode: one bf16 update against the CPU's, remat,
        # then the trainer CLI (profiled) and the tester on its checkpoint
        bf16_step_card_vs_cpu(root, dev)
        torch.cuda.empty_cache()
        remat_card(root, dev)
        torch.cuda.empty_cache()
        fast, _ = fast_path(root, dev)
        torch.cuda.empty_cache()
        tester_path(root, dev, "fast")
        mark("7")
        # 8. a checkpoint the JAX package wrote, on the card
        frtpu1_card(dev)
        torch.cuda.empty_cache()
        mark("8")
        # 9. offline preprocessing: the ResNet-152 extractor and the
        # decode -> extract -> BigFile pipeline (cuDNN convolutions; none
        # of the six kernels is on this path, so its counts stay 0)
        zero_counts()
        preprocessing_path(os.path.join(work, "preprocess"), dev)
        log("preprocessing path launches: %s" % read_counts())
        torch.cuda.empty_cache()
        mark("9")
        # the rank worlds of phases 10-13 train and test on a smaller tree
        # of the same width: their checks read one or two updates
        t0 = time.time()
        small = os.path.join(work, "insCarSmall")
        make_fixture(small, brand_num=N_BRANDS,
                     videos_per_brand=SMALL_VIDEOS_PER_BRAND,
                     imgs_per_brand=SMALL_IMGS_PER_BRAND, feat_dim=D_IN,
                     frames_per_video=FRAMES, seed=SEED)
        log("the rank worlds' tree (%d posts a split): %.1f s"
            % (N_SMALL, time.time() - t0))
        # 10. data parallelism: the native gather, the kernels at a rank's
        # shapes, the trainer in a world of one and of two ranks, the
        # tester over two ranks (each rank counts its own launches)
        # 10c's one process also runs 11b's, 11c's and 13b's one-process
        # updates, and 11b's (1, 2) world 13a's trainer: a world's start-up
        # (mostly importing torch) is paid once
        dp = data_parallel_path(small, dev, sass, root, tp_one_jobs(
            small, root, dev) + [pp_one_job(small, dev)])
        kernels += dp["records"]
        torch.cuda.empty_cache()
        mark("10")
        # 11. tensor parallelism: K2 on aspect shards, the trainer at (1, 2)
        # and one update at (2, 2), the tester at (1, 2)
        tp = tensor_parallel_path(small, dev, sass, dp["one_loss"], root,
                                  dp["ones"][:2], [sp_job(small, dev)])
        kernels += tp["records"]
        torch.cuda.empty_cache()
        mark("11")
        # 12. sharded serving: K3 on post shards, the query over two ranks,
        # the sharded service, the IVF lists over shards, the index build
        # over two ranks
        sh = sharded_serving_path(phase4, dev)
        next(k for k in kernels if k["name"] == "topk_int8")[
            "per_shard"] = sh["per_shard"]
        torch.cuda.empty_cache()
        mark("12")
        # 13. sequence parallelism and the BERT pipeline: the trainer at
        # (1, 2) --seq_shard and at (1, 3) --pp_stages 3, the tester at
        # (1, 3) (each rank counts its own launches)
        sp = seq_pp_path(small, dev, sass, dp["one_loss"], tp["also"][0],
                         dp["ones"][2])
        kernels += sp["records"]
        # 13a runs K1 and K2 at the shapes of phase 5 and 11b, and 13c K4
        # at phase 6's
        for k in kernels:
            if (k.get("path") == "tensor-parallel training"
                    or k["name"] == "gru_scan_bwd"):
                k["path"] = (k.get("path", "training")
                             + "+sequence-parallel training")
        torch.cuda.empty_cache()
        mark("13")
        # 14. the flagship forward (card against CPU) and the multi-rank
        # dry run over four ranks (each counts its own launches)
        fl = flagship_path(dev, sass)
        kernels += fl["records"]
        mark("14")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("gru_scan forward at the training batch (B=%d): %.3f ms (cuDNN GRU "
        "forward %.3f ms); launches on the training path: %d"
        % (B_TRAIN, fwd_b8["ms"], fwd_b8["library_ms"], training["gru_scan"]))
    paths = {"serving": serving, "training": training,
             "evaluation": evaluation, "fast training": fast,
             "IVF serving": ivf_serving, "artifact": artifact,
             "data-parallel training": dp["train_counts"],
             "data-parallel evaluation": dp["eval_counts"],
             "tensor-parallel training": tp["train_counts"],
             "tensor-parallel step 2x2": tp["step_counts"],
             "tensor-parallel evaluation": tp["eval_counts"],
             "sharded serving": sh["serve_counts"],
             "ranked serving": sh["ranked_counts"],
             "flagship forward": fl["forward_counts"],
             "multi-rank dry run": fl["dry_counts"],
             "sequence-parallel training": sp["train_counts"],
             "pipeline training": sp["pp_counts"],
             "pipeline evaluation": sp["eval_counts"],
             "ranked index build": sh["build_counts"]}
    # K1-fwd also runs inside the exported programs and the ranks' index
    # build, K3 on the IVF path's exact single-brand queries, on the shards
    # of the sharded service and on each rank of the ranked query: their
    # records count those launches too
    home = {"gru_scan": "serving+artifact+ranked index build",
            "topk_int8": "serving+IVF serving+sharded serving+ranked serving",
            "cosine_scores": "evaluation"}
    for k in kernels:
        k.setdefault("path", home.get(k["name"], "training"))
        counter = k.get("counter", k["name"])
        by_path = {p: paths[p][counter] for p in k["path"].split("+")}
        k["launches"] = sum(by_path.values())
        if min(by_path.values()) < 1:
            fail("%s was not launched on its main path: %s"
                 % (k["name"], by_path))
        if len(by_path) > 1 or "tensor-parallel" in k["path"]:
            k["launches_by_path"] = by_path
    # the bf16 K1 runs on no main path: its numbers go on a line of their own
    for k in k1_bf16:
        k["launches"] = 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("K1 in bfloat16, on no main path (the fast mode runs K1 in float32, "
        "as the JAX package does): %s"
        % json.dumps([{k: r[k] for k in keys} for r in k1_bf16]))
    # K2 on the aspect shards of a model axis of 4: checked, on no main
    # path (phase 11 runs model axes of 2)
    log("K2 on aspect shards of M=4, on no main path: %s" % json.dumps(
        [json_record(r, keys[:4] + keys[5:] + ("entry_ms", "device_ms",
                                               "shape", "a_off"))
         for r in tp["m4"]], allow_nan=False))

    # K5's main path is the DeepSeek-V2 caption tower, which no phase here
    # trains (the benchmark's dsv2.train cell does): checked, on a line of
    # its own
    log("K5 on the DeepSeek-V2 caption tower's path (no phase here): %s"
        % json.dumps(json_record(k5, keys + ("forward_ms", "shape")),
                     allow_nan=False))
    log("the whole script in %.1f s; by phase (s): %s"
        % (time.time() - t_script, json.dumps(spans)))
    # the contract's keys, then, where a record has them, its C entry's time
    # on buffers made once, its kernels' device time, and its path
    print(json.dumps({"kernels": [
        json_record(kern, keys + ("entry_ms", "device_ms", "path",
                                  "launches_by_path", "shape", "a_total",
                                  "a_off", "per_shard"))
        for kern in kernels]}, allow_nan=False))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def seq_pp_cards():
    """`python3 chip_smoke.py seq_pp`: phase 13 alone, on a host with a
    card a rank (3 or more): the ranks of 13a-13c each take a card of
    their own and join over NCCL, so the pipeline's point-to-point
    messages and the model group's collectives stay on the cards. Builds
    the three kernels of the path, makes phase 10's small tree, runs 10c's
    one-process epoch (the reference of 13a) on the first card, then
    `seq_pp_path`."""
    import torch
    sys.path.insert(0, HERE)
    from fancyrec_tpu_torch.device import resolve_device
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.utils.fixture import make_fixture

    t0 = time.time()
    dev = resolve_device("cuda")
    if torch.cuda.device_count() < PP_STAGES:
        fail("seq_pp needs %d cards, this host has %d"
             % (PP_STAGES, torch.cuda.device_count()))
    log("%d x %s" % (torch.cuda.device_count(), smi_name_power()))
    _build.build(["gru_scan", "aspect_dropout", "cosine_scores"])
    work = os.path.join(HERE, "build", "chip_smoke_seq_pp")
    shutil.rmtree(work, ignore_errors=True)
    try:
        root = os.path.join(work, "insCarTrain")
        make_fixture(root, brand_num=N_BRANDS,
                     videos_per_brand=SMALL_VIDEOS_PER_BRAND,
                     imgs_per_brand=SMALL_IMGS_PER_BRAND, feat_dim=D_IN,
                     frames_per_video=FRAMES, seed=SEED)
        one = run_ranks("train", os.path.join(root, "dp_one"), instance_args(
            root, "dp_one", 1) + ["--dropout", "0", "--bert_dropout", "0",
                                  "--device", "cuda"], 0)
        log("10c: one process: %.1f ms per update, device peak %.2f GB"
            % (one[0]["ms_per_update"], one[0]["peak_bytes"] / 1e9))
        sp = seq_pp_path(root, dev, None, one[0]["loss"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"seq_pp": {k: v for k, v in sp.items()
                                 if k != "records"},
                      "cards": torch.cuda.device_count(),
                      "seconds": time.time() - t0}))


if __name__ == "__main__":
    if sys.argv[1:] == ["seq_pp"]:
        seq_pp_cards()
    else:
        main()
