#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths on one
NVIDIA GPU and check them.

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
     brand dropout's masks, as both of its kernels draw them, bit for bit
     against the plain Philox mask, and its integer work counted from the
     SASS; K3 at 51 x 1M x 1024 (two calls bit-identical, the quantization
     inside its C entry against the plain one, its kernels in one profiled
     call); edge shapes of every kernel (K3 up to 33,024 wide, its brands
     through its ring), and int8 indexes 30 wide (which K3 does not take)
     and 4096 wide (which it does) served on the card as on the CPU;
  4. serving, at the full width of the recipe model (bin/instance.sh)
     with random weights from a seed: build an index of a synthetic
     collection through `fancyrec_tpu_torch.serving.index build`, append
     random embeddings up to 1,000,000 posts (the /v1/add path), serve it
     int8 over HTTP and ask /v1/topk for all 51 brands. The served posts
     must equal the plain top-k, and a batch encoded on the card must
     match the same batch encoded on the CPU;
  5. training, at the same width: one train step of 2 microbatches on the
     card against the same step on the CPU; one update of 8 microbatches
     timed and profiled (device time by kernel group); then the trainer
     CLI for one epoch with bin/instance.sh's flags on a synthetic
     train/val/test tree, and an index built from the checkpoint it wrote;
  6. evaluation: the tester CLI (`fancyrec_tpu_torch.eval.tester`) on the
     checkpoint that 5's trainer wrote, over the test split; its eight
     metrics must be finite and equal those of the plain cosine of the
     same embeddings.
The kernels' launch counts are zeroed just before each of the three paths
(4, 5c and 6) and read just after: each kernel must have run on its path.

Prints a `kernels` JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero; without a
CUDA device, or without the package beside this script, it exits
non-zero before printing any result.
"""

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
K1_TOL = 1e-4     # float32; sum order over H=1024 and 64 recurrent steps
# training shapes: bin/instance.sh's batch of 8 and 2000 brand aspects; the
# brand dropout's keep probability and fixed seed words for the checks
B_TRAIN, N_ASPECTS, KEEP, K2_SEED = 8, 2000, 0.5, (0x2545F491, 0x9E3779B9)
ACCUM, LR = 8, 1e-4        # bin/instance.sh: 8 summed microbatches, Adam lr
# the training fixture: 8 videos of 64 frames and 8 images per brand in
# each of train, val and test (816 posts each: 12 updates an epoch)
TRAIN_VIDEOS_PER_BRAND, TRAIN_IMGS_PER_BRAND = 8, 8
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
K4_TOL = 2e-5     # float32 sums over D=1024 in another order; the JAX
                  # package's tolerance for its kernel (test_similarity_ops)
N_EVAL = N_BRANDS * (TRAIN_VIDEOS_PER_BRAND + TRAIN_IMGS_PER_BRAND)  # test
ENC_TOL = dict(atol=1e-4, rtol=1e-3)   # card vs CPU, float32, no TF32


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
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
            **roofline(nbytes, ops, INT8_OPS), "library_ms": None}


def topk_entry(brands, posts_q, posts_inv, k, n_valid=None):
    """K3's C entry on buffers made once, as the wrapper would call it:
    (a call of it, vals, idxs, scratch, plan). Not counted as a launch of
    the wrapper."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import (
        _sm_count, _topk_fn, topk_int8_args, topk_int8_plan)

    (b, d), dev = brands.shape, brands.device
    n_valid = posts_q.shape[0] if n_valid is None else n_valid
    plan = topk_int8_plan(b, n_valid, d, k, _sm_count(dev))
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


def device_ms(fn, calls):
    """The union of the intervals of the kernels that `calls` calls of fn
    launch, in torch.profiler, a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.end > e.time_range.start]
    return _union_ms(spans) / calls if spans else float("nan")


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
    from fancyrec_tpu_torch.ops.similarity import (
        _sm_count, cosine_scores_cuda, cosine_scores_ref, cosine_slices)

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = _sm_count(dev)
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


def cosine_entry_ms(brands, posts):
    """K4's launches through its C entry on buffers made once, back to
    back: the call without the wrapper's Python (its checks, allocations,
    stream lookup and, for the single pass, the brands' normalization),
    which holds the card at few posts. Not counted as a launch of the
    wrapper."""
    import torch
    from fancyrec_tpu_torch.ops.similarity import (
        _cosine_fn, _sm_count, cosine_scratch_len, cosine_slices)

    (b, d), n, dev = brands.shape, posts.shape[0], brands.device
    s = cosine_slices(b, n, d, _sm_count(dev))
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


def check_aspect_dropout(dev):
    """K2 at the training shape (B=8, A=2000, C=1024, keep 0.5): the masks
    that both kernels draw equal the plain Philox mask bit for bit, and
    outputs and grads agree with the plain versions."""
    import torch
    from fancyrec_tpu_torch.ops.brand_dropout import (
        aspect_dropout_bwd_cuda, aspect_dropout_bwd_ref,
        aspect_dropout_fwd_cuda, aspect_dropout_fwd_ref, dropout_mask,
        keep_threshold)

    b, a, c = B_TRAIN, N_ASPECTS, DIM
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    w = torch.randn(b, a, generator=g, device=dev)
    asp = torch.randn(a, c, generator=g, device=dev)
    gr = torch.randn(b, c, generator=g, device=dev)
    thr, scale = keep_threshold(a, KEEP)
    with torch.no_grad():
        want = torch.cat([dropout_mask(K2_SEED, thr, b, a, c, lo,
                                       min(lo + 250, a), dev)
                          for lo in range(0, a, 250)], dim=1)
        # isolate the mask each kernel draws: with w = 1 and one aspect row
        # of ones, out = s * m[:, a*, :]; with w one-hot in row b* and g = 1,
        # dasp = s * m[b*]
        ones_w = torch.ones(b, a, device=dev)
        row = torch.zeros(a, c, device=dev)
        got_f = torch.empty_like(want)
        for k in range(a):
            row[k] = 1.0
            got_f[:, k] = aspect_dropout_fwd_cuda(ones_w, row, K2_SEED, KEEP) > 0
            row[k] = 0.0
        got_b = torch.empty_like(want)
        for k in range(b):
            onehot = torch.zeros(b, a, device=dev)
            onehot[k] = 1.0
            got_b[k] = aspect_dropout_bwd_cuda(
                onehot, asp, torch.ones(b, c, device=dev), K2_SEED, KEEP)[1] > 0
        torch.cuda.synchronize()
        if not (torch.equal(got_f, want) and torch.equal(got_b, want)):
            fail("aspect dropout masks differ from the plain Philox mask: "
                 "forward %d, backward %d of %d elements"
                 % (int((got_f != want).sum()), int((got_b != want).sum()),
                    want.numel()))
        log("aspect_dropout: forward and backward kernel masks equal the "
            "plain mask bit for bit (%d elements, kept share %.5f)"
            % (want.numel(), want.float().mean().item()))
        out_k = aspect_dropout_fwd_cuda(w, asp, K2_SEED, KEEP)
        out_p = aspect_dropout_fwd_ref(w, asp, K2_SEED, KEEP)
        dw_k, dasp_k = aspect_dropout_bwd_cuda(w, asp, gr, K2_SEED, KEEP)
        dw_p, dasp_p = aspect_dropout_bwd_ref(w, asp, gr, K2_SEED, KEEP)
        torch.cuda.synchronize()
        err_f = (out_k - out_p).abs().max().item()
        err_b = max((dw_k - dw_p).abs().max().item(),
                    (dasp_k - dasp_p).abs().max().item())
        log("aspect_dropout: max |kernel - plain| forward %.3g, backward %.3g "
            "(tolerance %g)" % (err_f, err_b, K2_TOL))
        if not (err_f <= K2_TOL and err_b <= K2_TOL):
            fail("aspect dropout kernels disagree with their plain versions")
        fwd_ms = cuda_ms(lambda: aspect_dropout_fwd_cuda(w, asp, K2_SEED, KEEP),
                         50)
        bwd_ms = cuda_ms(lambda: aspect_dropout_bwd_cuda(w, asp, gr, K2_SEED,
                                                         KEEP), 50)
        fwd_plain = cuda_ms(lambda: aspect_dropout_fwd_ref(w, asp, K2_SEED,
                                                           KEEP), 3)
        bwd_plain = cuda_ms(lambda: aspect_dropout_bwd_ref(w, asp, gr, K2_SEED,
                                                           KEEP), 3)
    log("aspect_dropout: forward kernel %.4f ms (plain %.3f ms), backward "
        "kernel %.4f ms (plain %.3f ms)" % (fwd_ms, fwd_plain, bwd_ms,
                                            bwd_plain))
    # integer work: the SASS instructions of one Philox4x32-10 block and its
    # 4 keep compares (`philox_sass_ops`) by the pipe that issues them,
    # IMAD* on the FMA pipe and the rest (LOP3, IADD3, ISETP, ...) on the
    # ALU pipe, each 64 a clock an SM (the CUDA C Programming Guide's
    # throughput table for compute capability 9.0, against 256 float32
    # flops), the two pipes issuing side by side: the busier pipe bounds the
    # time, as do the products' float32 flops on theirs. Each integer
    # instruction of the busier pipe counts as F32_FLOPS / INT32_OPS flops
    pipes = philox_sass_ops()
    blocks = b * a * c // 4
    int_flops = blocks * max(pipes.values()) * F32_FLOPS / INT32_OPS
    bounds = [roofline(4 * (w.numel() + asp.numel() + out_k.numel()),
                       max(int_flops, 2 * b * a * c), F32_FLOPS),
              roofline(4 * (w.numel() + asp.numel() + gr.numel()
                            + dw_k.numel() + dasp_k.numel()),
                       max(int_flops, 4 * b * a * c), F32_FLOPS)]
    log("aspect_dropout: SASS instructions a Philox block with its 4 "
        "compares: %d on the FMA pipe, %d on the ALU pipe; %d blocks a call; "
        "bounds %.4f ms forward, %.4f ms backward (%s)"
        % (pipes["fma"], pipes["alu"], blocks, bounds[0]["bound_ms"],
           bounds[1]["bound_ms"], bounds[0]["bound_by"]))
    common = {"route": "cuda",
              "source": "fancyrec_tpu_torch/csrc/aspect_dropout.cu",
              "library_ms": None}
    return [
        {"name": "aspect_dropout_fwd",
         "replaces": "fancyrec_tpu/ops/brand_pallas.py:130",
         "max_abs_err": err_f, "ms": fwd_ms, "plain_ms": fwd_plain,
         **bounds[0], **common},
        {"name": "aspect_dropout_bwd",
         "replaces": "fancyrec_tpu/ops/brand_pallas.py:175",
         "max_abs_err": err_b, "ms": bwd_ms, "plain_ms": bwd_plain,
         **bounds[1], **common},
    ]


def philox_sass_ops():
    """SASS instructions that one Philox4x32-10 block and its 4 keep
    compares take in the built K2 source, by pipe: {"fma": the IMAD*
    instructions, "alu": the rest}. A probe kernel that calls its `keep4`
    once, against one that only loads and stores the same words, both
    compiled with the kernels' nvcc flags and read with cuobjdump."""
    import re
    from fancyrec_tpu_torch.ops import _build

    work = os.path.join(HERE, "build", "philox_probe")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "probe.cu")
    with open(src, "w") as f:
        f.write('#include "%s"\n' % os.path.join(_build.CSRC,
                                                  "aspect_dropout.cu")
                + "extern \"C\" __global__ void probe_keep4(const uint64_t* e,"
                " unsigned* out, uint2 key, uint32_t thr) {\n"
                "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
                "  out[i] = keep4(e[i] << 2, key, thr, true);\n}\n"
                "extern \"C\" __global__ void probe_base(const uint64_t* e,"
                " unsigned* out, uint2 key, uint32_t thr) {\n"
                "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
                "  out[i] = static_cast<unsigned>(e[i] << 2);\n}\n")
    cubin = os.path.join(work, "probe.cubin")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
         "-sass", cubin], check=True, capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"fma": 0, "alu": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn and m and m.group(1) != "NOP":
            counts[fn]["fma" if m.group(1).startswith("IMAD") else "alu"] += 1
    if not {"probe_keep4", "probe_base"} <= set(counts):
        fail("the Philox probe's SASS lacks its kernels: %s" % sorted(counts))
    return {p: counts["probe_keep4"][p] - counts["probe_base"][p]
            for p in ("fma", "alu")}


def check_edges(dev):
    """K1, K2 and K3 against their plain versions on the card at small
    shapes that the main paths do not reach: ragged tiles, bf16, exact
    ties, k above the valid rows, several brand tiles, odd D, odd aspect
    counts and column counts (K4's edges are in check_cosine)."""
    import torch
    from fancyrec_tpu_torch.ops.brand_dropout import (
        aspect_dropout_bwd_cuda, aspect_dropout_bwd_ref,
        aspect_dropout_fwd_cuda, aspect_dropout_fwd_ref)
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
    # aspect dropout: aspects not a multiple of the tile, columns not a
    # multiple of 4 and past one 1024-column chunk, keep = 1 against the
    # deterministic mean
    for b, a, c, keep in ((3, 37, 130, 0.7), (5, 50, 2050, 0.5),
                          (2, 16, 64, 1.0), (9, 33, 1027, 0.3)):
        w = torch.randn(b, a, generator=g, device=dev)
        asp = torch.randn(a, c, generator=g, device=dev)
        gr = torch.randn(b, c, generator=g, device=dev)
        seed = (b * 7919, c * 104729)
        pairs = [(aspect_dropout_fwd_cuda(w, asp, seed, keep),
                  aspect_dropout_fwd_ref(w, asp, seed, keep))]
        pairs += list(zip(aspect_dropout_bwd_cuda(w, asp, gr, seed, keep),
                          aspect_dropout_bwd_ref(w, asp, gr, seed, keep)))
        if keep == 1.0:
            pairs.append((pairs[0][0], (w @ asp) / a))
        err = max((x - y).abs().max().item() for x, y in pairs)
        if not err <= K2_TOL:
            fail("aspect_dropout B=%d A=%d C=%d keep=%g: max err %.3g > %g"
                 % (b, a, c, keep, err, K2_TOL))
    torch.cuda.synchronize()
    check_topk_edges(dev)
    check_int8_routing(dev)
    log("edge shapes: every kernel agrees with its plain version")


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
    from fancyrec_tpu_torch.ops.brand_dropout import (
        aspect_dropout_bwd_cuda, aspect_dropout_fwd_cuda)
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_cuda)
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores_cuda, topk_int8_cuda)
    return {"gru_scan": gru_scan_cuda, "topk_int8": topk_int8_cuda,
            "gru_scan_bwd": gru_scan_bwd_cuda,
            "aspect_dropout_fwd": aspect_dropout_fwd_cuda,
            "aspect_dropout_bwd": aspect_dropout_bwd_cuda,
            "cosine_scores": cosine_scores_cuda}


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
    from fancyrec_tpu_torch.serving.server import FancyRecService, make_server
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
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
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
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
    if thread.is_alive():
        fail("the HTTP server thread did not stop")
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
    if any(s in low for s in ("gemm", "gemv", "xmma")):
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


def tester_path(root, dev):
    """Phase 6: the tester CLI on the card on the checkpoint that phase 5c's
    trainer wrote, over the test split at recipe width. The kernels' counts
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

    logdir = os.path.join(root, "model", "chip_smoke")
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
    log("tester CLI, %d test posts in %d batches at recipe width: %.2f s "
        "wall; AUC %.6f NDCG@10 %.6f NDCG@50 %.6f R@1/5/10 %.2f/%.2f/%.2f "
        "MedR %g MeanR %g" % (N_EVAL, n_batches, wall, m.auc, m.ndcg10,
                              m.ndcg50, m.r1, m.r5, m.r10, m.medr, m.meanr))
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


def main():
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

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))

    # 2. build
    t0 = time.time()
    reports = _build.build(["gru_scan", "topk_int8", "aspect_dropout",
                            "cosine_scores"])
    log("kernels built in %.1f s" % (time.time() - t0))
    for name, rep in reports.items():
        for fn, line in ptxas_lines(rep):
            log("%s ptxas: %s: %s" % (name, fn, line))

    # 3. kernels vs their plain versions
    gru_bwd, fwd_b8 = check_gru_train(dev)
    sweep_gru_rows(dev)
    kernels = ([check_gru(dev), check_topk(dev), gru_bwd]
               + check_aspect_dropout(dev) + [check_cosine(dev)])
    check_edges(dev)
    torch.cuda.empty_cache()

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # 4. the serving path, counts zeroed just before and read just after
        zero_counts()
        main_path(work, dev)
        serving = read_counts()
        log("serving path launches: %s" % serving)
        torch.cuda.empty_cache()
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
        training, _ = train_path(root, dev)
        torch.cuda.empty_cache()
        # 6. evaluation: the tester CLI on the trained checkpoint
        evaluation = tester_path(root, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("gru_scan forward at the training batch (B=%d): %.3f ms (cuDNN GRU "
        "forward %.3f ms); launches on the training path: %d"
        % (B_TRAIN, fwd_b8["ms"], fwd_b8["library_ms"], training["gru_scan"]))
    paths = {"gru_scan": serving, "topk_int8": serving,
             "cosine_scores": evaluation}
    for k in kernels:
        k["launches"] = paths.get(k["name"], training)[k["name"]]
        if k["launches"] < 1:
            fail("%s was not launched on its main path" % k["name"])

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
