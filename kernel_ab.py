#!/usr/bin/env python3
"""Time K3 (the fused int8 top-k), K4 (the cosine scores), K1-bwd (the GRU
reverse scan) and K2 (the brand dropout + mean, forward and backward) of
this checkout against those of another checkout, on one card, in turns.

    python3 kernel_ab.py BASE_DIR [k3] [k4] [k1bwd] [k2] [-DNAME=VALUE ...]
        (from the repository root; one card; all four when none is named)

BASE_DIR holds the other checkout, for example the parent commit unpacked
with `git archive` into the ignored build/ directory, or `.` to time this
tree against itself built with the -D definitions given (for example
`-DTOPK_SEED=0`, K3 without its first thresholds). Its sources are
built with this tree's nvcc flags, and those definitions, and called
through adapters chosen by the parameter count of their C entries:
  - csrc/topk_int8.cu: `topk_int8_fwd(qb, qp, inv, cand, vals, idx, B, D,
    n_valid, k, grid, stream)`, whose caller quantizes the brands and
    applies their scale (the commits before K3's ring), or this tree's
    entry, which does both itself;
  - csrc/cosine_scores.cu: the single-pass `cosine_scores_fwd(bn, posts,
    out, B, N, D, stream)`, whose caller divides the brands by their norms,
    or this tree's entry with the D split;
  - csrc/gru_scan.cu: the C entry `gru_scan_bwd` of this checkout, with no
    more carry scratch than this tree's (one (2, B, H) slot where its
    library states none);
  - csrc/aspect_dropout.cu: `aspect_dropout_fwd(w, asp, out, B, A, C,
    seed0, seed1, thr, scale, stream)` and `aspect_dropout_bwd(w, asp, g,
    dw, dasp, B, A, C, seed0, seed1, thr, scale, stream)`, whose backward
    redraws the mask from the seed (the commits before the keep bits), or
    the entries whose forward writes the keep bits and splits A over a
    scratch buffer and whose backward reads the bits: with 16 parameters
    (the commits before aspect shards) or this tree's 18 (A_total and
    a_off, here the whole table).
Each kernel is held against its plain version, and each quantity is timed
in ten pairs, the base and this tree taking turns at going first:
  - K3 at 51 x 1,000,000 x 1024, k = 10 and k = 128, and 51 x 4,080 x 1024
    (the freshly built index), k = 10: the wrapper's call (CUDA-event windows) and the device
    time of the call's kernels, the union of their intervals in
    torch.profiler, the quantization included;
  - K4 at 51 x 816 x 1024 (the test split) and 51 x 1,000,000 x 1024: the
    wrapper's call, the C entry alone on buffers made once, and (two
    profiles a side) the device time of the C entry's kernels;
  - K1-bwd at T=64, H=1024, float32, B=8 (the recipe's training batch) and
    B=128 (the trainer's default batch): the C entry on buffers made once;
    then this tree's backward at B=128 with each number of batch rows a
    gate block forced;
  - K2 at A=2000, C=1024, keep 0.5, B=8 (the training microbatch: this
    tree's streamed backward) and B=128 (the trainer's default batch: its
    forward's 16 row tiles, its backward a block a group): the C entries
    on buffers made once, the forward alone, the backward alone,
    and the forward then the backward (the fair unit, since this tree's
    forward also writes the bits its backward reads); and the device time
    of the forward then the backward (the union of their kernels'
    intervals in torch.profiler).
Each line gives the medians, the base's interquartile range, the pairs this
tree won and a verdict: faster (or slower) where one side won at least 9
of the 10 pairs and the medians differ by more than the base's
interquartile range, else unresolved. The last line is a JSON object of
every result, beside the card's name and power limit.
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PAIRS = 10


def log(msg):
    print("kernel_ab: %s" % msg, flush=True)


def fail(msg):
    print("kernel_ab: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def _entry_params(src, name):
    """The number of parameters of the `extern "C"` function `name` in a
    CUDA source."""
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src)
    if m is None:
        return None
    return len([p for p in m.group(1).split(",") if p.strip()])


def build_base(base, names, defines=()):
    """Start nvcc on the base tree's named sources, with the -D definitions
    given; returns {name: (process, library path)}."""
    from fancyrec_tpu_torch.ops import _build
    out_dir = os.path.join(HERE, "build", "kernel_ab_base")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(base, "fancyrec_tpu_torch", "csrc", name + ".cu")
        lib = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def pairs(base_fn, this_fn):
    """Ten pairs of (base, this) times, alternating which goes first."""
    got = {"base": [], "this": []}
    for i in range(PAIRS):
        for side in (("base", "this") if i % 2 == 0 else ("this", "base")):
            got[side].append((base_fn if side == "base" else this_fn)())
    return got


def verdict(name, got):
    b, t = got["base"], got["this"]
    mb, mt = statistics.median(b), statistics.median(t)
    q1, _, q3 = statistics.quantiles(b, n=4)
    wins = sum(x < y for x, y in zip(t, b))
    losses = sum(x > y for x, y in zip(t, b))
    if wins >= 0.9 * PAIRS and mb - mt > q3 - q1:
        word = "faster"
    elif losses >= 0.9 * PAIRS and mt - mb > q3 - q1:
        word = "slower"
    else:
        word = "unresolved"
    log("%s: base %.4f ms (IQR %.4f), this tree %.4f ms (range %.4f to "
        "%.4f); this tree won %d of %d pairs: %s"
        % (name, mb, q3 - q1, mt, min(t), max(t), wins, PAIRS, word))
    return {"name": name, "base_median": mb, "base_iqr": q3 - q1,
            "this_median": mt, "this_min": min(t), "this_max": max(t),
            "wins": wins, "pairs": PAIRS, "verdict": word}


def with_entry(module, name, fn, call):
    """Run `call` with `module.name` (a function returning a C entry)
    returning `fn` instead: this tree's wrapper around the base's entry."""
    saved = getattr(module, name)
    setattr(module, name, lambda: fn)
    try:
        return call()
    finally:
        setattr(module, name, saved)


def k3(dev, base_lib, params, results):
    import torch
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops import similarity as sim
    from fancyrec_tpu_torch.ops.similarity import (
        quantize_rows_int8, topk_int8_cuda)

    if params == 12:
        def base_wrapper(brands, posts_q, posts_inv, k):
            # the base tree's wrapper: checks, the brands' quantization,
            # the entry's argument types set, one foreign call, the brand
            # scale and the filler's index
            if brands.device.type != "cuda":
                raise ValueError("needs CUDA tensors")
            if brands.dim() != 2 or posts_q.dim() != 2 \
                    or brands.shape[1] != posts_q.shape[1]:
                raise ValueError("brands and posts_q must share D")
            if posts_q.dtype != torch.int8 or posts_inv.dtype != torch.float32:
                raise ValueError("posts_q must be int8, posts_inv float32")
            b, d = brands.shape
            n_valid = posts_q.shape[0]
            posts_q = posts_q.contiguous()
            posts_inv = posts_inv.contiguous()
            qb, b_inv = quantize_rows_int8(brands)
            qb = qb.contiguous()
            sms = torch.cuda.get_device_properties(
                brands.device).multi_processor_count
            grid = max(1, min(-(-n_valid // 64), 2 * sms))
            cand = torch.empty((b, grid, k), dtype=torch.int64,
                               device=brands.device)
            vals = torch.empty((b, k), dtype=torch.float32,
                               device=brands.device)
            idxs = torch.empty((b, k), dtype=torch.int32, device=brands.device)
            fn = base_lib.topk_int8_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            with torch.cuda.device(brands.device):
                stream = torch.cuda.current_stream(brands.device).cuda_stream
                err = fn(qb.data_ptr(), posts_q.data_ptr(),
                         posts_inv.data_ptr(), cand.data_ptr(),
                         vals.data_ptr(), idxs.data_ptr(), b, d, n_valid, k,
                         grid, stream)
            if err:
                raise RuntimeError("base topk_int8 failed: CUDA error %d"
                                   % err)
            vals = vals * b_inv[:, None]
            idxs = torch.where(torch.isneginf(vals), torch.zeros_like(idxs),
                               idxs)
            return vals, idxs
    else:
        fn_b = base_lib.topk_int8_fwd
        fn_b.argtypes = sim._topk_fn().argtypes
        fn_b.restype = ctypes.c_int

        def base_wrapper(brands, posts_q, posts_inv, k):
            return with_entry(sim, "_topk_fn", fn_b, lambda: topk_int8_cuda(
                brands, posts_q, posts_inv, k))

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    for n, ks, calls in ((cs.N_POSTS, (cs.TOPK, 128), 20),
                         (4080, (cs.TOPK,), 50)):
        brands = torch.randn(cs.N_BRANDS, cs.DIM, generator=g, device=dev)
        posts_q = torch.empty(n, cs.DIM, dtype=torch.int8, device=dev)
        posts_inv = torch.empty(n, device=dev)
        for lo in range(0, n, 1 << 17):
            hi = min(lo + (1 << 17), n)
            posts_q[lo:hi], posts_inv[lo:hi] = quantize_rows_int8(
                torch.randn(hi - lo, cs.DIM, generator=g, device=dev))
        for k in ks:
            k3_case(brands, posts_q, posts_inv, k, calls, base_wrapper,
                    results)
        del brands, posts_q, posts_inv
        torch.cuda.empty_cache()


def k3_case(brands, posts_q, posts_inv, k, calls, base_wrapper, results):
    """K3 of both trees at one shape: each against the plain version, then
    ten pairs of wrapper calls and of device times."""
    import chip_smoke as cs
    import torch
    from fancyrec_tpu_torch.ops.similarity import topk_int8_cuda, topk_int8_ref

    shape = "%d x %d x %d, k=%d" % (brands.shape[0], posts_q.shape[0],
                                    brands.shape[1], k)
    call = {"base": lambda: base_wrapper(brands, posts_q, posts_inv, k),
            "this": lambda: topk_int8_cuda(brands, posts_q, posts_inv, k)}
    with torch.no_grad():
        vp, ip = topk_int8_ref(brands, posts_q, posts_inv, k)
        for side, fn in call.items():
            vk, ik = fn()
            torch.cuda.synchronize()
            err = (vk - vp).abs().max().item()
            if not torch.equal(ik, ip) or not err <= cs.K3_TOL:
                fail("K3 %s, %s tree: indices differ or max err %.3g > %g"
                     % (shape, side, err, cs.K3_TOL))
        results.append(verdict("K3 %s, wrapper call" % shape, pairs(
            lambda: cs.cuda_ms(call["base"], calls),
            lambda: cs.cuda_ms(call["this"], calls))))
        results.append(verdict(
            "K3 %s, device time (profiler union a call)" % shape, pairs(
                lambda: cs.device_ms(call["base"], 5),
                lambda: cs.device_ms(call["this"], 5))))


def k4(dev, base_lib, params, results):
    import torch
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops import similarity as sim
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops.similarity import (
        _cosine_fn, cosine_scores_cuda, cosine_scores_ref,
        cosine_scratch_len, cosine_slices)

    split = params == 9           # the base's entry is this tree's

    def base_entry():
        fn = base_lib.cosine_scores_fwd
        fn.argtypes = (_cosine_fn().argtypes if split else
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn

    base_fn = base_entry()

    def base_wrapper(brands, posts):
        # the base tree's wrapper: checks, the brands' normalization, the
        # entry's argument types set, one foreign call
        if split:
            return with_entry(sim, "_cosine_fn", base_fn,
                              lambda: cosine_scores_cuda(brands, posts))
        if brands.device.type != "cuda":
            raise ValueError("needs CUDA tensors")
        if brands.dim() != 2 or posts.dim() != 2 \
                or brands.shape[1] != posts.shape[1]:
            raise ValueError("brands (B, D) and posts (N, D) must share D")
        if brands.dtype != torch.float32 or posts.dtype != torch.float32:
            raise ValueError("takes float32")
        if posts.device != brands.device:
            raise ValueError("brands and posts must be on one device")
        b, d = brands.shape
        n = posts.shape[0]
        brands_n = (brands / torch.linalg.norm(brands, dim=1,
                                               keepdim=True)).contiguous()
        posts = posts.contiguous()
        out = torch.empty((b, n), dtype=torch.float32, device=brands.device)
        fn = base_entry()
        with torch.cuda.device(brands.device):
            stream = torch.cuda.current_stream(brands.device).cuda_stream
            err = fn(brands_n.data_ptr(), posts.data_ptr(), out.data_ptr(),
                     b, n, d, stream)
        if err:
            raise RuntimeError("base cosine_scores failed: CUDA error %d"
                               % err)
        return out

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    for n, calls in ((cs.N_EVAL, 50), (cs.N_POSTS, 5)):
        brands, posts = cs._cosine_case(g, dev, cs.N_BRANDS, n, cs.DIM)
        shape = "%d x %d x %d" % (cs.N_BRANDS, n, cs.DIM)
        with torch.no_grad():
            want = cosine_scores_ref(brands, posts)
            for side, got in (("base", base_wrapper(brands, posts)),
                              ("this", cosine_scores_cuda(brands, posts))):
                err = cs._cosine_err(got, want)
                if not err <= cs.K4_TOL:
                    fail("K4 %s, %s tree: max err %.3g > %g"
                         % (shape, side, err, cs.K4_TOL))
            del want
            # the C entries alone on buffers made once
            s = cosine_slices(cs.N_BRANDS, n, cs.DIM, _build.sm_count(dev))
            bn = brands / torch.linalg.norm(brands, dim=1, keepdim=True)
            out_b = torch.empty((cs.N_BRANDS, n), device=dev)
            out_t = torch.empty((cs.N_BRANDS, n), device=dev)
            scratch = torch.empty(
                max(1, cosine_scratch_len(cs.N_BRANDS, n, s)), device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            args_t = ((bn if s == 1 else brands).data_ptr(), posts.data_ptr(),
                      out_t.data_ptr(), scratch.data_ptr(), cs.N_BRANDS, n,
                      cs.DIM, s, stream)
            args_b = ((args_t[0], posts.data_ptr(), out_b.data_ptr())
                      + args_t[3:] if split else
                      (bn.data_ptr(), posts.data_ptr(), out_b.data_ptr(),
                       cs.N_BRANDS, n, cs.DIM, stream))
            fn_t = _cosine_fn()
            entry_b = lambda: base_fn(*args_b)   # noqa: E731
            entry_t = lambda: fn_t(*args_t)      # noqa: E731
            results.append(verdict("K4 %s, wrapper call" % shape, pairs(
                lambda: cs.cuda_ms(lambda: base_wrapper(brands, posts), calls),
                lambda: cs.cuda_ms(lambda: cosine_scores_cuda(brands, posts),
                                   calls))))
            results.append(verdict("K4 %s, C entry alone (%d slices here)"
                                   % (shape, s), pairs(
                lambda: cs.cuda_ms(entry_b, calls),
                lambda: cs.cuda_ms(entry_t, calls))))
            dev_ms = {"base": [], "this": []}
            for side in ("base", "this", "this", "base"):
                dev_ms[side].append(cs.device_ms(
                    entry_b if side == "base" else entry_t, calls))
            log("K4 %s, device time of the C entry's kernels (profiler "
                "union a call, two profiles each): base %s ms, this tree "
                "%s ms" % (shape,
                           ", ".join("%.4f" % x for x in dev_ms["base"]),
                           ", ".join("%.4f" % x for x in dev_ms["this"])))
            results.append({"name": "K4 %s, device time" % shape, **dev_ms})
        del brands, posts, bn, out_b, out_t, scratch
        torch.cuda.empty_cache()


def k1_bwd(dev, base_lib, results):
    import torch
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops.gru_scan import (
        bwd_scratch, gru_scan_bwd_ref, gru_scan_cuda)

    def entry(lib):
        fn = lib.gru_scan_bwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def run(xw, h_prev, dout, w_hh, b_hh):
            t, _, b, g3 = xw.shape
            dxw = torch.empty_like(xw)
            danp = torch.empty((t, 2, b, g3 // 3), device=xw.device)
            carry, da = bwd_scratch(b, g3 // 3, xw.device)
            args = [x.data_ptr() for x in (xw, h_prev, dout, w_hh, b_hh, dxw,
                                           danp, carry, da)]
            stream = torch.cuda.current_stream(xw.device).cuda_stream
            call = lambda: fn(*args, t, b, g3 // 3, 0, stream)   # noqa: E731
            if call():
                fail("gru_scan_bwd failed")
            return call, (dxw, danp)
        return run

    # this tree's scratch serves both: its carry slots are at least the
    # base's (one where the base states none)
    this_lib = _build.load("gru_scan")
    base_slots = (base_lib.gru_scan_bwd_carry_slots()
                  if hasattr(base_lib, "gru_scan_bwd_carry_slots") else 1)
    if base_slots > this_lib.gru_scan_bwd_carry_slots():
        fail("the base's backward takes more carry slots than this tree's")
    runs = {"base": entry(base_lib), "this": entry(this_lib)}
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for b, calls in ((cs.B_TRAIN, 20), (cs.B_ENC, 5)):
        xw, w_hh, b_hh = cs._gru_inputs(g, dev, cs.T, b, cs.H)
        with torch.no_grad():
            out = gru_scan_cuda(xw, w_hh, b_hh)
            h_prev = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
            dout = torch.randn(out.shape, generator=g, device=dev)
            want = gru_scan_bwd_ref(xw, h_prev, dout, w_hh, b_hh)
            calls_of = {}
            for side, run in runs.items():
                call, got = run(xw, h_prev, dout, w_hh, b_hh)
                torch.cuda.synchronize()
                err = max((x - y).abs().max().item()
                          for x, y in zip(got, want))
                if not err <= cs.K1B_TOL:
                    fail("K1-bwd B=%d, %s tree: max err %.3g > %g"
                         % (b, side, err, cs.K1B_TOL))
                calls_of[side] = call
            results.append(verdict(
                "K1-bwd T=%d B=%d H=%d float32, C entry" % (cs.T, b, cs.H),
                pairs(lambda: cs.cuda_ms(calls_of["base"], calls),
                      lambda: cs.cuda_ms(calls_of["this"], calls))))
            if b == cs.B_ENC:
                # this tree's gate kernel at each number of rows a block
                sweep = {r: [] for r in cs.GRU_ROWS}
                for i in range(PAIRS):
                    for r in (cs.GRU_ROWS if i % 2 == 0
                              else cs.GRU_ROWS[::-1]):
                        got = cs.gru_bwd_forced(xw, h_prev, dout, w_hh, b_hh,
                                                r)
                        err = max((x - y).abs().max().item()
                                  for x, y in zip(got, want))
                        if not err <= cs.K1B_TOL:
                            fail("K1-bwd B=%d R=%d: max err %.3g > %g"
                                 % (b, r, err, cs.K1B_TOL))
                        sweep[r].append(cs.cuda_ms(lambda: cs.gru_bwd_forced(
                            xw, h_prev, dout, w_hh, b_hh, r), calls))
                log("K1-bwd B=%d by rows a gate block, PDL, medians of %d "
                    "(range): %s" % (b, PAIRS, ", ".join(
                        "R=%d %.3f ms (%.3f to %.3f)"
                        % (r, statistics.median(v), min(v), max(v))
                        for r, v in sweep.items())))
                results.append({"name": "K1-bwd B=%d by rows a gate block" % b,
                                **{"R=%d" % r: statistics.median(v)
                                   for r, v in sweep.items()}})
        del xw, out, h_prev, dout, want
        torch.cuda.empty_cache()


def k2(dev, base_lib, params, results):
    """K2's C entries, the base's against this tree's, at the training
    microbatch (B=8: the forward's one row tile and the streamed backward)
    and at the trainer's default batch (B=128: 16 row tiles and the
    backward a block a group)."""
    import torch
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.ops import brand_dropout as bd

    a, c = cs.N_ASPECTS, cs.DIM
    s0, s1 = cs.K2_SEED
    stream = torch.cuda.current_stream(dev).cuda_stream

    def entries(lib, n_fwd, n_bwd, w, asp, gr):
        """The two C entries of a library on buffers made once, through the
        adapters their parameter counts pick: (forward, backward, outputs)."""
        b = w.shape[0]
        thr, scale = bd.keep_threshold(a, cs.KEEP)
        plan = bd.aspect_dropout_plan(b, a, c, _build.sm_count(dev))
        out = torch.empty((b, c), device=dev)
        dw, dasp = torch.empty_like(w), torch.empty_like(asp)
        bits = torch.empty((b, a, -(-c // 32)), dtype=torch.int32,
                           device=dev)
        scratch = torch.empty(plan.scratch_floats, device=dev)
        key = bd.key_words(cs.K2_SEED, dev)
        fwd, bwd = lib.aspect_dropout_fwd, lib.aspect_dropout_bwd
        for fn in (fwd, bwd):
            fn.restype = ctypes.c_int
        if n_fwd == 11:
            fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                            + [ctypes.c_uint] * 3
                            + [ctypes.c_float, ctypes.c_void_p])
            fwd_args = (w.data_ptr(), asp.data_ptr(), out.data_ptr(), b, a, c,
                        s0, s1, thr, scale, stream)
        elif n_fwd in (16, 18):         # the seed words as arguments; 16:
            shard = (a, 0) if n_fwd == 18 else ()   # no A_total, a_off
            fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                            + [ctypes.c_int] * (3 + len(shard) + 2)
                            + [ctypes.c_uint] * 3
                            + [ctypes.c_float, ctypes.c_void_p])
            fwd_args = ((w.data_ptr(), asp.data_ptr(), out.data_ptr(),
                         bits.data_ptr(), scratch.data_ptr(),
                         plan.scratch_floats, b, a, c) + shard
                        + (plan.splits, plan.span, s0, s1, thr, scale, stream))
        else:
            fwd_args = bd.aspect_dropout_fwd_args(
                w, asp, out, bits, scratch, key, cs.KEEP, plan)
            fwd.argtypes = bd._fwd_fn().argtypes
        if n_bwd == 13:
            bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                            + [ctypes.c_uint] * 3
                            + [ctypes.c_float, ctypes.c_void_p])
            bwd_args = (w.data_ptr(), asp.data_ptr(), gr.data_ptr(),
                        dw.data_ptr(), dasp.data_ptr(), b, a, c, s0, s1, thr,
                        scale, stream)
        else:
            bwd.argtypes = bd._bwd_fn().argtypes
            bwd_args = bd.aspect_dropout_bwd_args(w, asp, gr, bits, dw, dasp,
                                                  cs.KEEP, plan)
        if fwd(*fwd_args) or bwd(*bwd_args):
            fail("an aspect_dropout C entry failed")
        return (lambda: fwd(*fwd_args), lambda: bwd(*bwd_args),
                (out, dw, dasp, bits, scratch, key))

    for b in (cs.B_TRAIN, 128):
        g = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
        w = torch.randn(b, a, generator=g, device=dev)
        asp = torch.randn(a, c, generator=g, device=dev)
        gr = torch.randn(b, c, generator=g, device=dev)
        with torch.no_grad():
            out_p = bd.aspect_dropout_fwd_ref(w, asp, cs.K2_SEED, cs.KEEP)
            dw_p, dasp_p = bd.aspect_dropout_bwd_ref(w, asp, gr, cs.K2_SEED,
                                                     cs.KEEP)
            calls, kept = {}, {}
            for side, lib, n_fwd, n_bwd in (
                    ("base", base_lib, params["aspect_dropout_fwd"],
                     params["aspect_dropout_bwd"]),
                    ("this", _build.load("aspect_dropout"), 17, 12)):
                fwd, bwd, bufs = entries(lib, n_fwd, n_bwd, w, asp, gr)
                out, dw, dasp = bufs[:3]
                torch.cuda.synchronize()
                err = max((x - y).abs().max().item()
                          for x, y in ((out, out_p), (dw, dw_p),
                                       (dasp, dasp_p)))
                if not err <= cs.K2_TOL:
                    fail("K2 B=%d, %s tree: max err %.3g > %g"
                         % (b, side, err, cs.K2_TOL))
                calls[side] = (fwd, bwd)
                kept[side] = bufs      # the entries' buffers stay allocated
            shape = "B=%d A=%d C=%d keep %g" % (b, a, c, cs.KEEP)
            for what, pick in (("forward", lambda f, bw: f),
                               ("backward", lambda f, bw: bw),
                               ("forward + backward",
                                lambda f, bw: lambda: (f(), bw()))):
                fns = {side: pick(*calls[side]) for side in calls}
                results.append(verdict(
                    "K2 %s, %s, C entries" % (shape, what),
                    pairs(lambda: cs.cuda_ms(fns["base"], 50),
                          lambda: cs.cuda_ms(fns["this"], 50))))
            both = {side: (lambda f, bw: lambda: (f(), bw()))(*calls[side])
                    for side in calls}
            results.append(verdict(
                "K2 %s, forward + backward, device time (profiler union)"
                % shape, pairs(lambda: cs.device_ms(both["base"], 20),
                               lambda: cs.device_ms(both["this"], 20))))
        del w, asp, gr, out_p, dw_p, dasp_p, calls, kept
        torch.cuda.empty_cache()


# kernel: (its source, {its C entry: the entry's parameter counts taken})
KERNELS = {"k3": ("topk_int8", {"topk_int8_fwd": (12, 17)}),
           "k4": ("cosine_scores", {"cosine_scores_fwd": (7, 9)}),
           "k1bwd": ("gru_scan", {"gru_scan_bwd": (14,)}),
           "k2": ("aspect_dropout", {"aspect_dropout_fwd": (11, 16, 18),
                                     "aspect_dropout_bwd": (13, 12)})}


def main():
    defines = [a for a in sys.argv[2:] if a.startswith("-D")]
    names = [a for a in sys.argv[2:] if a not in defines] or list(KERNELS)
    if len(sys.argv) < 2 or not set(names) <= set(KERNELS):
        sys.exit("usage: python3 kernel_ab.py BASE_DIR [k3] [k4] [k1bwd] "
                 "[k2] [-DNAME=VALUE ...]")
    base = os.path.abspath(sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch.cuda.is_available() is false: needs a card")
    sys.path.insert(0, HERE)
    from fancyrec_tpu_torch.device import resolve_device
    from fancyrec_tpu_torch.ops import _build

    params = {}
    for name in names:
        src, taken = KERNELS[name]
        with open(os.path.join(base, "fancyrec_tpu_torch", "csrc",
                               src + ".cu")) as f:
            text = f.read()
        params[name] = {entry: _entry_params(text, entry) for entry in taken}
        for entry, counts in taken.items():
            if params[name][entry] not in counts:
                fail("the base's %s takes %s parameters; the adapters take %s"
                     % (entry, params[name][entry], counts))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    t0 = time.time()
    sources = [KERNELS[n][0] for n in names]
    procs = build_base(base, sources, defines)
    _build.build(sources)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail("the base's %s did not build:\n%s" % (name, out))
        libs[name] = ctypes.CDLL(lib)
    log("both trees' kernels built in %.1f s (the base with %s); %s"
        % (time.time() - t0, " ".join(defines) or "no definitions",
           smi_line))
    results = []
    if "k3" in names:
        k3(dev, libs["topk_int8"], params["k3"]["topk_int8_fwd"], results)
    if "k4" in names:
        k4(dev, libs["cosine_scores"], params["k4"]["cosine_scores_fwd"],
           results)
    if "k1bwd" in names:
        k1_bwd(dev, libs["gru_scan"], results)
    if "k2" in names:
        k2(dev, libs["aspect_dropout"], params["k2"], results)
    print(smi_line)
    print(json.dumps({"device": smi_line, "results": results}), flush=True)


if __name__ == "__main__":
    main()
