#!/usr/bin/env python3
"""Time K4 (the cosine scores) and K1-bwd (the GRU reverse scan) of this
checkout against those of another checkout, on one card, in turns.

    python3 kernel_ab.py BASE_DIR    (from the repository root; one card)

BASE_DIR holds the other checkout, for example the parent commit unpacked
with `git archive` into the ignored build/ directory. Its
csrc/cosine_scores.cu must have the single-pass C entry
`cosine_scores_fwd(bn, posts, out, B, N, D, stream)`, whose caller divides
the brands by their norms; its csrc/gru_scan.cu the C entry `gru_scan_bwd`
of this checkout, with no more carry scratch than this tree's (one (2, B,
H) slot where its library states none). Both trees' sources are built with
the same nvcc flags, each kernel is held against its plain version, and
each quantity is timed in ten pairs of CUDA-event windows, the base and
this tree taking turns at going first:
  - K4 at 51 x 816 x 1024 (the test split) and 51 x 1,000,000 x 1024: the
    wrapper's call (each tree's Python around its C entry), the C entry
    alone on buffers made once, and the device time of the C entry's
    kernels, the union of their intervals in torch.profiler;
  - K1-bwd at T=64, H=1024, float32, B=8 (the recipe's training batch) and
    B=128 (the trainer's default batch): the C entry on buffers made once;
    then this tree's backward at B=128 with each number of batch rows a
    gate block forced.
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


def build_base(base):
    """Start nvcc on the base tree's two sources; returns {name: (process,
    library path)}."""
    from fancyrec_tpu_torch.ops import _build
    out_dir = os.path.join(HERE, "build", "kernel_ab_base")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("cosine_scores", "gru_scan"):
        src = os.path.join(base, "fancyrec_tpu_torch", "csrc", name + ".cu")
        lib = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
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


def device_ms(fn, calls):
    """The union of the intervals of the kernels that `calls` calls of fn
    launch, in torch.profiler, a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _union_ms
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


def k4(dev, base_lib, results):
    import torch
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops.similarity import (
        _cosine_fn, _sm_count, cosine_scores_cuda, cosine_scores_ref,
        cosine_scratch_len, cosine_slices)

    def base_entry():
        fn = base_lib.cosine_scores_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    base_fn = base_entry()

    def base_wrapper(brands, posts):
        # the base tree's wrapper: checks, the brands' normalization, the
        # entry's argument types set, one foreign call
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
            s = cosine_slices(cs.N_BRANDS, n, cs.DIM, _sm_count(dev))
            bn = brands / torch.linalg.norm(brands, dim=1, keepdim=True)
            out_b = torch.empty((cs.N_BRANDS, n), device=dev)
            out_t = torch.empty((cs.N_BRANDS, n), device=dev)
            scratch = torch.empty(
                max(1, cosine_scratch_len(cs.N_BRANDS, n, s)), device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            args_b = (bn.data_ptr(), posts.data_ptr(), out_b.data_ptr(),
                      cs.N_BRANDS, n, cs.DIM, stream)
            args_t = ((bn if s == 1 else brands).data_ptr(), posts.data_ptr(),
                      out_t.data_ptr(), scratch.data_ptr(), cs.N_BRANDS, n,
                      cs.DIM, s, stream)
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
                dev_ms[side].append(device_ms(
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


def main():
    if len(sys.argv) != 2:
        sys.exit("usage: python3 kernel_ab.py BASE_DIR")
    base = os.path.abspath(sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch.cuda.is_available() is false: needs a card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from fancyrec_tpu_torch.device import resolve_device
    from fancyrec_tpu_torch.ops import _build

    with open(os.path.join(base, "fancyrec_tpu_torch", "csrc",
                           "cosine_scores.cu")) as f:
        if _entry_params(f.read(), "cosine_scores_fwd") != 7:
            fail("the base's cosine_scores_fwd is not the single-pass "
                 "entry (bn, posts, out, B, N, D, stream)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    t0 = time.time()
    procs = build_base(base)
    _build.build(["cosine_scores", "gru_scan"])
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail("the base's %s did not build:\n%s" % (name, out))
        libs[name] = ctypes.CDLL(lib)
    log("both trees' kernels built in %.1f s; %s" % (time.time() - t0,
                                                       smi_line))
    results = []
    k4(dev, libs["cosine_scores"], results)
    k1_bwd(dev, libs["gru_scan"], results)
    print(smi_line)
    print(json.dumps({"device": smi_line, "results": results}), flush=True)


if __name__ == "__main__":
    main()
