#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the path, from fancyrec_tpu_torch/csrc,
     one nvcc per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes of the main path, with times, the library yardstick and
     the bound of the same work;
  4. main path, at the full width of the recipe model (bin/instance.sh)
     with random weights from a seed: build an index of a synthetic
     collection through `fancyrec_tpu_torch.serving.index build`, append
     random embeddings up to 1,000,000 posts (the /v1/add path), serve it
     int8 over HTTP and ask /v1/topk for all 51 brands. The kernels'
     launch counts are zeroed before and read after: each must have run.
     The served posts must equal the plain top-k, and a batch encoded on
     the card must match the same batch encoded on the CPU.

Prints a `kernels` JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero; without a
CUDA device, or without the package beside this script, it exits
non-zero before printing any result.
"""

import json
import math
import os
import shutil
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
K1_TOL = 1e-4     # float32; sum order over H=1024 and 64 recurrent steps
K3_TOL = 1e-6     # the same float32 products; only the sort differs
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
    ops = 2 * (T - 1) * 2 * B_ENC * 3 * H * H        # h0 = 0: no product at t=0
    nbytes = 4 * (xw.numel() + w_hh.numel() + b_hh.numel() + out_k.numel())
    return {"name": "gru_scan", "route": "cuda",
            "source": "fancyrec_tpu_torch/csrc/gru_scan.cu",
            "replaces": "fancyrec_tpu/ops/gru_scan.py:157",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **roofline(nbytes, ops, F32_FLOPS), "library_ms": library_ms}


def check_topk(dev):
    """K3 at the serving shape: kernel vs plain, indices equal."""
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
        vp, ip = topk_int8_ref(brands, posts_q, posts_inv, TOPK)
        torch.cuda.synchronize()
        if not torch.equal(ik, ip):
            fail("topk_int8 kernel indices differ from the plain version "
                 "in %d of %d slots" % (int((ik != ip).sum()), ik.numel()))
        err = (vk - vp).abs().max().item()
        log("topk_int8: indices equal; max |kernel - plain| = %.3g "
            "(tolerance %g)" % (err, K3_TOL))
        if not math.isfinite(err) or err > K3_TOL:
            fail("topk_int8 kernel values disagree with its plain version")
        ms = cuda_ms(lambda: topk_int8_cuda(brands, posts_q, posts_inv,
                                            TOPK), 20)
        plain_ms = cuda_ms(lambda: topk_int8_ref(brands, posts_q, posts_inv,
                                                 TOPK), 3)
    log("topk_int8: kernel %.3f ms, plain %.3f ms" % (ms, plain_ms))
    ops = 2 * N_BRANDS * N_POSTS * DIM
    nbytes = (4 * brands.numel() + posts_q.numel() + 4 * posts_inv.numel()
              + 8 * N_BRANDS * TOPK)
    return {"name": "topk_int8", "route": "cuda",
            "source": "fancyrec_tpu_torch/csrc/topk_int8.cu",
            "replaces": "fancyrec_tpu/ops/similarity.py:242",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **roofline(nbytes, ops, INT8_OPS), "library_ms": None}


def check_edges(dev):
    """Both kernels against their plain versions on the card at small
    shapes that the serving shapes do not reach: ragged tiles, bf16,
    exact ties, k above the valid rows, several brand tiles, odd D."""
    import torch
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda, gru_scan_ref
    from fancyrec_tpu_torch.ops.similarity import (
        quantize_rows_int8, topk_int8_cuda, topk_int8_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    # bf16: the two differ where a float32 sum-order difference crosses a
    # bf16 rounding boundary, one bf16 ulp of h (2^-8 relative)
    for t, b, h, dt, tol in ((5, 3, 40, torch.float32, K1_TOL),
                             (3, 130, 1000, torch.float32, K1_TOL),
                             (4, 7, 64, torch.bfloat16, 2e-2)):
        xw = torch.randn(t, 2, b, 3 * h, generator=g, device=dev).to(dt)
        w = torch.randn(2, 3 * h, h, generator=g, device=dev) / math.sqrt(h)
        bias = torch.randn(2, 3 * h, generator=g, device=dev) * 0.1
        err = (gru_scan_cuda(xw, w, bias).float()
               - gru_scan_ref(xw, w, bias).float()).abs().max().item()
        if not err <= tol:
            fail("gru_scan T=%d B=%d H=%d %s: max err %.3g > %g"
                 % (t, b, h, dt, err, tol))
    for b, n, d, k, n_valid, dups in ((3, 1000, 132, 10, None, False),
                                      (4, 300, 128, 8, 5, False),
                                      (5, 2000, 256, 12, None, True),
                                      (130, 700, 1024, 128, 650, False),
                                      (51, 900, 2048, 128, None, False)):
        brands = torch.randn(b, d, generator=g, device=dev)
        rows = torch.randn(n, d, generator=g, device=dev)
        if dups:                       # exact ties: copies of one row
            rows[500:520] = rows[40]
            rows[40] = rows[500:520] = brands[0] * 3
        posts_q, posts_inv = quantize_rows_int8(rows)
        vk, ik = topk_int8_cuda(brands, posts_q, posts_inv, k, n_valid)
        vp, ip = topk_int8_ref(brands, posts_q, posts_inv, k, n_valid)
        if not torch.equal(ik, ip) or not torch.allclose(
                vk, vp, rtol=0, atol=K3_TOL, equal_nan=False):
            fail("topk_int8 B=%d N=%d D=%d k=%d n_valid=%s differs from "
                 "the plain version" % (b, n, d, k, n_valid))
    torch.cuda.synchronize()
    log("edge shapes: both kernels agree with their plain versions")


def uncounted(fn):
    """Run a measurement without adding its launches to the main path's."""
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda
    from fancyrec_tpu_torch.ops.similarity import topk_int8_cuda
    saved = gru_scan_cuda.launches, topk_int8_cuda.launches
    try:
        return fn()
    finally:
        gru_scan_cuda.launches, topk_int8_cuda.launches = saved


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
        from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda
        from fancyrec_tpu_torch.ops.similarity import topk_int8_cuda
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
    reports = _build.build(["gru_scan", "topk_int8"])
    log("kernels built in %.1f s" % (time.time() - t0))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log("%s ptxas: %s" % (name, line.strip()))

    # 3. kernels vs their plain versions
    kernels = [check_gru(dev), check_topk(dev)]
    check_edges(dev)
    torch.cuda.empty_cache()

    # 4. the main path, counts zeroed just before and read just after
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        gru_scan_cuda.launches = 0
        topk_int8_cuda.launches = 0
        main_path(work, dev)
        launches = {"gru_scan": gru_scan_cuda.launches,
                    "topk_int8": topk_int8_cuda.launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            fail("%s was not launched on the main path" % k["name"])

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
