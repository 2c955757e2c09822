"""HTTP serving: brand -> top-k posts over a built index.

Port of fancyrec_tpu/serving/server.py. A long-lived process loads a
PostIndex (serving/index.py) on one device and answers JSON queries:

  GET  /healthz                     liveness + index summary
  GET  /metrics                     per-route request counts, error
                                     counts, and latency percentiles
                                     (p50/p90/p99 over a sliding window)
  POST /v1/topk      {"brand_ids": [0,3], "k": 10, "nprobe": 0}
                       -> top-k posts per brand (nprobe > 0: through the
                          IVF sidecar; --default_nprobe sets the default)
  POST /v1/encode    {"frames": ..., "origin": ..., "vmask": ..., "bows":
                      ..., "tokens": ..., "type_ids": ..., "tmask": ...}
                       -> post embeddings from the exported model
                          (--artifact, serving/export.py)
  POST /v1/recommend {same inputs, "k": 5}
                       -> top-k brands for each new post (cosine against
                          the index's brand embeddings, on the host)
  POST /v1/add       {"cap_ids": [...], "embeddings": [[...]],
                      "brands": [...]}
                       -> incremental index append + live refresh

Every device touch runs under one lock; the HTTP layer is threaded so
/healthz stays responsive during a long query. /v1/topk requests that
arrive while the device is busy are coalesced into one batched query
(_TopkCoalescer), and past --max_pending device-bound requests new
arrivals get 429 + Retry-After (_AdmissionGate).

CLI: python -m fancyrec_tpu_torch.serving.server INDEX_DIR [--port 8080]
         [--artifact DIR] [--quantize int8] [--default_nprobe 0]
         [--max_pending 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _l2n(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


def _positive_k(body: dict, default: int = 10) -> int:
    """Validate the request's k: a negative k would silently slice from
    the wrong end (np negative indexing) and k=0 selects nothing."""
    k = body.get("k", default)
    if isinstance(k, bool) or not isinstance(k, int) or k < 1:
        raise ValueError("k must be a positive integer, got %r" % (k,))
    return k


def _nonneg_int(body: dict, field: str, default: int) -> int:
    """Validate an optional non-negative integer field (e.g. nprobe: 0 =
    exact path). Booleans and non-ints must 400, not 500 or silently
    route to the ANN path (true == 1)."""
    v = body.get(field, default)
    if isinstance(v, bool) or not isinstance(v, int) or v < 0:
        raise ValueError("%s must be a non-negative integer, got %r"
                         % (field, v))
    return v


class _RouteStats:
    """Per-route request observability: counts + a sliding latency window
    (bounded memory regardless of uptime). Separate lock from the device
    lock -- recording a sample must never queue behind a long query."""

    WINDOW = 1024

    def __init__(self):
        import collections
        self._lock = threading.Lock()
        self._lat = collections.defaultdict(
            lambda: collections.deque(maxlen=self.WINDOW))
        self._count = collections.Counter()
        self._errors = collections.Counter()
        self._started = time.time()

    def record(self, route: str, seconds: float, error: bool) -> None:
        with self._lock:
            self._count[route] += 1
            if error:
                self._errors[route] += 1
            else:
                # error latencies would skew percentiles low (validation
                # rejects return in microseconds)
                self._lat[route].append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            routes = {}
            for route in sorted(self._count):
                lat = sorted(self._lat[route])
                entry = {"count": int(self._count[route]),
                         "errors": int(self._errors[route])}
                if lat:
                    q = lambda p: round(
                        lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 3)
                    entry.update({"p50_ms": q(0.50), "p90_ms": q(0.90),
                                  "p99_ms": q(0.99),
                                  "window": len(lat)})
                routes[route] = entry
            return {"uptime_s": round(time.time() - self._started, 1),
                    "routes": routes}


class Overloaded(RuntimeError):
    """Raised by the admission gate when the pending-request depth is at
    max_pending; the HTTP layer turns it into 429 + Retry-After."""

    def __init__(self, depth: int, retry_after_s: int):
        super().__init__("overloaded: %d requests pending" % depth)
        self.depth = depth
        self.retry_after_s = retry_after_s


class _AdmissionGate:
    """Bounded pending-queue for device-bound routes.

    The coalescer bounds DEVICE CALLS, but every admitted request still
    parks a ThreadingHTTPServer thread on the condition variable; a flood
    would accumulate threads (and their parsed request bodies) without
    bound. The gate sheds load instead: past max_pending concurrent
    device-bound requests, new arrivals fail fast with 429 + Retry-After
    -- in microseconds, without touching the coalescer or device lock --
    so p99 for ADMITTED requests stays bounded by
    max_pending x batch latency. /healthz and /metrics are never gated.
    """

    def __init__(self, max_pending: int = 64, retry_after_s: int = 1):
        self._lock = threading.Lock()
        self.max_pending = max_pending
        self.retry_after_s = retry_after_s
        self.depth = 0            # current pending/in-flight device work
        self.peak_depth = 0
        self.shed = 0             # total 429s issued

    def enter(self) -> None:
        with self._lock:
            if self.depth >= self.max_pending:
                self.shed += 1
                raise Overloaded(self.depth, self.retry_after_s)
            self.depth += 1
            if self.depth > self.peak_depth:
                self.peak_depth = self.depth

    def exit(self) -> None:
        with self._lock:
            self.depth -= 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"pending_depth": self.depth,
                    "max_pending": self.max_pending,
                    "peak_depth": self.peak_depth,
                    "shed_total": self.shed}


class _Request:
    __slots__ = ("brand_ids", "k", "nprobe", "done", "result", "error")

    def __init__(self, brand_ids, k, nprobe):
        self.brand_ids = brand_ids
        self.k, self.nprobe = k, nprobe
        self.done = False
        self.result = self.error = None


class _TopkCoalescer:
    """Leader-follower micro-batching for concurrent top-k requests.

    The device admits one query at a time (the single-flight lock), so N
    concurrent clients used to queue FIFO: N kernel dispatches, the last
    client waiting N full latencies. Here requests that arrive while the
    device is busy pend; when it frees, ONE waiter (the leader) drains
    every pending request with the same (k, nprobe) into a single
    index.query over the concatenated brand ids -- the kernel is batched
    over query rows, so 8 coalesced requests cost roughly one query
    latency instead of eight. Results slice back per request; errors
    propagate to every member of the failed batch. No background thread,
    no added latency when traffic is serial (a lone request becomes
    leader immediately and runs a batch of one).
    """

    def __init__(self, run_fn, device_lock, max_batch: int = 256):
        self._run = run_fn          # (brand_ids, k, nprobe) -> (vals, names)
        self._dlock = device_lock
        self._cv = threading.Condition()
        self._pending = []
        self._busy = False
        self.max_batch = max_batch
        # observability (read under the cv): device calls vs requests --
        # calls < requests means coalescing actually fired
        self.device_calls = 0
        self.requests = 0

    def query(self, brand_ids, k: int, nprobe: int):
        req = _Request(list(brand_ids), k, nprobe)
        with self._cv:
            self._pending.append(req)
            self.requests += 1
            while True:
                if req.done:
                    break               # a leader served us while waiting
                if not self._busy:
                    break               # become the leader
                self._cv.wait()
            if req.done:
                if req.error is not None:
                    raise req.error
                return req.result
            self._busy = True
            # the leader's own request is ALWAYS in the batch it runs --
            # seeding it first means the max_batch cap can never exclude
            # it (collecting in plain arrival order could fill the cap
            # with earlier arrivals and leave the leader returning its
            # own unserved None result)
            batch, total = [req], len(req.brand_ids)
            for r in self._pending:
                if r is req or r.k != k or r.nprobe != nprobe:
                    continue
                if total + len(r.brand_ids) > self.max_batch:
                    # skip just this one: an oversized request must not
                    # stop smaller later arrivals from riding the batch
                    continue
                batch.append(r)
                total += len(r.brand_ids)
            for r in batch:
                self._pending.remove(r)
            self.device_calls += 1
        try:
            all_ids = [b for r in batch for b in r.brand_ids]
            n_real = len(all_ids)
            if len(batch) > 1:
                # pad multi-request batches to the next power of two,
                # as the JAX service does to bound its compiled shapes;
                # the pad rows repeat a real brand and are sliced off
                padded = 1 << (n_real - 1).bit_length()
                all_ids = all_ids + [all_ids[0]] * (padded - n_real)
            with self._dlock:
                vals, names = self._run(all_ids, k, nprobe)
            off = 0
            for r in batch:
                n = len(r.brand_ids)
                r.result = (vals[off:off + n], names[off:off + n])
                off += n
        except BaseException as e:  # noqa: BLE001 -- deliver to every waiter
            for r in batch:
                r.error = e
            if not isinstance(e, Exception):
                # KeyboardInterrupt/SystemExit: followers were handed the
                # real failure above (not a bare None result); the leader
                # itself must still be interrupted, not swallow it
                raise
        finally:
            with self._cv:
                for r in batch:
                    r.done = True
                self._busy = False
                self._cv.notify_all()
        if req.error is not None:
            raise req.error
        return req.result

    def snapshot(self) -> dict:
        with self._cv:
            return {"requests": self.requests,
                    "device_calls": self.device_calls,
                    "coalesced": self.requests - self.device_calls}


class FancyRecService:
    """The transport-free serving core (used directly by tests/embeds)."""

    def __init__(self, index_dir: str, artifact_dir: str = None,
                 quantize: str = "", default_nprobe: int = 0,
                 device_resident: bool = True, max_pending: int = 64,
                 device="cuda"):
        from fancyrec_tpu_torch.serving.index import PostIndex

        self._lock = threading.Lock()          # serialize all device work
        self.index = PostIndex(index_dir, quantize=quantize, device=device,
                               device_resident=device_resident)
        self._index_dir = index_dir
        self.default_nprobe = default_nprobe
        self.stats = _RouteStats()
        self.gate = _AdmissionGate(max_pending=max_pending)
        # /v1/topk coalescing: index.query resolved at call time so
        # /v1/add refreshes that rebind the index still take effect
        self._coalescer = _TopkCoalescer(
            lambda ids, k, npb: self.index.query(ids, k=k, nprobe=npb),
            self._lock)
        self.model = None
        if artifact_dir:
            from fancyrec_tpu_torch.serving.export import ExportedModel
            self.model = ExportedModel(artifact_dir, device=device)

    # -- endpoints -------------------------------------------------------

    def healthz(self) -> dict:
        return {
            "ok": True,
            "n_posts": int(self.index.n_posts),
            "brand_num": int(self.index.brand_embs.shape[0]),
            "dim": int(self.index.meta["dim"]),
            "quantize": self.index.quantize,
            "artifact_entries": (self.model.entry_points
                                 if self.model else []),
        }

    def topk(self, body: dict) -> dict:
        brand_ids = body.get("brand_ids")
        if not isinstance(brand_ids, list) or not brand_ids:
            raise ValueError("brand_ids: non-empty list required")
        n_brands = self.index.brand_embs.shape[0]
        # JSON booleans are ints in Python -- reject them explicitly
        bad = [b for b in brand_ids
               if isinstance(b, bool) or not isinstance(b, int)
               or not 0 <= b < n_brands]
        if bad:
            raise ValueError("brand_ids out of range [0, %d): %s"
                             % (n_brands, bad))
        k = _positive_k(body)
        nprobe = _nonneg_int(body, "nprobe", self.default_nprobe)
        vals, names = self._coalescer.query(brand_ids, k, nprobe)
        return {"results": [
            {"brand": int(b),
             "posts": [{"cap_id": n, "score": float(v)}
                       for v, n in zip(vrow, nrow) if n is not None]}
            for b, vrow, nrow in zip(brand_ids, vals, names)]}

    def _encode(self, body: dict) -> np.ndarray:
        if self.model is None:
            raise ValueError("no --artifact loaded: /v1/encode and "
                             "/v1/recommend need an exported model")
        missing = [a for a in self.model.manifest["entries"]
                   ["encode_post"]["args"] if a not in body]
        if missing:
            raise ValueError("missing encode inputs: %s" % missing)
        with self._lock:
            return self.model.encode_post(body).float().cpu().numpy()

    def encode(self, body: dict) -> dict:
        embs = self._encode(body)
        return {"embeddings": embs.tolist()}

    def recommend(self, body: dict) -> dict:
        """Top-k brands for NEW posts: which brands this content should be
        recommended to."""
        k = _positive_k(body, default=5)
        embs = self._encode(body)
        brands = _l2n(self.index.brand_embs.astype(np.float32))
        scores = _l2n(embs) @ brands.T               # (B_posts, n_brands)
        k = min(k, scores.shape[1])
        order = np.argsort(-scores, axis=1)[:, :k]
        return {"results": [
            [{"brand": int(b), "score": float(row_scores[b])}
             for b in row_order]
            for row_scores, row_order in zip(scores, order)]}

    def add(self, body: dict) -> dict:
        from fancyrec_tpu_torch.serving.index import append_to_index

        cap_ids = body.get("cap_ids")
        embs = body.get("embeddings")
        brands = body.get("brands")
        if not (isinstance(cap_ids, list) and isinstance(embs, list)
                and isinstance(brands, list)
                and len(cap_ids) == len(embs) == len(brands) > 0):
            raise ValueError("cap_ids/embeddings/brands: equal-length "
                             "non-empty lists required")
        rows = np.asarray(embs, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.index.meta["dim"]:
            raise ValueError("embeddings must be (n, %d)"
                             % self.index.meta["dim"])
        with self._lock:
            n = append_to_index(self._index_dir, cap_ids, rows,
                                np.asarray(brands, np.int64))
            self.index.refresh()
        return {"n_posts": int(n)}

    ROUTES = {"/v1/topk": topk, "/v1/encode": encode,
              "/v1/recommend": recommend, "/v1/add": add}


class _Handler(BaseHTTPRequestHandler):
    service: FancyRecService = None     # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _reply(self, code: int, payload: dict, headers=()):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._reply(200, self.service.healthz())
        if self.path == "/metrics":
            snap = self.service.stats.snapshot()
            snap["overload"] = self.service.gate.snapshot()
            snap["topk_coalescing"] = self.service._coalescer.snapshot()
            return self._reply(200, snap)
        return self._reply(404, {"error": "not found: %s" % self.path})

    def do_POST(self):
        fn = FancyRecService.ROUTES.get(self.path)
        if fn is None:
            return self._reply(404, {"error": "not found: %s" % self.path})
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply(400, {"error": "bad request: %s" % e})
        t0 = time.monotonic()
        try:
            # admission gate: every POST route takes the device lock, so
            # shed load BEFORE parking this thread behind it -- a flood
            # past max_pending fails fast with 429 instead of
            # accumulating blocked server threads (the 429 path never
            # touches the coalescer or the device)
            self.service.gate.enter()
            try:
                payload = fn(self.service, body)
            finally:
                self.service.gate.exit()
        except Overloaded as e:
            self.service.stats.record(self.path, time.monotonic() - t0, True)
            return self._reply(
                429, {"error": str(e), "pending": e.depth},
                headers=[("Retry-After", str(e.retry_after_s))])
        except (ValueError, KeyError) as e:
            self.service.stats.record(self.path, time.monotonic() - t0, True)
            return self._reply(400, {"error": str(e)})
        except Exception as e:    # noqa: BLE001 -- surface, don't hang
            self.service.stats.record(self.path, time.monotonic() - t0, True)
            return self._reply(500, {"error": "%s: %s"
                                     % (type(e).__name__, e)})
        self.service.stats.record(self.path, time.monotonic() - t0, False)
        return self._reply(200, payload)


def make_server(service: FancyRecService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; port 0 picks an ephemeral port
    (read it back from server.server_port)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="serve brand<->post retrieval over a built index")
    p.add_argument("index_dir")
    p.add_argument("--artifact", default="",
                   help="exported model dir (serving.export) enabling "
                        "/v1/encode and /v1/recommend")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--quantize", default="", choices=["", "int8"])
    p.add_argument("--default_nprobe", type=int, default=0,
                   help=">0 routes /v1/topk through the IVF sidecar "
                        "unless the request overrides nprobe")
    p.add_argument("--max_pending", type=int, default=64,
                   help="max concurrent device-bound requests before new "
                        "arrivals are shed with 429 + Retry-After")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    service = FancyRecService(a.index_dir, artifact_dir=a.artifact or None,
                              quantize=a.quantize,
                              default_nprobe=a.default_nprobe,
                              max_pending=a.max_pending, device=a.device)
    server = make_server(service, a.host, a.port)
    print(json.dumps({"serving": "http://%s:%d" % server.server_address,
                      **service.healthz()}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
