"""IVF-Flat approximate retrieval: single-query serving over large indexes.

Port of fancyrec_tpu/serving/ivf.py. A single brand query on
the exact path reads the whole index (about 1 GB at 1M x 1024 int8); IVF
probes `nprobe` of `nlist` coarse clusters and scores only their posts
exactly, so the only recall loss is a post whose list was not probed.

  * spherical k-means: farthest-point seeding, then Lloyd steps whose
    assignment is a blockwise argmax of (block, D) x (D, nlist) products
    (the (N, nlist) score matrix never exists) and whose update is an
    `index_add_`; a capacity refinement splits clusters larger than the
    packed capacity.
  * the packed index is a dense (nlist + overflow, cap, D) tensor: every
    list padded to one capacity; posts that exhaust their top-C centroid
    choices go to always-probed overflow lists.
  * int8 mode scores with the exact integer dots of `ops/similarity`
    (per-row max-abs quantization; only 1/||q|| survives per row).
  * `shard_to_mesh` splits the lists over the devices of a serving mesh
    (capacity past one card), and `load(part=)` gives a rank of a world
    its data slot's lists of the same split; a sharded query answers as
    the JAX package's sharded query does.

Every argmax and top-k orders ties as the JAX package's `argmax` and
`lax.top_k` do: value descending, index ascending (`_topk_ordered`). The
first k-means seed is drawn from a `torch.Generator` seeded with `seed`
(the JAX package draws it from its PRNG key, which torch cannot
reproduce); everything after it follows the JAX code. The on-disk sidecar
is the JAX package's, file for file, so a sidecar built by either package
serves in the other. No Pallas kernel runs here in the JAX package, and
none is ported: products, scatters and top-k are plain PyTorch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.device import resolve_device
from fancyrec_tpu_torch.ops.similarity import _int_dots, quantize_rows_int8
from fancyrec_tpu_torch.parallel import collectives

_BLOCK = 16384          # rows a k-means assignment or choice block
_PROBE_CHUNK = 128      # probed lists scored together in a query


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _rows(x, dev: torch.device) -> torch.Tensor:
    """numpy rows or a tensor -> a float32 tensor on dev."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=dev, dtype=torch.float32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _order_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (value desc, index asc) along
    the last axis: the float's bits made monotone, then the index."""
    bits = scores.float().contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    width = scores.shape[-1]
    pos = torch.arange(width, device=scores.device, dtype=torch.int64)
    return (ordered << 32) | (width - 1 - pos)


def _topk_ordered(scores: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered as `lax.top_k` orders it (value
    descending, ties by index ascending) -> (values, int64 indices)."""
    _, idx = torch.topk(_order_keys(scores), k, dim=-1, sorted=True)
    return torch.gather(scores, -1, idx), idx


def _kcenter_init(x: torch.Tensor, nlist: int, first=None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Gonzalez farthest-point (k-center) seeding -> (nlist,) row indices.

    Each step takes the row with the largest cosine distance to its nearest
    chosen seed, so no region of the data is left unseeded while another
    holds two (Lloyd cannot move a centroid across an orthogonal gap). Only
    the first seed is random: `first`, or a draw from `generator`. The
    distances stay on x's device; no step waits for the host."""
    n = x.shape[0]
    if first is None:
        first = torch.randint(0, n, (1,), generator=generator)
    first = torch.as_tensor(first, dtype=torch.int64).reshape(1).to(x.device)
    idx = torch.zeros(nlist, dtype=torch.int64, device=x.device)
    idx[0:1] = first
    mind = 1.0 - x @ x.index_select(0, first)[0]
    for i in range(1, nlist):
        p = torch.argmax(mind).reshape(1)
        # a chosen row's own distance becomes 0: never re-chosen while any
        # unseeded spread remains
        idx[i:i + 1] = p
        mind = torch.minimum(mind, 1.0 - x @ x.index_select(0, p)[0])
    return idx


# A cluster may donate its centroid to a hot region only if its nearest
# sibling centroid is at least this close (cosine): members of a donated
# cluster must have somewhere nearby to land.
_DONOR_REDUNDANCY_FLOOR = 0.4


def _select_donors(counts: np.ndarray, cap_target: float,
                   maxcos: np.ndarray, sib: np.ndarray,
                   redundancy_floor: float = _DONOR_REDUNDANCY_FLOOR,
                   light_frac: float = 0.9) -> list:
    """Donor clusters for one capacity-refinement round, lightest first.

    A donor must be light (count < light_frac * cap_target) AND
    redundant (nearest sibling cosine >= redundancy_floor). Donating it
    protects its nearest sibling -- the absorber of its members -- from
    donating in the same round, and a cluster whose own absorber already
    donated is skipped, so one round cannot drain every list of a region.
    """
    order = np.argsort(counts, kind="stable")
    out = []
    protected, moved = set(), set()
    for c in order:
        c = int(c)
        if counts[c] >= light_frac * cap_target:
            break                      # ascending order: rest is heavier
        if maxcos[c] < redundancy_floor or c in protected:
            continue
        absorber = int(sib[c])
        if absorber in moved:
            continue                   # its absorber left this round
        protected.add(absorber)
        moved.add(c)
        out.append(c)
    return out


def _assign(x: torch.Tensor, cents: torch.Tensor, block: int) -> torch.Tensor:
    """Nearest centroid of each row (argmax, first index on ties)."""
    return torch.cat([torch.argmax(x[lo:lo + block] @ cents.T, dim=1)
                      for lo in range(0, x.shape[0], block)])


def _lloyd(x: torch.Tensor, cents: torch.Tensor, block: int):
    """One Lloyd step -> (new centroids, counts). Empty clusters keep
    their centroid."""
    nlist = cents.shape[0]
    a = _assign(x, cents, block)
    sums = torch.zeros_like(cents).index_add_(0, a, x)
    cnt = torch.zeros(nlist, dtype=torch.int64, device=x.device).index_add_(
        0, a, torch.ones_like(a))
    return torch.where(cnt[:, None] > 0, _l2norm(sums), cents), cnt


def spherical_kmeans(embs, nlist: int, iters: int = 10, seed: int = 0,
                     block: int = _BLOCK,
                     cap_target: Optional[float] = None,
                     balance_rounds: int = 12, init=None,
                     timings: Optional[Dict[str, float]] = None
                     ) -> torch.Tensor:
    """K-means on the unit sphere (cosine assignment) -> (nlist, D) f32 on
    embs' device.

    Seeding is farthest-point k-center (`_kcenter_init`) when nlist < N,
    else N rows drawn with replacement; `init` ((nlist,) row indices)
    replaces the seeding. Lloyd steps follow; empty clusters keep their
    centroid.

    cap_target: capacity-aware refinement. Up to `balance_rounds` extra
    rounds split every cluster with count > cap_target into
    ceil(count/cap_target) copies (perturbations of 1e-3 from
    np.random.RandomState(seed + 1), then one Lloyd step to settle),
    donating light clusters whose members have a nearby sibling
    (`_select_donors`). The best centroid set seen, by displaced mass,
    is returned. `timings`, if given, receives the seconds of the seeding
    ("kcenter_init") and of the Lloyd steps with the refinement
    ("lloyd")."""
    x = _l2norm(embs.float() if isinstance(embs, torch.Tensor)
                else _rows(embs, "cpu"))
    n, d = x.shape
    dev = x.device
    t0 = time.perf_counter()
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        if nlist < n:
            init = _kcenter_init(x, nlist, generator=gen)
        else:
            init = torch.randint(0, n, (nlist,), generator=gen)
    if not isinstance(init, torch.Tensor):
        init = torch.from_numpy(np.array(init, np.int64))
    init = init.to(device=dev, dtype=torch.int64)
    cents = _l2norm(x.index_select(0, init))
    _sync(dev)
    t1 = time.perf_counter()

    cnt = None
    for _ in range(iters):
        cents, cnt = _lloyd(x, cents, block)

    # iters=0 means "init centroids, unrefined": there is no count to
    # balance against, so the capacity refinement must not run
    if cap_target is not None and nlist > 1 and cnt is not None:
        rng = np.random.RandomState(seed + 1)
        eye2 = 2.0 * torch.eye(nlist, dtype=torch.float32, device=dev)

        def sibling(c):
            # nearest OTHER centroid per centroid: absorber candidates
            s = c @ c.T - eye2
            return (torch.amax(s, dim=1).cpu().numpy(),
                    torch.argmax(s, dim=1).cpu().numpy())

        def displaced(counts):
            return int(np.maximum(counts - cap_target, 0).sum())

        best = (displaced(cnt.cpu().numpy()), cents.cpu().numpy())
        for _ in range(balance_rounds):
            counts = cnt.cpu().numpy()
            order = np.argsort(counts, kind="stable")     # light -> heavy
            heavy = [int(c) for c in order[::-1] if counts[c] > cap_target]
            if not heavy:
                break
            maxcos, sib = sibling(cents)
            donors = _select_donors(counts, cap_target, maxcos, sib)
            ch = cents.cpu().numpy().copy()
            moved, di = False, 0
            for over in heavy:
                need = int(np.ceil(counts[over] / cap_target)) - 1
                take = min(need, len(donors) - di)
                if take <= 0:
                    break               # donor pool exhausted this round
                for _j in range(take):
                    eps = rng.randn(d).astype(np.float32)
                    eps *= 1e-3 / max(np.linalg.norm(eps), 1e-12)
                    ch[donors[di]] = ch[over] + eps
                    di += 1
                    moved = True
            if not moved:
                break
            cents, cnt = _lloyd(x, _l2norm(torch.from_numpy(ch).to(dev)),
                                block)                   # settle the split
            cur = displaced(cnt.cpu().numpy())
            if cur < best[0]:
                best = (cur, cents.cpu().numpy())
            if cur == 0:
                break
        if best[0] < displaced(cnt.cpu().numpy()):
            cents = torch.from_numpy(best[1]).to(dev)
    _sync(dev)
    if timings is not None:
        timings["kcenter_init"] = t1 - t0
        timings["lloyd"] = time.perf_counter() - t1
    return cents


def _top_choices(embs, cents: torch.Tensor, n_choices: int,
                 block: int = _BLOCK) -> np.ndarray:
    """Per post: indices of the n_choices nearest centroids -> (N, C)
    int32, nearest first (ties by centroid index)."""
    x = _l2norm(_rows(embs, cents.device))
    out = [_topk_ordered(x[lo:lo + block] @ cents.T, n_choices)[1]
           for lo in range(0, x.shape[0], block)]
    return torch.cat(out).to(torch.int32).cpu().numpy()


def balanced_assign(choices: np.ndarray, nlist: int, cap: int,
                    spill: str = "round_robin") -> np.ndarray:
    """Host-side capacity-balanced assignment from per-post top-C choices.

    Round c: posts still unassigned bid for their c-th choice; within a
    cluster, bids are granted in post order until the remaining capacity
    runs out (vectorized via a per-cluster running count).

    Posts that exhaust all C choices are handled per `spill`:
      * "round_robin": into whatever clusters still have room (they become
        invisible to probes of their true neighborhood).
      * "overflow": into virtual list ids nlist, nlist+1, ... (cap posts
        each) that IVFIndex packs as ALWAYS-PROBED overflow lists.
    """
    n, n_choices = choices.shape
    if spill == "round_robin":
        assert nlist * cap >= n, "capacity %d*%d < %d posts" % (
            nlist, cap, n)
    assign = np.full(n, -1, np.int64)
    used = np.zeros(nlist, np.int64)
    for c in range(n_choices):
        todo = np.nonzero(assign < 0)[0]
        if todo.size == 0:
            break
        want = choices[todo, c].astype(np.int64)
        order = np.argsort(want, kind="stable")
        w_sorted = want[order]
        seg_start = np.concatenate([[True], w_sorted[1:] != w_sorted[:-1]])
        pos_in_seg = np.arange(todo.size) - np.maximum.accumulate(
            np.where(seg_start, np.arange(todo.size), 0))
        slot = used[w_sorted] + pos_in_seg
        ok = slot < cap
        granted = todo[order][ok]
        assign[granted] = w_sorted[ok]
        np.add.at(used, w_sorted[ok], 1)
    todo = np.nonzero(assign < 0)[0]
    if todo.size:
        if spill == "overflow":
            assign[todo] = nlist + np.arange(todo.size) // cap
        else:
            free_clusters = np.repeat(np.arange(nlist), cap - used)
            assign[todo] = free_clusters[: todo.size]
    return assign


def _default_sizes(n: int, nlist: Optional[int], cap: Optional[int]):
    if nlist is None:
        nlist = max(1, min(n, int(np.sqrt(n) * 2)))
    if cap is None:
        cap = max(1, int(np.ceil(1.3 * n / nlist)))
    # rounded up to 32 rows, as the JAX package tiles its int8 slices
    return nlist, -(-cap // 32) * 32


def _pad_k(vals: torch.Tensor, ids: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids) of up to k candidates, padded to k with -inf / -1."""
    pad = k - vals.shape[0]
    if pad > 0:
        vals = torch.cat([vals, vals.new_full((pad,), float("-inf"))])
        ids = torch.cat([ids, ids.new_full((pad,), -1)])
    return vals, ids


def _merge_candidates(vals: torch.Tensor, ids: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' candidates of one query, shard-major -> the top k by
    (value desc, position asc), padded to k with -inf / -1."""
    v, pos = _topk_ordered(vals[None], min(k, vals.shape[0]))
    return _pad_k(v[0], ids[pos[0]], k)


class IVFIndex:
    """Packed IVF-Flat index over post embeddings, on one device, or with
    its lists sharded over several (`shard_to_mesh`).

      centroids   (nlist, D)  f32, unit rows
      packed      (nlist + overflow_lists, cap, D)  f32 unit rows or their
                  int8 max-abs quantization; rows past nlist are the
                  ALWAYS-PROBED overflow lists
      packed_idx  (same leading dims, cap) int32 post index, -1 = empty
      inv_norms   int8 only: (same leading dims, cap) f32 1/||q8||
      radii       (nlist,) f32 p95 member angle to the centroid, radians

    query(q, k, nprobe): the top-nprobe lists (by centroid cosine, or with
    probe="bound" by cos(max(theta - r, 0))) plus every overflow list,
    exact top-k over their slots. nprobe=nlist is exact brute force over
    the packed layout.
    """

    def __init__(self, centroids, packed, packed_idx, inv_norms=None,
                 radii=None, device="cuda"):
        self.device = resolve_device(device)
        put = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(  # noqa
            self.device)
        self.centroids = put(centroids, torch.float32)
        self.packed = put(packed)
        self.packed_idx = put(packed_idx, torch.int32)
        self.inv_norms = (None if inv_norms is None
                          else put(inv_norms, torch.float32))
        self.radii = None if radii is None else put(radii, torch.float32)
        n_lists, self.cap = self.packed_idx.shape
        self._int8 = self.packed.dtype == torch.int8
        # the ServingMesh the lists are sharded over (shard_to_mesh), or
        # (slot, slots) where this process holds one data slot's lists of a
        # world (`load(part=)`); the lists a shard holds
        self.mesh, self.part, self._per = None, None, n_lists
        self.nlist = int(self.centroids.shape[0])
        self.overflow_lists = n_lists - self.nlist
        # fraction of posts that exhausted their centroid choices at build
        # time (they sit in the overflow lists); None when unknown
        self.spill_frac = None
        # row count of the store the sidecar was built from (ivf_meta.json):
        # PostIndex.ivf() refuses a sidecar whose row indices no longer match
        self.source_posts = None
        # seconds of each build stage (build_chunked), or None
        self.build_seconds = None

    # ---------------------------------------------------------- radii --

    def compute_radii(self, quantile: float = 0.95,
                      chunk: int = 128) -> None:
        """Per-list member angular radius (radians) -> self.radii: the
        `quantile` order statistic of arccos(cos(member, centroid)) over
        the list's valid members (int8 packs recover the member direction
        through inv_norms); 0 for an empty list. Runs before
        shard_to_mesh."""
        if self.mesh is not None or self.part is not None:
            raise ValueError("compute_radii runs on an unsharded index")
        int8 = self._int8
        qf = float(quantile)
        cap = self.cap
        out = []
        for lo in range(0, self.nlist, chunk):
            hi = min(lo + chunk, self.nlist)
            blk = self.packed[lo:hi].float()
            cent = self.centroids[lo:hi, :, None]
            cos = torch.bmm(blk, cent)[..., 0]
            if int8:
                cos = cos * self.inv_norms[lo:hi]
            valid = self.packed_idx[lo:hi] >= 0
            ang = torch.where(valid, torch.arccos(torch.clamp(cos, -1.0, 1.0)),
                              torch.full_like(cos, float("-inf")))
            m = valid.sum(dim=1)
            srt = torch.sort(ang, dim=1, descending=True).values
            r = torch.floor((1.0 - qf) * torch.clamp(m - 1, min=0).float()
                            ).to(torch.int64)
            val = torch.gather(srt, 1, torch.clamp(r, 0, cap - 1)[:, None])
            out.append(torch.where(m > 0, val[:, 0], torch.zeros_like(
                val[:, 0])))
        self.radii = torch.cat(out) if out else torch.zeros(
            0, device=self.device)

    # ---------------------------------------------------------- build --

    @classmethod
    def build(cls, post_embs, nlist: Optional[int] = None,
              cap: Optional[int] = None, iters: int = 10, seed: int = 0,
              quantize: str = "", n_choices: int = 8,
              device="cuda") -> "IVFIndex":
        """Build from (N, D) embeddings (numpy, or a tensor on `device`)."""
        if quantize not in ("", "int8"):
            raise ValueError("quantize must be '' or 'int8'")
        dev = resolve_device(device)
        x = _rows(post_embs, dev)
        n, d = x.shape
        nlist, cap = _default_sizes(n, nlist, cap)
        cents = spherical_kmeans(x, nlist, iters=iters, seed=seed,
                                 cap_target=cap)
        choices = _top_choices(x, cents, min(n_choices, nlist))
        assign = balanced_assign(choices, nlist, cap, spill="overflow")
        spill_frac = float(np.mean(assign >= nlist))
        n_lists = max(nlist, int(assign.max()) + 1)

        # pack on the device: only the (N,) assignment crosses from the host
        a = torch.from_numpy(assign).to(dev)
        order = torch.argsort(a, stable=True)            # list-contiguous
        counts = torch.bincount(a, minlength=n_lists)
        starts = torch.cumsum(counts, 0) - counts
        rows = a[order]
        cols = torch.arange(n, device=dev) - starts[rows]
        slots = rows * cap + cols
        packed = torch.zeros((n_lists * cap, d), dtype=torch.float32,
                             device=dev)
        packed[slots] = _l2norm(x)[order]
        packed_idx = torch.full((n_lists * cap,), -1, dtype=torch.int32,
                                device=dev)
        packed_idx[slots] = order.to(torch.int32)
        del x
        inv = None
        if quantize == "int8":
            packed, inv = quantize_rows_int8(packed)
            inv = inv.reshape(n_lists, cap)
        out = cls(cents, packed.reshape(n_lists, cap, d),
                  packed_idx.reshape(n_lists, cap), inv, device=dev)
        out.spill_frac = spill_frac
        out.compute_radii()
        return out

    @classmethod
    def build_chunked(cls, row_source: Callable, n: int, d: int,
                      nlist: Optional[int] = None, cap: Optional[int] = None,
                      iters: int = 10, seed: int = 0, quantize: str = "int8",
                      n_choices: int = 8, chunk: int = 262144,
                      train_rows: int = 524288,
                      device="cuda") -> "IVFIndex":
        """Memory-lean build: rows stream through `row_source(lo, hi) ->
        (hi-lo, d)` float32 (numpy or a tensor), and the device holds the
        packed index plus one chunk in flight.

        k-means trains on an evenly-strided sample of `train_rows` rows
        (the full corpus when n <= train_rows); with a full sample the
        result is bit-identical to build() on the same data and seed.
        `build_seconds` records each stage's seconds."""
        if quantize not in ("", "int8"):
            raise ValueError("quantize must be '' or 'int8'")
        if n <= 0:
            raise ValueError("build_chunked needs a non-empty corpus")
        dev = resolve_device(device)
        nlist, cap = _default_sizes(n, nlist, cap)
        rows_of = lambda lo, hi: _rows(row_source(lo, hi), dev)  # noqa
        seconds = {}
        t0 = time.perf_counter()

        # ---- k-means on a strided sample (full corpus if it fits) ----
        step = min(chunk, n)
        if n <= train_rows:
            starts = list(range(0, n, step))
        else:
            # a train_rows below one chunk shrinks the read size; the chunk
            # count is ceiled, then the sample trimmed
            step = min(step, max(1, train_rows))
            n_train_chunks = -(-train_rows // step)
            stride = max(step, (n // n_train_chunks) // step * step)
            starts = list(range(0, n, stride))[:n_train_chunks]
        train = torch.cat([rows_of(lo, min(lo + step, n))
                           for lo in starts])[:train_rows]
        _sync(dev)
        seconds["sample_read"] = time.perf_counter() - t0
        # the capacity target scales to the sample: a cluster holding s
        # sample rows holds ~s * n / len(train) corpus rows
        cents = spherical_kmeans(train, nlist, iters=iters, seed=seed,
                                 cap_target=cap * len(train) / n,
                                 timings=seconds)
        del train

        # ---- per-row top-C choices, streamed ----
        t0 = time.perf_counter()
        choices = np.concatenate([
            _top_choices(rows_of(lo, min(lo + chunk, n)), cents,
                         min(n_choices, nlist))
            for lo in range(0, n, chunk)])
        seconds["choices"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assign = balanced_assign(choices, nlist, cap, spill="overflow")
        spill_frac = float(np.mean(assign >= nlist))
        n_lists = max(nlist, int(assign.max()) + 1)

        # ---- slot per global row (the same math as build()'s pack) ----
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=n_lists)
        starts_c = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rows_srt = assign[order]
        cols = np.arange(n) - starts_c[rows_srt]
        slot_of = np.empty(n, np.int64)
        slot_of[order] = rows_srt * cap + cols
        seconds["assignment"] = time.perf_counter() - t0

        # ---- streamed scatter into the packed device buffer ----------
        t0 = time.perf_counter()
        int8 = quantize == "int8"
        packed = torch.zeros((n_lists * cap, d),
                             dtype=torch.int8 if int8 else torch.float32,
                             device=dev)
        inv_host = np.zeros(n_lists * cap, np.float32) if int8 else None
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            xn = _l2norm(rows_of(lo, hi))
            slots = torch.from_numpy(slot_of[lo:hi]).to(dev)
            if int8:
                q, qinv = quantize_rows_int8(xn)
                packed[slots] = q
                inv_host[slot_of[lo:hi]] = qinv.cpu().numpy()
            else:
                packed[slots] = xn
        packed_idx = np.full(n_lists * cap, -1, np.int32)
        packed_idx[slot_of] = np.arange(n, dtype=np.int32)
        inv = inv_host.reshape(n_lists, cap) if int8 else None
        out = cls(cents, packed.reshape(n_lists, cap, d),
                  packed_idx.reshape(n_lists, cap), inv, device=dev)
        _sync(dev)
        seconds["scatter"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out.spill_frac = spill_frac
        out.compute_radii()
        _sync(dev)
        seconds["radii"] = time.perf_counter() - t0
        out.build_seconds = seconds
        return out

    def shard_to_mesh(self, mesh) -> "IVFIndex":
        """Shard the packed lists over the devices of `mesh` (a
        `parallel.mesh.ServingMesh`): the capacity mode of the JAX package.

        The list axis splits contiguously: shard s holds lists [s * per,
        (s + 1) * per) on mesh.devices[s], the axis padded with empty lists
        to the shard multiple (id -1, inverse norm 1: they never rank).
        packed, packed_idx and inv_norms become lists of those parts. The
        centroids and radii stay whole on the first device: the JAX
        package replicates them so that every device selects the same
        probes itself, and here the one process selects them once a query.
        Queries then return exactly what the JAX package's sharded query
        returns (`_query_sharded`)."""
        if self.mesh is not None or self.part is not None:
            raise ValueError("the IVF index is already sharded")
        n_shards = mesh.shards
        n_lists = self.packed_idx.shape[0]
        pad = (-n_lists) % n_shards
        packed, packed_idx, inv = self.packed, self.packed_idx, self.inv_norms
        if pad:
            packed = torch.cat([packed, packed.new_zeros(
                (pad,) + tuple(packed.shape[1:]))])
            packed_idx = torch.cat([packed_idx, packed_idx.new_full(
                (pad, self.cap), -1)])
            if inv is not None:
                inv = torch.cat([inv, inv.new_ones((pad, self.cap))])
        per = (n_lists + pad) // n_shards
        part = lambda t, s: t[s * per:(s + 1) * per].to(  # noqa: E731
            mesh.devices[s]).clone()
        self.packed = [part(packed, s) for s in range(n_shards)]
        self.packed_idx = [part(packed_idx, s) for s in range(n_shards)]
        if inv is not None:
            self.inv_norms = [part(inv, s) for s in range(n_shards)]
        self.device = resolve_device(mesh.devices[0])
        self.centroids = self.centroids.to(self.device)
        if self.radii is not None:
            self.radii = self.radii.to(self.device)
        self.mesh, self._per = mesh, per
        return self

    # ---------------------------------------------------------- query --

    def probe_lists(self, q: torch.Tensor, nprobe: int,
                    mode: str = "cosine") -> torch.Tensor:
        """The lists one query (D,) probes: its top-nprobe lists, then
        every overflow list -> (nprobe + overflow_lists,) int64."""
        qn = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
        cscore = self.centroids @ qn                       # (nlist,)
        if mode == "bound":
            # rank by the reachability bound cos(max(theta - r, 0)); lists
            # the query is inside tie at 1 and break by centroid angle
            theta = torch.arccos(torch.clamp(cscore, -1.0, 1.0))
            key = -torch.clamp(theta - self.radii, min=0.0) - 1e-3 * theta
        else:
            key = cscore
        probe = _topk_ordered(key[None], nprobe)[1][0]
        if self.overflow_lists:
            probe = torch.cat([probe, torch.arange(
                self.nlist, self.nlist + self.overflow_lists,
                device=probe.device)])
        return probe

    def _query_form(self, q: torch.Tensor):
        """What the lists are scored against: (q8 int8, 1/||q8||) for an
        int8 index (its exact integer dots over their norms), else the
        unit query."""
        if self._int8:
            amax = torch.amax(torch.abs(q))
            scale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                                torch.zeros_like(amax))
            q8 = torch.clamp(torch.round(q * scale), -127, 127).to(torch.int8)
            return q8, torch.rsqrt(torch.clamp(
                torch.sum(torch.square(q8.float())), min=1.0))
        return q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12), None

    def _scan(self, form, lists: torch.Tensor, packed, packed_idx, inv
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The scores and post ids of every slot of `lists` (in that order)
        of one packed part -> ((slots,) f32, -inf on empty slots; ids)."""
        qf, inv_q = form
        d = packed.shape[-1]
        parts = []
        for lo in range(0, lists.shape[0], _PROBE_CHUNK):
            chunk = lists[lo:lo + _PROBE_CHUNK]
            blk = packed.index_select(0, chunk).reshape(-1, d)
            if inv_q is not None:
                acc = _int_dots(qf[None], blk)[0]
                pinv = inv.index_select(0, chunk).reshape(-1)
                parts.append(acc * inv_q * pinv)
            else:
                parts.append(blk @ qf)
        s = torch.cat(parts) if parts else packed.new_zeros(
            0, dtype=torch.float32)
        ids = packed_idx.index_select(0, lists).reshape(-1)
        return torch.where(ids < 0, torch.full_like(s, float("-inf")), s), ids

    def _query_one(self, q: torch.Tensor, k: int, nprobe: int, mode: str):
        probe = self.probe_lists(q, nprobe, mode)
        s, ids = self._scan(self._query_form(q), probe, self.packed,
                            self.packed_idx, self.inv_norms)
        vals, local = _topk_ordered(s[None], min(k, s.shape[0]))
        return _pad_k(vals[0], ids[local[0]], k)

    def _shard_candidates(self, q: torch.Tensor, probe: np.ndarray, s: int,
                          kk: int, packed, packed_idx, inv, dev):
        """Shard s's part of a sharded query: the probed lists it owns, in
        probe order, scanned -> its top kk = min(k, (nprobe + overflow) *
        cap) (a shard that owns every probed list must not drop a true
        top-k post), padded to kk with -inf / -1 as JAX's masked slots
        are."""
        mine = probe[probe // self._per == s] - s * self._per
        lists = torch.from_numpy(mine).to(dev)
        sc, sid = self._scan(self._query_form(q.to(dev)), lists, packed,
                             packed_idx, inv)
        v, pos = _topk_ordered(sc[None], min(kk, sc.shape[0]))
        return _pad_k(v[0], sid[pos[0]], kk)

    def _probes(self, qs: torch.Tensor, k: int, nprobe: int, mode: str):
        """Every query's probed lists, on the host -> (probes (Q, P), the
        candidates kk a shard keeps)."""
        probes = torch.stack([self.probe_lists(q, nprobe, mode)
                              for q in qs]).cpu().numpy()
        return probes, min(k, probes.shape[1] * self.cap)

    def _query_sharded(self, qs: torch.Tensor, k: int, nprobe: int,
                       mode: str):
        """The JAX package's sharded query from one process. The probes of
        every query are selected once on the first device; shard s gives
        its `_shard_candidates`. Shard-major, the candidates merge by
        (value desc, position asc), as JAX's all-gather and `lax.top_k`
        merge them (`_merge_candidates`)."""
        probes, kk = self._probes(qs, k, nprobe, mode)
        home = self.mesh.devices[0]
        invs = self.inv_norms or [None] * self.mesh.shards
        out = []
        for q, probe in zip(qs, probes):
            vals, ids = [], []
            for s, dev in enumerate(self.mesh.devices):
                v, i = self._shard_candidates(q, probe, s, kk, self.packed[s],
                                              self.packed_idx[s], invs[s],
                                              dev)
                vals.append(v.to(home, non_blocking=True))
                ids.append(i.to(home, non_blocking=True))
            out.append(_merge_candidates(torch.cat(vals), torch.cat(ids), k))
        return out

    def _query_ranked(self, qs: torch.Tensor, k: int, nprobe: int,
                      mode: str):
        """The sharded query over the ranks of a world (`load(part=)`):
        every rank selects the probes itself from the replicated
        centroids, as each JAX device does, gives its slot's
        `_shard_candidates` for every query, and the candidates of all
        queries are gathered over the data group in slot order, then
        merged as `_query_sharded` merges them. A collective."""
        probes, kk = self._probes(qs, k, nprobe, mode)
        slot = self.part[0]
        cands = [self._shard_candidates(q, probe, slot, kk, self.packed,
                                        self.packed_idx, self.inv_norms,
                                        self.device)
                 for q, probe in zip(qs, probes)]
        # (S, Q, kk) in slot order
        vals = collectives.all_gather(torch.stack([v for v, _ in cands])[None])
        ids = collectives.all_gather(torch.stack([i for _, i in cands])[None])
        return [_merge_candidates(vals[:, j].reshape(-1),
                                  ids[:, j].reshape(-1), k)
                for j in range(len(cands))]

    def query(self, query_embs, k: int = 10, nprobe: int = 8,
              probe: Optional[str] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores (Q, k), post indices (Q, k)); slots past the probed
        posts carry -inf / -1. Queries run one at a time, so device memory
        stays O(nprobe * cap * D) whatever Q is.

        probe: "cosine" (centroid-cosine ranking, the default) or "bound"
        (radius-aware ranking; needs radii)."""
        qs = _rows(query_embs, self.device)
        qs = qs.reshape(-1, qs.shape[-1])
        nprobe = min(nprobe, self.nlist)
        mode = probe or "cosine"
        if mode == "bound" and self.radii is None:
            raise ValueError("probe='bound' needs radii; this index has "
                             "none (legacy sidecar) -- compute_radii() "
                             "or query with probe='cosine'")
        if mode not in ("bound", "cosine"):
            raise ValueError("probe must be 'bound' or 'cosine'")
        with torch.no_grad():
            if self.part is not None:
                outs = self._query_ranked(qs, k, nprobe, mode)
            elif self.mesh is not None:
                outs = self._query_sharded(qs, k, nprobe, mode)
            else:
                outs = [self._query_one(q, k, nprobe, mode) for q in qs]
        vals = torch.stack([v for v, _ in outs]).cpu().numpy()
        idxs = torch.stack([i for _, i in outs]).to(torch.int32).cpu().numpy()
        return vals, idxs

    # ------------------------------------------------------- save/load --

    def save(self, path: str) -> None:
        """The JAX package's sidecar files: centroids.npy, packed_idx.npy,
        packed.bin (raw rows), inv_norms.npy (int8), radii.npy and
        ivf_meta.json. A sharded index saves its lists whole, without the
        pad lists."""
        if self.part is not None:
            raise ValueError("a world's rank holds one slot's lists: save "
                             "the sidecar from an unsharded index")
        os.makedirs(path, exist_ok=True)
        n_lists = self.nlist + self.overflow_lists

        def host(t):
            if isinstance(t, list):
                return torch.cat([p.cpu() for p in t])[:n_lists].numpy()
            return t.cpu().numpy()
        np.save(os.path.join(path, "centroids.npy"), host(self.centroids))
        np.save(os.path.join(path, "packed_idx.npy"), host(self.packed_idx))
        packed = host(self.packed)
        packed.tofile(os.path.join(path, "packed.bin"))
        meta = {"nlist": int(self.nlist), "cap": int(self.cap),
                "overflow_lists": int(self.overflow_lists),
                "spill_frac": self.spill_frac,
                "dim": int(packed.shape[-1]),
                "dtype": str(packed.dtype)}
        if self.source_posts is not None:
            meta["source_posts"] = int(self.source_posts)
        if self.inv_norms is not None:
            np.save(os.path.join(path, "inv_norms.npy"), host(self.inv_norms))
        if self.radii is not None:
            np.save(os.path.join(path, "radii.npy"), host(self.radii))
        with open(os.path.join(path, "ivf_meta.json"), "w") as f:
            f.write(json.dumps(meta))

    @classmethod
    def load(cls, path: str, device="cuda", part=None) -> "IVFIndex":
        """A saved sidecar on `device`. part=(slot, slots): only the lists
        of data slot `slot` of a world of `slots` (a rank of
        `PostIndex(mesh=Mesh)`), split as `shard_to_mesh` splits them and
        padded alike, read from the files by memory map; the centroids and
        radii whole. Its queries are collectives of the world
        (`_query_ranked`)."""
        device = resolve_device(device)
        with open(os.path.join(path, "ivf_meta.json")) as f:
            meta = json.loads(f.read())
        n_lists = meta["nlist"] + meta.get("overflow_lists", 0)
        shape = (n_lists, meta["cap"], meta["dim"])
        inv_path = os.path.join(path, "inv_norms.npy")
        has_inv = os.path.exists(inv_path)
        if part is None:
            packed = np.fromfile(os.path.join(path, "packed.bin"),
                                 np.dtype(meta["dtype"])).reshape(shape)
            packed_idx = np.load(os.path.join(path, "packed_idx.npy"))
            inv = np.load(inv_path) if has_inv else None
        else:
            slot, slots = part
            per = -(-n_lists // slots)
            lo, hi = min(slot * per, n_lists), min((slot + 1) * per, n_lists)

            def mine(a, fill):
                a = np.asarray(a[lo:hi])
                return np.concatenate([a, np.full(
                    (per - (hi - lo),) + a.shape[1:], fill, a.dtype)])
            packed = mine(np.memmap(os.path.join(path, "packed.bin"),
                                    np.dtype(meta["dtype"]), "r",
                                    shape=shape), 0)
            packed_idx = mine(np.load(os.path.join(path, "packed_idx.npy"),
                                      mmap_mode="r"), -1)
            inv = (mine(np.load(inv_path, mmap_mode="r"), 1)
                   if has_inv else None)
        rad_path = os.path.join(path, "radii.npy")
        rad = np.load(rad_path) if os.path.exists(rad_path) else None
        out = cls(np.load(os.path.join(path, "centroids.npy")), packed,
                  packed_idx, inv, radii=rad, device=device)
        if part is not None:
            out.part, out._per = tuple(part), per
            out.overflow_lists = n_lists - out.nlist
        out.spill_frac = meta.get("spill_frac")
        out.source_posts = meta.get("source_posts")
        return out
