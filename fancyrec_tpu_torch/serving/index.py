"""Serving: persistent post-embedding indexes + brand -> top-k post query.

Port of fancyrec_tpu/serving/index.py. The on-disk index is the JAX
package's (a BigFile of post embeddings with tab-delimited cap ids,
brands.npy, brand_embeddings.npy, index_meta.json, and the int8 sidecar
feature.int8.bin + inv_norms.npy), so an index built by either package
serves in the other; so does the IVF-Flat sidecar under <index>/ivf
(`serving/ivf.py`, built by `ivf-build`, read by `query(..., nprobe>0)`).

Meshes, as in the JAX package, on two layouts:
  * build and add run data-parallel over the ranks of a world
    (`torchrun --nproc_per_node R ... build ... --mesh_shape R,1`, the
    tester's layout): each rank encodes its slice of every batch at the
    global batch-max lengths, the slices are gathered in collate order,
    and only the primary writes the index;
  * a query process holds the posts in shards, one a device of a
    `parallel.mesh.ServingMesh` (`PostIndex(mesh=...)`, `query
    --mesh_shape` outside a world: the host's cards by the JAX
    `build_mesh` rules), and answers with
    `ops.similarity.distributed_retrieval_topk`;
  * `query --mesh_shape R,M` in a world (torchrun, or RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT) lays the ranks out with
    `parallel.mesh.build_mesh`, as the JAX CLI builds one mesh over the
    devices of every process: the rank of data slot d holds post shard d
    (every model rank of the slot a copy, as JAX replicates a data shard
    over its model row), read alone from the store or the int8 sidecar,
    and its IVF lists (`IVFIndex.load(part=)`); the answers are gathered
    and merged over the data group (`ops.similarity.
    ranked_retrieval_topk`), every rank holds them, and the primary
    prints.
The rows pad to a multiple of the shard count and the pad rows never
rank. The JAX package pads to its fused block times the shards, since its
Pallas grid takes whole blocks; the port's K3 takes any shard length, so
the port pads to the shard multiple only.

CLI (runs on CUDA unless --device cpu):
  python -m fancyrec_tpu_torch.serving.index build out/ --checkpoint ... \
      --rootpath ... --collection ... [--mesh_shape R,1]
  python -m fancyrec_tpu_torch.serving.index add out/ --rootpath ... \
      --collection newposts [--mesh_shape R,1]
  python -m fancyrec_tpu_torch.serving.index ivf-build out/ --quantize int8
  python -m fancyrec_tpu_torch.serving.index query out/ --brands 0,3 --k 10 \
      [--nprobe 8] [--mesh_shape auto]
  torchrun --nproc_per_node R -m fancyrec_tpu_torch.serving.index query \
      out/ --brands 0,3 --quantize int8 --mesh_shape R,1
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.device import resolve_device
from fancyrec_tpu_torch.io.bigfile import BigFileReader, BigFileWriter
from fancyrec_tpu_torch.ops.similarity import (
    distributed_retrieval_topk, quantize_rows_int8_np, ranked_retrieval_topk,
    retrieval_topk, topk_int8)
from fancyrec_tpu_torch.parallel import distributed
from fancyrec_tpu_torch.parallel.mesh import Mesh, build_mesh


def load_collection(ckpt, rootpath: str, collection: str,
                    bert_vocab: str = ""):
    """A collection's PostDataset, read as the checkpoint's config says
    -> (cfg finalized against the collection's vocabularies, dataset)."""
    from fancyrec_tpu_torch.data.dataset import PostDataset, load_info
    from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer
    from fancyrec_tpu_torch.io.bigfile import ImageBigFile
    from fancyrec_tpu_torch.io.dictfile import read_dict
    from fancyrec_tpu_torch.io.vocab import Bow2Vec, load_vocab

    cfg = ckpt["config"]
    cfg.rootpath = rootpath
    feat_dir = os.path.join(rootpath, collection, "FeatureData")
    video_feat = ImageBigFile(os.path.join(feat_dir, cfg.video_feature))
    img_feat = ImageBigFile(os.path.join(feat_dir, cfg.img_feature))
    video2frames = read_dict(os.path.join(feat_dir, cfg.video_feature,
                                          "video2frames.txt"))
    vocab_dir = os.path.join(rootpath, cfg.trainCollection, "TextData",
                             "vocabulary")
    bow_vocab = load_vocab(os.path.join(vocab_dir, "bow", cfg.vocab + ".pkl"))
    rnn_vocab = load_vocab(os.path.join(vocab_dir, "rnn", cfg.vocab + ".pkl"))
    cfg.bow_vocab_size = len(bow_vocab)
    cfg.vocab_size = len(rnn_vocab)
    cfg.finalize()
    tokenizer = None
    if cfg.text_net == "transformers":
        tokenizer = WordPieceTokenizer(
            bert_vocab or cfg.bert_vocab
            or os.path.join(rootpath, "bert_vocab.txt"))
    img_info, cls_info = load_info(rootpath)

    dataset = PostDataset(
        os.path.join(rootpath, collection, "TextData",
                     "%s.caption.txt" % collection),
        video_feat, img_feat, Bow2Vec(bow_vocab), text_net=cfg.text_net,
        rnn_vocab=rnn_vocab, tokenizer=tokenizer, video2frames=video2frames,
        img_info=img_info, cls_info=cls_info, max_frames=cfg.max_frames,
        max_tokens=cfg.max_tokens, max_words=cfg.max_words)
    return cfg, dataset


def _encode_collection(ckpt, rootpath: str, collection: str,
                       batch_size: int, bert_vocab: str,
                       device: torch.device, mesh=None):
    """Encode one collection with a loaded checkpoint -> (cap_ids, brands,
    post_embs, cfg, model). Under a world's mesh (`parallel.mesh.Mesh`)
    each data slot encodes its slice of every batch and every rank returns
    the whole collection; the model ranks of a slot split the weights."""
    from fancyrec_tpu_torch.data.loader import BatchLoader
    from fancyrec_tpu_torch.eval.evaluator import encode_data
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.parallel.mesh import (
        process_batch_shard, require_divisible_batch)

    cfg, dataset = load_collection(ckpt, rootpath, collection, bert_vocab)
    pshard = None
    if mesh is not None:
        require_divisible_batch(mesh, batch_size)
        pshard = process_batch_shard(mesh, batch_size)
    # train-time bucket config rides the checkpoint: length-sort the encode
    # order so bucketed padding bites (rows scatter back by dataset index)
    bucketing = bool(cfg.token_buckets_list or cfg.frame_buckets_list)
    loader = BatchLoader(dataset, batch_size, final_batch="pad",
                         grouped="sort" if bucketing else "off",
                         process_shard=pshard)

    model = FancyRec(cfg, mesh)
    model.load_full_state_dict(ckpt["state_dict"])
    model.to(device).eval()
    brands, post_embs = encode_data(model, loader, cfg.common_embedding_size,
                                    device,
                                    token_buckets=cfg.token_buckets_list,
                                    frame_buckets=cfg.frame_buckets_list)
    return dataset.caps.cap_ids, brands, post_embs, cfg, model


def build_index(checkpoint_path: str, rootpath: str, collection: str,
                out_dir: str, batch_size: int = 128, bert_vocab: str = "",
                device="cuda", mesh=None) -> int:
    """Encode every post of a collection into an on-disk index. In a world
    (mesh: this rank's `parallel.mesh.Mesh`, device: its device) every
    rank encodes and only the primary writes."""
    from fancyrec_tpu_torch.eval.evaluator import brand_embeddings
    from fancyrec_tpu_torch.parallel.distributed import barrier, is_primary
    from fancyrec_tpu_torch.train.checkpoints import load_any

    dev = resolve_device(device)
    ckpt = load_any(checkpoint_path)
    cap_ids, brands, post_embs, cfg, model = _encode_collection(
        ckpt, rootpath, collection, batch_size, bert_vocab, dev, mesh)
    # a collective where the model axis splits the brand tables
    b_embs = brand_embeddings(model, cfg.brand_num, dev).cpu().numpy()
    if not is_primary():
        barrier()           # no rank leaves before the index is written
        return len(cap_ids)

    # a rebuild must drop sidecars derived from the old embeddings: the
    # int8 cache (mtime ordering cannot tell a same-second rebuild) and the
    # IVF sidecar (its row indices point into the old store)
    for stale in ("feature.int8.bin", "inv_norms.npy"):
        p = os.path.join(out_dir, stale)
        if os.path.exists(p):
            os.remove(p)
    ivf_dir = os.path.join(out_dir, "ivf")
    if os.path.isdir(ivf_dir):
        import shutil
        shutil.rmtree(ivf_dir)
    # cap_ids contain '#', so the index store uses a tab-delimited id.txt
    with BigFileWriter(out_dir, ndims=cfg.common_embedding_size,
                       delimiter="\t") as w:
        w.write_batch(cap_ids, post_embs)
    np.save(os.path.join(out_dir, "brands.npy"), brands)
    np.save(os.path.join(out_dir, "brand_embeddings.npy"), b_embs)
    with open(os.path.join(out_dir, "index_meta.json"), "w") as f:
        f.write(json.dumps({"collection": collection,
                            "checkpoint": os.path.abspath(checkpoint_path),
                            "brand_num": cfg.brand_num,
                            "dim": cfg.common_embedding_size,
                            "n_posts": len(cap_ids)}))
    barrier()
    return len(cap_ids)


def add_collection_to_index(index_dir: str, rootpath: str, collection: str,
                            batch_size: int = 128, bert_vocab: str = "",
                            device="cuda", mesh=None) -> int:
    """Encode a new collection with the index's own checkpoint and append
    its posts (incremental index update; no rebuild). In a world, as
    `build_index`: every rank encodes, the primary appends."""
    from fancyrec_tpu_torch.train.checkpoints import load_any

    dev = resolve_device(device)
    with open(os.path.join(index_dir, "index_meta.json")) as f:
        meta = json.loads(f.read())
    ckpt = load_any(meta["checkpoint"])
    cap_ids, brands, post_embs, _, _ = _encode_collection(
        ckpt, rootpath, collection, batch_size, bert_vocab, dev, mesh)
    return append_to_index(index_dir, cap_ids, post_embs, brands)


def append_to_index(index_dir: str, cap_ids, post_embs, brands) -> int:
    """Incrementally add posts to an existing index (no rebuild).

    feature.bin is row-major float32, so new rows append in place;
    id.txt / shape.txt / brands.npy / index_meta.json are rewritten.
    Duplicate cap_ids are rejected (BigFile names are unique). Returns
    the new total post count. Open PostIndex instances must refresh().
    In a world every rank validates against the store as it was, then
    only the primary writes, and no rank returns before it has written.
    """
    from fancyrec_tpu_torch.parallel.distributed import barrier, is_primary

    store = BigFileReader(index_dir, delimiter="\t")
    post_embs = np.asarray(post_embs, np.float32)
    brands = np.asarray(brands, np.int32)
    if post_embs.ndim != 2 or post_embs.shape[1] != store.ndims:
        raise ValueError("dim mismatch: index %d, new rows %s"
                         % (store.ndims, post_embs.shape[1:]))
    if len(cap_ids) != len(post_embs) or len(brands) != len(post_embs):
        raise ValueError("cap_ids/brands/post_embs length mismatch")
    dup = set(cap_ids) & set(store.names)
    if dup:
        raise ValueError("duplicate post ids: %s" % sorted(dup)[:5])
    if len(set(cap_ids)) != len(cap_ids):
        raise ValueError("duplicate ids within the appended batch")
    if np.isnan(post_embs).any():
        raise ValueError("NaN rows in appended embeddings")
    barrier()
    if not is_primary():
        barrier()
        return store.nr_of_rows + len(cap_ids)

    with open(os.path.join(index_dir, "feature.bin"), "ab") as f:
        f.write(np.ascontiguousarray(post_embs).tobytes())
    _maybe_append_quantized_sidecar(index_dir, post_embs,
                                    store.nr_of_rows, store.ndims)
    names = list(store.names) + list(cap_ids)
    with open(os.path.join(index_dir, "id.txt"), "w", encoding="utf-8") as f:
        f.write("\t".join(names))
    with open(os.path.join(index_dir, "shape.txt"), "w") as f:
        f.write("%d %d" % (len(names), store.ndims))
    old_brands = np.load(os.path.join(index_dir, "brands.npy"))
    np.save(os.path.join(index_dir, "brands.npy"),
            np.concatenate([old_brands.astype(np.int32), brands]))
    meta_path = os.path.join(index_dir, "index_meta.json")
    with open(meta_path) as f:
        meta = json.loads(f.read())
    meta["n_posts"] = len(names)
    with open(meta_path, "w") as f:
        f.write(json.dumps(meta))
    barrier()
    return len(names)


def _maybe_append_quantized_sidecar(index_dir: str, new_rows: np.ndarray,
                                    n_before: int, ndims: int) -> None:
    """Keep the int8 sidecar cache in sync across appends: rows quantize
    independently, so the existing prefix stays valid and only the new tail
    is quantized. A sidecar that does not exactly match the pre-append
    store is left for the next quantized load to rebuild."""
    qpath = os.path.join(index_dir, "feature.int8.bin")
    ipath = os.path.join(index_dir, "inv_norms.npy")
    if not (os.path.exists(qpath) and os.path.exists(ipath)):
        return
    if os.path.getsize(qpath) != n_before * ndims:
        return
    inv = np.load(ipath).astype(np.float32)
    if inv.size != n_before:
        return
    tail, tinv = quantize_rows_int8_np(new_rows)
    with open(qpath, "ab") as f:
        f.write(np.ascontiguousarray(tail).tobytes())
    np.save(ipath, np.concatenate([inv, tinv]))


def fused_eligible(quantize: str, k: int, dim: int) -> bool:
    """Whether a query takes the fused int8 score+top-k
    (`ops.similarity.topk_int8`, the CUDA kernel on the card): an int8
    index, 1 <= k <= 128, and rows of whole 4-byte words (dim % 4 == 0),
    which the kernel reads; any width. Other queries take
    `retrieval_topk`."""
    return quantize == "int8" and 1 <= k <= 128 and dim % 4 == 0


def shard_rows(rows: np.ndarray, inv, devices):
    """Rows (N, D) and their inverse norms (N,) or None, padded with zero
    rows to a multiple of len(devices) and cut into that many contiguous
    shards of ceil(N / S) rows -> ([shard s on devices[s]], [its inverse
    norms] or None). Each part is an allocation of its own, so every
    shard's rows start on an allocation boundary whatever the width."""
    n_shards = len(devices)
    size = -(-rows.shape[0] // n_shards)
    pad = size * n_shards - rows.shape[0]
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, rows.shape[1]),
                                              rows.dtype)])
        if inv is not None:
            inv = np.concatenate([inv, np.zeros(pad, np.float32)])

    def put(a, dev):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)
    parts = [slice(s * size, (s + 1) * size) for s in range(n_shards)]
    shards = [put(rows[p], dev) for p, dev in zip(parts, devices)]
    invs = (None if inv is None
            else [put(inv[p], dev) for p, dev in zip(parts, devices)])
    return shards, invs


class PostIndex:
    """Query interface over a built index directory.

    quantize="int8" keeps the index int8 on the device (quantized on the
    host, so loads ship 1 byte/elem); a query that `fused_eligible` admits
    answers with the fused int8 score+top-k, the others with
    `retrieval_topk` over the same int8 rows. device_resident=False loads
    the posts at the first exact query (an IVF-only caller never does).

    mesh (a `parallel.mesh.ServingMesh` of S > 1 devices) shards the posts
    (`shard_rows`): the rows pad to a multiple of S, shard s and the int8
    sidecar's inverse norms beside it live on mesh.devices[s], and queries
    run `distributed_retrieval_topk`, routed as the single-device path
    routes them. `posts()` is then the list of shards. The IVF sidecar's
    lists shard over the same devices (`IVFIndex.shard_to_mesh`). The
    first device of the mesh takes the place of `device`: the queries'
    brands and the merged answers live there. A mesh of one device is the
    single-device path on that device.

    mesh (a `parallel.mesh.Mesh`, this rank's place in a world's layout)
    makes the index one rank's: the shards are the R data slots', this
    rank holds its slot's shard alone on `device` (`posts()` is that one
    tensor), read from the store (or the int8 sidecar) by itself, and its
    slot's IVF lists; queries are collectives of the world
    (`ranked_retrieval_topk`, `IVFIndex._query_ranked`) whose answer every
    rank holds. With int8, the primary writes a missing or stale sidecar
    before any rank reads it.
    """

    def __init__(self, index_dir: str, quantize: str = "", device="cuda",
                 device_resident: bool = True, mesh=None):
        if quantize not in ("", "int8"):
            raise ValueError("quantize must be '' or 'int8'")
        self.mesh = mesh
        # (data slot, data slots) of this rank in a world, else None
        self._slot = ((mesh.data_rank, mesh.data)
                      if isinstance(mesh, Mesh) else None)
        self.device = (resolve_device(mesh.devices[0])
                       if mesh is not None and self._slot is None
                       else resolve_device(device))
        self._shards = (1 if mesh is None else
                        mesh.data if self._slot else mesh.shards)
        self.quantize = quantize
        self._index_dir = index_dir
        self.brand_embs = np.load(
            os.path.join(index_dir, "brand_embeddings.npy"))
        self.refresh()
        if device_resident:
            self.posts()

    def refresh(self) -> None:
        """(Re)read the store after append_to_index; drops the device copy
        (or its shards), which the next query loads (and shards) again."""
        self.store = BigFileReader(self._index_dir, delimiter="\t")
        self.cap_ids = self.store.names
        self.brands = np.load(os.path.join(self._index_dir, "brands.npy"))
        with open(os.path.join(self._index_dir, "index_meta.json")) as f:
            self.meta = json.loads(f.read())
        self.n_posts = self.store.nr_of_rows
        self._posts = None
        self._posts_inv = None
        # appends invalidate the IVF sidecar's layout: the next ivf() call
        # rereads ivf_meta.json and flags a row-count mismatch as stale
        self._ivf = None
        self._ivf_stale = ""

    def ivf(self):
        """The lazily loaded IVF sidecar (build_ivf_sidecar), or None.

        Its packed row indices point into the store it was built from;
        ivf_meta.json records that store's row count (source_posts), and a
        mismatch marks the sidecar stale: the ANN path refuses until
        `ivf-build` runs again. Over a mesh its lists are sharded."""
        if self._ivf is None:
            self._ivf_stale = ""
            ivf_dir = os.path.join(self._index_dir, "ivf")
            meta_path = os.path.join(ivf_dir, "ivf_meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    src = json.loads(f.read()).get("source_posts", -1)
                if src != self.n_posts:
                    self._ivf_stale = (
                        "IVF sidecar is stale: built over %s posts, store "
                        "now has %d -- rerun `fancyrec-index ivf-build %s`"
                        % (src if src >= 0 else "unknown", self.n_posts,
                           self._index_dir))
                    return None
                from fancyrec_tpu_torch.serving.ivf import IVFIndex
                self._ivf = IVFIndex.load(ivf_dir, device=self.device,
                                          part=self._slot)
                if self._shards > 1 and self._slot is None:
                    self._ivf.shard_to_mesh(self.mesh)
        return self._ivf

    def _sidecar(self):
        """The int8 sidecar cached next to the store (feature.int8.bin /
        inv_norms.npy), mapped, not read -> (rows (N, D), inverse norms)
        or None. Valid only if at least as new as feature.bin with exactly
        matching row counts."""
        n, d = self.n_posts, self.store.ndims
        qpath = os.path.join(self._index_dir, "feature.int8.bin")
        ipath = os.path.join(self._index_dir, "inv_norms.npy")
        fpath = os.path.join(self._index_dir, "feature.bin")
        if not (os.path.exists(qpath) and os.path.exists(ipath)
                and os.path.getmtime(qpath) >= os.path.getmtime(fpath)
                and os.path.getsize(qpath) == n * d):
            return None
        try:
            inv = np.load(ipath, mmap_mode="r")
        except (ValueError, OSError):
            return None                       # corrupt sidecar: rebuild
        if inv.size != n:
            return None
        return np.memmap(qpath, np.int8, "r", shape=(n, d)), inv

    def _load_quantized(self, lo: int = 0, hi: int = None, write=True):
        """int8 rows [lo, hi) + their inverse norms, from the sidecar where
        it is valid; anything else requantizes: the whole store, written
        back as the sidecar (atomically; read-only index dirs quantize in
        memory) when `write`, else only rows [lo, hi) (rows quantize
        independently, so they equal the sidecar's)."""
        hi = self.n_posts if hi is None else hi
        side = self._sidecar()
        if side is not None:
            q, inv = side
            return np.array(q[lo:hi]), np.array(inv[lo:hi], np.float32)
        if not write:
            return quantize_rows_int8_np(self.store.read_rows(
                np.arange(lo, hi)))
        q, inv = quantize_rows_int8_np(
            self.store.read_rows(np.arange(self.n_posts)))
        qpath = os.path.join(self._index_dir, "feature.int8.bin")
        ipath = os.path.join(self._index_dir, "inv_norms.npy")
        try:
            # atomic (tmp + rename): a crash mid-save leaves a complete
            # file or none, never a truncated one
            with open(qpath + ".tmp", "wb") as f:
                f.write(np.ascontiguousarray(q).tobytes())
            os.replace(qpath + ".tmp", qpath)
            np.save(ipath + ".tmp.npy", inv)
            os.replace(ipath + ".tmp.npy", ipath)
        except OSError:
            pass
        return q[lo:hi], inv[lo:hi]

    def _slot_rows(self):
        """This rank's post shard in a world: its data slot's rows of the
        store (or of the int8 sidecar, which the primary writes first
        where it is missing or stale), zero-padded to `shard_size` as
        `shard_rows` pads the last shard -> (rows, inverse norms or
        None)."""
        size = self.shard_size
        lo = min(self._slot[0] * size, self.n_posts)
        hi = min(lo + size, self.n_posts)
        inv = None
        if self.quantize == "int8":
            if distributed.is_primary():
                rows, inv = self._load_quantized(lo, hi)
            distributed.barrier()
            if not distributed.is_primary():
                rows, inv = self._load_quantized(lo, hi, write=False)
        else:
            rows = self.store.read_rows(np.arange(lo, hi))
        pad = size - (hi - lo)
        if pad:
            rows = np.concatenate([rows, np.zeros((pad, rows.shape[1]),
                                                  rows.dtype)])
            if inv is not None:
                inv = np.concatenate([inv, np.zeros(pad, np.float32)])
        return rows, inv

    @property
    def shard_size(self) -> int:
        """Rows a shard holds (`shard_rows`)."""
        return -(-self.n_posts // self._shards)

    def posts(self):
        """The device-resident rows: one tensor, or over a ServingMesh the
        list of shards, or in a world this rank's shard."""
        if self._posts is None:
            inv = None
            if self._slot is not None:
                rows, inv = self._slot_rows()
            elif self.quantize == "int8":
                rows, inv = self._load_quantized()
            else:
                rows = self.store.read_rows(np.arange(self.n_posts))
            if self._shards == 1 or self._slot is not None:
                self._posts = torch.from_numpy(rows).to(self.device)
                if inv is not None:
                    self._posts_inv = torch.from_numpy(inv).to(self.device)
            else:
                self._posts, self._posts_inv = shard_rows(
                    rows, inv, self.mesh.devices)
        return self._posts

    def query(self, brand_ids: Sequence[int], k: int = 10,
              block: int = 4096, nprobe: int = 0) -> Tuple[np.ndarray, list]:
        """-> (scores (B, k), [[cap_id, ...] per brand]) best-first.

        When k exceeds the number of posts, the trailing slots carry score
        -inf and name None. nprobe > 0 answers from the IVF sidecar
        (approximate; it reads about nprobe/nlist of the index, for
        single-brand queries over large indexes)."""
        if nprobe > 0:
            ivf = self.ivf()
            if ivf is None:
                raise ValueError(
                    self._ivf_stale
                    or "nprobe given but no IVF sidecar: run "
                       "`fancyrec-index ivf-build %s` first"
                       % self._index_dir)
            vals, idxs = ivf.query(self.brand_embs[np.asarray(brand_ids)],
                                   k=k, nprobe=nprobe)
            names = [[self.cap_ids[i] if i >= 0 else None for i in row]
                     for row in idxs]
            return vals, names
        q = torch.from_numpy(self.brand_embs[np.asarray(brand_ids)]).to(
            self.device)
        posts = self.posts()
        fused = fused_eligible(self.quantize, k, self.store.ndims)
        if self._slot is not None:
            vals, idxs = ranked_retrieval_topk(
                q, posts, k, n_valid=self.n_posts, posts_inv=self._posts_inv,
                fused=fused, block=block)
        elif self._shards > 1:
            vals, idxs = distributed_retrieval_topk(
                q, posts, k, n_valid=self.n_posts, shard_size=self.shard_size,
                posts_inv=self._posts_inv, fused=fused, block=block)
        elif fused:
            vals, idxs = topk_int8(q, posts, self._posts_inv, k,
                                   n_valid=self.n_posts)
        else:
            vals, idxs = retrieval_topk(q, posts, k, block=block,
                                        n_valid=self.n_posts,
                                        posts_inv=self._posts_inv)
        vals = vals.cpu().numpy()
        idxs = idxs.cpu().numpy()
        names = [[self.cap_ids[i] if np.isfinite(v) else None
                  for i, v in zip(row, vrow)]
                 for row, vrow in zip(idxs, vals)]
        return vals, names


def build_ivf_sidecar(index_dir: str, nlist: int = None, iters: int = 10,
                      quantize: str = "", seed: int = 0,
                      train_rows: int = 524288, device="cuda") -> dict:
    """Build the IVF-Flat sidecar of an index directory under
    <index_dir>/ivf, for PostIndex.query(..., nprobe=N). Rows stream from
    the store in chunks (`IVFIndex.build_chunked`); k-means trains on an
    evenly-strided sample of `train_rows` rows. -> a summary with the
    seconds of each build stage."""
    from fancyrec_tpu_torch.serving.ivf import IVFIndex

    dev = resolve_device(device)
    store = BigFileReader(index_dir, delimiter="\t")
    ivf = IVFIndex.build_chunked(
        lambda lo, hi: store.read_rows(np.arange(lo, hi)),
        store.nr_of_rows, store.ndims, nlist=nlist, iters=iters, seed=seed,
        quantize=quantize, train_rows=train_rows, device=dev)
    out = os.path.join(index_dir, "ivf")
    # the store size the sidecar indexes, part of ivf_meta.json: PostIndex
    # refuses a sidecar whose row space no longer matches the store
    ivf.source_posts = store.nr_of_rows
    ivf.save(out)
    return {"nlist": int(ivf.nlist), "cap": int(ivf.cap),
            "posts": store.nr_of_rows, "spill_frac": ivf.spill_frac,
            "overflow_lists": int(ivf.overflow_lists), "out": out,
            "seconds": ivf.build_seconds}


_ENCODE_MESH_HELP = (
    "'' or 'auto' = encode data-parallel over every rank of the world "
    "(one process outside a world); 'R,M' = over R*M ranks (torchrun), "
    "the model ranks of a slot splitting the weights; a shape the world "
    "does not fill raises")


def main(argv=None):
    p = argparse.ArgumentParser(description="post-embedding index tool")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", parents=[common])
    b.add_argument("out_dir")
    b.add_argument("--checkpoint", required=True)
    b.add_argument("--rootpath", required=True)
    b.add_argument("--collection", required=True)
    b.add_argument("--batch_size", type=int, default=128)
    b.add_argument("--bert_vocab", default="")
    b.add_argument("--mesh_shape", default="", help=_ENCODE_MESH_HELP)
    ad = sub.add_parser("add", parents=[common])
    ad.add_argument("index_dir")
    ad.add_argument("--rootpath", required=True)
    ad.add_argument("--collection", required=True,
                    help="new collection to encode (with the index's own "
                         "checkpoint) and append")
    ad.add_argument("--batch_size", type=int, default=128)
    ad.add_argument("--bert_vocab", default="")
    ad.add_argument("--mesh_shape", default="", help=_ENCODE_MESH_HELP)
    iv = sub.add_parser("ivf-build", parents=[common])
    iv.add_argument("index_dir")
    iv.add_argument("--nlist", type=int, default=0,
                    help="coarse clusters (default ~2*sqrt(N))")
    iv.add_argument("--iters", type=int, default=10)
    iv.add_argument("--quantize", default="", choices=["", "int8"])
    iv.add_argument("--seed", type=int, default=0)
    iv.add_argument("--kmeans_train_rows", type=int, default=524288,
                    help="k-means training sample size (strided)")
    q = sub.add_parser("query", parents=[common])
    q.add_argument("index_dir")
    q.add_argument("--brands", required=True,
                   help="comma-separated brand ids")
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--nprobe", type=int, default=0,
                   help=">0: approximate single-query path over the IVF "
                        "sidecar, probing nprobe coarse clusters")
    q.add_argument("--mesh_shape", default="",
                   help="'auto' = shard posts over all local devices; "
                        "'N' or 'N,1' = over N; '' = single device. In a "
                        "world (torchrun): 'R,M' = over its R*M ranks, a "
                        "post shard a data slot; 'auto' = every rank on "
                        "data")
    q.add_argument("--quantize", default="", choices=["", "int8"])
    a = p.parse_args(argv)
    # as the JAX CLI joins its job before it builds the one mesh of every
    # subcommand: build and add always (a world's ranks encode), query
    # where --mesh_shape asks for a mesh
    in_world = a.cmd in ("build", "add") or (
        a.cmd == "query" and a.mesh_shape and "WORLD_SIZE" in os.environ)
    if in_world:
        device = distributed.initialize_multihost(a.device)
        mesh = build_mesh("" if a.mesh_shape == "auto" else a.mesh_shape)
    if a.cmd == "build":
        n = build_index(a.checkpoint, a.rootpath, a.collection, a.out_dir,
                        a.batch_size, a.bert_vocab, device=device, mesh=mesh)
        print(json.dumps({"indexed_posts": n, "out": a.out_dir}))
    elif a.cmd == "add":
        n = add_collection_to_index(a.index_dir, a.rootpath, a.collection,
                                    a.batch_size, a.bert_vocab,
                                    device=device, mesh=mesh)
        print(json.dumps({"total_posts": n, "index": a.index_dir}))
    elif a.cmd == "ivf-build":
        info = build_ivf_sidecar(a.index_dir, nlist=a.nlist or None,
                                 iters=a.iters, quantize=a.quantize,
                                 seed=a.seed,
                                 train_rows=a.kmeans_train_rows,
                                 device=a.device)
        print(json.dumps(info))
    else:
        if not in_world:
            device, mesh = a.device, None
            if a.mesh_shape:
                from fancyrec_tpu_torch.parallel.mesh import (
                    serving_mesh, visible_devices)
                mesh = serving_mesh(a.mesh_shape, visible_devices(a.device))
        index = PostIndex(a.index_dir, quantize=a.quantize, device=device,
                          device_resident=a.nprobe == 0, mesh=mesh)
        ids = [int(x) for x in a.brands.split(",")]
        vals, names = index.query(ids, k=a.k, nprobe=a.nprobe)
        if distributed.is_primary():
            for b_id, v, n in zip(ids, vals, names):
                print(json.dumps({"brand": b_id,
                                  "results": [{"post": pid,
                                               "score": round(float(s), 5)}
                                              for pid, s in zip(n, v)]}))


if __name__ == "__main__":
    main()
