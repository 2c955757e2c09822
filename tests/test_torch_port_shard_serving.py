"""Sharded serving in the port against the JAX package, on the CPU.

The JAX package shards its posts over the test session's 8 virtual CPU
devices (`build_mesh("8,1")` and `("4,1")`); the port places the same
number of shards on a device list that repeats the CPU. The same seeded
numpy inputs go through both:

  * `distributed_retrieval_topk`, float32 and int8, fused (the JAX Pallas
    kernel in interpret mode) and not, with N not a multiple of the shard
    count, a shard with no valid row and k > N;
  * the sharded `PostIndex`, `FancyRecService` (and `/v1/add`, whose new
    post the next query sees) against the JAX package's over its mesh and
    the port's single-device answers;
  * `IVFIndex.shard_to_mesh` on a sidecar the JAX package built and saved
    (the k-means seeds differ across packages), both probe modes, list
    counts the shards do not divide, k past the probed pool;
  * `index build` and `add` over two gloo ranks against one process and the
    JAX package's build;
  * the mesh rules (`serving_mesh` against `build_mesh`) and the CLIs'
    refusal of more shards than devices.

int8 values agree within 1e-6 (the brand scale's float32 multiply order
and `lax.rsqrt`'s last ulps), float32 within atol=rtol=5e-5.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fancyrec_tpu.io.vocab import load_vocab
from fancyrec_tpu.ops import similarity as jsim
from fancyrec_tpu.parallel.mesh import build_mesh as jax_build_mesh
from fancyrec_tpu.serving import ivf as jivf
from fancyrec_tpu.serving.index import PostIndex as JaxPostIndex
from fancyrec_tpu.serving.index import build_index as jax_build_index
from fancyrec_tpu.serving.server import FancyRecService as JaxService
from fancyrec_tpu.train import checkpoints as jax_checkpoints
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.interop import load_jax_variables
from fancyrec_tpu_torch.io.bigfile import BigFileReader
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.ops import similarity as tsim
from fancyrec_tpu_torch.parallel import mesh as pmesh
from fancyrec_tpu_torch.parallel.mesh import ServingMesh, serving_mesh
from fancyrec_tpu_torch.serving import index as pindex
from fancyrec_tpu_torch.serving import ivf as pivf
from fancyrec_tpu_torch.serving import server as pserver
from fancyrec_tpu_torch.serving.index import PostIndex
from fancyrec_tpu_torch.serving.server import FancyRecService
from fancyrec_tpu_torch.train.checkpoints import save_checkpoint
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_serving import _toy_index
from tests.test_torch_port_ivf import _clustered, assert_same_posts
from tests.test_torch_port_model import jax_variables, tiny_cfg_kwargs
from tests.test_torch_port_parallel import results, run_world

F32_TOL = dict(atol=5e-5, rtol=5e-5)
INT8_TOL = dict(atol=1e-6, rtol=0)
CPU = torch.device("cpu")


def cpu_mesh(shards):
    return ServingMesh((CPU,) * shards)


def _needs_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


# ---------------------------------------------------------------------------
# the mesh rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["", "auto", "4", "2,1", "3,2", "1,1"])
def test_serving_mesh_takes_the_devices_build_mesh_takes(shape):
    """The shards lie where the JAX mesh's data axis lies: shard s on the
    first device of data row s."""
    _needs_8()
    cards = [torch.device("cuda", i) for i in range(8)]
    got = serving_mesh(shape, cards)
    want = jax_build_mesh("" if shape == "auto" else shape)
    assert got.shards == want.devices.shape[0]
    assert [d.index for d in got.devices] == [
        d.id for d in want.devices[:, 0]]


@pytest.mark.parametrize("shape", ["9", "5,2"])
def test_serving_mesh_refuses_what_build_mesh_refuses(shape):
    _needs_8()
    with pytest.raises(ValueError, match="needs"):
        jax_build_mesh(shape)
    with pytest.raises(ValueError, match="needs"):
        serving_mesh(shape, [torch.device("cuda", i) for i in range(8)])


# ---------------------------------------------------------------------------
# distributed_retrieval_topk
# ---------------------------------------------------------------------------

N_POSTS, DIM, BLOCK = 103, 16, 16


def _jax_distributed(brands, rows, inv, k, shards, fused):
    mesh = jax_build_mesh("%d,1" % shards)
    with mesh:
        rows_sh = jax.device_put(rows, NamedSharding(mesh, P("data", None)))
        inv_sh = (None if inv is None else
                  jax.device_put(inv, NamedSharding(mesh, P("data"))))
        v, i = jsim.distributed_retrieval_topk(
            jnp.asarray(brands), rows_sh, k, mesh, block=BLOCK,
            n_valid=N_POSTS, posts_inv=inv_sh, fused=fused)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("shards", [8, 4])
@pytest.mark.parametrize("kind", ["f32", "int8", "int8_fused"])
def test_distributed_retrieval_topk_matches_jax(shards, kind):
    """103 posts padded to shards of whole 16-row blocks (8 shards: the last
    holds no valid row), k below and above N; the port's shards share the
    CPU. Against the JAX sharded answer and the port's single-device one."""
    _needs_8()
    rng = np.random.RandomState(shards)
    brands = rng.randn(5, DIM).astype(np.float32)
    posts = rng.randn(N_POSTS, DIM).astype(np.float32)
    posts[60:64] = posts[3]                     # ties across shards
    int8, fused = kind != "f32", kind == "int8_fused"
    size = -(-N_POSTS // (shards * BLOCK)) * BLOCK
    pad = size * shards - N_POSTS
    if int8:
        rows, inv = tsim.quantize_rows_int8_np(posts)
        inv = np.concatenate([inv, np.zeros(pad, np.float32)])
    else:
        rows, inv = posts, None
    rows = np.concatenate([rows, np.zeros((pad, DIM), rows.dtype)])
    if shards == 8:
        assert N_POSTS <= size * 7          # the last shard: no valid row
    def part(a):
        return [torch.from_numpy(a[s * size:(s + 1) * size].copy())
                for s in range(shards)]
    post_shards = part(rows)
    inv_shards = None if inv is None else part(inv)
    tol = INT8_TOL if int8 else F32_TOL
    for k in (7, 120):
        want_v, want_i = _jax_distributed(brands, rows, inv, k, shards, fused)
        got_v, got_i = tsim.distributed_retrieval_topk(
            torch.from_numpy(brands), post_shards, k, n_valid=N_POSTS,
            shard_size=size, posts_inv=inv_shards, fused=fused, block=BLOCK)
        got_v, got_i = got_v.numpy(), got_i.numpy()
        fin = np.isfinite(want_v)
        assert np.array_equal(np.isfinite(got_v), fin)
        assert fin.sum() == 5 * min(k, N_POSTS)
        np.testing.assert_array_equal(got_i[fin], want_i[fin])
        np.testing.assert_allclose(got_v[fin], want_v[fin], **tol)
        if fused:
            # the -inf slots too: each shard's filler, local row 0
            np.testing.assert_array_equal(got_i, want_i)
        # the port's single device: the same rows unsharded
        one = torch.from_numpy(rows[:N_POSTS].copy())
        if fused:
            sv, si = tsim.topk_int8(torch.from_numpy(brands), one,
                                    torch.from_numpy(inv[:N_POSTS].copy()),
                                    k)
        else:
            sv, si = tsim.retrieval_topk(
                torch.from_numpy(brands), one, k,
                posts_inv=(None if inv is None else
                           torch.from_numpy(inv[:N_POSTS].copy())))
        np.testing.assert_array_equal(got_i[fin], si.numpy()[fin])
        if int8:                             # exact integer dots
            np.testing.assert_array_equal(got_v, sv.numpy())
        else:
            np.testing.assert_allclose(got_v, sv.numpy(), **F32_TOL)


def test_distributed_retrieval_topk_refuses_bad_shards():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="shard_size"):
        tsim.distributed_retrieval_topk(torch.zeros(1, 8), [a, a[:3]], 2)
    with pytest.raises(ValueError, match="int8 index"):
        tsim.distributed_retrieval_topk(torch.zeros(1, 8), [a.float()], 2,
                                        fused=True)


# ---------------------------------------------------------------------------
# PostIndex and FancyRecService over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("shard_toy") / "toy")
    _toy_index(idx, n_posts=97)      # 97 rows: not a multiple of 4 or 8
    return idx


@pytest.mark.parametrize("shards", [8, 4])
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_sharded_post_index_matches_jax_and_one_device(toy, shards,
                                                       quantize):
    _needs_8()
    brands = [0, 1, 2, 3]
    one = PostIndex(toy, quantize=quantize, device="cpu")
    idx = PostIndex(toy, quantize=quantize, mesh=cpu_mesh(shards))
    posts = idx.posts()
    size = -(-97 // shards)
    assert len(posts) == shards and all(p.shape == (size, 16)
                                        for p in posts)
    assert len({p.data_ptr() for p in posts}) == shards   # own allocations
    if quantize:
        assert len(idx._posts_inv) == shards
    jmesh = jax_build_mesh("%d,1" % shards)
    # int8: the JAX fused Pallas kernel per shard (interpret mode)
    jidx = JaxPostIndex(toy, mesh=jmesh, quantize=quantize,
                        fused=True if quantize else None)
    for k in (9, 120):
        got_v, got_n = idx.query(brands, k=k)
        want_v, want_n = jidx.query(brands, k=k)
        one_v, one_n = one.query(brands, k=k)
        assert got_n == want_n == one_n
        tol = INT8_TOL if quantize else F32_TOL
        np.testing.assert_allclose(got_v, one_v, **tol)
        np.testing.assert_allclose(got_v, want_v, **tol)
    assert got_n[0][97:] == [None] * 23


def test_sharded_service_and_add_match_jax(toy, tmp_path):
    """/v1/topk over 4 shards as the JAX service over its mesh answers;
    /v1/add re-shards, and the next query sees the new post."""
    _needs_8()
    idx = str(tmp_path / "index")
    shutil.copytree(toy, idx)
    service = FancyRecService(idx, quantize="int8", mesh=cpu_mesh(4))
    jservice = JaxService(toy, quantize="int8", mesh=jax_build_mesh("4,1"))
    body = {"brand_ids": [0, 1, 2, 3], "k": 6}
    got, want = service.topk(body), jservice.topk(body)
    assert ([[p["cap_id"] for p in r["posts"]] for r in got["results"]]
            == [[p["cap_id"] for p in r["posts"]] for r in want["results"]])
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_allclose([p["score"] for p in g["posts"]],
                                   [p["score"] for p in w["posts"]],
                                   **INT8_TOL)
    assert service.healthz()["n_posts"] == 97

    new = (service.index.brand_embs[2] * 5.0).tolist()
    assert service.add({"cap_ids": ["fresh#enc#0"], "embeddings": [new],
                        "brands": [2]})["n_posts"] == 98
    res = service.topk({"brand_ids": [2], "k": 3})
    assert res["results"][0]["posts"][0]["cap_id"] == "fresh#enc#0"
    shards = service.index.posts()
    assert len(shards) == 4 and shards[0].shape[0] == 25     # 98 -> 100
    one = FancyRecService(idx, quantize="int8", device="cpu")
    assert one.topk(body) == service.topk(body)


# ---------------------------------------------------------------------------
# IVF lists over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sidecars(tmp_path_factory):
    """Sidecars the JAX package built and saved: 10 lists (and any
    overflow), which 4 and 8 shards do not divide."""
    tmp = tmp_path_factory.mktemp("shard_ivf")
    x = _clustered(n=1500, d=32, n_clusters=12, seed=5)
    out = {"x": x}
    for q in ("", "int8"):
        path = str(tmp / ("sidecar_" + (q or "f32")))
        jivf.IVFIndex.build(x, nlist=10, iters=5, quantize=q).save(path)
        out[q] = path
    return out


@pytest.mark.parametrize("shards", [8, 4])
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_sharded_ivf_matches_jax_sharded_and_one_device(jax_sidecars, shards,
                                                        quantize):
    _needs_8()
    path, x = jax_sidecars[quantize], jax_sidecars["x"]
    qs = x[[3, 77, 512]] + 0.01
    one = pivf.IVFIndex.load(path, device="cpu")
    port = pivf.IVFIndex.load(path, device="cpu")
    assert port.shard_to_mesh(cpu_mesh(shards)) is port
    n_lists = 10 + one.overflow_lists
    per = -(-n_lists // shards)
    assert [t.shape[0] for t in port.packed] == [per] * shards
    ids = torch.cat(port.packed_idx)
    assert torch.equal(ids[:n_lists], one.packed_idx)
    assert (ids[n_lists:] == -1).all()
    jx = jivf.IVFIndex.load(path)
    jx.shard_to_mesh(jax_build_mesh("%d,1" % shards))
    for probe, nprobe in (("cosine", 2), ("cosine", 5), ("cosine", 10),
                          ("bound", 3)):
        want_v, want_i = jx.query(qs, k=7, nprobe=nprobe, probe=probe)
        got_v, got_i = port.query(qs, k=7, nprobe=nprobe, probe=probe)
        assert_same_posts(got_v, got_i, want_v, want_i,
                          ulps=2 if quantize else 0)
        np.testing.assert_allclose(got_v, np.asarray(want_v), atol=1e-6,
                                   rtol=0)
        one_v, one_i = one.query(qs, k=7, nprobe=nprobe, probe=probe)
        np.testing.assert_array_equal(got_i, one_i)
        np.testing.assert_allclose(got_v, one_v, atol=1e-6, rtol=0)


def test_sharded_ivf_k_past_pool_pads_as_jax(jax_sidecars, tmp_path):
    """k past one probe's pool pads with -inf / -1 as the JAX sharded
    query does; a sharded index saves whole, without its pad lists."""
    _needs_8()
    path, x = jax_sidecars["int8"], jax_sidecars["x"]
    port = pivf.IVFIndex.load(path, device="cpu")
    k = port.cap * (1 + port.overflow_lists) + 5
    port.shard_to_mesh(cpu_mesh(8))
    jx = jivf.IVFIndex.load(path)
    jx.shard_to_mesh(jax_build_mesh("8,1"))
    want_v, want_i = jx.query(x[:2], k=k, nprobe=1)
    got_v, got_i = port.query(x[:2], k=k, nprobe=1)
    assert_same_posts(got_v, got_i, want_v, want_i, ulps=2)
    np.testing.assert_allclose(got_v, np.asarray(want_v), atol=1e-6, rtol=0)
    assert np.isneginf(got_v[:, -1]).all() and (got_i[:, -1] == -1).all()
    port.save(str(tmp_path))
    for name in ("packed.bin", "packed_idx.npy", "inv_norms.npy",
                 "centroids.npy"):
        with open(os.path.join(path, name), "rb") as a, \
                open(os.path.join(str(tmp_path), name), "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(ValueError, match="unsharded"):
        port.compute_radii()


def test_sharded_post_index_shards_its_ivf(tmp_path):
    idx = str(tmp_path / "toy")
    _toy_index(idx, n_posts=300)
    pindex.build_ivf_sidecar(idx, nlist=6, iters=3, quantize="int8",
                             device="cpu")
    one = PostIndex(idx, quantize="int8", device="cpu",
                    device_resident=False)
    sharded = PostIndex(idx, quantize="int8", mesh=cpu_mesh(4),
                        device_resident=False)
    assert sharded.ivf().mesh is not None and one.ivf().mesh is None
    for npb in (1, 3, 6):
        assert one.query([0, 1, 2], k=5, nprobe=npb)[1] == sharded.query(
            [0, 1, 2], k=5, nprobe=npb)[1]


# ---------------------------------------------------------------------------
# build and add over ranks; the CLIs
# ---------------------------------------------------------------------------

FIXTURE = dict(brand_num=4, videos_per_brand=3, imgs_per_brand=3,
               feat_dim=12, frames_per_video=5, seed=0)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of weights as a JAX checkpoint and as the port's, over a
    fixture tree of each package (their trees are the same files)."""
    from fancyrec_tpu.utils.fixture import make_fixture as jax_make_fixture
    tmp = tmp_path_factory.mktemp("shard_build")
    root_j, root_t = str(tmp / "jax_tree"), str(tmp / "port_tree")
    info = jax_make_fixture(root_j, **FIXTURE)
    make_fixture(root_t, **FIXTURE)
    vdir = os.path.join(root_j, "insCartrain", "TextData", "vocabulary")
    kw = tiny_cfg_kwargs()
    kw.update(trainCollection="insCartrain",
              video_feature=info["video_feature"],
              img_feature=info["img_feature"], vocab="word_vocab_5",
              bow_vocab_size=len(load_vocab(os.path.join(
                  vdir, "bow", "word_vocab_5.pkl"))),
              vocab_size=len(load_vocab(os.path.join(
                  vdir, "rnn", "word_vocab_5.pkl"))))
    jcfg, _, params, stats = jax_variables(kw, seed=6)
    ckpt_j = str(tmp / "jax.pth.tar")
    jax_checkpoints.save_checkpoint(ckpt_j, jcfg, params, stats, epoch=1,
                                    best_rsum=0.0, eiters=1)
    ckpt_t = os.path.join(root_t, "port.pth.tar")
    cfg = Config(**kw).finalize()
    save_checkpoint(ckpt_t, cfg,
                    load_jax_variables(FancyRec(cfg), params, stats))
    return {"root_j": root_j, "root_t": root_t, "ckpt_j": ckpt_j,
            "ckpt_t": ckpt_t, "tmp": tmp}


_BUILD_ADD = """
import builtins, json, os, sys, time
import torch
torch.set_num_threads(1)
root, ckpt, out = sys.argv[1:4]
rank = int(os.environ["RANK"])
if rank != 0:
    _open = builtins.open
    def _trap(file, mode="r", *a, **k):
        if (set(mode) & set("wax+")
                and os.path.abspath(str(file)).startswith(root)):
            raise AssertionError("rank %d opened %s to write" % (rank, file))
        return _open(file, mode, *a, **k)
    builtins.open = _trap
from fancyrec_tpu_torch.serving import index
if rank:
    # rank 1 reaches the append late: it must still validate against the
    # store as it was before the primary appends
    _append = index.append_to_index
    def _late(*a, **k):
        time.sleep(3)
        return _append(*a, **k)
    index.append_to_index = _late
common = ["--rootpath", root, "--batch_size", "4", "--device", "cpu",
          "--mesh_shape", "2,1"]
index.main(["build", out, "--checkpoint", ckpt, "--collection",
            "insCartest"] + common)
index.main(["add", out, "--collection", "insCarval"] + common)
print("RESULT " + json.dumps({"rank": rank}))
"""


def _rows(idx):
    store = BigFileReader(idx, delimiter="\t")
    return store.names, store.read_rows(np.arange(store.nr_of_rows))


def test_build_and_add_over_two_ranks(checkpoints):
    """`index build` then `add` at --mesh_shape 2,1 over two gloo ranks:
    only the primary writes (rank 1 fails on any write under the tree), a
    late rank validates the add against the store the primary has not yet
    appended to,
    the cap ids come in the one-process build's order and the rows within
    5e-5 of it and of the JAX package's build."""
    root, ckpt = checkpoints["root_t"], checkpoints["ckpt_t"]
    ranked = os.path.join(root, "index_2rank")
    results(run_world(_BUILD_ADD, [root, ckpt, ranked]))
    one = str(checkpoints["tmp"] / "index_1proc")
    pindex.build_index(ckpt, root, "insCartest", one, batch_size=4,
                       device="cpu")
    jax_idx = str(checkpoints["tmp"] / "index_jax")
    jax_build_index(checkpoints["ckpt_j"], checkpoints["root_j"],
                    "insCartest", jax_idx, batch_size=4)
    names_r, rows_r = _rows(ranked)
    names_o, rows_o = _rows(one)
    names_j, rows_j = _rows(jax_idx)
    assert names_r[:24] == names_o == names_j
    np.testing.assert_allclose(rows_r[:24], rows_o, **F32_TOL)
    np.testing.assert_allclose(rows_r[:24], rows_j, **F32_TOL)
    for f in ("brands.npy", "brand_embeddings.npy"):
        np.testing.assert_allclose(np.load(os.path.join(ranked, f))[:24],
                                   np.load(os.path.join(one, f)), **F32_TOL)
    # the add: 24 val posts appended once, as one process appends them
    pindex.add_collection_to_index(one, root, "insCarval", batch_size=4,
                                   device="cpu")
    names_o, rows_o = _rows(one)
    assert names_r == names_o and len(names_r) == 48
    np.testing.assert_allclose(rows_r, rows_o, **F32_TOL)
    with open(os.path.join(ranked, "index_meta.json")) as f:
        assert json.load(f)["n_posts"] == 48


def test_index_cli_query_over_a_mesh(toy, monkeypatch, capsys):
    """`query --mesh_shape 4` over a host of four devices (the CPU four
    times) prints what the single-device query prints."""
    pindex.main(["query", toy, "--brands", "0,3", "--k", "5", "--quantize",
                 "int8", "--device", "cpu"])
    want = capsys.readouterr().out
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device="cuda": (CPU,) * 4)
    pindex.main(["query", toy, "--brands", "0,3", "--k", "5", "--quantize",
                 "int8", "--device", "cpu", "--mesh_shape", "4"])
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("cli", ["query", "serve", "build"])
def test_clis_refuse_more_shards_than_devices(toy, checkpoints, tmp_path,
                                              cli):
    """One CPU is one device, and a process outside a world one rank."""
    with pytest.raises(ValueError, match="needs 2"):
        if cli == "query":
            pindex.main(["query", toy, "--brands", "0", "--device", "cpu",
                         "--mesh_shape", "2"])
        elif cli == "serve":
            pserver.main([toy, "--device", "cpu", "--mesh_shape", "2,1"])
        else:
            pindex.main(["build", str(tmp_path / "out"), "--checkpoint",
                         checkpoints["ckpt_t"], "--rootpath",
                         checkpoints["root_t"], "--collection", "insCartest",
                         "--device", "cpu", "--mesh_shape", "2,1"])
