"""`index query --mesh_shape` over the ranks of a world, in the port
against one process and the JAX package, on the CPU.

Gloo worlds of 2 ranks at --mesh_shape 2,1 and of 4 ranks at 2,2 run the
query CLI's `main` in turn on a 97-post toy index (97 rows: not a multiple
of the 2 post shards, and k = 120 past them), float32 and int8, exact and
`--nprobe` over an IVF sidecar of each kind. Each rank records what it
read and holds; the test holds the answers:

  * bit for bit equal to one process's sharded answer over the same 2
    shards (`serving_mesh("2")`'s layout: a device list that repeats the
    CPU), filler slots included;
  * within 1e-6 (int8) or atol=rtol=5e-5 (float32) of the JAX `PostIndex`
    over its 2-device mesh (the int8 one through its fused Pallas kernel
    in interpret mode), exact and IVF;
  * `--nprobe` equal to the unsharded sidecar's answer.

And the layout: each rank holds only its data slot's rows (and IVF lists),
read from the store alone, the int8 sidecar written once, by the primary,
only the primary prints, and a mesh that leaves ranks idle is refused.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from fancyrec_tpu.parallel.mesh import build_mesh as jax_build_mesh
from fancyrec_tpu.serving.index import PostIndex as JaxPostIndex
from fancyrec_tpu_torch.parallel.mesh import ServingMesh
from fancyrec_tpu_torch.serving import index as pindex
from fancyrec_tpu_torch.serving.index import PostIndex
from fancyrec_tpu_torch.serving.ivf import IVFIndex
from tests.test_serving import _toy_index
from tests.test_torch_port_ivf import assert_same_posts
from tests.test_torch_port_parallel import results, run_world

F32_TOL = dict(atol=5e-5, rtol=5e-5)
INT8_TOL = dict(atol=1e-6, rtol=0)
N_POSTS, DIM, BRANDS = 97, 16, [0, 1, 2, 3]
CPU = torch.device("cpu")

# One rank: spec {"runs": [[name, argv]], "out": the dump prefix}. Each run
# is the query CLI's main with stdout captured; the rank records the rows
# it read from the store, the sidecar files it wrote, the rows it
# quantized, and what its index holds (its post shard, or its IVF lists).
_QUERY = r"""
import contextlib, io, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from fancyrec_tpu_torch.io import bigfile
from fancyrec_tpu_torch.parallel import collectives
from fancyrec_tpu_torch.serving import index
spec = json.loads(sys.argv[1])
seen = {}
_read = bigfile.BigFileReader.read_rows
def read_rows(self, idx):
    idx = np.asarray(idx)
    if idx.size:
        seen["read"].append([int(idx.min()), int(idx.max()) + 1,
                             int(idx.size)])
    return _read(self, idx)
bigfile.BigFileReader.read_rows = read_rows
_replace = os.replace
def replace(a, b):
    seen["wrote"].append(os.path.basename(b))
    return _replace(a, b)
os.replace = replace
_quantize = index.quantize_rows_int8_np
def quantize(rows):
    seen["quantized"] += len(rows)
    return _quantize(rows)
index.quantize_rows_int8_np = quantize
_query = index.PostIndex.query
def query(self, brand_ids, k=10, block=4096, nprobe=0):
    vals, names = _query(self, brand_ids, k=k, block=block, nprobe=nprobe)
    held = {"vals": vals}
    if nprobe:
        held["lists"] = self.ivf().packed_idx.numpy()
    else:
        held["posts"] = self.posts().float().numpy()
    np.savez("%s.%s.%d.npz" % (spec["out"], seen["name"],
                                collectives.rank()), **held)
    seen["names"] = names
    return vals, names
index.PostIndex.query = query
out = {}
for name, argv in spec["runs"]:
    seen.update(name=name, read=[], wrote=[], quantized=0, names=None)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            index.main(argv)
    except ValueError as e:
        out[name] = {"error": str(e)}
        continue
    out[name] = {"stdout": buf.getvalue(), "read": seen["read"],
                 "wrote": seen["wrote"], "quantized": seen["quantized"],
                 "names": seen["names"]}
print("RESULT " + json.dumps({"rank": collectives.rank(),
                              "mesh": [collectives.data_size(),
                                       collectives.model_size()],
                              "runs": out}))
"""

# the runs of a world: name -> (index, quantize, k, nprobe)
RUNS = {"f32_k9": ("f32", "", 9, 0), "f32_k120": ("f32", "", 120, 0),
        "int8_k9": ("int8", "int8", 9, 0),
        "int8_k120": ("int8", "int8", 120, 0),
        "ivf_int8": ("int8", "int8", 7, 3), "ivf_f32": ("f32", "", 7, 3),
        "ivf_int8_k_past": ("int8", "int8", 60, 1)}


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The toy index twice, with an int8 and a float32 IVF sidecar; the
    int8 sidecar of the post rows not yet written."""
    tmp = tmp_path_factory.mktemp("world_query")
    paths = {}
    for kind, q in (("int8", "int8"), ("f32", "")):
        path = str(tmp / kind)
        _toy_index(path, n_posts=N_POSTS, dim=DIM)
        pindex.build_ivf_sidecar(path, nlist=6, iters=3, quantize=q,
                                 device="cpu")
        paths[kind] = path
    paths["tmp"] = tmp
    return paths


def _argv(path, quantize, k, nprobe, mesh):
    argv = ["query", path, "--brands", ",".join(map(str, BRANDS)), "--k",
            str(k), "--device", "cpu", "--mesh_shape", mesh]
    if quantize:
        argv += ["--quantize", quantize]
    if nprobe:
        argv += ["--nprobe", str(nprobe)]
    return argv


def _world(indexes, tag, mesh, ranks):
    """A world of `ranks` over fresh copies of the indexes (no int8 row
    sidecar yet) running every RUNS entry at `mesh`, then a mesh of one
    rank (idle ranks) -> (the ranks' results, the copies, the dump
    prefix)."""
    copies = {}
    for kind in ("int8", "f32"):
        copies[kind] = str(indexes["tmp"] / ("%s_%s" % (tag, kind)))
        shutil.copytree(indexes[kind], copies[kind])
    runs = [[name, _argv(copies[kind], q, k, npb, mesh)]
            for name, (kind, q, k, npb) in RUNS.items()]
    runs.append(["idle", _argv(copies["f32"], "", 9, 0, "1,1")])
    out = str(indexes["tmp"] / tag)
    got = results(run_world(_QUERY, [json.dumps({"runs": runs,
                                                 "out": out})], ranks))
    return got, copies, out


@pytest.fixture(scope="module")
def world_2x1(indexes):
    return _world(indexes, "w21", "2,1", 2)


@pytest.fixture(scope="module")
def world_2x2(indexes):
    return _world(indexes, "w22", "2,2", 4)


WORLDS = pytest.mark.parametrize("world", ["world_2x1", "world_2x2"],
                                 indirect=True)


@pytest.fixture
def world(request):
    """The world fixture that the parameter names."""
    return request.getfixturevalue(request.param)


def _dump(out, name, rank):
    return np.load("%s.%s.%d.npz" % (out, name, rank))


def _one_process(path, quantize, k, nprobe):
    """One process's answer over the same 2 shards (the CPU twice)."""
    idx = PostIndex(path, quantize=quantize, mesh=ServingMesh((CPU,) * 2),
                    device_resident=nprobe == 0)
    return idx.query(BRANDS, k=k, nprobe=nprobe)


@WORLDS
@pytest.mark.parametrize("name", list(RUNS))
def test_world_answer_is_one_process_sharded_answer(world, name):
    """Every rank holds the one-process answer over the same shards, bit
    for bit (filler slots: -inf, name None), and only the primary
    prints it, as one process prints it."""
    got, copies, out = world
    kind, q, k, npb = RUNS[name]
    want_v, want_n = _one_process(copies[kind], q, k, npb)
    for r in got:
        v = _dump(out, name, r["rank"])["vals"]
        assert np.array_equal(v, want_v), (r["rank"], v, want_v)
        assert r["runs"][name]["names"] == want_n
    printed = [r["runs"][name]["stdout"] for r in got]
    assert all(p == "" for p in printed[1:])
    lines = [json.loads(x) for x in printed[0].splitlines()]
    assert [x["brand"] for x in lines] == BRANDS
    assert [[p["post"] for p in x["results"]] for x in lines] == want_n
    if k > N_POSTS:
        assert want_n[0][N_POSTS:] == [None] * (k - N_POSTS)
        assert np.isneginf(want_v[:, N_POSTS:]).all()


def _jax_answer(path, quantize, k, nprobe):
    mesh = jax_build_mesh("2,1", jax.devices()[:2])
    jidx = JaxPostIndex(path, mesh=mesh, quantize=quantize,
                        fused=True if quantize and not nprobe else None)
    return jidx.query(BRANDS, k=k, nprobe=nprobe)


def _ids(names):
    return np.array([[-1 if n is None else int(n[4:].split("#")[0])
                      for n in row] for row in names])


@WORLDS
@pytest.mark.parametrize("name", list(RUNS))
def test_world_answer_matches_jax_over_its_mesh(world, name):
    """The JAX package's PostIndex over a 2-device mesh (the same shards
    of posts, or of IVF lists): the same posts, int8 within 1e-6 (posts
    within 2 ulps of JAX's rsqrt may trade places on the IVF path),
    float32 within 5e-5."""
    got, copies, out = world
    kind, q, k, npb = RUNS[name]
    want_v, want_n = _jax_answer(copies[kind], q, k, npb)
    want_v = np.asarray(want_v)
    got_v = _dump(out, name, 0)["vals"]
    got_n = got[0]["runs"][name]["names"]
    fin = np.isfinite(want_v)
    assert np.array_equal(np.isfinite(got_v), fin)
    if npb:
        assert_same_posts(got_v, _ids(got_n), want_v, _ids(want_n),
                          ulps=2 if q else 0)
    else:
        assert [row[:c] for row, c in zip(got_n, fin.sum(1))] == [
            row[:c] for row, c in zip(want_n, fin.sum(1))]
    np.testing.assert_allclose(got_v[fin], want_v[fin],
                               **(INT8_TOL if q else F32_TOL))


@WORLDS
@pytest.mark.parametrize("name", ["ivf_int8", "ivf_f32", "ivf_int8_k_past"])
def test_world_nprobe_equals_the_unsharded_sidecar(world, name):
    got, copies, out = world
    kind, q, k, npb = RUNS[name]
    idx = PostIndex(copies[kind], quantize=q, device="cpu",
                    device_resident=False)
    want_v, want_n = idx.query(BRANDS, k=k, nprobe=npb)
    for r in got:
        assert np.array_equal(_dump(out, name, r["rank"])["vals"], want_v)
        assert r["runs"][name]["names"] == want_n


@WORLDS
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_each_rank_holds_and_reads_only_its_slot_rows(world, kind):
    """Rank r of data slot d holds post shard d (49 rows: the 97 posts in
    two shards, the last padded with a zero row), the one-process shard
    bit for bit, and read no other row: float32 from the store, int8 from
    the sidecar, which only the primary writes (once) and quantizes."""
    got, copies, out = world
    data, model = got[0]["mesh"]
    size = -(-N_POSTS // data)
    q = "int8" if kind == "int8" else ""
    one = PostIndex(copies[kind], quantize=q, mesh=ServingMesh((CPU,) * 2))
    for r in got:
        slot = r["rank"] // model
        lo, hi = slot * size, min((slot + 1) * size, N_POSTS)
        posts = _dump(out, "%s_k9" % kind, r["rank"])["posts"]
        assert posts.shape == (size, DIM)
        assert np.array_equal(posts, one.posts()[slot].float().numpy())
        run = r["runs"]["%s_k9" % kind]
        if kind == "f32":
            assert run["read"] == [[lo, hi, hi - lo]]
            assert run["wrote"] == [] and run["quantized"] == 0
        elif r["rank"] == 0:
            # the sidecar did not exist: the primary quantized the store once
            assert run["wrote"] == ["feature.int8.bin", "inv_norms.npy"]
            assert run["quantized"] == N_POSTS
        else:
            assert run["wrote"] == [] and run["quantized"] == 0
            assert run["read"] == []          # its rows from the sidecar
        # the second int8 run reads the sidecar on every rank
        if kind == "int8":
            run = r["runs"]["int8_k120"]
            assert run["wrote"] == [] and run["quantized"] == 0
            assert run["read"] == []


@WORLDS
def test_each_rank_holds_only_its_slot_ivf_lists(world):
    got, copies, out = world
    data, model = got[0]["mesh"]
    full = IVFIndex.load(os.path.join(copies["int8"], "ivf"), device="cpu")
    n_lists = full.packed_idx.shape[0]
    per = -(-n_lists // data)
    padded = torch.cat([full.packed_idx, full.packed_idx.new_full(
        (per * data - n_lists, full.cap), -1)]).numpy()
    for r in got:
        slot = r["rank"] // model
        lists = _dump(out, "ivf_int8", r["rank"])["lists"]
        assert np.array_equal(lists, padded[slot * per:(slot + 1) * per])


@WORLDS
def test_world_refuses_a_mesh_that_leaves_ranks_idle(world):
    got, _, _ = world
    for r in got:
        assert "idle" in r["runs"]["idle"]["error"]


def test_query_outside_a_world_keeps_the_host_mesh(indexes, monkeypatch,
                                                   capsys):
    """Without WORLD_SIZE, --mesh_shape is PR 14's serving mesh over the
    host's devices: nothing joins a world, 2 shards over 1 CPU raise."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 2"):
        pindex.main(_argv(indexes["f32"], "", 9, 0, "2,1"))
    assert not torch.distributed.is_initialized()
