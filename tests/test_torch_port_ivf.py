"""The port's IVF-Flat sidecar against the JAX package's, on the CPU.

The same seeded numpy blobs (the JAX package's own `tests/test_ivf.py`
fixture) go through `fancyrec_tpu.serving.ivf` and
`fancyrec_tpu_torch.serving.ivf`. The k-means' first seed is a JAX random
draw the port cannot reproduce, so the port is handed JAX's first index
(or JAX's centroids) and must follow from there: the same seeds, centroids
within 1e-5 with the same counts, the same packing. A sidecar either
package saved serves in the other with the same post ids. int8 inverse
norms agree within two ulps: `jax.lax.rsqrt` on the CPU is not correctly
rounded.
"""

import http.client
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fancyrec_tpu.serving import ivf as jivf
from fancyrec_tpu.serving.index import PostIndex as JaxPostIndex
from fancyrec_tpu.serving.index import build_ivf_sidecar as jax_ivf_sidecar
from fancyrec_tpu_torch.serving import ivf as pivf
from fancyrec_tpu_torch.serving.index import (
    PostIndex, append_to_index, build_ivf_sidecar)
from fancyrec_tpu_torch.serving.index import main as index_main
from fancyrec_tpu_torch.serving.server import FancyRecService, make_server
from tests.test_serving import _toy_index

ULP = 2.0 ** -23          # one float32 ulp, relative
ULP2 = 2.0 ** -22         # two: lax.rsqrt on the CPU is not correctly rounded


def _clustered(n=4000, d=32, n_clusters=16, seed=0):
    rng = np.random.RandomState(seed)
    means = rng.randn(n_clusters, d) * 3.0
    lab = rng.randint(0, n_clusters, n)
    return (means[lab] + rng.randn(n, d)).astype(np.float32)


def _port_copy(jax_ivf, device="cpu"):
    """A port IVFIndex over (writable copies of) a JAX index's arrays."""
    inv = None if jax_ivf.inv_norms is None else np.array(jax_ivf.inv_norms)
    return pivf.IVFIndex(np.array(jax_ivf.centroids), np.array(jax_ivf.packed),
                         np.array(jax_ivf.packed_idx), inv,
                         radii=np.array(jax_ivf.radii), device=device)


@pytest.fixture(scope="module")
def blobs():
    return _clustered()


@pytest.fixture(scope="module")
def jax_built(blobs, tmp_path_factory):
    """JAX-built sidecars over the blobs, f32 and int8, saved to disk."""
    tmp = tmp_path_factory.mktemp("jax_ivf")
    out = {}
    for q in ("", "int8"):
        ivf = jivf.IVFIndex.build(blobs, nlist=16, iters=6, seed=0,
                                  quantize=q)
        path = str(tmp / ("sidecar_" + (q or "f32")))
        ivf.save(path)
        out[q] = (ivf, path)
    return out


@pytest.mark.parametrize("case", ["round_robin", "overflow", "donors"])
def test_host_helpers_bit_equal_jax(case):
    rng = np.random.RandomState(5)
    if case == "donors":
        counts = rng.randint(0, 60, 40)
        maxcos = rng.rand(40).astype(np.float32)
        sib = rng.randint(0, 40, 40)
        assert (pivf._select_donors(counts, 50.0, maxcos, sib)
                == jivf._select_donors(counts, 50.0, maxcos, sib))
        return
    nlist, cap = 12, 20 if case == "round_robin" else 9
    choices = rng.randint(0, nlist, (200, 3)).astype(np.int32)
    got = pivf.balanced_assign(choices, nlist, cap, spill=case)
    want = jivf.balanced_assign(choices, nlist, cap, spill=case)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if case == "overflow":
        assert got.max() >= nlist          # the fixture does spill


def test_kcenter_init_given_jax_first_seed(blobs):
    n = blobs.shape[0]
    xj = jivf._l2norm(jnp.asarray(blobs))
    want = np.asarray(jivf._kcenter_init(xj, n, 16, jax.random.PRNGKey(3)))
    got = pivf._kcenter_init(pivf._l2norm(torch.from_numpy(blobs)), 16,
                             first=int(want[0]))
    assert np.array_equal(got.numpy(), want)
    # without `first`, the seed comes from the generator: reproducible
    g = lambda: torch.Generator().manual_seed(3)          # noqa: E731
    x = pivf._l2norm(torch.from_numpy(blobs))
    assert torch.equal(pivf._kcenter_init(x, 16, generator=g()),
                       pivf._kcenter_init(x, 16, generator=g()))


@pytest.mark.parametrize("cap_target", [None, 200.0])
def test_spherical_kmeans_matches_jax_given_init(blobs, cap_target):
    n = blobs.shape[0]
    xj = jivf._l2norm(jnp.asarray(blobs))
    init = np.asarray(jivf._kcenter_init(xj, n, 16, jax.random.PRNGKey(1)))
    want = np.asarray(jivf.spherical_kmeans(blobs, 16, iters=8, seed=1,
                                            cap_target=cap_target))
    got = pivf.spherical_kmeans(torch.from_numpy(blobs), 16, iters=8, seed=1,
                                cap_target=cap_target, init=init).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    xn = np.asarray(xj)
    assert np.array_equal(
        np.bincount(np.argmax(xn @ got.T, 1), minlength=16),
        np.bincount(np.argmax(xn @ want.T, 1), minlength=16))


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_build_given_jax_centroids_packs_the_same(blobs, jax_built, quantize,
                                                  monkeypatch):
    jax_ivf, _ = jax_built[quantize]
    cents = torch.from_numpy(np.array(jax_ivf.centroids))
    monkeypatch.setattr(pivf, "spherical_kmeans", lambda *a, **k: cents)
    got = pivf.IVFIndex.build(blobs, nlist=16, iters=6, seed=0,
                              quantize=quantize, device="cpu")
    assert got.overflow_lists == jax_ivf.overflow_lists
    assert got.spill_frac == jax_ivf.spill_frac
    assert np.array_equal(got.packed_idx.numpy(),
                          np.asarray(jax_ivf.packed_idx))
    want_packed = np.asarray(jax_ivf.packed)
    if quantize:
        assert np.array_equal(got.packed.numpy(), want_packed)
        np.testing.assert_allclose(got.inv_norms.numpy(),
                                   np.asarray(jax_ivf.inv_norms),
                                   rtol=ULP2, atol=0)
    else:
        # unit rows: the norm's float32 sum order differs from XLA's
        np.testing.assert_allclose(got.packed.numpy(), want_packed,
                                   rtol=0, atol=ULP)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_compute_radii_matches_jax(jax_built, quantize):
    jax_ivf, _ = jax_built[quantize]
    port = _port_copy(jax_ivf)
    port.radii = None
    port.compute_radii()
    np.testing.assert_allclose(port.radii.numpy(), np.asarray(jax_ivf.radii),
                               atol=1e-6, rtol=0)


def assert_same_posts(got_v, got_i, want_v, want_i, ulps=0):
    """The same post ids in the same order, except that posts whose JAX
    scores lie within `ulps` float32 ulps of each other (or of the k-th
    score, at the cut) may trade places."""
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    tol = ulps * ULP * np.abs(np.where(np.isfinite(want_v), want_v, 0.0))
    for r in range(want_i.shape[0]):
        for p in np.nonzero(got_i[r] != want_i[r])[0]:
            assert ulps, (r, p, got_i[r], want_i[r])
            q = np.nonzero(want_i[r] == got_i[r, p])[0]
            near = want_v[r, q] if q.size else want_v[r, -1:]
            assert np.abs(near - want_v[r, p]) <= tol[r, p], (
                r, p, got_v[r, p], want_v[r, p])


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("probe", ["cosine", "bound"])
def test_query_on_jax_sidecar_matches_jax(blobs, jax_built, quantize, probe):
    jax_ivf, path = jax_built[quantize]
    port = pivf.IVFIndex.load(path, device="cpu")
    qs = blobs[:6] + 0.1
    # k past the probed posts at nprobe 1: the tail pads with -inf / -1
    for k, nprobe in ((10, 2), (600, 1), (5, 16)):
        want_v, want_i = jax_ivf.query(qs, k=k, nprobe=nprobe, probe=probe)
        got_v, got_i = port.query(qs, k=k, nprobe=nprobe, probe=probe)
        # float32: the same ids. int8: the query's 1/||q8|| comes from
        # lax.rsqrt, up to two ulps off, so posts whose scores tie within
        # two ulps may trade places
        assert_same_posts(got_v, got_i, want_v, want_i,
                          ulps=2 if quantize else 0)
        fin = np.isfinite(want_v)
        assert np.array_equal(np.isfinite(got_v), fin)
        np.testing.assert_allclose(got_v[fin], np.asarray(want_v)[fin],
                                   atol=1e-6, rtol=0)
    assert (got_i >= 0).all() and port.spill_frac == jax_ivf.spill_frac


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_port_saved_sidecar_serves_in_jax(blobs, quantize, tmp_path):
    port = pivf.IVFIndex.build(blobs[:1500], nlist=12, iters=4, seed=2,
                               quantize=quantize, device="cpu")
    port.source_posts = 1500
    port.save(str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(["centroids.npy", "packed_idx.npy", "packed.bin",
                            "radii.npy", "ivf_meta.json"]
                           + (["inv_norms.npy"] if quantize else []))
    meta = json.loads((tmp_path / "ivf_meta.json").read_text())
    assert meta["source_posts"] == 1500
    assert meta["dtype"] == ("int8" if quantize else "float32")
    loaded = jivf.IVFIndex.load(str(tmp_path))
    assert loaded.source_posts == 1500
    qs = blobs[1500:1505]
    want_v, want_i = loaded.query(qs, k=7, nprobe=3)
    got_v, got_i = port.query(qs, k=7, nprobe=3)
    assert np.array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_v, np.asarray(want_v), atol=1e-6, rtol=0)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_build_chunked_bit_identical_to_build(blobs, quantize):
    x = blobs[:1000]
    mono = pivf.IVFIndex.build(x, nlist=10, iters=4, seed=3,
                               quantize=quantize, device="cpu")
    chunked = pivf.IVFIndex.build_chunked(
        lambda lo, hi: x[lo:hi], 1000, x.shape[1], nlist=10, iters=4,
        seed=3, quantize=quantize, chunk=300, train_rows=1000,
        device="cpu")
    for name in ("centroids", "packed", "packed_idx", "radii", "inv_norms"):
        a, b = getattr(mono, name), getattr(chunked, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert mono.spill_frac == chunked.spill_frac
    assert set(chunked.build_seconds) == {
        "sample_read", "kcenter_init", "lloyd", "choices", "assignment",
        "scatter", "radii"}


def test_ivf_build_cli_query_nprobe_and_staleness(tmp_path, capsys):
    """As the JAX package's test_ivf_sidecar_build_and_query and
    test_ivf_sidecar_staleness_guard, through the port's CLI; the JAX
    package serves the port's sidecar with the same posts."""
    idx_dir = str(tmp_path / "toy")
    _toy_index(idx_dir, n_posts=240, dim=16)
    info = build_ivf_sidecar(idx_dir, nlist=8, iters=5, device="cpu")
    assert info["posts"] == 240 and os.path.isdir(info["out"])

    index = PostIndex(idx_dir, device_resident=False, device="cpu")
    assert index._posts is None                 # nothing loaded for IVF
    v_exact, n_exact = index.query([1], k=5)
    v_full, n_full = index.query([1], k=5, nprobe=8)     # probe everything
    assert n_full[0] == n_exact[0]
    np.testing.assert_allclose(v_full[0], v_exact[0], atol=1e-5)
    v_small, n_small = index.query([1], k=5, nprobe=2)
    assert all(n is not None for n in n_small[0])
    assert n_small[0][0] in n_exact[0]
    want_v, want_n = JaxPostIndex(idx_dir, device_resident=False).query(
        [0, 1, 2], k=5, nprobe=2)
    got_v, got_n = index.query([0, 1, 2], k=5, nprobe=2)
    assert got_n == want_n
    np.testing.assert_allclose(got_v, want_v, atol=1e-6)

    capsys.readouterr()
    index_main(["ivf-build", idx_dir, "--nlist", "8", "--quantize", "int8",
                "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["nlist"] == 8 and rec["posts"] == 240
    index_main(["query", idx_dir, "--brands", "1", "--k", "3",
                "--nprobe", "2", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["brand"] == 1 and len(rec["results"]) == 3

    # an append makes the sidecar stale; the exact path keeps working
    index.refresh()
    index.query([0], k=3, nprobe=2)
    append_to_index(idx_dir, ["late0#enc#0"],
                    np.random.RandomState(9).randn(1, 16).astype(np.float32),
                    [0])
    index.refresh()
    with pytest.raises(ValueError, match="stale"):
        index.query([0], k=3, nprobe=2)
    index.query([0], k=3)
    with pytest.raises(ValueError, match="stale"):
        PostIndex(idx_dir, device_resident=False,
                  device="cpu").query([0], k=3, nprobe=2)
    with pytest.raises(ValueError, match="stale"):       # the JAX package
        JaxPostIndex(idx_dir, device_resident=False).query([0], k=3,
                                                           nprobe=2)
    build_ivf_sidecar(idx_dir, nlist=4, iters=3, device="cpu")
    index.refresh()
    _, names = index.query([0], k=3, nprobe=4)
    assert all(n is not None for n in names[0])

    bare = str(tmp_path / "bare")
    _toy_index(bare, n_posts=40, dim=16)
    with pytest.raises(ValueError, match="ivf-build"):
        PostIndex(bare, device_resident=False, device="cpu").query(
            [0], k=3, nprobe=2)
    with pytest.raises(NotImplementedError, match="one device"):
        pivf.IVFIndex.load(info["out"], device="cpu").shard_to_mesh(None)


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_topk_nprobe_and_default_nprobe_match_jax_service(tmp_path,
                                                          quantize):
    from fancyrec_tpu.serving.server import FancyRecService as JaxService

    idx_dir = str(tmp_path / "toy")
    _toy_index(idx_dir, n_posts=300, dim=16, seed=4)
    jax_ivf_sidecar(idx_dir, nlist=10, iters=4, quantize=quantize)
    service = FancyRecService(idx_dir, quantize=quantize, default_nprobe=3,
                              device="cpu")
    jax_service = JaxService(idx_dir, quantize=quantize, default_nprobe=3)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_port
        for body in ({"brand_ids": [0, 2], "k": 6},             # default 3
                     {"brand_ids": [1], "k": 4, "nprobe": 1},
                     {"brand_ids": [3], "k": 5, "nprobe": 0}):  # exact
            status, got = _req(port, "POST", "/v1/topk", body)
            assert status == 200
            want = jax_service.topk(body)
            for g, w in zip(got["results"], want["results"]):
                assert ([p["cap_id"] for p in g["posts"]]
                        == [p["cap_id"] for p in w["posts"]])
                np.testing.assert_allclose(
                    [p["score"] for p in g["posts"]],
                    [p["score"] for p in w["posts"]], atol=1e-5)
        status, err = _req(port, "POST", "/v1/topk",
                           {"brand_ids": [0], "nprobe": True})
        assert status == 400 and "nprobe" in err["error"]
        status, metrics = _req(port, "GET", "/metrics")
        assert metrics["routes"]["/v1/topk"]["count"] == 4
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    # an append through /v1/add makes the next nprobe query stale
    idx2 = str(tmp_path / "toy2")
    shutil.copytree(idx_dir, idx2)
    service = FancyRecService(idx2, quantize=quantize, default_nprobe=3,
                              device="cpu")
    service.add({"cap_ids": ["n#enc#0"], "embeddings": [[0.5] * 16],
                 "brands": [1]})
    with pytest.raises(ValueError, match="stale"):
        service.topk({"brand_ids": [1], "k": 3})
    assert len(service.topk({"brand_ids": [1], "k": 3,
                             "nprobe": 0})["results"][0]["posts"]) == 3
