"""The port's serving path against the JAX package's, on the CPU.

One fixture tree per package (their make_fixture must write the same
files), one set of weights: JAX FancyRec variables saved as a JAX
checkpoint and, carried across with interop, as a port checkpoint. Both
packages build an index; the stored embeddings agree at float32 tolerance
5e-5 and the served top-k posts are the same.
"""

import filecmp
import http.client
import json
import os
import threading

import numpy as np
import pytest
import torch

from fancyrec_tpu.io.vocab import load_vocab
from fancyrec_tpu.serving.index import PostIndex as JaxPostIndex
from fancyrec_tpu.serving.index import build_index as jax_build_index
from fancyrec_tpu.serving.server import FancyRecService as JaxService
from fancyrec_tpu.train import checkpoints as jax_checkpoints
from fancyrec_tpu.utils.fixture import make_fixture as jax_make_fixture
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.interop import load_jax_variables
from fancyrec_tpu_torch.io.bigfile import BigFileReader
from fancyrec_tpu_torch.io.vocab import load_vocab as port_load_vocab
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.serving.index import PostIndex, build_index
from fancyrec_tpu_torch.serving.index import main as index_main
from fancyrec_tpu_torch.serving.server import FancyRecService, make_server
from fancyrec_tpu_torch.train.checkpoints import save_checkpoint
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_model import jax_variables, tiny_cfg_kwargs

TOL = dict(atol=5e-5, rtol=5e-5)
FIXTURE = dict(brand_num=4, videos_per_brand=3, imgs_per_brand=3,
               feat_dim=12, frames_per_video=5, seed=0)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_serving")
    root_j, root_t = str(tmp / "jax_tree"), str(tmp / "port_tree")
    info = jax_make_fixture(root_j, **FIXTURE)
    make_fixture(root_t, **FIXTURE)

    vdir = os.path.join(root_j, "insCartrain", "TextData", "vocabulary")
    kw = tiny_cfg_kwargs()
    kw.update(trainCollection="insCartrain", video_feature=info["video_feature"],
              img_feature=info["img_feature"], vocab="word_vocab_5",
              bow_vocab_size=len(load_vocab(os.path.join(
                  vdir, "bow", "word_vocab_5.pkl"))),
              vocab_size=len(load_vocab(os.path.join(
                  vdir, "rnn", "word_vocab_5.pkl"))))
    jcfg, _, params, stats = jax_variables(kw, seed=4)
    ckpt_j = str(tmp / "jax.pth.tar")
    jax_checkpoints.save_checkpoint(ckpt_j, jcfg, params, stats, epoch=1,
                                    best_rsum=0.0, eiters=1)
    cfg = Config(**kw).finalize()
    model = load_jax_variables(FancyRec(cfg), params, stats)
    ckpt_t = str(tmp / "port.pth.tar")
    save_checkpoint(ckpt_t, cfg, model)

    idx_j, idx_t = str(tmp / "index_jax"), str(tmp / "index_port")
    n_j = jax_build_index(ckpt_j, root_j, "insCartest", idx_j, batch_size=4)
    n_t = build_index(ckpt_t, root_t, "insCartest", idx_t, batch_size=4,
                      device="cpu")
    assert n_j == n_t == 24
    return {"roots": (root_j, root_t), "idx_j": idx_j, "idx_t": idx_t}


def test_fixtures_write_the_same_files(built):
    root_j, root_t = built["roots"]
    for dirpath, _, files in os.walk(root_j):
        rel = os.path.relpath(dirpath, root_j)
        for f in files:
            a, b = os.path.join(dirpath, f), os.path.join(root_t, rel, f)
            if f.endswith(".pkl"):
                # pickles name their package's Vocabulary class; the words
                # and ids must match
                assert (port_load_vocab(a).word2idx
                        == port_load_vocab(b).word2idx)
            else:
                assert filecmp.cmp(a, b, shallow=False), os.path.join(rel, f)


def test_built_index_matches_jax(built):
    a = BigFileReader(built["idx_j"], delimiter="\t")
    b = BigFileReader(built["idx_t"], delimiter="\t")
    assert a.names == b.names
    np.testing.assert_allclose(b.read_rows(np.arange(b.nr_of_rows)),
                               a.read_rows(np.arange(a.nr_of_rows)), **TOL)
    for f in ("brand_embeddings.npy", "brands.npy"):
        np.testing.assert_allclose(np.load(os.path.join(built["idx_t"], f)),
                                   np.load(os.path.join(built["idx_j"], f)),
                                   **TOL)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_query_matches_jax(built, quantize):
    brands = [0, 1, 2, 3]
    # the JAX int8 side is the fused Pallas kernel in interpret mode
    jidx = JaxPostIndex(built["idx_j"], quantize=quantize,
                        fused=True if quantize else None)
    want_v, want_n = jidx.query(brands, k=5)
    # the port on the JAX-built index (shared format) and on its own build
    for idx_dir in (built["idx_j"], built["idx_t"]):
        got_v, got_n = PostIndex(idx_dir, quantize=quantize,
                                 device="cpu").query(brands, k=5)
        assert got_n == want_n
        np.testing.assert_allclose(got_v, want_v, **TOL)
    # k above the post count: trailing slots are -inf / None
    got_v, got_n = PostIndex(built["idx_t"], quantize=quantize,
                             device="cpu").query([0], k=30)
    assert np.isneginf(got_v[0, 24:]).all()
    assert got_n[0][24:] == [None] * 6


def test_index_cli_query(built, capsys):
    index_main(["query", built["idx_t"], "--brands", "0,2", "--k", "3",
                "--quantize", "int8", "--device", "cpu"])
    recs = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["brand"] for r in recs] == [0, 2]
    assert all(len(r["results"]) == 3 for r in recs)


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_http_service_matches_jax_service(built):
    service = FancyRecService(built["idx_t"], quantize="int8", device="cpu")
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_port
        body = {"brand_ids": [0, 1, 2, 3], "k": 5}
        status, got = _req(port, "POST", "/v1/topk", body)
        assert status == 200
        want = JaxService(built["idx_j"], quantize="int8").topk(body)
        assert ([[p["cap_id"] for p in r["posts"]] for r in got["results"]]
                == [[p["cap_id"] for p in r["posts"]]
                    for r in want["results"]])

        status, health = _req(port, "GET", "/healthz")
        assert status == 200 and health["ok"] and health["n_posts"] == 24
        assert health["quantize"] == "int8" and health["brand_num"] == 4
        status, metrics = _req(port, "GET", "/metrics")
        assert status == 200
        assert metrics["routes"]["/v1/topk"]["count"] == 1
        assert metrics["topk_coalescing"]["device_calls"] == 1

        status, err = _req(port, "POST", "/v1/encode", {"frames": []})
        assert status == 400 and "no --artifact loaded" in err["error"]
        status, err = _req(port, "POST", "/v1/topk",
                           {"brand_ids": [0], "nprobe": 4})
        assert status == 400 and "no IVF sidecar" in err["error"]
        status, err = _req(port, "POST", "/v1/topk", {"brand_ids": [9]})
        assert status == 400
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()


def test_add_then_query_sees_new_post(built, tmp_path):
    import shutil
    idx = str(tmp_path / "index")
    shutil.copytree(built["idx_t"], idx)
    service = FancyRecService(idx, quantize="int8", device="cpu")
    new = (service.index.brand_embs[1] * 10.0).tolist()
    other = np.random.RandomState(0).randn(16).tolist()
    out = service.add({"cap_ids": ["fresh#enc#0", "fresh2#enc#0"],
                       "embeddings": [new, other], "brands": [1, 2]})
    assert out["n_posts"] == 26
    res = service.topk({"brand_ids": [1], "k": 3})
    assert res["results"][0]["posts"][0]["cap_id"] == "fresh#enc#0"
    # the int8 sidecar followed the append
    assert os.path.getsize(os.path.join(idx, "feature.int8.bin")) == 26 * 16
    assert torch.equal(service.index.posts()[-2:].cpu(), torch.from_numpy(
        np.fromfile(os.path.join(idx, "feature.int8.bin"),
                    np.int8).reshape(26, 16)[-2:]))


def test_concurrent_topk_coalesces_and_answers_each_caller(built):
    import sys
    service = FancyRecService(built["idx_t"], quantize="int8", device="cpu")
    want = {b: service.topk({"brand_ids": [b], "k": 4})
            for b in range(4)}
    results, errors = [], []

    def client(i):
        try:
            for j in range(4):
                b = (i + j) % 4
                results.append((b, service.topk({"brand_ids": [b], "k": 4})))
        except Exception as e:  # noqa: BLE001 -- reported by the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 48
    assert all(got == want[b] for b, got in results)
    snap = service._coalescer.snapshot()
    assert snap["requests"] == 52 and snap["device_calls"] <= 52
