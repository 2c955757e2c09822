"""The port's exported serving artifacts against the JAX package, on the CPU.

JAX FancyRec variables (perturbed, so every bias and running statistic is
non-trivial) are saved as a JAX checkpoint and carried across with
`interop.load_jax_variables` into a port checkpoint. `export_model` takes
either file; each artifact's entry points must equal the JAX package's
`embed_*` within the tower tolerance (atol = rtol = 5e-5,
tests/test_tower_parity.py) and the port's live model within 1e-6, at a
symbolic batch of two sizes and at a fixed batch. The programs call the
bi-GRU as the operator `fancyrec::gru_scan_fwd`. The HTTP routes
`/v1/encode` and `/v1/recommend` answer as the JAX service does.
"""

import http.client
import json
import os
import threading
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.serving.export import export_model as jax_export_model
from fancyrec_tpu.serving.server import FancyRecService as JaxService
from fancyrec_tpu.train import checkpoints as jax_checkpoints
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.eval.evaluator import (
    encode_batch, encode_txt, encode_vis)
from fancyrec_tpu_torch.interop import load_jax_variables
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.serving.export import (
    ExportedModel, export_model, main as export_main)
from fancyrec_tpu_torch.serving.server import FancyRecService, make_server
from fancyrec_tpu_torch.train.checkpoints import save_checkpoint
from tests.test_serving import _toy_index
from tests.test_torch_port_model import (
    jax_variables, ragged_batch, tiny_cfg_kwargs)

TOL = dict(atol=5e-5, rtol=5e-5)
LIVE_TOL = dict(atol=1e-6, rtol=1e-6)
ENTRIES = ("encode_post", "embed_brand", "embed_vis", "embed_txt")


def _checkpoints(tmp, text_net):
    """-> (jax model, variables, JAX FRTPU1 path, port path, live model)."""
    kw = tiny_cfg_kwargs(text_net)
    jcfg, jmodel, params, stats = jax_variables(kw, seed=2)
    jpath = str(tmp / "jax.pth.tar")
    jax_checkpoints.save_checkpoint(jpath, jcfg, params, stats, epoch=1,
                                    best_rsum=0.0, eiters=1)
    cfg = Config(**kw).finalize()
    live = load_jax_variables(FancyRec(cfg), params, stats).eval()
    ppath = str(tmp / "port.pth.tar")
    save_checkpoint(ppath, cfg, live)
    return jmodel, {"params": params, "batch_stats": stats}, jpath, ppath, live


def _jax_entry(jmodel, variables, name, batch, brand_num):
    v = JVisualBatch(jnp.asarray(batch["frames"]),
                     jnp.asarray(batch["origin"]), jnp.asarray(batch["vmask"]))
    t = JTextBatch(jnp.asarray(batch["bows"]), jnp.asarray(batch["tokens"]),
                   jnp.asarray(batch["type_ids"]), jnp.asarray(batch["tmask"]))
    if name == "embed_brand":
        return jmodel.apply({"params": variables["params"]},
                            jnp.arange(brand_num, dtype=jnp.int32),
                            deterministic=True, method=jmodel.embed_brand)
    method = getattr(jmodel, "embed_post" if name == "encode_post" else name)
    args = {"encode_post": (v, t), "embed_vis": (v,), "embed_txt": (t,)}
    return jmodel.apply(variables, *args[name], deterministic=True,
                        method=method)


def _live_entry(model, name, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        if name == "embed_brand":
            return model.embed_brand(torch.arange(model.cfg.brand_num))
        fn = {"encode_post": encode_batch, "embed_vis": encode_vis,
              "embed_txt": encode_txt}[name]
        return fn(model, t)


@pytest.mark.parametrize("text_net,source,batch", [
    ("transformers", "frtpu1", 0),     # the recipe's towers, symbolic batch
    ("bi-gru", "port", 0),             # two GRUs in encode_post
    ("transformers", "port", 3),       # a fixed batch
])
def test_artifact_entries_match_jax_and_live_model(tmp_path, text_net,
                                                   source, batch):
    jmodel, variables, jpath, ppath, live = _checkpoints(tmp_path, text_net)
    out = str(tmp_path / "art")
    manifest = export_model(jpath if source == "frtpu1" else ppath, out,
                            batch=batch, device="cpu")
    assert manifest["format"] == "fancyrec-torch-export-v1"
    assert sorted(manifest["entries"]) == sorted(ENTRIES)
    assert manifest["custom_ops"] == ["fancyrec::gru_scan_fwd"]
    post = manifest["entries"]["encode_post"]
    assert post["arg_dtypes"]["tokens"] == "int32"
    assert post["arg_shapes"]["frames"][0] == ("b" if batch == 0 else "3")
    assert post["out_shape"] == ["b" if batch == 0 else "3", "16"]
    # the weights ship once, beside programs that hold none of them
    weight_bytes = os.path.getsize(os.path.join(out, "weights.pt"))
    n_weights = sum(v.numel() * 4 for v in live.state_dict().values())
    assert weight_bytes < 1.2 * n_weights + 65536
    assert post["bytes"] < weight_bytes + 2 ** 20

    art = ExportedModel(out, device="cpu")
    assert art.entry_points == sorted(ENTRIES)
    sizes = (1, 4) if batch == 0 else (batch,)
    brand_num = live.cfg.brand_num
    for b in sizes:
        data = ragged_batch(live.cfg, b, seed=10 + b)
        # JSON-like inputs: float64 / int64 lists cast by the manifest
        as_lists = {k: v.tolist() for k, v in data.items()}
        for name in ENTRIES:
            got = (art.embed_brand() if name == "embed_brand"
                   else getattr(art, name)(as_lists)).numpy()
            want = np.asarray(_jax_entry(jmodel, variables, name, data,
                                         brand_num))
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(
                got, _live_entry(live, name, data).numpy(), **LIVE_TOL)


@pytest.mark.parametrize("text_net,n_gru", [("transformers", 1),
                                            ("bi-gru", 2)])
def test_program_calls_the_gru_operator(tmp_path, text_net, n_gru):
    _, _, _, ppath, _ = _checkpoints(tmp_path, text_net)
    out = str(tmp_path / "art")
    export_model(ppath, out, entries=["encode_post"], device="cpu")
    ep = torch.export.load(os.path.join(out, "encode_post.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes if n.op ==
               "call_function"]
    assert targets.count("fancyrec.gru_scan_fwd.default") == n_gru
    assert not [t for t in targets if "gru" in t and "fancyrec" not in t]
    # the program takes every weight as an input and holds none
    assert not ep.state_dict and not ep.constants
    with zipfile.ZipFile(os.path.join(out, "encode_post.pt2")) as z:
        assert sum(i.file_size for i in z.infolist()) < 4 * 2 ** 20


def test_export_cli_and_unknown_entry(tmp_path, capsys):
    _, _, _, ppath, _ = _checkpoints(tmp_path, "transformers")
    out = str(tmp_path / "art")
    export_main([out, "--checkpoint", ppath, "--platforms", "cpu",
                 "--entries", "embed_brand", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["entries"] == ["embed_brand"] and rec["platforms"] == ["cpu"]
    assert os.path.exists(os.path.join(out, "manifest.json"))
    assert os.path.exists(os.path.join(out, "embed_brand.pt2"))
    assert not os.path.exists(os.path.join(out, "encode_post.pt2"))
    with pytest.raises(ValueError, match="unknown entry"):
        export_model(ppath, str(tmp_path / "a"), entries=["nope"],
                     device="cpu")
    with pytest.raises(KeyError, match="not in artifact"):
        ExportedModel(out, device="cpu").encode_post({})


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_encode_and_recommend_routes_match_jax_service(tmp_path):
    jmodel, variables, jpath, ppath, live = _checkpoints(tmp_path,
                                                         "transformers")
    idx_dir = str(tmp_path / "index")
    _toy_index(idx_dir, n_posts=40, dim=16, brand_num=4, seed=0)
    jart, part = str(tmp_path / "jart"), str(tmp_path / "part")
    jax_export_model(jpath, jart, platforms=("cpu",), batch=0)
    export_model(ppath, part, batch=0, device="cpu")
    jax_service = JaxService(idx_dir, artifact_dir=jart)
    service = FancyRecService(idx_dir, artifact_dir=part, device="cpu")
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_port
        status, health = _req(port, "GET", "/healthz")
        assert status == 200
        assert (health["artifact_entries"]
                == jax_service.healthz()["artifact_entries"]
                == sorted(ENTRIES))
        body = {k: v.tolist()
                for k, v in ragged_batch(live.cfg, 3, seed=7).items()}
        status, got = _req(port, "POST", "/v1/encode", body)
        assert status == 200
        want = jax_service.encode(body)
        np.testing.assert_allclose(np.asarray(got["embeddings"]),
                                   np.asarray(want["embeddings"]), **TOL)
        body["k"] = 3
        status, rec = _req(port, "POST", "/v1/recommend", body)
        assert status == 200
        want = jax_service.recommend(body)
        assert ([[r["brand"] for r in row] for row in rec["results"]]
                == [[r["brand"] for r in row] for row in want["results"]])
        np.testing.assert_allclose(
            [[r["score"] for r in row] for row in rec["results"]],
            [[r["score"] for r in row] for row in want["results"]], **TOL)

        for path, bad in (("/v1/encode", {"frames": []}),
                          ("/v1/recommend", {"k": -1}),
                          ("/v1/recommend", {"k": True})):
            status, err = _req(port, "POST", path, bad)
            assert status == 400, (path, bad)
            with pytest.raises(ValueError) as jerr:
                getattr(jax_service, path.rsplit("/", 1)[1])(bad)
            assert err["error"] == str(jerr.value)
        status, metrics = _req(port, "GET", "/metrics")
        assert metrics["routes"]["/v1/encode"] == {
            **metrics["routes"]["/v1/encode"], "count": 2, "errors": 1}
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    assert FancyRecService(idx_dir, device="cpu").healthz()[
        "artifact_entries"] == []
