"""Four places where the port once parted from the JAX package, each held
against it on the CPU:

1. the trainer resumes from a reference torch checkpoint (`load_any`),
   restoring the optimizer only from the port's own format;
2. index build and add read a reference torch checkpoint;
3. an int8 query takes the fused top-k only where its kernel takes the
   shape (`fused_eligible`), so a 30-wide int8 index serves through
   `retrieval_topk` as in the JAX package, and the kernel takes every
   width a 4-byte-word index has (4096 too);
4. `--validate_split check` validates on the train split.
"""

import json
import os

import numpy as np
import pytest
import torch

from fancyrec_tpu.serving.index import PostIndex as JaxPostIndex
from fancyrec_tpu.serving.index import build_index as jax_build_index
from fancyrec_tpu.serving.index import (
    add_collection_to_index as jax_add_collection)
from fancyrec_tpu_torch.data.tokenizer import write_minimal_bert_vocab
from fancyrec_tpu_torch.io.bigfile import BigFileReader, BigFileWriter
from fancyrec_tpu_torch.io.vocab import Vocabulary, load_vocab, save_vocab
from fancyrec_tpu_torch.ops import similarity as tsim
from fancyrec_tpu_torch.serving import index as sindex
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.utils.fixture import make_fixture

from tests.test_checkpoint_import import ASPECTS, BRANDS, COMMON
from tests.test_tower_parity import BOWD, FEAT, HID, KNUM, RNN, VOCAB
from tests.test_torch_port_eval import _reference_checkpoint
from tests.test_torch_port_trainer import TINY

TOL = dict(atol=5e-5, rtol=5e-5)
MAX_TOKENS = 24             # within the reference BERT's 32 positions
# the trainer flags that give the reference checkpoint's shapes
REF_FLAGS = [
    "insCartrain", "insCarval", "insCartest",
    "--brand_num", str(BRANDS), "--brand_aspect", str(ASPECTS),
    "--video_feature", "resnet152_dim_%d" % FEAT,
    "--img_feature", "imgfeat_dim_%d" % FEAT,
    "--common_embedding_size", str(COMMON), "--visual_rnn_size", str(RNN),
    "--visual_kernel_num", str(KNUM), "--visual_kernel_sizes", "2-3",
    "--text_kernel_num", str(KNUM), "--text_kernel_sizes", "2-3",
    "--text_mapping_size", "8", "--visual_mapping_size", "8",
    "--text_transformers_hidden_size", str(HID), "--text_net",
    "transformers", "--fusion_style", "ph", "--concate", "full",
    "--batch_size", "4", "--accumulation_step", "1", "--overwrite", "1",
    "--max_frames", "8", "--max_tokens", str(MAX_TOKENS),
    "--loss_fun", "cl", "--device", "cpu",
]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A reference torch checkpoint and a fixture tree it can encode: the
    reference oracles' feature width, a BoW vocabulary of their BOWD words
    and a WordPiece vocabulary within their VOCAB tokens."""
    tmp = tmp_path_factory.mktemp("port_faults")
    path = str(tmp / "reference.pth.tar")
    _reference_checkpoint(path, "ph")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    blob["opt"].max_tokens = MAX_TOKENS
    blob["opt"].video_feature = "resnet152_dim_%d" % FEAT
    blob["opt"].img_feature = "imgfeat_dim_%d" % FEAT
    torch.save(blob, path)

    root = str(tmp / "tree")
    make_fixture(root, brand_num=BRANDS, videos_per_brand=2,
                 imgs_per_brand=2, feat_dim=FEAT, frames_per_video=4, seed=1)
    bow_path = os.path.join(root, "insCartrain", "TextData", "vocabulary",
                            "bow", "word_vocab_5.pkl")
    words = list(load_vocab(bow_path).word2idx)
    assert len(words) >= BOWD
    bow = Vocabulary("bow")
    for w in words[:BOWD]:
        bow.add_word(w)
    save_vocab(bow, bow_path)
    write_minimal_bert_vocab(os.path.join(root, "bert_vocab.txt"),
                             words[:VOCAB - 5])
    return {"path": path, "root": root}


# --- 1. the trainer resumes from a reference checkpoint ----------------------

class _Stop(Exception):
    pass


def test_trainer_resumes_from_a_reference_checkpoint(ref, monkeypatch,
                                                     capsys):
    want = checkpoints.load_any(ref["path"])
    build_datasets = trainer.build_datasets

    def datasets_with_reference_bert(cfg):
        # the reference BERT's shape knobs have no trainer flag
        out = build_datasets(cfg)
        for k in ("bert_vocab_size", "bert_max_position", "bert_type_vocab",
                  "bert_intermediate_size"):
            setattr(cfg, k, getattr(want["config"], k))
        return out

    seen = {}

    def validate(model, loader, cfg, device):
        # the trainer validates the resumed model before any epoch
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        raise _Stop

    monkeypatch.setattr(trainer, "build_datasets",
                        datasets_with_reference_bert)
    monkeypatch.setattr(trainer, "validate", validate)
    with pytest.raises(_Stop):
        trainer.main(REF_FLAGS + ["--rootpath", ref["root"], "--postfix",
                                  "resume_ref", "--resume", ref["path"]])
    out = capsys.readouterr().out
    assert "=> loaded checkpoint (epoch 7, best_rsum 123.4)" in out
    assert "optimizer state restored" not in out
    assert seen["state"].keys() == want["state_dict"].keys()
    for k, v in want["state_dict"].items():
        assert torch.equal(seen["state"][k], v), k


# --- 2. index build and add from a reference checkpoint -----------------------

def test_index_build_and_add_from_a_reference_checkpoint_match_jax(
        ref, tmp_path):
    idx_j, idx_t = str(tmp_path / "jax"), str(tmp_path / "port")
    n_j = jax_build_index(ref["path"], ref["root"], "insCartest", idx_j,
                          batch_size=4)
    n_t = sindex.build_index(ref["path"], ref["root"], "insCartest", idx_t,
                             batch_size=4, device="cpu")
    assert n_j == n_t == BRANDS * 4
    n_j = jax_add_collection(idx_j, ref["root"], "insCarval", batch_size=4)
    n_t = sindex.add_collection_to_index(idx_t, ref["root"], "insCarval",
                                         batch_size=4, device="cpu")
    assert n_j == n_t == 2 * BRANDS * 4
    a = BigFileReader(idx_j, delimiter="\t")
    b = BigFileReader(idx_t, delimiter="\t")
    assert a.names == b.names
    np.testing.assert_allclose(b.read_rows(np.arange(b.nr_of_rows)),
                               a.read_rows(np.arange(a.nr_of_rows)), **TOL)
    for f in ("brand_embeddings.npy", "brands.npy"):
        np.testing.assert_allclose(np.load(os.path.join(idx_t, f)),
                                   np.load(os.path.join(idx_j, f)), **TOL)


# --- 3. int8 queries that the fused kernel does not take ----------------------

@pytest.mark.parametrize("quantize,k,dim,fused", [
    ("int8", 10, 1024, True), ("int8", 10, 30, False),
    ("int8", 128, 32, True), ("int8", 129, 1024, False),
    ("int8", 0, 1024, False), ("", 10, 1024, False),
    # K3 takes any width: rows too wide for its shared memory come through
    # its ring beside the posts
    ("int8", 128, 4096, True), ("int8", 10, 4096, True),
    ("int8", 128, 2180, True), ("int8", 10, 4100, True)])
def test_fused_eligible(quantize, k, dim, fused):
    assert sindex.fused_eligible(quantize, k, dim) is fused


@pytest.mark.parametrize("k", [1, 10, 64, 128])
def test_k3_plans_every_width_fused_eligible_admits(k):
    """Every width `fused_eligible` admits has a launch that fits an H100
    block's shared memory: the brand rows in shared memory up to a width,
    through the ring past it, with at least 4 ring stages either way."""
    for d in (4, 36, 1024, 2048, 2176, 3136, 4096, 4100, 16384):
        assert sindex.fused_eligible("int8", k, d)
        plan = tsim.topk_int8_plan(51, 10_000, d, k, 132)
        assert plan.stages >= 4
        assert tsim._k3_smem(d, k, plan.ks, plan.stages,
                             plan.ring_brands) <= tsim._K3_SMEM
        assert plan.ring_brands == all(
            tsim._k3_smem(d, k, w, 4, False) > tsim._K3_SMEM
            for w in tsim._K3_STAGE_BYTES)
        if d in (1024, 4096):   # the serving width; one past every k's
            assert plan.ring_brands == (d == 4096)


def _write_index(path, rows, brands, brand_embs):
    with BigFileWriter(path, ndims=rows.shape[1], delimiter="\t") as w:
        w.write_batch(["post%03d#enc#0" % i for i in range(len(rows))], rows)
    np.save(os.path.join(path, "brands.npy"), brands)
    np.save(os.path.join(path, "brand_embeddings.npy"), brand_embs)
    with open(os.path.join(path, "index_meta.json"), "w") as f:
        json.dump({"collection": "synthetic", "checkpoint": "",
                   "brand_num": len(brand_embs), "dim": rows.shape[1],
                   "n_posts": len(rows)}, f)


@pytest.mark.parametrize("dim,fused", [(30, False), (32, True), (4096, True)])
def test_int8_query_routes_by_shape_and_matches_jax(tmp_path, monkeypatch,
                                                    dim, fused):
    rng = np.random.RandomState(dim)
    idx = str(tmp_path / "index")
    _write_index(idx, rng.randn(200, dim).astype(np.float32),
                 rng.randint(0, 5, 200).astype(np.int32),
                 rng.randn(5, dim).astype(np.float32))
    want_v, want_n = JaxPostIndex(idx, quantize="int8").query(range(5), k=10)
    calls = []
    topk_int8 = sindex.topk_int8
    monkeypatch.setattr(sindex, "topk_int8",
                        lambda *a, **kw: calls.append(1) or topk_int8(*a, **kw))
    got_v, got_n = sindex.PostIndex(idx, quantize="int8",
                                    device="cpu").query(range(5), k=10)
    assert bool(calls) is fused
    assert got_n == want_n
    np.testing.assert_allclose(got_v, want_v, **TOL)


# --- 4. --validate_split check --------------------------------------------------

@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_check_split"))
    make_fixture(root, brand_num=3, videos_per_brand=2, imgs_per_brand=2,
                 feat_dim=16, frames_per_video=4, seed=2)
    return root


@pytest.mark.parametrize("split,coll", [("check", "insCartrain"),
                                        ("val", "insCarval")])
def test_validate_split_picks_its_collection(tiny_root, monkeypatch, split,
                                             coll):
    seen = []
    validate = trainer.validate

    def spy(model, loader, cfg, device):
        seen.append((list(loader.dataset.caps.cap_ids), loader.final_batch,
                     sum(1 for _ in loader)))
        return validate(model, loader, cfg, device)

    monkeypatch.setattr(trainer, "validate", spy)
    trainer.main(TINY + ["--rootpath", tiny_root, "--postfix", split,
                         "--text_net", "bi-gru", "--num_epochs", "1",
                         "--validate_split", split])
    with open(os.path.join(tiny_root, coll, "TextData",
                           "%s.caption.txt" % coll)) as f:
        want = [line.split(" ", 1)[0] for line in f if line.strip()]
    assert len(seen) == 1
    ids, final_batch, n_batches = seen[0]
    assert ids == want and final_batch == "pad"
    assert n_batches == -(-len(want) // 4)
