"""The port's evaluation toolkit against the JAX package: the scorers,
random_sim, the single-modality datasets and encoders, the 'attn' fusion
head, reference torch checkpoints through `load_any`, and the word2vec
embedding init. Inputs come from seeded numpy and a shared fixture tree;
embeddings agree at atol = rtol = 5e-5 (that of tests/test_tower_parity.py).
"""

import argparse
import os

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax.numpy as jnp

from fancyrec_tpu.data import modality as jmod
from fancyrec_tpu.data.loader import BatchLoader as JBatchLoader
from fancyrec_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from fancyrec_tpu.eval import evaluator as jeval
from fancyrec_tpu.eval import scorers as jscorers
from fancyrec_tpu.io.bigfile import ImageBigFile as JImageBigFile
from fancyrec_tpu.io.vocab import Bow2Vec as JBow2Vec
from fancyrec_tpu.io.vocab import load_vocab as jload_vocab
from fancyrec_tpu.io.word2vec import get_we_parameter as jget_we
from fancyrec_tpu.models import FancyRec as JFancyRec
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.train import checkpoints as jckpt
from fancyrec_tpu_torch.config import build_train_parser, config_from_args
from fancyrec_tpu_torch.data import modality as tmod
from fancyrec_tpu_torch.data.loader import BatchLoader
from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer
from fancyrec_tpu_torch.eval import evaluator as teval
from fancyrec_tpu_torch.eval import scorers as tscorers
from fancyrec_tpu_torch.interop import torch_state_from_jax
from fancyrec_tpu_torch.io.bigfile import BigFileWriter, ImageBigFile
from fancyrec_tpu_torch.io.dictfile import read_dict
from fancyrec_tpu_torch.io.vocab import Bow2Vec, load_vocab
from fancyrec_tpu_torch.io.word2vec import get_we_parameter
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
from fancyrec_tpu_torch.train import checkpoints
from fancyrec_tpu_torch.train import trainer
from fancyrec_tpu_torch.train.state import init_state
from fancyrec_tpu_torch.utils.fixture import make_fixture

from tests.test_checkpoint_import import (
    ASPECTS, BRANDS, COMMON, TorchBrandOracle, TorchFusionPH)
from tests.test_torch_port_model import (
    jax_variables, port_model, ragged_batch, tiny_cfg_kwargs)
from tests.test_torch_port_trainer import TINY
from tests.test_tower_parity import (
    BOWD, FEAT, HID, KNUM, RNN, TSIZES, VOCAB, VSIZES,
    TorchTextTransformersOracle, TorchVisualOracle)

TOL = dict(atol=5e-5, rtol=5e-5)
FEAT_DIM = 12                     # tiny_cfg_kwargs' visual_feat_dim


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_eval"))
    make_fixture(root, brand_num=3, videos_per_brand=3, imgs_per_brand=3,
                 feat_dim=FEAT_DIM, frames_per_video=4, seed=0)
    return root


# --- scorers ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["P", "P@1", "P@5", "P@100", "AP", "AP@3",
                                  "AP@10", "RR", "NDCG", "NDCG@5", "NDCG@10",
                                  "DCG@5", "DCG@10"])
def test_scorer_matches_jax(name):
    rng = np.random.RandomState(len(name))
    jsc, tsc = jscorers.getScorer(name), tscorers.getScorer(name)
    assert tsc.name() == jsc.name() and tsc.k == jsc.k
    for trial in range(20):
        n = rng.randint(1, 30)
        # binary and graded labels, with the (0, 1) grades of the AP quirk
        labels = list(rng.choice([0, 0, 1, 2, 0.5], size=n))
        if trial == 0:
            labels = [0] * n                       # no relevant item
        if name.startswith("NDCG") and not any(x > 0 for x in labels):
            continue                               # 0/0 in both packages
        assert tsc.score(labels) == jsc.score(labels)


def test_batch_scorers_match_jax():
    rng = np.random.RandomState(7)
    labels = rng.choice([0.0, 1.0, 0.5, 2.0], size=(9, 25))
    labels[3] = 0.0
    for k in (0, 1, 5, 25, 40):
        np.testing.assert_array_equal(tscorers.batch_ap(labels, k),
                                      jscorers.batch_ap(labels, k))
        np.testing.assert_array_equal(tscorers.batch_precision(labels, k),
                                      jscorers.batch_precision(labels, k))
    np.testing.assert_array_equal(tscorers.batch_rr(labels),
                                  jscorers.batch_rr(labels))
    assert tscorers.DCGScorer.SCALE == jscorers.DCGScorer.SCALE == 0.01757


def test_random_sim_matches_jax_for_a_seed():
    np.testing.assert_array_equal(teval.random_sim(4, 30, seed=5),
                                  jeval.random_sim(4, 30, seed=5))
    assert teval.random_sim(2, 3).shape == (2, 3)


# --- single-modality datasets and encoders ----------------------------------

def _stores(root, img, v2f):
    feat = os.path.join(root, "insCartest", "FeatureData")
    return (img(os.path.join(feat, "resnet152_dim_%d" % FEAT_DIM)),
            img(os.path.join(feat, "imgfeat_dim_%d" % FEAT_DIM)),
            v2f(os.path.join(feat, "resnet152_dim_%d" % FEAT_DIM,
                             "video2frames.txt")))


def _datasets(root, text_net):
    cap = os.path.join(root, "insCartest", "TextData", "insCartest.caption.txt")
    vdir = os.path.join(root, "insCartrain", "TextData", "vocabulary")
    bert = os.path.join(root, "bert_vocab.txt")
    bow = os.path.join(vdir, "bow", "word_vocab_5.pkl")
    rnn = os.path.join(vdir, "rnn", "word_vocab_5.pkl")
    kw = dict(text_net=text_net, max_tokens=10, max_words=8)
    vf, imf, v2f = _stores(root, ImageBigFile, read_dict)
    jvf, jimf, _ = _stores(root, JImageBigFile, read_dict)
    port = (tmod.VisDataset(vf, v2f, imf, max_frames=6),
            tmod.TxtDataset(cap, Bow2Vec(load_vocab(bow)),
                            rnn_vocab=load_vocab(rnn),
                            tokenizer=WordPieceTokenizer(bert), **kw))
    jax_ = (jmod.VisDataset(jvf, v2f, jimf, max_frames=6),
            jmod.TxtDataset(cap, JBow2Vec(jload_vocab(bow)),
                            rnn_vocab=jload_vocab(rnn),
                            tokenizer=JTokenizer(bert), **kw))
    sizes = dict(bow_vocab_size=len(load_vocab(bow)),
                 vocab_size=len(load_vocab(rnn)))
    return port, jax_, sizes


@pytest.mark.parametrize("text_net", ["transformers", "bi-gru"])
def test_modality_datasets_and_encoders_match_jax(root, text_net):
    (tvis, ttxt), (jvis, jtxt), sizes = _datasets(root, text_net)
    assert tvis.names == jvis.names and ttxt.names == jtxt.names
    for t, j in ((tvis, jvis), (ttxt, jtxt)):
        assert len(t) == len(j)
        got, want = t.gather_batch([4, 0, 2], pad_to=4), j.gather_batch(
            [4, 0, 2], pad_to=4)
        assert got.keys() == want.keys() and got["n_valid"] == 3
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    kw = dict(tiny_cfg_kwargs(text_net, "ph", True), **sizes)
    jcfg, jmodel, params, stats = jax_variables(kw)
    model = port_model(kw, params, stats)
    for tds, jds, tfn, jfn, width in (
            (tvis, jvis, teval.encode_vis, jeval.make_encode_vis_fn(jmodel),
             kw["visual_mapping_size"]),
            (ttxt, jtxt, teval.encode_txt, jeval.make_encode_txt_fn(jmodel),
             kw["text_mapping_size"])):
        got = tmod.encode_modality(model, BatchLoader(tds, 4,
                                                      final_batch="pad"),
                                   width, tfn, torch.device("cpu"))
        want = jmod.encode_modality(jmodel, params, stats,
                                    JBatchLoader(jds, 4, final_batch="pad"),
                                    width, jfn)
        assert got.shape == (len(tds), width) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)


# --- the 'attn' fusion head --------------------------------------------------

@pytest.mark.parametrize("text_net", ["transformers", "bi-gru"])
def test_attn_fusion_matches_jax(text_net):
    kw = tiny_cfg_kwargs(text_net, "attn", True)
    jcfg, jmodel, params, stats = jax_variables(kw)
    assert "visual_mapping" not in params["vid_encoding"]
    model = port_model(kw, params, stats)
    batch = ragged_batch(jcfg, 5, seed=4)
    want = jmodel.apply(
        {"params": params},
        JVisualBatch(*(jnp.asarray(batch[k])
                       for k in ("frames", "origin", "vmask"))),
        JTextBatch(*(jnp.asarray(batch[k])
                     for k in ("bows", "tokens", "type_ids", "tmask"))),
        deterministic=True, method=jmodel.embed_post)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model.embed_post(
            VisualBatch(t["frames"], t["origin"], t["vmask"]),
            TextBatch(t["bows"], t["tokens"].long(), t["type_ids"].long(),
                      t["tmask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attn_fusion_init_keeps_the_torch_defaults():
    from fancyrec_tpu_torch.config import Config
    from fancyrec_tpu_torch.models import init_fancyrec
    cfg = Config(**tiny_cfg_kwargs("bi-gru", "attn", True)).finalize()
    model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(0))
    f = model.fusion_encoding
    assert f.vis_linear.shape == (cfg.text_mapping_in,)
    assert f.text_linear.shape == (cfg.visual_mapping_in,)
    for v in (f.vis_linear, f.text_linear):
        assert v.abs().max() <= 1.0 and v.abs().max() > 0.5
    assert torch.count_nonzero(f.b) == 0
    for lin in (f.fusion_visual_linear, f.fusion_text_linear):
        bound = 1.0 / np.sqrt(lin.in_features)
        for p in (lin.weight, lin.bias):
            assert p.abs().max() <= bound and p.abs().max() > 0.5 * bound


# --- reference torch checkpoints ---------------------------------------------

class TorchFusionAttn(tnn.Module):
    """The reference's attn fusion parameters (model.py:495-534)."""

    def __init__(self, v_size, t_size):
        super().__init__()
        self.vis_linear = tnn.Linear(1, t_size, bias=False)
        self.text_linear = tnn.Linear(1, v_size, bias=False)
        self.b = tnn.Parameter(0.1 * torch.randn(v_size))
        self.fusion_visual_linear = tnn.Linear(t_size, COMMON)
        self.fusion_text_linear = tnn.Linear(v_size, COMMON)


def _reference_checkpoint(path, fusion_style):
    torch.manual_seed(0)
    vid, txt, brand = TorchVisualOracle(), TorchTextTransformersOracle(), \
        TorchBrandOracle()
    if fusion_style == "ph":
        fusion = TorchFusionPH(16)
        with torch.no_grad():
            bn = fusion.projection_head[1]
            bn.running_mean.uniform_(-0.3, 0.3)
            bn.running_var.uniform_(0.5, 1.5)
    else:
        fusion = TorchFusionAttn(2 * FEAT + 2 * RNN + KNUM * len(VSIZES),
                                 BOWD + HID + KNUM * len(TSIZES))
    opt = argparse.Namespace(
        trainCollection="insCartrain", valCollection="insCarval",
        testCollection="insCartest", brand_num=BRANDS, brand_aspect=ASPECTS,
        common_embedding_size=COMMON, visual_rnn_size=RNN,
        visual_feat_dim=FEAT, visual_kernel_num=KNUM,
        visual_kernel_sizes=list(VSIZES), text_kernel_num=KNUM,
        text_kernel_sizes=list(TSIZES), text_transformers_hidden_size=HID,
        text_net="transformers", fusion_style=fusion_style, concate="full",
        cost_style="mean", loss_fun="cl", text_mapping_size=[0, 8],
        visual_mapping_size=[0, 8], vocab="word_vocab_5", metric="auc",
        cv_name="FancyRec", optimizer=object())
    torch.save({"epoch": 7,
                "model": [vid.state_dict(), txt.state_dict(),
                          brand.state_dict(), fusion.state_dict()],
                "best_rsum": 123.4, "opt": opt, "Eiters": 999}, path)


@pytest.mark.parametrize("fusion_style", ["ph", "attn"])
def test_reference_checkpoint_loads_like_jax(tmp_path, fusion_style):
    path = str(tmp_path / "model_best.pth.tar")
    _reference_checkpoint(path, fusion_style)
    got, want = checkpoints.load_any(path), jckpt.load_any(path)
    assert (got["epoch"], got["Eiters"], got["best_rsum"]) == (7, 999, 123.4)
    cfg, jcfg = got["config"], want["config"]
    assert cfg.to_json() == jcfg.to_json()      # BERT dims read off weights
    assert cfg.text_kernel_sizes_list == list(TSIZES)
    # the testers size the BoW input from the vocabulary, then finalize
    for c in (cfg, jcfg):
        c.bow_vocab_size = BOWD
        c.finalize()
    model = FancyRec(cfg)
    model.load_state_dict(got["state_dict"])
    model.eval()

    rng = np.random.RandomState(0)
    b, t, tt = 3, 6, 8
    vmask = (np.arange(t)[None] < np.array([6, 4, 2])[:, None]).astype(
        np.float32)
    tmask = (np.arange(tt)[None] < np.array([8, 5, 2])[:, None]).astype(
        np.int32)
    batch = {"frames": rng.randn(b, t, FEAT).astype(np.float32)
             * vmask[..., None],
             "origin": rng.randn(b, FEAT).astype(np.float32), "vmask": vmask,
             "bows": rng.randn(b, BOWD).astype(np.float32),
             "tokens": (rng.randint(1, VOCAB, (b, tt)) * tmask).astype(
                 np.int32),
             "type_ids": np.zeros((b, tt), np.int32), "tmask": tmask}
    ids = np.arange(BRANDS)
    variables = {"params": want["model"]["params"]}
    if want["model"]["batch_stats"]:
        variables["batch_stats"] = want["model"]["batch_stats"]
    jb, jp = JFancyRec(jcfg).apply(
        variables, jnp.asarray(ids),
        JVisualBatch(*(jnp.asarray(batch[k])
                       for k in ("frames", "origin", "vmask"))),
        JTextBatch(*(jnp.asarray(batch[k])
                     for k in ("bows", "tokens", "type_ids", "tmask"))),
        deterministic=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        pb, pp = model(torch.from_numpy(ids),
                       VisualBatch(tb["frames"], tb["origin"], tb["vmask"]),
                       TextBatch(tb["bows"], tb["tokens"].long(),
                                 tb["type_ids"].long(), tb["tmask"]))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), **TOL)


def test_load_any_refuses_a_jax_checkpoint(tmp_path):
    """The JAX package's checkpoints are read now (the state dict equals
    interop's); what `load_any` refuses is a file that only starts like
    one: the FRTPU1 magic line without its blobs."""
    kw = tiny_cfg_kwargs()
    jcfg, _, params, stats = jax_variables(kw)
    path = str(tmp_path / "model_best.pth.tar")
    jckpt.save_checkpoint(path, jcfg, params, stats, 1, 0.0, 0)
    got = checkpoints.load_any(path)
    want = torch_state_from_jax(params, stats)
    assert set(got["state_dict"]) == set(want)
    for k, v in want.items():
        assert torch.equal(got["state_dict"][k], v), k
    stub = tmp_path / "stub.pth.tar"
    stub.write_bytes(b"FRTPU1\n")
    with pytest.raises(ValueError, match="FRTPU1"):
        checkpoints.load_any(str(stub))


def test_load_any_reads_the_ports_own_checkpoint(tmp_path):
    from fancyrec_tpu_torch.config import Config
    kw = tiny_cfg_kwargs()
    _, _, params, stats = jax_variables(kw)
    model = port_model(kw, params, stats)
    path = str(tmp_path / "own.pth.tar")
    checkpoints.save_checkpoint(path, Config(**kw).finalize(), model,
                                epoch=3)
    got = checkpoints.load_any(path)
    assert got["epoch"] == 3 and got["config"].brand_num == kw["brand_num"]
    for k, v in model.state_dict().items():
        assert torch.equal(got["state_dict"][k], v)


# --- --w2v_feature -------------------------------------------------------------

def test_w2v_feature_initializes_the_word_embeddings(root, tmp_path):
    vocab = load_vocab(os.path.join(root, "insCartrain", "TextData",
                                    "vocabulary", "rnn", "word_vocab_5.pkl"))
    w2v = str(tmp_path / "w2v")
    rng = np.random.RandomState(3)
    with BigFileWriter(w2v, 16, delimiter=" ") as w:   # every other word
        for i in range(0, len(vocab), 2):
            w.write(vocab.idx2word[i], rng.randn(16).astype(np.float32))
    args = build_train_parser().parse_args(
        TINY + ["--rootpath", root, "--text_net", "bi-gru",
                "--w2v_feature", w2v, "--video_feature",
                "resnet152_dim_%d" % FEAT_DIM, "--img_feature",
                "imgfeat_dim_%d" % FEAT_DIM])
    cfg = config_from_args(args)            # no longer refused
    trainer.build_datasets(cfg)
    cfg.finalize()
    model, _, _ = init_state(cfg, torch.device("cpu"))
    trainer.init_word_embeddings(model, cfg)
    want = jget_we(jload_vocab(os.path.join(
        root, "insCartrain", "TextData", "vocabulary", "rnn",
        "word_vocab_5.pkl")), w2v, seed=cfg.seed)
    np.testing.assert_array_equal(model.text_encoding.embed.detach().numpy(),
                                  want)
    np.testing.assert_array_equal(
        get_we_parameter(vocab, w2v, seed=cfg.seed), want)
