"""The port's evaluation CLI against the JAX package's, end to end on the
CPU: one JAX FancyRec from a seed, saved by the JAX package and carried
into a port checkpoint through `interop`, evaluated by both testers on the
same fixture tree. The rank metrics (MedR, MeanR, R@1/5/10) must be equal;
AUC and NDCG agree within 1e-6 (float32 encodes and cosines in other sum
orders on the same weights).
"""

import json
import os

import numpy as np
import pytest

from fancyrec_tpu.eval import tester as jtester
from fancyrec_tpu.train import checkpoints as jckpt
from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.eval import tester
from fancyrec_tpu_torch.io.vocab import load_vocab
from fancyrec_tpu_torch.train import checkpoints
from fancyrec_tpu_torch.utils.fixture import make_fixture

from tests.test_torch_port_model import (
    jax_variables, port_model, tiny_cfg_kwargs)

FEAT_DIM = 12                     # tiny_cfg_kwargs' visual_feat_dim
RANK = ("medr", "meanr", "r1", "r5", "r10")
SCORE = ("auc", "ndcg10", "ndcg50")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_tester"))
    # 3 brands x (4 videos + 4 images) = 24 test posts
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=FEAT_DIM, frames_per_video=4, seed=0)
    return root


def _kwargs(root, text_net):
    vdir = os.path.join(root, "insCartrain", "TextData", "vocabulary")
    with open(os.path.join(root, "bert_vocab.txt")) as f:
        bert_vocab = sum(1 for _ in f)
    return dict(
        tiny_cfg_kwargs(text_net, "ph", True), brand_num=3,
        trainCollection="insCartrain", valCollection="insCarval",
        testCollection="insCartest",
        video_feature="resnet152_dim_%d" % FEAT_DIM,
        img_feature="imgfeat_dim_%d" % FEAT_DIM,
        bow_vocab_size=len(load_vocab(os.path.join(vdir, "bow",
                                                   "word_vocab_5.pkl"))),
        vocab_size=len(load_vocab(os.path.join(vdir, "rnn",
                                               "word_vocab_5.pkl"))),
        bert_vocab_size=bert_vocab)


def _checkpoints(root, text_net, tmp_path, buckets=None):
    """The same weights as a JAX checkpoint and as a port checkpoint, with
    the same config -> (JAX logdir, port logdir)."""
    kw = _kwargs(root, text_net)
    jcfg, _, params, stats = jax_variables(kw, seed=3)
    if buckets:
        jcfg.token_buckets, jcfg.frame_buckets = buckets
        jcfg.finalize()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(os.path.join(jdir, "model_best.pth.tar"), jcfg,
                          params, stats, 1, 0.0, 0)
    checkpoints.save_checkpoint(os.path.join(pdir, "model_best.pth.tar"),
                                Config.from_json(jcfg.to_json()),
                                port_model(kw, params, stats))
    return jdir, pdir


def _argv(root, logdir):
    return ["insCartest", "--rootpath", root, "--logger_name", logdir,
            "--batch_size", "4"]


def _read(logdir):
    with open(os.path.join(logdir, "mean_metrics.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("text_net,buckets", [
    ("transformers", None),
    ("bi-gru", None),
    # buckets ride the checkpoint: both testers length-sort their loaders
    # and pad each batch to its bucket
    ("transformers", ("4,8", "2")),
])
def test_port_tester_gives_the_jax_testers_metrics(root, tmp_path, text_net,
                                                   buckets, capsys):
    jdir, pdir = _checkpoints(root, text_net, tmp_path, buckets)
    want = jtester.main(_argv(root, jdir))
    got = tester.main(_argv(root, pdir) + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert all(np.isfinite(v) for v in got)
    for k in RANK:
        assert getattr(got, k) == getattr(want, k), k
    for k in SCORE:
        assert getattr(got, k) == pytest.approx(getattr(want, k), abs=1e-6), k
    # the eight metric lines, in the JAX tester's order, and the JSON file
    lines = [ln.split(":")[0] for ln in out.splitlines()
             if ln.split(":")[0] in ("AUC[0-1]", "NDCG@10[0-1]",
                                     "NDCG@50[0-1]", "recall@1", "recall@5",
                                     "recall@10", "MedR", "MeanR")]
    assert lines[-8:] == ["AUC[0-1]", "NDCG@10[0-1]", "NDCG@50[0-1]",
                          "recall@1", "recall@5", "recall@10", "MedR",
                          "MeanR"]
    jj, pj = _read(jdir), _read(pdir)
    assert pj.keys() == jj.keys() and pj == {k: float(v) for k, v in
                                            got._asdict().items()}
    for k in RANK:
        assert pj[k] == jj[k]
    for k in SCORE:
        assert pj[k] == pytest.approx(jj[k], abs=1e-6)


def test_tester_skips_and_refuses_like_the_jax_tester(root, tmp_path):
    with pytest.raises(SystemExit) as e:          # no checkpoint
        tester.main(_argv(root, str(tmp_path / "none")) + ["--device", "cpu"])
    assert e.value.code == 0
    # the reference's layout: <train>/<cv_name>/<run> maps to the results
    # tree <test>/results/<train>/<run>, whose skip marker (never written)
    # is honoured and which receives mean_metrics.json
    _, pdir = _checkpoints(root, "bi-gru",
                           tmp_path / "insCartrain" / "FancyRec")
    results = str(tmp_path / "insCartest" / "results" / "insCartrain" /
                  "port")
    marker = os.path.join(results, "model_best.pth.tar")
    os.makedirs(marker)
    open(os.path.join(marker, "pred_errors_matrix.pth.tar"), "w").close()
    with pytest.raises(SystemExit) as e:
        tester.main(_argv(root, pdir) + ["--device", "cpu"])
    assert e.value.code == 0
    assert not os.path.exists(os.path.join(results, "mean_metrics.json"))
    m = tester.main(_argv(root, pdir) + ["--device", "cpu", "--overwrite",
                                         "1"])
    assert _read(results)["auc"] == m.auc
    # a data axis of 2 needs a world of 2 ranks (this process is one); a
    # model axis and XLA's compile cache are not in the port
    for flag, error, match in (
            (["--mesh_shape", "2,1"], ValueError, "needs 2 ranks, have 1"),
            (["--mesh_shape", "1,2"], NotImplementedError, "model mesh axis"),
            (["--compilation_cache_dir", str(tmp_path / "xla")],
             NotImplementedError, "--compilation_cache_dir")):
        with pytest.raises(error, match=match):
            tester.main(_argv(root, pdir) + ["--device", "cpu"] + flag)
