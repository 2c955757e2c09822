"""The port's training CLI end to end on the CPU, on a tiny fixture tree:
two epochs, the checkpoint files, an exact auto-resume, and the serving
path loading what training wrote."""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from fancyrec_tpu_torch.serving import index as sindex
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.utils.fixture import make_fixture

TINY = [
    "insCartrain", "insCarval", "insCartest",
    "--brand_num", "3", "--brand_aspect", "16",
    "--video_feature", "resnet152_dim_16", "--img_feature", "imgfeat_dim_16",
    "--common_embedding_size", "32", "--visual_rnn_size", "16",
    "--text_rnn_size", "16", "--visual_kernel_num", "8",
    "--text_kernel_num", "8", "--text_mapping_size", "32",
    "--visual_mapping_size", "32", "--word_dim", "16",
    "--text_transformers_hidden_size", "24", "--bert_num_layers", "2",
    "--batch_size", "4", "--accumulation_step", "2",
    "--learning_rate", "0.001", "--overwrite", "1",
    "--max_frames", "8", "--max_tokens", "24", "--max_words", "16",
    "--fusion_style", "ph", "--loss_fun", "cl", "--cost_style", "mean",
    "--text_norm", "--visual_norm", "--device", "cpu",
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_train"))
    # 3 brands x (4 videos + 4 images) = 24 train posts: 6 batches of 4,
    # 3 updates of 2 microbatches an epoch
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    return root


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_cli_trains_saves_and_serves(root, tmp_path):
    best = trainer.main(TINY + ["--rootpath", root, "--postfix", "tf",
                                "--text_net", "transformers",
                                "--num_epochs", "2"])
    logdir = os.path.join(root, "model", "tf")
    recs = _records(logdir)
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(math.isfinite(r["loss"]) and r["updates"] == 3 for r in recs)
    assert recs[-1]["Eiters"] == 12 and best == max(r["score"] for r in recs)
    assert os.path.exists(os.path.join(logdir, "model_best.pth.tar"))
    assert os.path.exists(os.path.join(logdir, "val_metric.txt"))

    # the serving path builds an index from the trained checkpoint
    out = str(tmp_path / "index")
    sindex.main(["build", out, "--checkpoint",
                 os.path.join(logdir, "model_best.pth.tar"), "--rootpath",
                 root, "--collection", "insCartest", "--batch_size", "4",
                 "--device", "cpu"])
    embs = np.load(os.path.join(out, "brand_embeddings.npy"))
    assert embs.shape == (3, 32) and np.isfinite(embs).all()


def test_auto_resume_restores_the_optimizer_moments(root, monkeypatch):
    args = TINY + ["--rootpath", root, "--postfix", "ar",
                   "--text_net", "bi-gru"]
    trainer.main(args + ["--num_epochs", "2"])
    logdir = os.path.join(root, "model", "ar")
    _, latest = checkpoints.latest_epoch_checkpoint(logdir)
    saved = checkpoints.load_checkpoint(latest)
    assert set(saved) >= {"optimizer", "epoch", "best_rsum", "Eiters",
                          "no_impr", "lr_counter", "pending_lr_scale"}

    seen = []
    train_epoch = trainer.train_epoch

    def spy(model, opt, cfg, state, loader, epoch, device):
        seen.append((epoch, copy.deepcopy(opt.state_dict()), state.step))
        return train_epoch(model, opt, cfg, state, loader, epoch, device)

    monkeypatch.setattr(trainer, "train_epoch", spy)
    os.remove(os.path.join(logdir, "val_metric.txt"))   # a crashed run
    trainer.main(args + ["--num_epochs", "3", "--auto_resume",
                         "--overwrite", "0"])
    recs = _records(logdir)
    assert [e for e, _, _ in seen] == list(range(saved["epoch"], 3))
    assert [r["epoch"] for r in recs] == [0, 1] + [e for e, _, _ in seen]
    assert recs[-1]["Eiters"] == 3 * 6      # 6 microbatches an epoch
    # the first resumed epoch starts from the saved moments, Adam's step
    # count (3 updates an epoch) and the lr the schedule had reached
    _, opt_state, _ = seen[0]
    want = saved["optimizer"]
    assert opt_state["state"].keys() == want["state"].keys()
    for k, s in opt_state["state"].items():
        assert float(s["step"]) == 3.0 * saved["epoch"]
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], want["state"][k][name])
    assert opt_state["param_groups"][0]["lr"] == pytest.approx(
        want["param_groups"][0]["lr"] * saved["pending_lr_scale"])
    # a finished run with auto_resume skips
    assert trainer.main(args + ["--num_epochs", "3", "--auto_resume",
                                "--overwrite", "0"]) is None


@pytest.mark.parametrize("flag, error, match", [
    # a data axis of 2 needs a world of 2 ranks; this process is a world
    # of one (as the JAX package's build_mesh refuses too many devices)
    (["--mesh_shape", "2,1"], ValueError, "needs 2 ranks, have 1"),
    (["--mesh_shape", "2"], ValueError, "needs 2 ranks, have 1"),
    # so does a model axis of 2 (tensor parallelism: a rank a model index)
    (["--mesh_shape", "1,2"], ValueError, "needs 2 ranks, have 1"),
    # --pp_stages 2 takes a model axis of 2 stages: a world of one cannot
    # host it (the JAX trainer's error on one device)
    (["--pp_stages", "2"], ValueError, "does not divide"),
    (["--rng_impl", "rbg"], NotImplementedError, "--rng_impl"),
    (["--compilation_cache_dir", "/nonexistent"], NotImplementedError,
     "--compilation_cache_dir"),
])
def test_not_ported_flags_are_refused(root, flag, error, match):
    logdir = os.path.join(root, "model", "refused")
    with pytest.raises(error, match=match):
        trainer.main(TINY + ["--rootpath", root, "--postfix", "refused"]
                     + flag)
    assert not os.path.exists(logdir)      # refused before any write


def test_seq_shard_in_a_world_of_one_trains_as_without(root):
    """--seq_shard with one model rank leaves the time axes whole (the JAX
    package's constraint does nothing where the mesh axis is 1): the run
    equals the one without the flag."""
    args = TINY + ["--rootpath", root, "--text_net", "transformers",
                   "--num_epochs", "1", "--dropout", "0"]
    best = trainer.main(args + ["--postfix", "seq1", "--seq_shard"])
    plain = trainer.main(args + ["--postfix", "seq_none"])
    assert best == plain


def test_mesh_of_one_trains_as_no_mesh(root):
    """--mesh_shape 1,1 in a world of one is the one-process run."""
    args = TINY + ["--rootpath", root, "--text_net", "bi-gru",
                   "--num_epochs", "1"]
    best = trainer.main(args + ["--postfix", "mesh11", "--mesh_shape", "1,1"])
    plain = trainer.main(args + ["--postfix", "mesh_none"])
    assert best == plain
