"""The JAX package's FRTPU1 checkpoints in the port, on the CPU.

`fancyrec_tpu_torch.io.msgpack` against flax's own encoder; `load_any` on
files that `fancyrec_tpu.train.checkpoints.save_checkpoint` wrote: the
state dict, config and meta, and the optax Adam or RMSprop moments, which
must make the port's next step the JAX package's; the trainer CLI
resuming from such a file; and the committed tiny FRTPU1 file that
`chip_smoke.py` loads onto the card, regenerated byte for byte.
"""

import copy
import json
import os
import pathlib
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from fancyrec_tpu.config import Config as JaxConfig
from fancyrec_tpu.losses import contrastive_loss as jax_contrastive_loss
from fancyrec_tpu.losses import init_queue_state as jax_init_queue_state
from fancyrec_tpu.models.encoders import TextBatch as JTextBatch
from fancyrec_tpu.models.encoders import VisualBatch as JVisualBatch
from fancyrec_tpu.train import checkpoints as jckpt
from fancyrec_tpu.train.state import init_state as jax_init_state
from fancyrec_tpu.train.state import make_optimizer as jax_make_optimizer
from fancyrec_tpu_torch.config import build_train_parser, config_from_args
from fancyrec_tpu_torch.interop import (
    torch_params_from_jax, torch_state_from_jax)
from fancyrec_tpu_torch.io import msgpack as pmsgpack
from fancyrec_tpu_torch.losses import init_queue_state
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.train import checkpoints, trainer
from fancyrec_tpu_torch.train.state import (
    TrainState, load_optimizer_state, make_optimizer)
from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_model import (
    jax_variables, port_model, ragged_batch, tiny_cfg_kwargs)
from tests.test_torch_port_train import _microbatches
from tests.test_torch_port_trainer import TINY

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "frtpu1_tiny.pth.tar"


# ---------------------------------------------------------------- msgpack

_LEAVES = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "f64": np.array([1e300, -2.5]),
    "f16": np.array([0.5, 65504.0], np.float16),
    "bf16": jnp.asarray([1.5, -2.25, 3e38, 1e-3], jnp.bfloat16),
    "i8": np.array([-128, 0, 127], np.int8),
    "u8": np.array([0, 255], np.uint8),
    "i32": np.array([[-(2 ** 31), 2 ** 31 - 1]], np.int32),
    "i64": np.array([-(2 ** 63), 2 ** 63 - 1], np.int64),
    "u32": np.array([2 ** 32 - 1], np.uint32),
    "bool": np.array([True, False, True]),
    "empty": np.zeros((0, 3), np.float32),
    "scalar_f32": np.float32(0.1),
    "scalar_i32": np.int32(-7),
    "scalar_bool": np.bool_(True),
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)],
    "floats": [0.0, -1.5, 1e-300, float("inf")],
    "strs": ["", "a", "x" * 31, "y" * 32, "z" * 255, "w" * 256,
             "v" * 65536, "é中"],
    "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
    "misc": [None, True, False, 1 + 2j, {"nested": {"deep": [1, [2]]}}],
    "map16": {str(i): i for i in range(20)},
    "array16": list(range(20)),
}


def _assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert got.dtype == np.float32, path
        np.testing.assert_array_equal(got, want.astype(np.float32))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype, path
        assert np.shape(got) == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("leaf", sorted(_LEAVES))
def test_msgpack_restore_matches_flax(leaf):
    """Each leaf type flax writes, through flax's encoder, decoded by the
    port and by flax: equal values and dtypes (bfloat16 comes back as the
    same values in float32)."""
    data = serialization.msgpack_serialize({"leaf": _LEAVES[leaf]})
    _assert_same(pmsgpack.msgpack_restore(data),
                 serialization.msgpack_restore(data))


def test_msgpack_restore_reassembles_chunked_arrays(monkeypatch):
    """flax's chunked form of an array above MAX_CHUNK_SIZE bytes (64 here,
    so a 10 x 7 float32 array splits into 5 chunks), at the top level and
    nested, beside arrays below the limit."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(0)
    tree = {"big": rng.randn(10, 7).astype(np.float32),
            "small": np.arange(3, dtype=np.int32),
            "inner": {"big": rng.randn(3, 5, 4)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = pmsgpack.msgpack_restore(data)
    _assert_same(got, serialization.msgpack_restore(data))
    _assert_same(got, tree)


def test_msgpack_rejects_truncated_and_trailing_input():
    data = serialization.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        pmsgpack.unpackb(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        pmsgpack.unpackb(data + b"\xc0")


# ---------------------------------------------------------------- FRTPU1

def _adam_state_after(jcfg, params, seed, lr_scale=1.0):
    """An optax state with non-trivial moments: one update from random
    grads, then the injected lr scaled."""
    rng = np.random.RandomState(seed)
    tx = jax_make_optimizer(jcfg)
    opt_state = tx.init(params)
    grads = jax.tree.map(
        lambda x: jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32)),
        params)
    _, opt_state = tx.update(grads, opt_state, params)
    inner = opt_state[-1]
    hp = dict(inner.hyperparams)
    hp["learning_rate"] = hp["learning_rate"] * lr_scale
    return tx, opt_state[:-1] + (inner._replace(hyperparams=hp),)


def write_fixture(path):
    """The committed tiny FRTPU1 file: `tiny_cfg_kwargs`' model (rootpath
    fixed so that the config JSON does not depend on the environment),
    perturbed weights from seed 0, Adam moments after one update."""
    kw = dict(tiny_cfg_kwargs(), rootpath="insCar")
    jcfg, _, params, stats = jax_variables(kw, seed=0)
    _, opt_state = _adam_state_after(jcfg, params, seed=5, lr_scale=0.5)
    jckpt.save_checkpoint(str(path), jcfg, params, stats, 2, 0.75, 8,
                          opt_state=jax.device_get(opt_state),
                          extra_meta={"no_impr": 1, "lr_counter": 2,
                                      "pending_lr_scale": 0.99})


def test_committed_frtpu1_fixture_regenerates_byte_for_byte(tmp_path):
    """chip_smoke.py reads tests/data/frtpu1_tiny.pth.tar on the card; the
    JAX package rewrites it here from seed 0, so it cannot drift."""
    path = tmp_path / "regen.pth.tar"
    write_fixture(path)
    assert FIXTURE.stat().st_size < 1 << 20
    assert path.read_bytes() == FIXTURE.read_bytes()


def test_load_any_reads_a_jax_checkpoint(tmp_path):
    """The state dict equals interop's from the same variables, and the
    config and meta are the file's."""
    kw = tiny_cfg_kwargs()
    jcfg, _, params, stats = jax_variables(kw, seed=2)
    path = str(tmp_path / "model_best.pth.tar")
    jckpt.save_checkpoint(path, jcfg, params, stats, 3, 1.25, 17,
                          extra_meta={"no_impr": 2, "lr_counter": 1,
                                      "pending_lr_scale": 0.5})
    got = checkpoints.load_any(path)
    want = torch_state_from_jax(params, stats)
    assert set(got["state_dict"]) == set(want)
    for k, v in want.items():
        assert torch.equal(got["state_dict"][k], v), k
    assert got["config"].to_json() == \
        checkpoints.Config.from_json(jcfg.to_json()).to_json()
    assert (got["epoch"], got["best_rsum"], got["Eiters"], got["no_impr"],
            got["lr_counter"], got["pending_lr_scale"]) == (
                3, 1.25, 17, 2, 1, 0.5)
    assert "optimizer" not in got and got["has_opt_state"] is False
    # the state dict loads into the model its config builds
    model = FancyRec(got["config"])
    model.load_state_dict(got["state_dict"])


def test_load_any_frtpu1_moments_match_interop(tmp_path):
    """The optax Adam moments come back keyed by the port's parameter
    names in their torch layouts (Dense kernels transposed, conv kernels
    permuted), with optax's count and the injected lr."""
    kw = tiny_cfg_kwargs()
    jcfg, _, params, stats = jax_variables(kw, seed=4)
    _, opt_state = _adam_state_after(jcfg, params, seed=6, lr_scale=0.25)
    path = str(tmp_path / "ck.pth.tar")
    jckpt.save_checkpoint(path, jcfg, params, stats, 1, 0.0, 2,
                          opt_state=jax.device_get(opt_state))
    got = checkpoints.load_any(path)["optimizer"]
    adam = opt_state[-1].inner_state[0]
    assert got["optimizer"] == "adam" and got["step"] == int(adam.count) == 1
    assert got["lr"] == pytest.approx(jcfg.learning_rate * 0.25, rel=1e-6)
    mu = torch_params_from_jax(jax.device_get(adam.mu))
    nu = torch_params_from_jax(jax.device_get(adam.nu))
    names = {n for n, _ in port_model(kw, params, stats).named_parameters()}
    assert set(got["state"]) == names == set(mu)
    for n in names:
        assert torch.equal(got["state"][n]["exp_avg"], mu[n]), n
        assert torch.equal(got["state"][n]["exp_avg_sq"], nu[n]), n
    w = got["state"]["fusion_encoding.fc1.weight"]["exp_avg"]
    assert tuple(w.shape) == np.asarray(
        adam.mu["fusion_encoding"]["fc1"]["kernel"]).T.shape


def test_load_any_refuses_a_truncated_frtpu1(tmp_path):
    """An FRTPU1 file cut short, or one without its model blob, is refused
    with a clear error instead of a half-read model."""
    kw = tiny_cfg_kwargs()
    jcfg, _, params, stats = jax_variables(kw)
    path = tmp_path / "model_best.pth.tar"
    jckpt.save_checkpoint(str(path), jcfg, params, stats, 1, 0.0, 0)
    data = path.read_bytes()
    cut = tmp_path / "cut.pth.tar"
    cut.write_bytes(data[:-100])
    with pytest.raises(ValueError, match="FRTPU1"):
        checkpoints.load_any(str(cut))
    head = tmp_path / "head.pth.tar"
    n = struct.unpack("<Q", data[7:15])[0]
    m = struct.unpack("<Q", data[15 + n:23 + n])[0]
    head.write_bytes(data[:23 + n + m])          # config and meta only
    with pytest.raises(ValueError, match="FRTPU1"):
        checkpoints.load_any(str(head))


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_one_step_after_an_frtpu1_resume_matches_jax(tmp_path, optimizer):
    """One update in the port after `load_any` + `load_optimizer_state`
    against the JAX package's update from the same file
    (`restore_opt_state`, the optax transform, `apply_updates`), on the
    same two microbatches with every dropout off. The step moves each
    param by about lr = 5e-4; the params agree within atol 5e-7 (lr times
    the two packages' float32 grad agreement, which RMSprop divides by a
    small root of nu) and rtol 2.4e-7 (two ulps of a BatchNorm scale near
    1). A moment carried without its layout change would be O(lr) off."""
    kw = dict(tiny_cfg_kwargs("transformers", "ph", True), dropout=0.0,
              bert_dropout=0.0, loss_fun="cl", cost_style="mean",
              accumulation_step=2, grad_clip=2.0, queue_size=16,
              optimizer=optimizer, learning_rate=1e-3)
    jcfg, jmodel, params, stats = jax_variables(kw, seed=7)
    tx, opt_state = _adam_state_after(jcfg, params, seed=8, lr_scale=0.5)
    path = str(tmp_path / "resume.pth.tar")
    jckpt.save_checkpoint(path, jcfg, params, stats, 1, 0.0, 2,
                          opt_state=jax.device_get(opt_state))
    mbs = _microbatches(jcfg, 2, 4, seed=40)

    # the JAX package's update from the file
    ck = jckpt.load_any(path)
    jparams, bs = ck["model"]["params"], ck["model"]["batch_stats"]
    jopt, restored = jckpt.restore_opt_state(ck, tx.init(jparams))
    assert restored

    def micro(p, bs, q, mb):
        v = JVisualBatch(*(jnp.asarray(mb[k])
                           for k in ("frames", "origin", "vmask")))
        t = JTextBatch(*(jnp.asarray(mb[k])
                         for k in ("bows", "tokens", "type_ids", "tmask")))
        post, mut = jmodel.apply({"params": p, "batch_stats": bs}, v, t,
                                 deterministic=False, mutable=["batch_stats"],
                                 method=jmodel.embed_post,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        brand = jmodel.apply({"params": p}, jnp.asarray(mb["brand_ids"]),
                             deterministic=True, method=jmodel.embed_brand)
        loss, q = jax_contrastive_loss(brand, post, q, cost_style="mean")
        return loss, (mut["batch_stats"], q)

    grad_fn = jax.value_and_grad(micro, has_aux=True)
    q = jax_init_queue_state(16, kw["common_embedding_size"])
    gsum = None
    for mb in mbs:
        (_, (bs, q)), g = grad_fn(jparams, bs, q, mb)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    updates, _ = tx.update(gsum, jopt, jparams)
    want = torch_params_from_jax(
        jax.device_get(optax.apply_updates(jparams, updates)))

    # the port's update from the same file
    ckpt = checkpoints.load_any(path)
    model = FancyRec(ckpt["config"])
    model.load_state_dict(ckpt["state_dict"])
    model.brand_encoding.p = 0.0
    model.seed_dropout(0)
    opt = make_optimizer(ckpt["config"], model.parameters())
    load_optimizer_state(opt, model, ckpt["optimizer"])
    state = TrainState(queue=init_queue_state(16, kw["common_embedding_size"]))
    superbatch = {k: torch.from_numpy(v)
                  for k, v in stack_microbatches(mbs).items()}
    train_step(model, opt, ckpt["config"], state, superbatch)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    moved = 0.0
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=5e-7, rtol=2.4e-7, err_msg=name)
        moved = max(moved, float((p.detach() - ckpt["state_dict"][name])
                                 .abs().max()))
    assert moved > 1e-4          # the step moved the params


def test_trainer_cli_resumes_from_an_frtpu1_file(tmp_path):
    """--resume of a JAX-written checkpoint in the port's trainer CLI on
    the CPU: the weights and Adam moments the first epoch starts from are
    the file's (moments in torch layouts, the step and lr optax's), and
    the run trains to a finite loss."""
    root = str(tmp_path / "tree")
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    args = TINY + ["--rootpath", root, "--postfix", "frtpu1",
                   "--num_epochs", "1"]
    cfg = config_from_args(build_train_parser().parse_args(args))
    trainer.build_datasets(cfg)
    cfg.finalize()
    jcfg = JaxConfig.from_json(cfg.to_json())
    _, jstate = jax_init_state(jcfg, seed=3)
    params = jax.device_get(jstate.params)
    _, opt_state = _adam_state_after(jcfg, params, seed=9, lr_scale=0.5)
    path = str(tmp_path / "jax.pth.tar")
    jckpt.save_checkpoint(path, jcfg, params,
                          jax.device_get(jstate.batch_stats), 1, 0.0, 2,
                          opt_state=jax.device_get(opt_state))

    seen = {}
    run_epoch = trainer.train_epoch

    def spy(model, opt, cfg, state, loader, epoch, device):
        seen["params"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        seen["opt"] = copy.deepcopy(opt.state_dict())
        seen["names"] = [n for n, _ in model.named_parameters()]
        return run_epoch(model, opt, cfg, state, loader, epoch, device)

    trainer.train_epoch = spy
    try:
        trainer.main(args + ["--resume", path])
    finally:
        trainer.train_epoch = run_epoch
    want = torch_params_from_jax(params)
    mu = torch_params_from_jax(jax.device_get(opt_state[-1].inner_state[0].mu))
    for n, v in want.items():
        assert torch.equal(seen["params"][n], v), n
    for i, n in enumerate(seen["names"]):
        s = seen["opt"]["state"][i]
        assert float(s["step"]) == 1.0
        assert torch.equal(s["exp_avg"], mu[n]), n
    assert seen["opt"]["param_groups"][0]["lr"] == pytest.approx(
        cfg.learning_rate * 0.5, rel=1e-6)
    logdir = os.path.join(root, "model", "frtpu1")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f][-1]
    assert np.isfinite(rec["loss"]) and rec["updates"] == 3


def test_committed_fixture_loads_and_encodes_like_jax():
    """The committed file through `load_any` encodes a seeded batch as the
    JAX model does from the same variables (float32, atol = rtol = 5e-5):
    the CPU side of chip_smoke.py's FRTPU1 phase."""
    ck = checkpoints.load_any(str(FIXTURE))
    assert ck["epoch"] == 2 and ck["optimizer"]["step"] == 1
    model = FancyRec(ck["config"])
    model.load_state_dict(ck["state_dict"])
    model.eval()
    jck = jckpt.load_any(str(FIXTURE))
    jcfg = jck["config"]
    from fancyrec_tpu.models import FancyRec as JFancyRec
    jmodel = JFancyRec(jcfg)
    batch = ragged_batch(jcfg, 5, seed=11)
    jp = jmodel.apply(jck["model"],
                      JVisualBatch(*(jnp.asarray(batch[k]) for k in
                                     ("frames", "origin", "vmask"))),
                      JTextBatch(*(jnp.asarray(batch[k]) for k in
                                   ("bows", "tokens", "type_ids", "tmask"))),
                      method=JFancyRec.embed_post)
    from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        pp = model.embed_post(
            VisualBatch(tb["frames"], tb["origin"], tb["vmask"]),
            TextBatch(tb["bows"], tb["tokens"].long(), tb["type_ids"].long(),
                      tb["tmask"]))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=5e-5,
                               rtol=5e-5)
