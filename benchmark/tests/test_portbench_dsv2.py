"""The dsv2.train cell on the CPU at tiny widths (its own overrides): it
resolves and runs, correct; the routing top-(k - 1) fault and the
half-batch fault come out not correct, and on the card the TF32 control
too (`chip`); the Zipf draw of caption words is seeded."""

import io
import json
import os
import time

import numpy as np
import pytest
import torch

import harness
import run
from portbench_tiny import DATA, MODEL, Args

TOWER = {"vocab_size": 405, "hidden_size": 32, "intermediate_size": 48,
         "moe_intermediate_size": 8, "num_hidden_layers": 3,
         "num_attention_heads": 4, "n_routed_experts": 8,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
         "v_head_dim": 8}
SHAPES = {"config": dict(TOWER, model=MODEL, data=DATA),
          "traffic": {"posts": 48, "video_frames": [2, 8],
                      "caption_length": [4, 16]}}


def _driver():
    cell = harness.Cell(harness.spec(), "dsv2.train")
    return cell, cell.driver()


def run_cpu(tmp_path, monkeypatch, seed, trace=0):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = io.StringIO()
    result = run.run(Args("dsv2.train", seed, trace=trace),
                     require_chip=False, overrides=SHAPES, out=out,
                     t_start=time.time())
    last = json.loads(out.getvalue().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    return last


def test_the_cell_resolves_to_its_files():
    cell, driver = _driver()
    assert cell.traffic["driver"] == "train_moe" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"train_posts_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "moe_roofline.dsv2", "train_mfu.dsv2", "moe_load_max.dsv2"}
    # every width as published, only the depth cut
    assert (cell.config["hidden_size"], cell.config["n_routed_experts"],
            cell.config["num_experts_per_tok"],
            cell.config["moe_intermediate_size"],
            cell.config["num_hidden_layers"]) == (2048, 64, 6, 1408, 5)
    spec = driver.weight_spec(cell.config)
    n = sum(int(np.prod(s)) for name, s, _, _ in spec
            if name.startswith("text_encoding.deepseek."))
    assert 2.60e9 < n < 2.66e9


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu(tmp_path, monkeypatch, trace):
    last = run_cpu(tmp_path, monkeypatch, 2 ** 31 + 7, trace)
    assert last["correct"] is True, last["checks"]
    assert last["checks"]["routing_rows_off"]["value"] == 0
    assert last["attempted"] > 0 and last["failed"] == 0
    if trace:
        # no device trace on the CPU: only the program's counter reads
        assert set(last["metrics"]) == {"moe_load_max.dsv2"}
        assert last["metrics"]["moe_load_max.dsv2"]["value"] >= 1.0
    else:
        assert set(last["metrics"]) == {"train_posts_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["top_k_minus_1", "half_batch"])
def test_faults_are_not_correct(kind, tmp_path, monkeypatch):
    if kind == "top_k_minus_1":
        from fancyrec_tpu_torch.config import Config
        real = Config.tower_config

        def fewer(self):
            tc = real(self)
            tc.num_experts_per_tok -= 1
            return tc

        monkeypatch.setattr(Config, "tower_config", fewer)
    else:
        import fancyrec_tpu_torch.train.trainer as trainer
        real_step = trainer.train_step

        def step(model, opt, cfg, state, sb):
            b = sb["frames"].shape[1]
            sb = {k: (v[:, :b // 2] if v.dim() > 1 else v)
                  for k, v in sb.items()}
            return real_step(model, opt, cfg, state, sb)

        monkeypatch.setattr(trainer, "train_step", step)
    last = run_cpu(tmp_path, monkeypatch, 23)
    assert last["correct"] is False
    if kind == "top_k_minus_1":
        assert last["checks"]["routing_rows_off"]["value"] > 0


def test_the_zipf_draw_is_seeded():
    _, driver = _driver()
    lengths = [5, 9, 30, 1000]
    a = driver.zipf_words(lengths, 400, 1.0, 2 ** 33 + 1)
    b = driver.zipf_words(lengths, 400, 1.0, 2 ** 33 + 1)
    c = driver.zipf_words(lengths, 400, 1.0, 2 ** 33 + 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert [len(x) for x in a] == lengths
    ids = np.concatenate(driver.zipf_words([200000], 400, 1.0, 3))
    assert ids.min() >= 0 and ids.max() < 400
    # rank 1 takes 1 / H_400 of the draws, rank 2 half that
    h = np.sum(1.0 / np.arange(1, 401))
    assert abs(np.mean(ids == 0) - 1 / h) < 0.01
    assert abs(np.mean(ids == 1) - 0.5 / h) < 0.01


@pytest.mark.chip
def test_controls_fail_the_check_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell, driver = _driver()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = driver.run(dict(cell=cell, seed=7, seconds=1.0, trace=False,
                        device=dev, t_start=time.time(), control=True,
                        work=str(tmp_path)))
    lim = harness.load_json(os.path.join(harness.BENCH, "limits",
                                         "dsv2.train.json"))
    assert r["correct"]
    for control in ("tf32", "half_batch", "top_k_minus_1"):
        assert any(v > lim[k] for k, v in r["controls"][control].items()), (
            control, r["controls"][control])
