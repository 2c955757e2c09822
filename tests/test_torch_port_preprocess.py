"""The port's offline preprocessing against the JAX package's.

The same inputs (numpy seeds, a tiny synthetic scrape tree as in
tests/test_preprocess.py) go through both packages. Writers are held byte
for byte: BigFiles, txt lines, video2frames.txt, caption and split files;
vocabulary pickles by content (each names its own package's class). The
ResNet-backed extraction runs on the CPU at a tiny depth."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fancyrec_tpu.io import format_check as jformat_check
from fancyrec_tpu.io import vocab as jvocab
from fancyrec_tpu.models import resnet as jresnet
from fancyrec_tpu.preprocess import captions as jcaptions
from fancyrec_tpu.preprocess import features as jfeatures
from fancyrec_tpu.preprocess import frameinfo as jframeinfo
from fancyrec_tpu.preprocess import pipeline as jpipeline
from fancyrec_tpu.preprocess import txt2bin as jtxt2bin
from fancyrec_tpu.preprocess import vocab_cli as jvocab_cli
from fancyrec_tpu_torch.io import format_check, vocab
from fancyrec_tpu_torch.io.bigfile import BigFileWriter, ImageBigFile
from fancyrec_tpu_torch.io.dictfile import read_dict
from fancyrec_tpu_torch.models import resnet
from fancyrec_tpu_torch.preprocess import (captions, features, frameinfo,
                                           pipeline, txt2bin, videos,
                                           vocab_cli)
from fancyrec_tpu_torch.utils.meters import Progress


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _fake_extractor(images):
    """tests/test_preprocess.py's stand-in for the ResNet: cheap
    deterministic 32-d features."""
    x = images.astype(np.float32) / 255.0
    pooled = x.mean(axis=(1, 2))          # (B, 3)
    feats = np.concatenate([pooled ** (i + 1) for i in range(11)], axis=1)
    return np.concatenate([feats[:, :32 - 33 + 33], feats], axis=1)[:, :32]


def _frames(n, seed=0, hw=16):
    rng = np.random.RandomState(seed)
    return [("video%d_%d_cls%d" % (i // 3 + 1, (i % 3) * 5, i % 2),
             rng.randint(0, 256, (hw, hw, 3)).astype(np.uint8))
            for i in range(n)]


def _write_video(cv2, path, n_frames=20, fps=10, size=(64, 48), seed=0):
    rng = np.random.RandomState(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert vw.isOpened(), "mp4v codec unavailable"
    for _ in range(n_frames):
        vw.write(rng.randint(0, 255, (size[1], size[0], 3), np.uint8))
    vw.release()


@pytest.fixture(scope="module")
def scrape_tree(tmp_path_factory):
    """tests/test_preprocess.py's tree: 2 brands, 2 videos and 20 images
    each, with their Instagram-scrape JSON."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image
    src = str(tmp_path_factory.mktemp("scrape"))
    for b, brand in enumerate(["audi", "bmw"]):
        d = os.path.join(src, brand)
        os.makedirs(d)
        items = []
        for i in range(2):
            code = "%s_vid%d" % (brand, i)
            _write_video(cv2, os.path.join(d, code + ".mp4"), seed=b * 10 + i)
            items.append({
                "__typename": "GraphVideo", "is_video": True,
                "shortcode": code,
                "edge_media_to_caption": {"edges": [{"node": {
                    "text": "a fast %s car drives at night #%d"
                            % (brand, i)}}]},
                "tags": ["car", brand],
            })
        for i in range(20):
            code = "%s_img%d" % (brand, i)
            Image.fromarray(np.full((32, 32, 3), (b * 40 + i) % 255,
                                    np.uint8)).save(
                os.path.join(d, code + ".jpg"))
            items.append({
                "__typename": "GraphImage", "is_video": False,
                "shortcode": code,
                "edge_media_to_caption": {"edges": [{"node": {
                    "text": "new red %s on the road %d" % (brand, i)}}]},
            })
        with open(os.path.join(d, "scrape.json"), "w") as f:
            json.dump({"GraphImages": items}, f)
    return src


# ---------------------------------------------------------------- writers


@pytest.mark.parametrize("n", [8, 11], ids=["full", "tail"])
def test_extract_features_writes_the_jax_bytes(tmp_path, n):
    """feature.bin, id.txt, shape.txt and the txt lines, byte for byte,
    with a tail batch that is not full (11 = 2 x 4 + 3)."""
    stream = _frames(n)
    stats = {}
    rows = features.extract_features(
        iter(stream), str(tmp_path / "port"), batch_size=4,
        extract_fn=_fake_extractor, txt_path=str(tmp_path / "port.txt"),
        stats=stats)
    want = jfeatures.extract_features(
        iter(stream), str(tmp_path / "jax"), batch_size=4,
        extract_fn=_fake_extractor, txt_path=str(tmp_path / "jax.txt"))
    assert rows == want == n
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert stats["batches"] == (n + 3) // 4
    assert min(stats[k] for k in ("wait_s", "compute_s", "write_s")) >= 0


@pytest.mark.parametrize("own", [False, True], ids=["extract_fn", "resnet"])
def test_extract_features_propagates_a_decode_exception(tmp_path, own,
                                                        monkeypatch):
    """A decode failure in the producer thread fails the extraction and
    leaves no id.txt / shape.txt (never a silently truncated BigFile)."""
    def failing_stream():
        for item in _frames(5):
            yield item
        raise OSError("decode failed")

    if own:
        monkeypatch.setattr(resnet, "init_random_params", _tiny_state)
        kw = dict(device="cpu")
    else:
        kw = dict(extract_fn=lambda im: np.ones((len(im), 4), np.float32))
    out = tmp_path / "out"
    with pytest.raises(OSError, match="decode failed"):
        features.extract_features(failing_stream(), str(out), batch_size=2,
                                  **kw)
    assert not (out / "shape.txt").exists()
    assert not (out / "id.txt").exists()


def _tiny_state(seed=0, dtype=torch.float32):
    """A stem-and-one-block extractor (256-d), random from a seed."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return resnet.ResNetFeatures((1, 0, 0, 0)).to(dtype).state_dict()


def test_extract_features_on_the_cpu_writes_the_extractors_rows(tmp_path):
    """Without extract_fn the port's own extractor runs on the device it
    is given (here the CPU) from the uint8 batches staged for it: each
    row is the extractor's output for its image, bit for bit."""
    state = _tiny_state()
    stream = _frames(7, seed=3, hw=32)
    n = features.extract_features(iter(stream), str(tmp_path / "f"),
                                  batch_size=4, params=state, device="cpu")
    assert n == 7
    store = ImageBigFile(str(tmp_path / "f"))
    assert store.shape() == [7, 256]
    assert store.names == [name for name, _ in stream]
    extract = resnet.make_extractor(state, 4, device="cpu")
    imgs = np.stack([im for _, im in stream])
    want = torch.cat([extract(imgs[:4]), extract(np.concatenate(
        [imgs[4:], np.zeros((1, 32, 32, 3), np.uint8)]))[:3]])
    np.testing.assert_array_equal(store.read_rows(range(7)), want.numpy())


@pytest.mark.parametrize("feat_dim", [3, 0])
def test_txt2bin_writes_the_jax_bytes(tmp_path, feat_dim):
    txt = tmp_path / "f.txt"
    txt.write_text("name one 1.0 2.0 3.0\nother 4.0 5.0 6.0\n"
                   "bad nan 1.0 2.0\nother 7.0 8.0 9.0\n\n"
                   "last 1e-3 -2.5 3\n")
    lst = tmp_path / "list.txt"
    lst.write_text("# a file list\n%s\n" % txt)
    for pkg, mod in (("port", txt2bin), ("jax", jtxt2bin)):
        mod.process(feat_dim, [str(txt)], str(tmp_path / pkg), overwrite=1)
        mod.main([str(feat_dim), str(lst), "1", str(tmp_path / (pkg + "_l"))])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert _files(tmp_path / "port_l") == _files(tmp_path / "jax_l")
    assert _files(tmp_path / "port") == _files(tmp_path / "port_l")


def _frame_store(path, names, seed=0, dim=4):
    rng = np.random.RandomState(seed)
    with BigFileWriter(str(path)) as w:
        for name in names:
            w.write(name, rng.rand(dim).astype(np.float32))


def test_frameinfo_writes_the_jax_video2frames(tmp_path):
    names = ["video2_10_cls1", "video1_5_cls0", "video2_0_cls1",
             "video1_0_cls0", "video3_15_cls2", "video1_10_cls0"]
    for pkg in ("port", "jax"):
        _frame_store(tmp_path / pkg, names)
    got = frameinfo.get_frame_info(str(tmp_path / "port"))
    want = jframeinfo.get_frame_info(str(tmp_path / "jax"))
    assert got == want
    assert got["video1"] == ["video1_0_cls0", "video1_5_cls0",
                             "video1_10_cls0"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    # a second call keeps the file; the CLI overwrites it
    assert frameinfo.get_frame_info(str(tmp_path / "port")) == {}
    frameinfo.main(["--feature_dir", str(tmp_path / "port"),
                    "--overwrite", "1"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def _corrupt(path, kind):
    names = ["video1_0_cls0", "video1_5_cls0", "video2_0_cls1"]
    _frame_store(path, names)
    if kind == "truncated":
        with open(path / "feature.bin", "r+b") as f:
            f.truncate(20)
    elif kind == "trailing":
        with open(path / "feature.bin", "ab") as f:
            f.write(b"\0" * 8)
    elif kind == "nan":
        with open(path / "feature.bin", "r+b") as f:
            f.seek(16 + 4)
            f.write(np.float32(np.nan).tobytes())
    elif kind == "duplicate":
        (path / "id.txt").write_text("video1_0_cls0#video1_0_cls0#x")
    elif kind == "frames":
        (path / "video2frames.txt").write_text(
            "{'video1': ['video1_0_cls0', 'video1_9_cls0']}")
    elif kind == "unreadable":
        (path / "shape.txt").write_text("three 4")


@pytest.mark.parametrize("kind", ["ok", "truncated", "trailing", "nan",
                                  "duplicate", "frames", "unreadable"])
def test_format_check_gives_the_jax_report(tmp_path, kind, capsys):
    for pkg in ("port", "jax"):
        _corrupt(tmp_path / pkg, kind)
    got = format_check.check_feature_dir(str(tmp_path / "port"))
    want = jformat_check.check_feature_dir(str(tmp_path / "jax"))
    assert got == want
    assert bool(got) == (kind != "ok")
    rc = format_check.main([str(tmp_path / "port")])
    assert rc == jformat_check.main([str(tmp_path / "jax")]) == int(bool(got))
    out = capsys.readouterr().out
    assert ("[FAIL]" in out) == (kind != "ok")


# ---------------------------------------------------------------- text


def _vocab_content(path):
    v = vocab.load_vocab(path)
    return v.word2idx, v.idx2word, v.idx, v.text_style


@pytest.mark.parametrize("style", ["bow", "rnn"])
def test_vocab_cli_builds_the_jax_vocabulary(tmp_path, style):
    lines = ["video%d#enc#0 %s" % (i, t) for i, t in enumerate(
        ["a fast car at night", "the red car", "a car a car", "road trip",
         "night road and the car"])]
    for pkg in ("port", "jax"):
        td = tmp_path / pkg / "coll" / "TextData"
        td.mkdir(parents=True)
        (td / "coll.caption.txt").write_text("\n".join(lines) + "\n")
    got = vocab_cli.build(str(tmp_path / "port"), "coll", 2, style)
    want = jvocab_cli.build(str(tmp_path / "jax"), "coll", 2, style)
    assert _vocab_content(got) == _vocab_content(want)
    # each package reads the other's pickle
    theirs = jvocab.load_vocab(got)
    assert (theirs.word2idx, theirs.idx2word) == _vocab_content(want)[:2]
    counter = os.path.join(os.path.dirname(got), "word_vocab_counter_2.txt")
    with open(counter) as f, open(os.path.join(
            os.path.dirname(want), "word_vocab_counter_2.txt")) as g:
        assert f.read() == g.read()
    assert vocab.captions_from_txt(
        str(tmp_path / "port" / "coll" / "TextData" / "coll.caption.txt")) \
        == jvocab.captions_from_txt(
            str(tmp_path / "jax" / "coll" / "TextData" / "coll.caption.txt"))
    assert vocab.get_text_encoder("bow") is vocab.Bow2Vec
    with pytest.raises(ValueError, match="unknown text encoder"):
        vocab.get_text_encoder("w2v")


def test_caption_splits_shuffle_as_the_jax_package():
    """random.seed(brand index) + random.shuffle: the same ids per split."""
    per_brand = [list(range(1, 44)), list(range(100, 161)), [7, 8]]
    assert captions._split_ids(per_brand) == jcaptions._split_ids(per_brand)


def test_progress_reports_rate_and_values():
    import io
    buf = io.StringIO()
    p = Progress(4, label="encode", interval=1e9, stream=buf)
    p.add(1, [("loss", 1.0)])     # the first report
    p.add(1, [("loss", 1.0)])     # within the interval, not done: silent
    p.add(2, [("loss", 4.0)])     # done
    lines = buf.getvalue().splitlines()
    assert len(lines) == 2 and lines[0].startswith("encode 1/4")
    assert lines[1].startswith("encode 4/4")
    # the reference meter divides by count + 1e-4
    assert "loss 4.0000 (2.4999)" in lines[1]


# ---------------------------------------------------------------- decode


def test_frame_sampling_rate_matches_jax(scrape_tree):
    from fancyrec_tpu.preprocess import videos as jvideos
    path = os.path.join(scrape_tree, "audi", "audi_vid0.mp4")
    got = list(videos.iter_video_frames(path))
    want = list(jvideos.iter_video_frames(path))
    # 20 frames at 10 fps, interval 5: samples at counts 0, 5, 10, ...
    assert [c for c, _ in got] == [c for c, _ in want]
    assert all(c % 5 == 0 for c, _ in got) and len(got) >= 3
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,workers", [("thread", 3), ("process", 3),
                                             ("process", 1)])
def test_parallel_decode_matches_serial(scrape_tree, backend, workers):
    """The same names and pixels in the same order as the serial decode,
    for both pool kinds (spawned processes import the port's task)."""
    brands = sorted(os.listdir(scrape_tree))
    serial = list(videos.iter_sampled_frames(scrape_tree, brands))
    par = list(videos.iter_sampled_frames_parallel(
        scrape_tree, brands, workers=workers, backend=backend))
    assert [n for n, _ in serial] == [n for n, _ in par]
    for (_, a), (_, b) in zip(serial, par):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="backend"):
        list(videos.iter_sampled_frames_parallel(scrape_tree, brands,
                                                 workers=2, backend="gpu"))


# ---------------------------------------------------------------- pipeline


def _vocab_files(root):
    return sorted(p for p in _files(root) if p.endswith(".pkl"))


def test_pipeline_gives_the_jax_collection_tree(scrape_tree, tmp_path):
    """pipeline.run through both packages with the same extractor: every
    file the same bytes, the vocabulary pickles the same content; then
    the port's trainer runs one epoch on the port's tree."""
    kw = dict(dataset_name="mini", feat_dim_name="resnet152_dim_32",
              img_feat_name="imgfeat_dim_32", batch_size=8,
              vocab_threshold=1, extract_fn=_fake_extractor)
    out = pipeline.run(scrape_tree, str(tmp_path / "port"), **kw)
    want = jpipeline.run(scrape_tree, str(tmp_path / "jax"), **kw)
    assert {k: os.path.relpath(v, str(tmp_path / "port"))
            for k, v in out.items()} == \
        {k: os.path.relpath(v, str(tmp_path / "jax"))
         for k, v in want.items()}
    got_files, want_files = _files(out["out_dir"]), _files(want["out_dir"])
    assert got_files.keys() == want_files.keys()
    pickles = _vocab_files(out["out_dir"])
    assert len(pickles) == 2     # bow and rnn, over the train collection
    for p in got_files:
        if p in pickles:
            assert _vocab_content(os.path.join(out["out_dir"], p)) == \
                _vocab_content(os.path.join(want["out_dir"], p)), p
        else:
            assert got_files[p] == want_files[p], p
    assert "minitrain/FeatureData/resnet152_dim_32/video2frames.txt" \
        in got_files
    # resumable: a second run skips the extraction and rewrites the same
    pipeline.run(scrape_tree, str(tmp_path / "port"),
                 **dict(kw, extract_fn=None), device="cpu")
    assert _files(out["out_dir"]) == got_files

    root = out["out_dir"]
    from fancyrec_tpu_torch.data.tokenizer import write_minimal_bert_vocab
    from fancyrec_tpu_torch.train import trainer
    write_minimal_bert_vocab(os.path.join(root, "bert_vocab.txt"),
                             ["car", "fast", "audi", "bmw", "red", "road"])
    best = trainer.main([
        "minitrain", "minival", "minitest", "--rootpath", root,
        "--brand_num", "2", "--brand_aspect", "8",
        "--video_feature", "resnet152_dim_32",
        "--img_feature", "imgfeat_dim_32",
        "--common_embedding_size", "16", "--visual_rnn_size", "8",
        "--text_rnn_size", "8", "--visual_kernel_num", "4",
        "--text_kernel_num", "4", "--text_mapping_size", "16",
        "--visual_mapping_size", "16", "--word_dim", "8",
        "--text_net", "bi-gru", "--fusion_style", "fc", "--loss_fun", "cl",
        "--cost_style", "mean", "--batch_size", "2",
        "--accumulation_step", "2", "--num_epochs", "1",
        "--overwrite", "1", "--postfix", "pp_run", "--vocab", "word_vocab_1",
        "--max_frames", "6", "--max_words", "16", "--device", "cpu",
    ])
    assert np.isfinite(best)


def test_pipeline_cli_on_the_cpu_runs_the_resnet(scrape_tree, tmp_path,
                                                 monkeypatch, capsys):
    """`python -m fancyrec_tpu_torch.preprocess.pipeline SRC DST --device
    cpu`: the port's own extractor (a one-block tree here) writes both
    feature stores, and they pass the format check."""
    monkeypatch.setattr(resnet, "init_random_params", _tiny_state)
    pipeline.main([scrape_tree, str(tmp_path), "--dataset_name", "cli",
                   "--batch_size", "16", "--vocab_threshold", "1",
                   "--device", "cpu"])
    text = capsys.readouterr().out
    out = json.loads(text[text.rindex("\n{\n") + 1:])
    assert out["train"] == "clitrain"
    for sub in ("video_features", "img_features"):
        d = tmp_path / "cli" / sub
        assert format_check.check_feature_dir(str(d)) == []
        assert ImageBigFile(str(d)).ndims == 256
    v2f = read_dict(str(tmp_path / "cli" / "video_features"
                        / "video2frames.txt"))
    assert sorted(v2f) == ["video1", "video2", "video3", "video4"]
