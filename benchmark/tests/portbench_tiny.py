"""Small shapes of every cell, for runs on the CPU, and a helper that runs
a cell there and returns its result and its printed lines."""

import io
import time

import run

MODEL = {"brand_num": 5, "brand_aspect": 32, "common_embedding_size": 16,
         "text_mapping_size": 16, "visual_mapping_size": 16,
         "visual_rnn_size": 16, "visual_kernel_num": 8, "text_kernel_num": 8,
         "text_transformers_hidden_size": 32, "bert_vocab_size": 405,
         "bert_num_layers": 2, "bert_num_heads": 4,
         "bert_intermediate_size": 64, "bert_max_position": 64,
         "word_dim": 12, "text_rnn_size": 10, "batch_size": 4,
         "accumulation_step": 2, "queue_size": 40}
DATA = {"feat_dim": 24, "max_frames": 8, "max_tokens": 16, "max_words": 12,
        "bow_vocab_size": 50, "rnn_vocab_size": 54}
SHAPES = {
    "bert3.train": {"config": {"model": MODEL, "data": DATA},
                    "traffic": {"posts": 48, "video_frames": [2, 8],
                                "caption_length": [4, 16]}},
    "bigru.train": {"config": {"model": MODEL, "data": DATA},
                    "traffic": {"posts": 48, "video_frames": [2, 8],
                                "caption_length": [3, 12]}},
    "bert3.extract": {"config": {"model": {"brand_num": 5},
                                 "extractor": {"blocks": [1, 1, 1, 1],
                                               "image_size": 32,
                                               "batch_size": 4}},
                      "traffic": {"pool_frames": 8, "check_frames": 4,
                                  "frames_per_video": 4}},
}


class Args:
    def __init__(self, workload, seed, seconds=1.0, trace=0):
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace


def run_cpu(workload: str, seed: int, tmp_path, monkeypatch, trace=0):
    """-> (result, the lines printed to standard output)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = io.StringIO()
    result = run.run(Args(workload, seed, trace=trace), require_chip=False,
                     overrides=SHAPES[workload], out=out,
                     t_start=time.time())
    return result, out.getvalue().splitlines()
