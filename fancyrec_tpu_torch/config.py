"""Typed configuration, field for field the JAX package's `Config`.

The same dataclass and the same JSON form as `fancyrec_tpu.config`, so a
config written by either package loads in the other. `mesh_shape` lays
the ranks of a world out as the (data, model) mesh (`parallel/mesh.py`);
`seq_shard` and `pp_stages` shard the time axes and pipeline BERT over
its model axis. The port adds one field the JAX package lacks:
`text_tower`, the published config.json keys of a DeepSeek-V2 caption
tower (`--text_net deepseek_v2`, `models/deepseek_v2.py`; keys left out
take DeepSeek-V2-Lite's values). The fields that only steer JAX (the XLA
compile cache, the dropout PRNG) are kept for that interchange, and the
training CLI refuses them at any value but their default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List

from fancyrec_tpu_torch.parallel.mesh import parse_mesh_shape

ROOT_PATH = os.environ.get("FANCYREC_ROOT_PATH", os.path.expanduser("~/insCar"))


@dataclass
class Config:
    # collections
    rootpath: str = ROOT_PATH
    trainCollection: str = ""
    valCollection: str = ""
    testCollection: str = ""
    n_caption: int = 1
    overwrite: int = 0

    # model
    model: str = "FancyRec"
    measure: str = "cosine"
    dropout: float = 0.2

    # encoder ablations
    concate: str = "full"          # full|reduced
    level_vis: str = "1+2+3"
    level_txt: str = "1+2+3"

    # brand tower
    brand_num: int = 52
    brand_aspect: int = 2000

    # text encoding
    vocab: str = "word_vocab_5"
    word_dim: int = 500
    text_rnn_size: int = 512
    text_kernel_num: int = 512
    text_kernel_sizes: str = "2-3-4"
    text_norm: bool = False
    text_transformers_hidden_size: int = 768
    text_net: str = "transformers"  # bi-gru|transformers|deepseek_v2
    # deepseek_v2: its config.json keys (port only; see the module doc)
    text_tower: dict = field(default_factory=dict)
    # BERT architecture knobs (bert-base-uncased defaults; the reference
    # hardcodes BertConfig(num_hidden_layers=3, num_attention_heads=12)
    # over bert-base, model.py:317)
    bert_vocab_size: int = 30522
    bert_num_layers: int = 3
    bert_num_heads: int = 12
    bert_intermediate_size: int = 3072
    bert_max_position: int = 512
    bert_type_vocab: int = 2
    bert_remat: bool = False        # rematerialize BERT layers (saves HBM)
    bert_dropout: float = 0.1       # BERT hidden+attention dropout prob (HF
                                    # bert-base default 0.1, which the
                                    # reference inherits via BertConfig,
                                    # model.py:317; exposed so deterministic
                                    # parity runs can zero it)

    # visual encoding
    video_feature: str = "resnet-152-img1k-flatten0_outputos"
    img_feature: str = "imgfeat_dim_2048"
    visual_rnn_size: int = 1024
    visual_kernel_num: int = 512
    visual_kernel_sizes: str = "2-3-4-5"
    visual_norm: bool = False

    # common space
    text_mapping_size: int = 512
    visual_mapping_size: int = 2048
    common_embedding_size: int = 2048
    single_modal_visual: bool = False
    single_modal_text: bool = False
    fusion_style: str = "fc"       # fc|ph|attn
    prj_head_output: bool = False

    # loss
    loss_fun: str = "mrl"          # mrl|CrossCLR|cl|lab
    margin: float = 0.2
    direction: str = "all"         # b2p|p2b|all
    max_violation: bool = False
    cost_style: str = "sum"        # sum|mean
    no_queue: bool = False
    queue_size: int = 5000
    no_intra: bool = False

    # optimizer
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    lr_decay_rate: float = 0.99
    grad_clip: float = 2.0
    resume: str = ""
    metric: str = "recall"

    # misc
    num_epochs: int = 100
    batch_size: int = 128
    accumulation_step: int = 8
    workers: int = 0
    postfix: str = "runs_0"
    log_step: int = 10
    cv_name: str = "FancyRec"

    # TPU-native additions (absent from the reference; defaults keep parity)
    seed: int = 2
    dtype: str = "float32"          # compute dtype for the towers: float32|bfloat16
    rng_impl: str = "threefry"      # dropout PRNG: threefry (parity default) |
                                    # rbg (TPU hardware-backed generator --
                                    # measured ~5 ms/step of threefry mask
                                    # generation at recipe b64; different but
                                    # equally distributed streams)
    transfer_dtype: str = ""        # host->device staging dtype for float batch
                                    # arrays ("bfloat16" halves wire traffic on
                                    # transfer-bound hosts; "" = ship float32)
    mesh_shape: str = ""            # e.g. "4,2" -> (data=4, model=2); "" = all-data
    max_frames: int = 64            # static frame-axis pad (== reference VIDEO_MAX_LEN)
    max_tokens: int = 128           # static token-axis pad for BERT path
    max_words: int = 64             # static token-axis pad for bi-gru path
    bert_vocab: str = ""            # WordPiece vocab.txt path (offline tokenizer)
    w2v_feature: str = ""           # word2vec WordBigFile dir for embed init (bi-gru path)
    bert_weights: str = ""          # optional HF/torch BERT weight file to load
    validate_split: str = "test"    # reference validates on the *test* loader (trainer.py:283-288)
    auto_resume: bool = False       # resume from the latest epoch checkpoint after a crash
    keep_checkpoints: int = 0       # keep only the newest N epoch checkpoints
                                    # (0 = keep all, the reference's behavior;
                                    # model_best.pth.tar is never pruned)
    seq_shard: bool = False         # sequence-parallel time-axis sharding over 'model'
    pp_stages: int = 0              # pipeline-parallel the BERT layer stack over
                                    # this many 'model'-axis stages (GPipe,
                                    # parallel/pipeline.py); 0/1 = off. Requires
                                    # text_net=transformers and bert_num_layers %
                                    # pp_stages == 0; pays off on deep text towers
                                    # that exceed one chip, not the 3-layer recipe
    profile_dir: str = ""           # capture an XLA profiler trace of epoch 1 into this dir
    token_buckets: str = ""         # e.g. "32,64,96" -- pad the token axis to the
                                    # smallest listed bucket covering the batch max
                                    # instead of the static max (one compiled program
                                    # per bucket; numerically exact -- every reduction
                                    # is bounded by the dynamic batch-max length)
    frame_buckets: str = ""         # same for the frame axis (insCar is ~90% 1-frame
                                    # image posts padded to 64 frames without this)
    compilation_cache_dir: str = "" # persistent XLA compile cache: executables
                                    # survive process restarts (first jit over
                                    # a TPU link is 20-40 s per program, and
                                    # buckets multiply the program count)
    length_grouped: bool = False    # compose TRAIN batches from length-sorted windows
                                    # so buckets actually bite (changes batch
                                    # composition -- opt-in; eval batches are length
                                    # -sorted automatically whenever buckets are on,
                                    # which is composition-free: embeddings are
                                    # scattered back by dataset index)

    # -- derived at setup (reference trainer.py:154-234) --
    text_kernel_sizes_list: List[int] = field(default_factory=list)
    visual_kernel_sizes_list: List[int] = field(default_factory=list)
    token_buckets_list: List[int] = field(default_factory=list)
    frame_buckets_list: List[int] = field(default_factory=list)
    text_mapping_in: int = 0
    visual_mapping_in: int = 0
    visual_feat_dim: int = 2048
    bow_vocab_size: int = 0
    vocab_size: int = 0
    logger_name: str = ""

    # ------------------------------------------------------------------
    def finalize(self) -> "Config":
        """Compute derived sizes. Mirrors trainer.py:154-155,182-234."""
        if self.dtype not in ("", "float32", "bfloat16"):
            raise ValueError("--dtype must be float32 or bfloat16, got %r"
                             % self.dtype)
        if self.transfer_dtype not in ("", "bfloat16"):
            # fail at parse time, not minutes later in the prefetch
            # thread; only bfloat16 has a matching on-device upcast
            # (train/step.micro_loss)
            raise ValueError(
                "--transfer_dtype must be '' or 'bfloat16', got %r"
                % self.transfer_dtype)
        if self.rng_impl not in ("threefry", "rbg"):
            raise ValueError(
                "--rng_impl must be 'threefry' or 'rbg', got %r"
                % self.rng_impl)

        def _buckets(spec: str, cap: int, flag: str) -> List[int]:
            if not spec:
                return []
            try:
                bs = sorted({int(x) for x in str(spec).split(",")})
            except ValueError:
                raise ValueError("%s must be a comma list of ints, got %r"
                                 % (flag, spec))
            if bs[0] < 1 or bs[-1] > cap:
                raise ValueError("%s buckets must lie in [1, %d], got %r"
                                 % (flag, cap, spec))
            if bs[-1] != cap:
                bs.append(cap)   # always cover the static max
            return bs
        if self.text_net == "deepseek_v2":
            self._refuse_for_deepseek()
        tok_cap = (self.max_tokens if uses_wordpiece(self.text_net)
                   else self.max_words)
        self.token_buckets_list = _buckets(
            self.token_buckets, tok_cap, "--token_buckets")
        self.frame_buckets_list = _buckets(
            self.frame_buckets, self.max_frames, "--frame_buckets")
        if self.pp_stages and self.pp_stages > 1:
            if self.text_net != "transformers" or self.single_modal_visual:
                raise ValueError(
                    "--pp_stages pipelines the BERT layer stack: it needs "
                    "--text_net transformers with the text tower enabled "
                    "(got text_net=%r, single_modal_visual=%s)"
                    % (self.text_net, self.single_modal_visual))
            if self.bert_num_layers % self.pp_stages:
                raise ValueError(
                    "--bert_num_layers %d is not divisible by --pp_stages "
                    "%d: each pipeline stage must own an equal block of "
                    "consecutive layers"
                    % (self.bert_num_layers, self.pp_stages))
            if self.batch_size % self.pp_stages:
                raise ValueError(
                    "--batch_size %d is not divisible into %d pipeline "
                    "microbatches (--pp_stages)"
                    % (self.batch_size, self.pp_stages))
            if self.mesh_shape:
                dims = [int(x) for x in str(self.mesh_shape).split(",")]
                model_axis = dims[1] if len(dims) > 1 else 1
                if model_axis != self.pp_stages:
                    raise ValueError(
                        "--pp_stages %d must equal the model mesh axis "
                        "(--mesh_shape %s has model=%d): the pipeline "
                        "stages ARE the 'model' axis devices"
                        % (self.pp_stages, self.mesh_shape, model_axis))
                data_axis = dims[0]
                if (self.batch_size // self.pp_stages) % data_axis:
                    raise ValueError(
                        "pipeline microbatch %d (= batch %d / %d stages) "
                        "is not divisible by the data mesh axis %d"
                        % (self.batch_size // self.pp_stages,
                           self.batch_size, self.pp_stages, data_axis))
        if self.mesh_shape:
            # a batch that does not divide the data mesh axis cannot be
            # split into equal slices, one a rank (the JAX package would
            # replicate it on every device). Fail at config time.
            data_axis = int(str(self.mesh_shape).split(",")[0])
            if data_axis > 1 and self.batch_size % data_axis != 0:
                raise ValueError(
                    "--batch_size %d is not divisible by the data mesh "
                    "axis %d (--mesh_shape %s): the batch would be "
                    "replicated on every device instead of sharded. Pick "
                    "a batch_size that is a multiple of the data axis."
                    % (self.batch_size, data_axis, self.mesh_shape))
        self.text_kernel_sizes_list = [int(x) for x in str(self.text_kernel_sizes).split("-")]
        self.visual_kernel_sizes_list = [int(x) for x in str(self.visual_kernel_sizes).split("-")]
        tks = self.text_kernel_num * len(self.text_kernel_sizes_list)
        vks = self.visual_kernel_num * len(self.visual_kernel_sizes_list)
        tf_hidden = (self.tower_config().hidden_size
                     if self.text_net == "deepseek_v2"
                     else self.text_transformers_hidden_size)

        if self.concate == "full":
            if self.text_net == "bi-gru":
                self.text_mapping_in = self.bow_vocab_size + self.text_rnn_size * 2 + tks
            elif uses_wordpiece(self.text_net):
                self.text_mapping_in = self.bow_vocab_size + tf_hidden + tks
            self.visual_mapping_in = (
                self.visual_feat_dim * 2 + self.visual_rnn_size * 2 + vks)
        elif self.concate == "reduced":
            if self.text_net == "bi-gru":
                self.text_mapping_in = 1024
            elif uses_wordpiece(self.text_net):
                widths = {
                    "1+2": self.bow_vocab_size + tf_hidden,
                    "1+3": self.bow_vocab_size + tks,
                    "2+3": tf_hidden + tks,
                    "1": self.bow_vocab_size,
                    "2": tf_hidden,
                    "3": tks,
                }
                self.text_mapping_in = widths.get(
                    self.level_txt, self.bow_vocab_size + tf_hidden + tks)
            vwidths = {
                "1+2": self.visual_feat_dim * 2 + self.visual_rnn_size * 2,
                "1+3": self.visual_feat_dim * 2 + vks,
                "2+3": self.visual_rnn_size * 2 + vks,
                "1": self.visual_feat_dim * 2,
                "2": self.visual_rnn_size * 2,
                "3": vks,
            }
            self.visual_mapping_in = vwidths.get(
                self.level_vis,
                self.visual_feat_dim * 2 + self.visual_rnn_size * 2 + vks)
        else:
            raise NotImplementedError("Unknown concate method: %s" % self.concate)
        return self

    def tower_config(self):
        """The DeepSeek-V2 tower's `models.deepseek_v2.DeepseekV2Config`:
        `text_tower` over DeepSeek-V2-Lite's published values."""
        from fancyrec_tpu_torch.models.deepseek_v2 import DeepseekV2Config
        return DeepseekV2Config.from_dict(self.text_tower)

    def _refuse_for_deepseek(self) -> None:
        """What the deepseek_v2 tower does not run yet: K5 computes in
        float32 only, and the tower is neither pipelined, sequence-sharded
        nor split over a model axis."""
        self.tower_config()
        refused = []
        if self.pp_stages and self.pp_stages > 1:
            refused.append("--pp_stages %d" % self.pp_stages)
        if self.seq_shard:
            refused.append("--seq_shard")
        if (parse_mesh_shape(self.mesh_shape) or (1, 1))[1] > 1:
            refused.append("--mesh_shape %s (a model axis)" % self.mesh_shape)
        if self.dtype not in ("", "float32"):
            refused.append("--dtype %s" % self.dtype)
        if self.bert_remat:
            refused.append("--bert_remat")
        if refused:
            raise NotImplementedError(
                "--text_net deepseek_v2 does not support %s"
                % ", ".join(refused))

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        """The JSON form; without a DeepSeek-V2 tower, the JAX package's
        form exactly (no `text_tower` key)."""
        data = dataclasses.asdict(self)
        if not data["text_tower"]:
            del data["text_tower"]
        return json.dumps(data, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())


def build_train_parser() -> argparse.ArgumentParser:
    """The JAX package's training flags (the reference's names), plus
    --device."""
    p = argparse.ArgumentParser()
    d = Config()
    p.add_argument("--rootpath", type=str, default=d.rootpath)
    p.add_argument("trainCollection", type=str)
    p.add_argument("valCollection", type=str)
    p.add_argument("testCollection", type=str)
    p.add_argument("--n_caption", type=int, default=d.n_caption)
    p.add_argument("--overwrite", type=int, default=0, choices=[0, 1])
    p.add_argument("--model", type=str, default=d.model)
    p.add_argument("--measure", type=str, default=d.measure)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--concate", type=str, default=d.concate)
    p.add_argument("--level_vis", type=str, default=d.level_vis)
    p.add_argument("--level_txt", type=str, default=d.level_txt)
    p.add_argument("--brand_num", type=int, default=d.brand_num)
    p.add_argument("--brand_aspect", type=int, default=d.brand_aspect)
    p.add_argument("--vocab", type=str, default=d.vocab)
    p.add_argument("--word_dim", type=int, default=d.word_dim)
    p.add_argument("--text_rnn_size", type=int, default=d.text_rnn_size)
    p.add_argument("--text_kernel_num", type=int, default=d.text_kernel_num)
    p.add_argument("--text_kernel_sizes", type=str, default=d.text_kernel_sizes)
    p.add_argument("--text_norm", action="store_true")
    p.add_argument("--text_transformers_hidden_size", type=int,
                   default=d.text_transformers_hidden_size)
    p.add_argument("--text_net", type=str, default=d.text_net)
    p.add_argument("--text_tower", type=str, default="",
                   help="deepseek_v2: a config.json (path or JSON text) "
                        "over DeepSeek-V2-Lite's")
    p.add_argument("--video_feature", type=str, default=d.video_feature)
    p.add_argument("--img_feature", type=str, default=d.img_feature)
    p.add_argument("--visual_rnn_size", type=int, default=d.visual_rnn_size)
    p.add_argument("--visual_kernel_num", type=int, default=d.visual_kernel_num)
    p.add_argument("--visual_kernel_sizes", type=str,
                   default=d.visual_kernel_sizes)
    p.add_argument("--visual_norm", action="store_true")
    p.add_argument("--text_mapping_size", type=int, default=d.text_mapping_size)
    p.add_argument("--visual_mapping_size", type=int,
                   default=d.visual_mapping_size)
    p.add_argument("--common_embedding_size", type=int,
                   default=d.common_embedding_size)
    p.add_argument("--single_modal_visual", action="store_true")
    p.add_argument("--single_modal_text", action="store_true")
    p.add_argument("--fusion_style", type=str, default=d.fusion_style)
    p.add_argument("--prj_head_output", action="store_true")
    p.add_argument("--loss_fun", type=str, default=d.loss_fun)
    p.add_argument("--margin", type=float, default=d.margin)
    p.add_argument("--direction", type=str, default=d.direction)
    p.add_argument("--max_violation", action="store_true")
    p.add_argument("--cost_style", type=str, default=d.cost_style)
    p.add_argument("--no_queue", action="store_true")
    p.add_argument("--queue_size", type=int, default=d.queue_size)
    p.add_argument("--no_intra", action="store_true")
    p.add_argument("--optimizer", type=str, default=d.optimizer)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--lr_decay_rate", type=float, default=d.lr_decay_rate)
    p.add_argument("--grad_clip", type=float, default=d.grad_clip)
    p.add_argument("--resume", type=str, default="", metavar="PATH")
    p.add_argument("--metric", type=str, default=d.metric)
    p.add_argument("--num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--accumulation_step", type=int,
                   default=d.accumulation_step)
    p.add_argument("--workers", type=int, default=d.workers)
    p.add_argument("--postfix", type=str, default=d.postfix)
    p.add_argument("--log_step", type=int, default=d.log_step)
    p.add_argument("--cv_name", type=str, default=d.cv_name)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--dtype", type=str, default=d.dtype)
    p.add_argument("--rng_impl", type=str, default=d.rng_impl,
                   choices=["threefry", "rbg"])
    p.add_argument("--bert_remat", type=int, default=int(d.bert_remat),
                   choices=[0, 1])
    p.add_argument("--token_buckets", type=str, default=d.token_buckets)
    p.add_argument("--frame_buckets", type=str, default=d.frame_buckets)
    p.add_argument("--length_grouped", type=int, default=int(d.length_grouped))
    p.add_argument("--compilation_cache_dir", type=str,
                   default=d.compilation_cache_dir)
    p.add_argument("--transfer_dtype", type=str, default=d.transfer_dtype)
    p.add_argument("--mesh_shape", type=str, default=d.mesh_shape)
    p.add_argument("--max_frames", type=int, default=d.max_frames)
    p.add_argument("--max_tokens", type=int, default=d.max_tokens)
    p.add_argument("--max_words", type=int, default=d.max_words)
    p.add_argument("--bert_vocab", type=str, default=d.bert_vocab)
    p.add_argument("--w2v_feature", type=str, default=d.w2v_feature)
    p.add_argument("--bert_weights", type=str, default=d.bert_weights)
    p.add_argument("--validate_split", type=str, default=d.validate_split)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--keep_checkpoints", type=int, default=d.keep_checkpoints)
    p.add_argument("--seq_shard", action="store_true")
    p.add_argument("--pp_stages", type=int, default=d.pp_stages)
    p.add_argument("--bert_num_layers", type=int, default=d.bert_num_layers)
    p.add_argument("--bert_dropout", type=float, default=d.bert_dropout)
    p.add_argument("--profile_dir", type=str, default=d.profile_dir)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


# flags the port does not implement, with the value that means "off" and
# why: the JAX package's dropout PRNG choice and its XLA compile cache
_NOT_PORTED = {
    "rng_impl": ("threefry", "--rng_impl picks a JAX PRNG; the port draws "
                 "dropout from torch generators"),
    "compilation_cache_dir": ("", "--compilation_cache_dir is XLA's compile "
                              "cache; the port runs eager"),
}


def config_from_args(args: argparse.Namespace) -> Config:
    """The parsed flags -> Config. Raises NotImplementedError for a flag the
    port does not implement, set to anything but off, and ValueError for a
    malformed --mesh_shape. `Config.finalize` validates --pp_stages against
    the rest, with the JAX package's messages."""
    vals = vars(args)
    for flag, (off, why) in _NOT_PORTED.items():
        if vals.get(flag, off) != off:
            raise NotImplementedError(
                "--%s is not implemented by the PyTorch port (got %r): %s"
                % (flag, vals[flag], why))
    parse_mesh_shape(vals.get("mesh_shape", ""))
    vals["text_tower"] = load_tower(vals.get("text_tower", ""))
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vals.items() if k in known})


def load_tower(spec: str) -> dict:
    """--text_tower: JSON text or the path of a JSON file; "" is {}
    (DeepSeek-V2-Lite as published)."""
    if not spec:
        return {}
    if spec.lstrip().startswith("{"):
        return json.loads(spec)
    with open(spec) as f:
        return json.load(f)


def uses_wordpiece(text_net: str) -> bool:
    """Does the text tower read WordPiece ids (BERT's token path)?"""
    return text_net in ("transformers", "deepseek_v2")
