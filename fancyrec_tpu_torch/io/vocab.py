"""Vocabulary building + bag-of-words featurization.

Semantics mirror the reference (preprocess/vocab.py:16-125,
preprocess/text2vec.py:10-121): clean_str tokenization, frequency
thresholding, special tokens for the 'rnn' style, term-frequency BoW
vectors with optional L1/L2 norm. Pickles written by the reference
(module path preprocess.vocab) or by the JAX package (fancyrec_tpu.io.vocab)
load transparently via load_vocab(): the unpickler maps by class name.
"""

from __future__ import annotations

import os
import pickle
import re
from collections import Counter
from typing import Iterable, List, Optional

import numpy as np

_CLEAN_RE = re.compile(r"[^A-Za-z0-9]")


def clean_str(string: str) -> List[str]:
    """Strip non-alphanumerics, lowercase, whitespace-split (ref preprocess/vocab.py:49-51)."""
    return _CLEAN_RE.sub(" ", string).strip().lower().split()


class Vocabulary:
    """word <-> index map. 'rnn' style raises OOV to <unk>; 'bow' style KeyErrors."""

    def __init__(self, text_style: str = "bow"):
        self.word2idx = {}
        self.idx2word = {}
        self.idx = 0
        self.text_style = text_style

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        if word not in self.word2idx and "bow" not in self.text_style:
            return self.word2idx["<unk>"]
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.word2idx)


class _VocabUnpickler(pickle.Unpickler):
    """Map any '<pkg>.vocab.Vocabulary' class path onto our Vocabulary."""

    def find_class(self, module, name):
        if name == "Vocabulary":
            return Vocabulary
        return super().find_class(module, name)


def load_vocab(path: str) -> Vocabulary:
    with open(path, "rb") as f:
        vocab = _VocabUnpickler(f).load()
    if not isinstance(vocab, Vocabulary):
        raise TypeError("%s did not contain a Vocabulary" % path)
    return vocab


def save_vocab(vocab: Vocabulary, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(vocab, f, pickle.HIGHEST_PROTOCOL)


def captions_from_txt(cap_file: str) -> List[str]:
    """Read 'capid caption...' lines -> list of caption strings."""
    captions = []
    with open(cap_file, "r") as reader:
        for line in reader:
            _, caption = line.split(" ", 1)
            captions.append(caption.strip())
    return captions


def build_vocab(captions: Iterable[str], text_style: str, threshold: int = 5):
    """Count clean_str tokens, keep those with freq >= threshold.

    Returns (Vocabulary, Counter). Word order follows first-appearance order
    of surviving words, with <pad>/<start>/<end>/<unk> prepended for 'rnn'
    (ref preprocess/vocab.py:63-97).
    """
    counter: Counter = Counter()
    for caption in captions:
        counter.update(clean_str(caption.lower()))
    words = [w for w, c in counter.items() if c >= threshold]
    vocab = Vocabulary(text_style)
    if "rnn" in text_style:
        for tok in ("<pad>", "<start>", "<end>", "<unk>"):
            vocab.add_word(tok)
    for w in words:
        vocab.add_word(w)
    return vocab, counter


class Bow2Vec:
    """Caption -> term-frequency vector over the bow vocabulary.

    mapping() returns None when no known word appears (the data pipeline
    substitutes a zero vector), matching preprocess/text2vec.py:46-79.
    """

    def __init__(self, vocab: Vocabulary, ndims: int = 0, L1_norm: int = 0, L2_norm: int = 0):
        assert (L1_norm + L2_norm) <= 1
        self.vocab = vocab
        self.L1_norm = L1_norm
        self.L2_norm = L2_norm
        if ndims != 0:
            assert len(vocab) == ndims, "feature dimension not match %d != %d" % (len(vocab), ndims)
        self.ndims = len(vocab)

    def mapping(self, query: str, clear: bool = True) -> Optional[np.ndarray]:
        words = clean_str(query) if clear else query.strip().split()
        vec = np.zeros(self.ndims, dtype=np.float64)
        w2i = self.vocab.word2idx
        hit = False
        for word in words:
            i = w2i.get(word)
            if i is not None:
                vec[i] += 1.0
                hit = True
        if not hit:
            return None
        if self.L1_norm:
            return vec / np.linalg.norm(vec, 1)
        if self.L2_norm:
            return vec / np.linalg.norm(vec, 2)
        return vec


def get_text_encoder(name: str):
    encoders = {"bow": Bow2Vec}
    if name not in encoders:
        raise ValueError("unknown text encoder %r (%s)"
                         % (name, ", ".join(encoders)))
    return encoders[name]
