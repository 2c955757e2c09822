"""word2vec utilities over WordBigFile stores.

The port's copy of fancyrec_tpu/io/word2vec.py, which ports
get_we_parameter (reference model.py:18-35: build a word-embedding
init matrix from a word2vec BigFile, random-uniform for OOV words) and
AveWord2Vec (preprocess/text2vec.py:84-121 -- broken there by an unimported
BigFile name; fixed here): caption -> mean of known word vectors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fancyrec_tpu_torch.io.bigfile import WordBigFile
from fancyrec_tpu_torch.io.vocab import Vocabulary, clean_str


def get_we_parameter(vocab: Vocabulary, w2v_file: str,
                     seed: Optional[int] = None) -> np.ndarray:
    """(len(vocab), ndims) embedding-init matrix from a word2vec store."""
    reader = WordBigFile(w2v_file)
    ndims = reader.ndims
    rng = np.random.RandomState(seed) if seed is not None else np.random
    we = []
    for i in range(len(vocab)):
        word = vocab.idx2word[i]
        if word in reader:
            we.append(np.asarray(reader.read_one(word)))
        else:
            we.append(rng.uniform(-1, 1, ndims))
    return np.array(we, dtype=np.float32)


class AveWord2Vec:
    """caption -> mean word2vec vector (None when no word is known)."""

    def __init__(self, datafile: str, ndims: int = 0,
                 L1_norm: int = 0, L2_norm: int = 0):
        assert (L1_norm + L2_norm) <= 1
        self.word2vec = WordBigFile(datafile)
        if ndims != 0:
            assert self.word2vec.ndims == ndims, \
                "feature dimension not match %d != %d" % (self.word2vec.ndims, ndims)
        self.ndims = self.word2vec.ndims
        self.L1_norm = L1_norm
        self.L2_norm = L2_norm

    def mapping(self, query: str, clear: bool = True) -> Optional[np.ndarray]:
        words = clean_str(query) if clear else query.strip().split()
        known = [w for w in words if w in self.word2vec]
        if not known:
            return None
        vec = self.word2vec.read_by_names(known).mean(axis=0)
        if self.L1_norm:
            return vec / np.linalg.norm(vec, 1)
        if self.L2_norm:
            return vec / np.linalg.norm(vec, 2)
        return vec
