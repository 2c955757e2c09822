"""Offline WordPiece tokenizer (BERT-compatible).

Replaces the reference's network-fetched
BertTokenizer.from_pretrained("bert-base-uncased") (data_provider.py:13) with
a self-contained implementation over a local vocab.txt. Matches HuggingFace
BertTokenizer output (basic tokenization with lower-casing + accent
stripping, greedy longest-match WordPiece, [CLS]/[SEP] wrapping, id 0 [PAD]
padding) -- verified token-for-token in tests against a local-vocab HF
tokenizer.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk_id = self.vocab[unk_token]

    # -- basic tokenization -------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" %s " % ch)
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split_punct(self, token: str) -> List[str]:
        pieces, cur = [], []
        for ch in token:
            if _is_punctuation(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._split_cjk(self._clean(text))
        tokens = []
        for tok in text.strip().split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    # -- wordpiece ----------------------------------------------------------

    def wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]


def write_minimal_bert_vocab(path: str, words: Sequence[str]) -> None:
    """Write a tiny vocab.txt (specials + whole words) for tests/fixtures."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    with open(path, "w", encoding="utf-8") as f:
        for t in specials + list(dict.fromkeys(words)):
            f.write(t + "\n")
