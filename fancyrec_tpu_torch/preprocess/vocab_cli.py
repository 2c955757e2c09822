"""Vocabulary-building CLI (reference preprocess/vocab.py:100-147).

Builds bow + rnn vocabularies from a collection's caption file and writes
word_vocab_<threshold>.pkl plus the sorted counter file.
"""

from __future__ import annotations

import argparse
import json
import os

from fancyrec_tpu_torch.io.vocab import build_vocab, captions_from_txt, save_vocab


def build(rootpath: str, collection: str, threshold: int, text_style: str,
          overwrite: int = 0) -> str:
    vocab_file = os.path.join(rootpath, collection, "TextData", "vocabulary",
                              text_style, "word_vocab_%d.pkl" % threshold)
    counter_file = os.path.join(os.path.dirname(vocab_file),
                                "word_vocab_counter_%s.txt" % threshold)
    if os.path.exists(vocab_file) and not overwrite:
        print("%s exists. skip" % vocab_file)
        return vocab_file
    cap_file = os.path.join(rootpath, collection, "TextData",
                            "%s.caption.txt" % collection)
    if not os.path.exists(cap_file):
        # the reference vocab tool reads rootpath/<collection>.caption.txt
        cap_file = os.path.join(rootpath, collection + ".caption.txt")
    captions = captions_from_txt(cap_file)
    vocab, counter = build_vocab(captions, text_style, threshold=threshold)
    save_vocab(vocab, vocab_file)
    kept = sorted(((w, c) for w, c in counter.items() if c >= threshold),
                  key=lambda x: x[1], reverse=True)
    with open(counter_file, "w") as f:
        f.write("\n".join("%s %d" % wc for wc in kept))
    print("Saved vocabulary (%d words) to %s" % (len(vocab), vocab_file))
    return vocab_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("collection")
    p.add_argument("--rootpath", required=True)
    p.add_argument("--threshold", type=int, default=5)
    p.add_argument("--overwrite", type=int, default=0, choices=[0, 1])
    p.add_argument("--text_style", choices=["rnn", "bow", "both"],
                   default="both")
    a = p.parse_args(argv)
    print(json.dumps(vars(a), indent=2))
    styles = ["bow", "rnn"] if a.text_style == "both" else [a.text_style]
    for style in styles:
        build(a.rootpath, a.collection, a.threshold, style, a.overwrite)


if __name__ == "__main__":
    main()
