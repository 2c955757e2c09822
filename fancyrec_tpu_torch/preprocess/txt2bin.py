"""txt -> BigFile converter (reference preprocess/txt2bin.py:25-110).

Each input line: '<name with possible spaces> f1 ... fD'. Feature values
are the last D fields; duplicates skipped, NaN rows dropped. CLI matches
the reference: nDims inputTextFile isFileList resultDir [--overwrite].
"""

from __future__ import annotations

import os
import sys
from typing import Iterable

import numpy as np

from fancyrec_tpu_torch.io.bigfile import BigFileWriter


def process(feat_dim: int, input_text_files: Iterable[str], result_dir: str,
            overwrite: int = 0) -> int:
    bin_path = os.path.join(result_dir, "feature.bin")
    if os.path.exists(bin_path) and not overwrite:
        print("%s exists. skip" % bin_path)
        return 0
    count_line = 0
    with BigFileWriter(result_dir, ndims=max(feat_dim, 0)) as w:
        for filename in input_text_files:
            filename = filename.strip()
            print(">>> Processing %s" % filename)
            with open(filename) as f:
                for line in f:
                    elems = line.strip().split()
                    if not elems:
                        continue
                    count_line += 1
                    if feat_dim > 0:
                        values = elems[-feat_dim:]
                        name = " ".join(elems[: len(elems) - feat_dim])
                    else:
                        name, values = elems[0], elems[1:]
                    try:
                        vec = np.array(values, dtype=np.float32)
                    except ValueError:
                        print(elems)
                        break
                    w.write(name, vec)
        names, failed = len(w.names), w.failed
    print("%d lines parsed, %d failed -> %d unique ids"
          % (count_line, failed, names))
    return 0


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("nDims", type=int)
    p.add_argument("inputTextFile")
    p.add_argument("isFileList", type=int)
    p.add_argument("resultDir")
    p.add_argument("--overwrite", type=int, default=0)
    a = p.parse_args(argv)
    if a.isFileList == 1:
        with open(a.inputTextFile) as f:
            files = [x.strip() for x in f
                     if x.strip() and not x.strip().startswith("#")]
    else:
        files = [a.inputTextFile]
    return process(a.nDims, files, a.resultDir, a.overwrite)


if __name__ == "__main__":
    sys.exit(main())
