"""BigFile integrity checker.

The reference's bin/do_format_check.sh points at a util/format_check.py
that does not exist in its tree (script drift); this is that tool, made
real: verifies shape.txt vs id.txt vs feature.bin byte length, scans for
NaN/Inf rows, and (optionally) checks video2frames.txt coverage.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from fancyrec_tpu_torch.io.bigfile import ImageBigFile
from fancyrec_tpu_torch.io.dictfile import read_dict


def check_feature_dir(feature_dir: str, sample: int = 1024) -> list:
    problems = []
    # byte-length check BEFORE opening the reader: a truncated feature.bin
    # (the likely post-crash corruption) makes the reader's mmap raise, so
    # the specific diagnostic would otherwise be unreachable
    shape_path = os.path.join(feature_dir, "shape.txt")
    bin_path = os.path.join(feature_dir, "feature.bin")
    try:
        with open(shape_path) as f:
            rows, dims = (int(x) for x in f.read().split())
        expect = rows * dims * 4
        actual = os.path.getsize(bin_path)
        if actual < expect:
            return ["feature.bin truncated: %d < %d bytes"
                    % (actual, expect)]
        if actual > expect:
            problems.append(
                "feature.bin has %d trailing bytes" % (actual - expect))
    except (OSError, ValueError) as e:
        return ["unreadable store: %s" % e]

    try:
        store = ImageBigFile(feature_dir)
    except Exception as e:
        return ["unreadable store: %s" % e]

    if len(set(store.names)) != len(store.names):
        problems.append("duplicate names in id.txt")

    n = store.nr_of_rows
    if n:
        idx = np.unique(np.linspace(0, n - 1, min(sample, n), dtype=np.int64))
        rows = store.read_rows(idx)
        bad = ~np.isfinite(rows).all(axis=1)
        if bad.any():
            problems.append("non-finite values in rows %s"
                            % idx[bad][:10].tolist())

    v2f_path = os.path.join(feature_dir, "video2frames.txt")
    if os.path.exists(v2f_path):
        v2f = read_dict(v2f_path)
        missing = [f for frames in v2f.values() for f in frames
                   if f not in store.name2index]
        if missing:
            problems.append("video2frames references %d unknown frames "
                            "(first: %s)" % (len(missing), missing[:3]))
    return problems


def main(argv=None):
    p = argparse.ArgumentParser(description="verify BigFile feature dirs")
    p.add_argument("feature_dirs", nargs="+")
    p.add_argument("--sample", type=int, default=1024)
    a = p.parse_args(argv)
    rc = 0
    for d in a.feature_dirs:
        problems = check_feature_dir(d, a.sample)
        if problems:
            rc = 1
            print("[FAIL] %s" % d)
            for prob in problems:
                print("   - " + prob)
        else:
            print("[OK]   %s" % d)
    return rc


if __name__ == "__main__":
    sys.exit(main())
