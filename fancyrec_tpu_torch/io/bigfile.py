"""BigFile: the on-disk dense-feature store.

File contract (kept bit-compatible with the reference format so artifacts
interchange freely; see reference util/imgbigfile.py:5-61, util/wordbigfile.py,
preprocess/txt2bin.py:25-110):

  <dir>/feature.bin   row-major float32 matrix, N rows of D values
  <dir>/shape.txt     single line "N D"
  <dir>/id.txt        single line of N names joined by a delimiter
                      ('#' for image/frame stores, ' ' for word2vec stores)

Unlike the reference's per-row seek/read loop, the reader gathers a batch
of rows in one call: through the native mmap gather
(`io/native.py`, built with the host's g++ at first use), or, where the
host has no C++ compiler, through a numpy memmap's fancy indexing.
`reader.engine` says which ("native" or "memmap").
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from fancyrec_tpu_torch.io import native


class BigFileReader:
    """Memory-mapped reader for a BigFile directory."""

    def __init__(self, datadir: str, delimiter: str = "#"):
        self.datadir = datadir
        shape_path = os.path.join(datadir, "shape.txt")
        with open(shape_path) as f:
            self.nr_of_rows, self.ndims = map(int, f.readline().split())
        id_path = os.path.join(datadir, "id.txt")
        with open(id_path, encoding="utf8") as f:
            names = f.readline().strip().split(delimiter)
        if names == [""]:
            names = []
        self.names: List[str] = names
        if len(self.names) != self.nr_of_rows:
            raise ValueError(
                "id.txt holds %d names but shape.txt declares %d rows (%s)"
                % (len(self.names), self.nr_of_rows, datadir)
            )
        self.nr_of_images = self.nr_of_rows  # reference API alias
        self.name2index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        self.binary_file = os.path.join(datadir, "feature.bin")
        self._mmap = np.memmap(
            self.binary_file, dtype=np.float32, mode="r",
            shape=(self.nr_of_rows, self.ndims),
        )
        self._native = None
        if self.nr_of_rows > 0 and native.available():
            self._native = native.NativeGather(
                self.binary_file, self.nr_of_rows, self.ndims)
        self.engine = "native" if self._native is not None else "memmap"

    # -- bulk vectorized access (the fast path) ------------------------------

    def read_rows(self, indices: Sequence[int]) -> np.ndarray:
        """Gather rows by integer index -> (len(indices), D) float32 array,
        through the native gather where it is built, else the memmap."""
        idx = np.asarray(indices, dtype=np.int64)
        if self._native is not None:
            return self._native.gather(idx)
        return np.asarray(self._mmap[idx])

    def read_by_names(self, names: Sequence[str]) -> np.ndarray:
        """Gather rows by name, preserving request order."""
        idx = [self.name2index[n] for n in names]
        return self.read_rows(idx)

    # -- reference-compatible API -------------------------------------------

    def read(self, requested: Iterable, isname: bool = True) -> Tuple[List[str], List[List[float]]]:
        """De-duplicated read sorted by storage index.

        Matches the reference contract (util/imgbigfile.py:19-53): the
        return order is storage order, unknown names are silently dropped,
        vectors come back as Python lists.
        """
        requested = set(requested)
        if isname:
            index_name = [(self.name2index[x], x) for x in requested if x in self.name2index]
        else:
            requested = {int(x) for x in requested}
            if requested:
                assert min(requested) >= 0
                assert max(requested) < len(self.names)
            index_name = [(x, self.names[x]) for x in requested]
        if not index_name:
            return [], []
        index_name.sort(key=lambda v: v[0])
        rows = self.read_rows([i for i, _ in index_name])
        return [n for _, n in index_name], [r.tolist() for r in rows]

    def read_one(self, name: str) -> List[float]:
        _, vectors = self.read([name])
        if not vectors:
            raise KeyError(name)
        return vectors[0]

    def shape(self) -> List[int]:
        return [self.nr_of_rows, self.ndims]

    def iter_rows(self, batch: int = 1024):
        """Sequential (name, float32 row) stream in storage order, constant
        memory (the reference's StreamFile, util/wordbigfile.py:63-98,
        replaced by batched mmap reads)."""
        for start in range(0, self.nr_of_rows, batch):
            stop = min(start + batch, self.nr_of_rows)
            rows = self.read_rows(np.arange(start, stop))
            for i in range(stop - start):
                yield self.names[start + i], rows[i]

    def __contains__(self, name: str) -> bool:
        return name in self.name2index


class ImageBigFile(BigFileReader):
    """Image/frame feature store: names '#'-delimited in id.txt."""

    def __init__(self, datadir: str):
        super().__init__(datadir, delimiter="#")


class WordBigFile(BigFileReader):
    """Word-embedding store: names ' '-delimited in id.txt."""

    def __init__(self, datadir: str):
        super().__init__(datadir, delimiter=" ")


class BigFileWriter:
    """Streaming writer emitting the exact reference on-disk format.

    Usage:
        with BigFileWriter(outdir, ndims=2048) as w:
            w.write("video1_0_cls3", vec)
            w.write_batch(names, matrix)
    NaN rows are dropped and duplicate names skipped, mirroring
    preprocess/txt2bin.py:25-110 of the reference.
    """

    def __init__(self, datadir: str, ndims: int = 0, delimiter: str = "#"):
        os.makedirs(datadir, exist_ok=True)
        self.datadir = datadir
        self.ndims = ndims
        self.delimiter = delimiter
        self.names: List[str] = []
        self._seen = set()
        self.failed = 0
        self._fh = open(os.path.join(datadir, "feature.bin"), "wb")
        self._closed = False

    def write(self, name: str, vec) -> bool:
        vec = np.asarray(vec, dtype=np.float32).reshape(-1)
        if name in self._seen:
            return False
        if np.isnan(vec).any():
            self.failed += 1
            return False
        if self.ndims == 0:
            self.ndims = len(vec)
        elif len(vec) != self.ndims:
            raise ValueError(
                "dimensionality mismatch: required %d, input %d, id=%s"
                % (self.ndims, len(vec), name)
            )
        self._seen.add(name)
        vec.tofile(self._fh)
        self.names.append(name)
        return True

    def write_batch(self, names: Sequence[str], matrix) -> int:
        """`write` of each (name, row) pair, as `zip` pairs them, with the
        same bytes, return value (the rows written) and `failed` count: a
        name already written, earlier or in this batch, is skipped, a NaN
        row fails and leaves its name free. The kept rows go out in one
        contiguous write."""
        matrix = np.asarray(matrix, dtype=np.float32)
        names = list(names)[: len(matrix)]
        n = len(names)
        if n == 0:
            return 0
        rows = matrix[:n].reshape(n, math.prod(matrix.shape[1:]))
        nan = np.isnan(rows).any(axis=1)
        keep: List[int] = []
        for i, name in enumerate(names):
            if name in self._seen:
                continue
            if nan[i]:
                self.failed += 1
                continue
            if not keep:                    # every row is as wide
                if self.ndims == 0:
                    self.ndims = rows.shape[1]
                elif rows.shape[1] != self.ndims:
                    raise ValueError(
                        "dimensionality mismatch: required %d, input %d, "
                        "id=%s" % (self.ndims, rows.shape[1], name))
            self._seen.add(name)
            keep.append(i)
        if keep:
            block = rows if len(keep) == n else rows[keep]
            np.ascontiguousarray(block).tofile(self._fh)
            self.names.extend(names[i] for i in keep)
        return len(keep)

    def close(self) -> None:
        if self._closed:
            return
        self._fh.close()
        with open(os.path.join(self.datadir, "id.txt"), "w", encoding="utf-8") as f:
            f.write(self.delimiter.join(self.names))
        with open(os.path.join(self.datadir, "shape.txt"), "w") as f:
            f.write("%d %d" % (len(self.names), self.ndims))
        self._closed = True

    def __enter__(self) -> "BigFileWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # do NOT finalize on error: id.txt/shape.txt are what marks a
            # store complete (preprocess resume guards key on shape.txt),
            # so a crashed extraction must not leave a valid-looking
            # truncated store behind
            self._fh.close()
            self._closed = True
            return
        self.close()
