"""Per-query ranking scorers: AP / RR / Precision / NDCG / DCG.

The port's copy of fancyrec_tpu/eval/scorers.py (numpy only), itself the
reference's scorer toolkit (util/metric.py:6-123, dead code there but part
of the documented surface): getScorer("AP@10") etc., scoring a sorted
relevance-label list. Alongside the scalar API,
vectorized numpy batch versions score many queries at once (rows of a
sorted-label matrix) for evaluation sweeps.

Quirk preserved: NDCGScorer's discount is 1/log2(i+1) with the *first*
element undiscounted and DCGScorer uses the (2^rel - 1) gain scaled by the
reference's literal 0.01757 constant.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np


class MetricScorer:
    def __init__(self, k: int = 0):
        self.k = k

    def score(self, sorted_labels: Sequence[float]) -> float:
        return 0.0

    def getLength(self, sorted_labels: Sequence[float]) -> int:
        length = self.k
        if length > len(sorted_labels) or length <= 0:
            length = len(sorted_labels)
        return length

    def name(self) -> str:
        base = self.__class__.__name__.replace("Scorer", "")
        return "%s@%d" % (base, self.k) if self.k > 0 else base


class APScorer(MetricScorer):
    def score(self, sorted_labels):
        nr_relevant = len([x for x in sorted_labels if x > 0])
        if nr_relevant == 0:
            return 0.0
        ap, rel = 0.0, 0
        for i in range(self.getLength(sorted_labels)):
            if sorted_labels[i] >= 1:
                rel += 1
                ap += rel / (i + 1.0)
        return ap / nr_relevant


class RRScorer(MetricScorer):
    def score(self, sorted_labels):
        for i, lab in enumerate(sorted_labels):
            if lab >= 1:
                return 1.0 / (i + 1)
        return 0.0


class PrecisionScorer(MetricScorer):
    def score(self, sorted_labels):
        length = self.getLength(sorted_labels)
        rel = sum(1 for i in range(length) if sorted_labels[i] >= 1)
        return rel / length


class NDCGScorer(PrecisionScorer):
    def score(self, sorted_labels):
        return self.getDCG(sorted_labels) / self.getIdealDCG(sorted_labels)

    def getDCG(self, sorted_labels):
        length = self.getLength(sorted_labels)
        dcg = max(sorted_labels[0], 0)
        for i in range(1, length):
            dcg += max(sorted_labels[i], 0) / math.log(i + 1, 2)
        return dcg

    def getIdealDCG(self, sorted_labels):
        return self.getDCG(sorted(sorted_labels, reverse=True))


class DCGScorer(PrecisionScorer):
    SCALE = 0.01757  # reference literal (util/metric.py:108)

    def score(self, sorted_labels):
        return self.getDCG(sorted_labels)

    def getDCG(self, sorted_labels):
        part = [(math.pow(2, rel) - 1) / math.log(i + 1, 2)
                for i, rel in enumerate(sorted_labels[: self.k], 1)]
        return self.SCALE * sum(part)

    def getIdealDCG(self, sorted_labels):
        return self.getDCG(sorted(sorted_labels, reverse=True))

    def getRandomDCG(self, sorted_labels):
        shuffled = list(sorted_labels)
        random.shuffle(shuffled)
        return self.getDCG(shuffled)


def getScorer(name: str) -> MetricScorer:
    mapping = {"P": PrecisionScorer, "AP": APScorer, "RR": RRScorer,
               "NDCG": NDCGScorer, "DCG": DCGScorer}
    elems = name.split("@")
    k = int(elems[1]) if len(elems) == 2 else 0
    return mapping[elems[0]](k)


# ---------------------------------------------------------------------------
# vectorized batch versions: (Q, N) sorted binary labels -> (Q,) scores
# ---------------------------------------------------------------------------

def batch_ap(sorted_labels: np.ndarray, k: int = 0) -> np.ndarray:
    # relevance rule matches the scalar APScorer (reference
    # util/metric.py: label >= 1 counts as relevant, so graded labels in
    # (0, 1) are NOT hits)
    lab = (np.asarray(sorted_labels) >= 1).astype(np.float64)
    q, n = lab.shape
    length = n if k <= 0 or k > n else k
    rel_cum = np.cumsum(lab[:, :length], axis=1)
    prec = rel_cum / np.arange(1, length + 1)
    ap = np.sum(prec * lab[:, :length], axis=1)
    # denominator counts label > 0 (reference util/metric.py:32 nr_relevant)
    # while hits above use >= 1 (:38) -- for graded labels in (0, 1) the
    # reference's AP is deflated by the quirk; mirrored exactly
    total_rel = (np.asarray(sorted_labels) > 0).sum(axis=1).astype(np.float64)
    return np.where(total_rel > 0, ap / np.maximum(total_rel, 1), 0.0)


def batch_rr(sorted_labels: np.ndarray) -> np.ndarray:
    lab = np.asarray(sorted_labels) >= 1
    any_rel = lab.any(axis=1)
    first = np.argmax(lab, axis=1)
    return np.where(any_rel, 1.0 / (first + 1), 0.0)


def batch_precision(sorted_labels: np.ndarray, k: int = 0) -> np.ndarray:
    lab = (np.asarray(sorted_labels) >= 1).astype(np.float64)
    q, n = lab.shape
    length = n if k <= 0 or k > n else k
    return lab[:, :length].sum(axis=1) / length
