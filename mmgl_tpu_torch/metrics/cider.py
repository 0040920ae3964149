"""Corpus-level CIDEr.

Same algorithm as the reference's vendored scorer (wikiweb2m/cider/
cider_scorer.py:54-199, itself from vrama91/cider): n-gram TF-IDF vectors with
document frequency computed over the reference corpus, `ref_len = log(#refs)`
(cider_scorer.py:169), clipped cosine similarity per n-gram order, gaussian
length penalty (sigma=6.0, :165), mean over orders 1..4, /#refs, x10 (:185).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngram_counts(sentence: str, n: int = 4) -> Counter:
    words = sentence.split()
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class Cider:
    """Drop-in equivalent of the reference's `Cider` (cider/cider.py:11-52)."""

    def __init__(self, test=None, refs=None, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert gts.keys() == res.keys()
        ids = list(gts.keys())
        tests, refs = [], []
        for i in ids:
            hypo, ref = res[i], gts[i]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(ref, list) and len(ref) > 0
            tests.append(hypo[0])
            refs.append(ref)
        scores = _cider_scores(tests, refs, self._n, self._sigma)
        return float(np.mean(scores)), scores

    def method(self) -> str:
        return "CIDEr"


def cider_score(preds: List[str], targets: List[List[str]],
                n: int = 4, sigma: float = 6.0) -> float:
    return float(np.mean(_cider_scores(preds, targets, n, sigma)))


def _flatten(s):
    # the reference precook accepts a [string] and uses s[0]
    return s[0] if isinstance(s, (list, tuple)) else s


def _cider_scores(tests: List[str], refs: List[List[str]],
                  n: int, sigma: float) -> np.ndarray:
    ctest = [_ngram_counts(_flatten(t), n) for t in tests]
    crefs = [[_ngram_counts(_flatten(r), n) for r in rs] for rs in refs]

    # document frequency over the reference corpus
    doc_freq: Dict[tuple, float] = defaultdict(float)
    for rs in crefs:
        for ngram in set(ng for r in rs for ng in r):
            doc_freq[ngram] += 1

    ref_len = np.log(float(len(crefs)))

    def counts2vec(cnts: Counter):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ngram, tf in cnts.items():
            df = np.log(max(1.0, doc_freq[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(tf) * (ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = np.zeros(n)
        for k in range(n):
            for ngram in vh[k]:
                val[k] += min(vh[k][ngram], vr[k][ngram]) * vr[k][ngram]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.e ** (-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for test, rs in zip(ctest, crefs):
        vec, norm, length = counts2vec(test)
        score = np.zeros(n)
        for ref in rs:
            vec_r, norm_r, length_r = counts2vec(ref)
            score += sim(vec, vec_r, norm, norm_r, length, length_r)
        scores.append(float(np.mean(score)) / len(rs) * 10.0)
    return np.array(scores)
