"""Corpus BLEU.

Same semantics as torchmetrics.BLEUScore(n_gram=N) used by the reference at
run_generation.py:544,653-660: whitespace tokenization, uniform 1/N weights,
clipped modified n-gram precision accumulated over the corpus, brevity
penalty, no smoothing.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            counts[tuple(tokens[i : i + k])] += 1
    return counts


def bleu_score(
    preds: List[str],
    targets: List[List[str]],
    n_gram: int = 4,
    smooth: bool = False,
) -> float:
    """Corpus-level BLEU over whitespace tokens.

    Args:
      preds: candidate sentences.
      targets: per-candidate list of reference sentences.
      n_gram: max n-gram order (weights are uniform 1/n_gram).
      smooth: add-one smoothing on precision numerators/denominators (off by
        default, matching torchmetrics' default).
    """
    assert len(preds) == len(targets), "preds/targets length mismatch"
    numer = [0] * n_gram
    denom = [0] * n_gram
    pred_len = 0
    ref_len = 0

    for pred, refs in zip(preds, targets):
        pred_tokens = pred.split()
        refs_tokens = [r.split() for r in refs]
        pred_len += len(pred_tokens)
        # closest reference length (ties -> shorter), standard corpus BLEU
        if refs_tokens:
            ref_len += min(
                (abs(len(r) - len(pred_tokens)), len(r)) for r in refs_tokens
            )[1]
        pred_counts = _ngrams(pred_tokens, n_gram)
        max_ref_counts: Counter = Counter()
        for r in refs_tokens:
            for ng, c in _ngrams(r, n_gram).items():
                if c > max_ref_counts[ng]:
                    max_ref_counts[ng] = c
        per_order = [0] * n_gram
        for ng, c in pred_counts.items():
            n = len(ng) - 1
            per_order[n] += c
            numer[n] += min(c, max_ref_counts[ng])
        for n in range(n_gram):
            # nltk guards each sample's denominator at >=1 (modified_precision)
            denom[n] += max(per_order[n], 1)

    log_precisions = 0.0
    for n in range(n_gram):
        num, den = numer[n], denom[n]
        if smooth:
            num, den = num + 1, den + 1
        if num == 0 or den == 0:
            return 0.0
        log_precisions += math.log(num / den) / n_gram

    if pred_len == 0:
        return 0.0
    bp = 1.0 if pred_len > ref_len else math.exp(1.0 - ref_len / max(pred_len, 1))
    return bp * math.exp(log_precisions)
