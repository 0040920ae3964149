"""ROUGE-1 / ROUGE-2 / ROUGE-L / ROUGE-Lsum f-measures.

Same semantics as torchmetrics.ROUGEScore() used by the reference at
run_generation.py:545,662-666, which mirrors google-research/rouge_score:
  - normalization: lowercase, strip non-alphanumeric to spaces, whitespace split
  - rougeN: n-gram overlap F1
  - rougeL: sentence-level longest common subsequence F1
  - rougeLsum: union-LCS over newline-split sentences
  - multiple references: best score per sample (accumulate='best')
  - corpus value: mean of per-sample f-measures
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List

_NON_ALNUM = re.compile(r"[^a-z0-9]+")


def _normalize(text: str) -> List[str]:
    return _NON_ALNUM.sub(" ", text.lower()).split()


def _ngram_counts(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _f_measure(matches: int, pred_total: int, ref_total: int) -> float:
    if pred_total == 0 or ref_total == 0:
        return 0.0
    precision = matches / pred_total
    recall = matches / ref_total
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _rouge_n(pred: List[str], ref: List[str], n: int) -> float:
    p, r = _ngram_counts(pred, n), _ngram_counts(ref, n)
    matches = sum((p & r).values())
    return _f_measure(matches, max(sum(p.values()), 0), max(sum(r.values()), 0))


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _rouge_l(pred: List[str], ref: List[str]) -> float:
    return _f_measure(_lcs_len(pred, ref), len(pred), len(ref))


def _lcs_table_union(ref_sents: List[List[str]], pred_sents: List[List[str]]) -> float:
    """Union-LCS (summary-level ROUGE-L) as in rouge_score.scoring."""
    ref_total = sum(len(s) for s in ref_sents)
    pred_total = sum(len(s) for s in pred_sents)
    if ref_total == 0 or pred_total == 0:
        return 0.0
    hits = 0
    pred_counts = Counter(tok for s in pred_sents for tok in s)
    for ref_sent in ref_sents:
        # union of LCS token positions across all prediction sentences
        union = set()
        for pred_sent in pred_sents:
            union |= _lcs_indices(ref_sent, pred_sent)
        # clip hits by prediction token counts (rouge_score semantics)
        matched = Counter(ref_sent[i] for i in union)
        for tok, c in matched.items():
            take = min(c, pred_counts[tok])
            hits += take
            pred_counts[tok] -= take
    return _f_measure(hits, pred_total, ref_total)


def _lcs_indices(ref: List[str], pred: List[str]) -> set:
    """Indices of `ref` tokens participating in the LCS with `pred`."""
    if not ref or not pred:
        return set()
    table = [[0] * (len(pred) + 1) for _ in range(len(ref) + 1)]
    for i in range(1, len(ref) + 1):
        for j in range(1, len(pred) + 1):
            if ref[i - 1] == pred[j - 1]:
                table[i][j] = table[i - 1][j - 1] + 1
            else:
                table[i][j] = max(table[i - 1][j], table[i][j - 1])
    idx = set()
    i, j = len(ref), len(pred)
    while i > 0 and j > 0:
        if ref[i - 1] == pred[j - 1]:
            idx.add(i - 1)
            i, j = i - 1, j - 1
        elif table[i - 1][j] >= table[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return idx


def _split_sentences(text: str) -> List[List[str]]:
    sents = [s for s in text.split("\n") if s.strip()]
    if not sents:
        sents = [text]
    return [_normalize(s) for s in sents]


def rouge_score(preds: List[str], targets: List[List[str]]) -> Dict[str, float]:
    """Mean per-sample best-reference f-measures for rouge1/2/L/Lsum."""
    assert len(preds) == len(targets)
    keys = ("rouge1_fmeasure", "rouge2_fmeasure", "rougeL_fmeasure",
            "rougeLsum_fmeasure")
    sums = dict.fromkeys(keys, 0.0)
    n = 0
    for pred, refs in zip(preds, targets):
        if isinstance(refs, str):
            refs = [refs]
        pred_tok = _normalize(pred)
        pred_sents = _split_sentences(pred)
        best = dict.fromkeys(keys, 0.0)
        for ref in refs:
            ref_tok = _normalize(ref)
            sample = {
                "rouge1_fmeasure": _rouge_n(pred_tok, ref_tok, 1),
                "rouge2_fmeasure": _rouge_n(pred_tok, ref_tok, 2),
                "rougeL_fmeasure": _rouge_l(pred_tok, ref_tok),
                "rougeLsum_fmeasure": _lcs_table_union(
                    _split_sentences(ref), pred_sents
                ),
            }
            for k in keys:
                best[k] = max(best[k], sample[k])
        for k in keys:
            sums[k] += best[k]
        n += 1
    if n == 0:
        return dict.fromkeys(keys, 0.0)
    return {k: v / n for k, v in sums.items()}
