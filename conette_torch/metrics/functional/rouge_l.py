"""ROUGE-L (COCO-caption convention: β=1.2, max precision/recall over
references). Twin of the ROUGE-L metric in the reference's ``AllMetrics``."""

from __future__ import annotations

from typing import Sequence


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        curr = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            curr[j] = prev[j - 1] + 1 if x == y else max(prev[j], curr[j - 1])
        prev = curr
    return prev[-1]


def rouge_l_single(
    candidate: Sequence[str],
    references: Sequence[Sequence[str]],
    beta: float = 1.2,
) -> float:
    if len(candidate) == 0:
        return 0.0
    precs, recs = [], []
    for ref in references:
        if len(ref) == 0:
            continue
        lcs = _lcs_len(list(ref), list(candidate))
        precs.append(lcs / len(candidate))
        recs.append(lcs / len(ref))
    if not precs:
        return 0.0
    p, r = max(precs), max(recs)
    if p == 0 or r == 0:
        return 0.0
    return (1 + beta**2) * p * r / (r + beta**2 * p)


def rouge_l(
    candidates: Sequence[Sequence[str]],
    mult_references: Sequence[Sequence[Sequence[str]]],
    beta: float = 1.2,
) -> dict[str, object]:
    scores = [
        rouge_l_single(c, refs, beta) for c, refs in zip(candidates, mult_references)
    ]
    corpus = sum(scores) / max(len(scores), 1)
    return {"rouge_l": corpus, "rouge_l_sents": scores}
