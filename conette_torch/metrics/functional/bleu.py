"""BLEU-N, COCO-caption convention (corpus + per-sentence).

Twin of the BLEU1-4 metrics in the reference's ``AllMetrics``
(``src/conette/metrics/classes/all_metrics.py:92-104``), which wrap
aac-metrics' vendored COCO ``bleu_scorer``. Semantics replicated exactly:

* clipped n-gram ``correct`` vs max-over-refs counts, ``guess`` =
  ``max(0, len(cand) - n + 1)``;
* smoothing constants ``tiny = 1e-15`` / ``small = 1e-9`` applied as
  ``(correct + tiny) / (guess + small)`` at BOTH sentence and corpus level;
* geometric mean via the cumulative-product form
  ``(prod_{k<=n} p_k) ** (1/n)``;
* brevity penalty ``exp(1 - 1/ratio)`` with
  ``ratio = (testlen + tiny) / (reflen + small)`` applied when
  ``ratio < 1`` — per-sentence with that sentence's own lengths, corpus
  with the summed lengths;
* reference length = *closest* to the candidate length (ties → shorter).

Per-sentence values are what the reference logs into the published
``outputs_*.csv`` ``bleu_1..4`` columns — validated to ≤1e-6 against them
in ``tests/test_reference_parity.py``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _closest_reflen(ref_lens: Sequence[int], testlen: int) -> int:
    return min((abs(rl - testlen), rl) for rl in ref_lens)[1]


def bleu(
    candidates: Sequence[Sequence[str]],
    mult_references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
) -> dict[str, object]:
    """:param candidates: tokenized candidates, one per example.
    :param mult_references: tokenized references per example.
    :returns: {"bleu_1": float, ..., "bleu_1_sents": [float], ...}
    """
    if len(candidates) != len(mult_references):
        raise ValueError(f"{len(candidates)=} != {len(mult_references)=}")

    tot_guess = [0] * max_n
    tot_correct = [0] * max_n
    tot_testlen = 0
    tot_reflen = 0.0
    sents: list[list[float]] = [[] for _ in range(max_n)]

    for cand, refs in zip(candidates, mult_references):
        cand = list(cand)
        testlen = len(cand)
        reflen = _closest_reflen([len(r) for r in refs], testlen)
        tot_testlen += testlen
        tot_reflen += reflen

        guess = [max(testlen - k, 0) for k in range(max_n)]
        correct = []
        for n in range(1, max_n + 1):
            cand_ng = _ngrams(cand, n)
            max_ref: Counter = Counter()
            for ref in refs:
                for ng, c in _ngrams(list(ref), n).items():
                    if c > max_ref[ng]:
                        max_ref[ng] = c
            correct.append(sum(min(c, max_ref[ng]) for ng, c in cand_ng.items()))
            tot_guess[n - 1] += guess[n - 1]
            tot_correct[n - 1] += correct[n - 1]

        prod = 1.0
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        bp = math.exp(1.0 - 1.0 / ratio) if ratio < 1 else 1.0
        for k in range(max_n):
            prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
            sents[k].append(prod ** (1.0 / (k + 1)) * bp)

    out: dict[str, object] = {}
    prod = 1.0
    ratio = (tot_testlen + _TINY) / (tot_reflen + _SMALL)
    bp = math.exp(1.0 - 1.0 / ratio) if ratio < 1 else 1.0
    for k in range(max_n):
        prod *= (tot_correct[k] + _TINY) / (tot_guess[k] + _SMALL)
        out[f"bleu_{k + 1}"] = prod ** (1.0 / (k + 1)) * bp
    for k in range(max_n):
        out[f"bleu_{k + 1}_sents"] = sents[k]
    return out
