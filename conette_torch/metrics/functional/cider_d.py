"""CIDEr-D (COCO-caption convention; the CIDEr half of SPIDEr).

Twin of the CIDEr-D metric used for validation monitoring and test scoring
in the reference (``callbacks/aac_validator.py``, ``AllMetrics``):
tf-idf-weighted 1..4-gram similarity with count clipping and a Gaussian
length penalty (σ=6), scaled by 10, averaged over references.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Sequence


def _ngram_counts(tokens: Sequence[str], max_n: int) -> list[Counter]:
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, max_n + 1)
    ]


def cider_d(
    candidates: Sequence[Sequence[str]],
    mult_references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> dict[str, object]:
    """Returns {"cider_d": corpus score, "cider_d_sents": per-sentence}."""
    if len(candidates) != len(mult_references):
        raise ValueError(f"{len(candidates)=} != {len(mult_references)=}")
    n_images = len(candidates)

    # document frequencies over reference sets (one increment per image)
    doc_freq: list[defaultdict] = [defaultdict(int) for _ in range(max_n)]
    for refs in mult_references:
        seen: list[set] = [set() for _ in range(max_n)]
        for ref in refs:
            for n_i, counts in enumerate(_ngram_counts(list(ref), max_n)):
                seen[n_i].update(counts.keys())
        for n_i in range(max_n):
            for ng in seen[n_i]:
                doc_freq[n_i][ng] += 1

    log_n = math.log(max(n_images, 1))

    def tfidf_vec(tokens: Sequence[str]):
        vecs, norms = [], []
        for n_i, counts in enumerate(_ngram_counts(list(tokens), max_n)):
            vec = {}
            norm_sq = 0.0
            for ng, tf in counts.items():
                idf = log_n - math.log(max(1.0, doc_freq[n_i][ng]))
                w = tf * idf
                vec[ng] = w
                norm_sq += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm_sq))
        return vecs, norms, len(tokens)

    sent_scores: list[float] = []
    for cand, refs in zip(candidates, mult_references):
        c_vecs, c_norms, c_len = tfidf_vec(cand)
        score_n = [0.0] * max_n
        for ref in refs:
            r_vecs, r_norms, r_len = tfidf_vec(ref)
            delta = float(c_len - r_len)
            penalty = math.exp(-(delta**2) / (2 * sigma**2))
            for n_i in range(max_n):
                num = 0.0
                for ng, cw in c_vecs[n_i].items():
                    rw = r_vecs[n_i].get(ng, 0.0)
                    num += min(cw, rw) * rw
                if c_norms[n_i] > 0 and r_norms[n_i] > 0:
                    num /= c_norms[n_i] * r_norms[n_i]
                score_n[n_i] += num * penalty
        n_refs = max(len(refs), 1)
        sent = 10.0 * sum(s / n_refs for s in score_n) / max_n
        sent_scores.append(sent)

    corpus = sum(sent_scores) / max(len(sent_scores), 1)
    return {"cider_d": corpus, "cider_d_sents": sent_scores}
