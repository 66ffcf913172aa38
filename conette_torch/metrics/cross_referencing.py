"""Human-score estimation by reference hold-out.

Twin of ``compute_cross_referencing``
(``src/conette/metrics/cross_referencing.py:19-93``): estimate the human
ceiling of a metric by scoring each held-out reference against the
remaining references, averaged over hold-out rounds.
"""

from __future__ import annotations

from typing import Callable, Sequence


def compute_cross_referencing(
    metric_fn: Callable[[Sequence[str], Sequence[Sequence[str]]], dict],
    mult_references: Sequence[Sequence[str]],
    n_rounds: int | None = None,
    score_key: str | None = None,
) -> dict[str, float]:
    """:param metric_fn: (candidates, mult_references) → {name: corpus score}.
    :param n_rounds: number of hold-out rounds (default: min ref count).
    :returns: mean held-out score per metric key.
    """
    min_refs = min(len(refs) for refs in mult_references)
    if min_refs < 2:
        raise ValueError("cross-referencing requires ≥2 references per item")
    rounds = n_rounds if n_rounds is not None else min_refs

    totals: dict[str, float] = {}
    for r in range(rounds):
        cands = [refs[r % len(refs)] for refs in mult_references]
        helds = [
            [ref for i, ref in enumerate(refs) if i != (r % len(refs))]
            for refs in mult_references
        ]
        scores = metric_fn(cands, helds)
        if isinstance(scores, tuple):
            scores = scores[0]
        for k, v in scores.items():
            if isinstance(v, (int, float)):
                totals[k] = totals.get(k, 0.0) + float(v)
    out = {f"cross_ref_{k}": v / rounds for k, v in totals.items()}
    if score_key is not None:
        return {k: v for k, v in out.items() if score_key in k}
    return out
