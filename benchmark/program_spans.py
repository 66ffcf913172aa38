"""The program's own spans and counters (``conette_torch/utils/profiling.py``)
for the per-layer readers: its ring of span records and its summary, and
the roots that lie in the traced window outside its profiled part.

A root (a request's ``forward``, a call's ``caption_corpus``, a training
batch's ``train_step``) counts when it overlaps a span of the benchmark's
own that ``Trace.spans`` kept: the benchmark keeps none inside the profiled
part or before the window. A tree whose program keeps no spans gives None
here, and its readers read nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any


def _recorder() -> Any:
    try:
        from conette_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") and hasattr(profiling, "summary") else None


def records() -> list | None:
    """The program's span records, oldest first, or None."""
    rec = _recorder()
    return rec.records() if rec is not None else None


def summary() -> dict | None:
    """The program's summary of every span and counter, or None."""
    rec = _recorder()
    return rec.summary() if rec is not None else None


def kept_roots(recs: list, trace: Any, root: str, mark: str) -> list:
    """The records named ``root`` that overlap a span named ``mark`` of
    ``trace.spans`` (the benchmark's spans of that name do not overlap each
    other)."""
    marks = sorted((t0, t1) for n, t0, t1 in trace.spans if n == mark)
    starts = [m[0] for m in marks]
    out = []
    for r in recs:
        if r.name == root:
            i = bisect.bisect_right(starts, r.end) - 1
            if i >= 0 and marks[i][1] >= r.start:
                out.append(r)
    return out


def children_s(recs: list, roots: list, names: tuple[str, ...]) -> dict[int, float]:
    """For each of ``roots`` (by id), the seconds of its direct children
    named in ``names``."""
    ids = {r.id for r in roots}
    out: dict[int, float] = defaultdict(float)
    for r in recs:
        if r.parent in ids and r.name in names:
            out[r.parent] += r.seconds
    return out


def request_roots(trace: Any) -> tuple[list, list] | None:
    """The captioning window's records and its kept requests (``forward``
    roots around a kept ``_generate``), or None where there are none."""
    recs = records()
    if not recs:
        return None
    roots = kept_roots(recs, trace, "forward", "_generate")
    return (recs, roots) if roots else None
