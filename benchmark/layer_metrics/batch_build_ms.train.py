"""Host time the prefetch thread takes to build a batch, in ms: its
``build_batch`` span (the items read, the collation) and its ``pin`` span
of the batch that each timed step outside the profiled part trained on,
found by the root the two threads share, (epoch, the batch's index): the
last such built before the step began (``fit`` runs twice in a cell)."""

from collections import defaultdict

from benchmark.program_spans import kept_roots, records


def read(trace):
    recs = records()
    if not recs:
        return None
    steps = kept_roots(recs, trace, "train_step", "train_step")
    built = {"build_batch": defaultdict(list), "pin": defaultdict(list)}
    for r in recs:
        if r.name in built:
            built[r.name][r.root].append(r)
    total, n = 0.0, 0
    for step in steps:
        parts = [max((r for r in built[name][step.root] if r.end <= step.start), key=lambda r: r.end,
                     default=None) for name in built]
        if None not in parts:
            total += sum(r.seconds for r in parts)
            n += 1
    return 1e3 * total / n if n else None
