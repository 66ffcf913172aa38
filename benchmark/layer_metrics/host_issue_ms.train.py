"""Host time a training step takes to issue, in ms: the program's
``train_step`` span around the step ``fit`` is handed (its ``loss``,
``grad``, ``clip`` and ``optimizer`` children split it), over the timed
steps outside the profiled part."""

from benchmark.program_spans import kept_roots, records


def read(trace):
    recs = records()
    if not recs:
        return None
    steps = kept_roots(recs, trace, "train_step", "train_step")
    return 1e3 * sum(r.seconds for r in steps) / len(steps) if steps else None
