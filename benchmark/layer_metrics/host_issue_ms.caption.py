"""Host time a request spends issuing work, in ms: the program's ``forward``
span less its ``load_resample`` and its ``readback`` children (the load and
the host's waits on the card): the encoder's and the decode's staging and
launches, the tasks and the detokenizing. The mean over the requests of
the traced window outside its profiled part."""

from benchmark.program_spans import children_s, request_roots


def read(trace):
    found = request_roots(trace)
    if found is None:
        return None
    recs, roots = found
    less = children_s(recs, roots, ("load_resample", "readback"))
    return 1e3 * sum(r.seconds - less[r.id] for r in roots) / len(roots)
