"""Host time a request waits on the card, in ms: the program's ``readback``
spans of a request (the clip probabilities' read after the encoder, the
tokens' read after the decode). The mean over the requests of the traced
window outside its profiled part."""

from benchmark.program_spans import children_s, request_roots


def read(trace):
    found = request_roots(trace)
    if found is None:
        return None
    recs, roots = found
    waits = children_s(recs, roots, ("readback",))
    return 1e3 * sum(waits[r.id] for r in roots) / len(roots)
