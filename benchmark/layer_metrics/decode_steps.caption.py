"""Decode steps a replay runs: the steps the captured search ran, counted
on the card inside each step's conditional node and read back with the
tokens (the ``decode_steps`` of a request's ``readback`` span, a mean over
its rows), over the requests of the traced window outside its profiled
part. Random weights never emit EOS: 20 of 20."""

from benchmark.program_spans import request_roots


def read(trace):
    found = request_roots(trace)
    if found is None:
        return None
    recs, roots = found
    ids = {r.id for r in roots}
    steps = [r.attrs["decode_steps"] for r in recs
             if r.parent in ids and r.name == "readback" and "decode_steps" in r.attrs]
    return sum(steps) / len(steps) if steps else None
