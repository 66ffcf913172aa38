"""Threads the native loader keeps busy, in threads: over the
``caption_corpus`` calls of the traced window outside its profiled part,
the summed seconds of the pool's ``load_file`` spans over the summed
seconds of the ``native_load`` spans that hand them out (1: one file at a
time; 8: the whole pool)."""

from benchmark.program_spans import kept_roots, records


def read(trace):
    recs = records()
    if not recs:
        return None
    calls = {r.root for r in kept_roots(recs, trace, "caption_corpus", "caption_corpus")}
    files = sum(r.seconds for r in recs if r.name == "load_file" and r.root in calls)
    loads = sum(r.seconds for r in recs if r.name == "native_load" and r.root in calls)
    return files / loads if loads > 0 else None
