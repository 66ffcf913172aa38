"""Share of a pack's wall time spent loading its files on the host, in %:
the program's ``native_load`` spans (each batch's files decoded and
resampled on the loader's pool) over the ``pack_dataset`` roots that hold
them, over the calls of the traced window outside its profiled part."""

from benchmark.program_spans import kept_roots, records


def read(trace):
    recs = records()
    if not recs:
        return None
    roots = kept_roots(recs, trace, "pack_dataset", "pack_dataset")
    ids = {r.root for r in roots}
    loads = sum(r.seconds for r in recs if r.name == "native_load" and r.root in ids)
    calls = sum(r.seconds for r in roots)
    return 100.0 * loads / calls if calls > 0 and loads > 0 else None
