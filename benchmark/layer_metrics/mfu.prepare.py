"""The packs' share of the card's peak, in %: each call's least time (every
file's Cnn14 frame embeddings at its own length, their operations at f32's
67 TFLOP/s or bytes at 3.35 TB/s) over the wall time of the program's
``pack_dataset`` roots, over the calls of the traced window outside its
profiled part."""

from benchmark.program_spans import kept_roots, records


def read(trace):
    recs = records()
    bound = trace.units.get("call_bound_s")
    if not recs or not bound:
        return None
    roots = kept_roots(recs, trace, "pack_dataset", "pack_dataset")
    wall = sum(r.seconds for r in roots)
    return 100.0 * bound * len(roots) / wall if wall > 0 else None
