"""The Cnn14 encoder's share of its roofline, in %: the least time of the
profiled call's frame embeddings, each file at its own length (its
operations at f32's 67 TFLOP/s or its bytes at 3.35 TB/s,
``benchmark/roofline_pann.py``; a batch's padding is not counted), over
the device time of the kernels that the program's ``pann_encode`` spans
launched (their copies to the card left out)."""

COPIES = ("Memcpy HtoD",)


def read(trace):
    p = trace.prof
    if p is None or not p.units.get("bound_s") or "pann_encode" not in p.device_s_by_span:
        return None
    spent = p.device_s_by_span["pann_encode"] - p.kernel_s(*COPIES)
    return 100.0 * p.units["bound_s"] / spent if spent > 0 else None
