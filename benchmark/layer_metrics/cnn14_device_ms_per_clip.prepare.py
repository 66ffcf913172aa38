"""Device time of the Cnn14 encoder a packed clip, in ms: every kernel,
copy and fill that the program's ``pann_encode`` spans launched in the
profiled call (the batches' copies to the card and the masked batches'
kernels), over the call's files."""


def read(trace):
    p = trace.prof
    if p is None or not p.units.get("clips") or "pann_encode" not in p.device_s_by_span:
        return None
    return 1e3 * p.device_s_by_span["pann_encode"] / p.units["clips"]
