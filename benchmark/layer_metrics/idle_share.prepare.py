"""Share of the profiled part of a pack window in which no kernel, copy or
fill ran on the card, in %."""


def read(trace):
    p = trace.prof
    if p is None or p.busy_s <= 0 or p.window_s <= 0:  # no device activity read
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
