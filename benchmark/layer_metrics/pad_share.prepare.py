"""Share of the mel frames the Cnn encoder computed that lie past their
rows' lengths, in %: the program's counter ``pann_pad_frames`` over it and
``pann_valid_frames`` (a batch padded to the length bucket of its longest
clip), over every batch of the process."""

from benchmark.program_spans import summary


def read(trace):
    s = summary()
    counters = s["counters"] if s is not None else {}
    pad, valid = counters.get("pann_pad_frames"), counters.get("pann_valid_frames")
    if not valid:
        return None
    return 100.0 * (pad or 0) / (valid + (pad or 0))
