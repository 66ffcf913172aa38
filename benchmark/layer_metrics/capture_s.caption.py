"""Seconds a program takes to capture, in s: the mean of the program's
``capture`` spans (the CUDA graph's capture and instantiation, without the
eager warm-up call before it, which builds kernels and loads libraries and
has a ``warmup`` span of its own) over every program the process captured,
set-up's included. The cells pay it in set-up; a live request would pay it
where its key is new, or was evicted."""

from benchmark.program_spans import summary


def read(trace):
    s = summary()
    capture = s["spans"].get("capture") if s is not None else None
    return capture["total_s"] / capture["count"] if capture else None
