"""The waveform branch's share of its roofline, in %: the least time of
the profiled call's wavegram branches (``pre_conv0`` through
``pre_block4``), each file at its own length (its operations at f32's 67
TFLOP/s or its bytes at 3.35 TB/s, whichever bound is larger,
``benchmark/roofline_wavegram.py``; a batch's padding is not counted),
over the device time of the kernels that the program's ``wavegram`` spans
launched. A program without the span reads nothing."""


def read(trace):
    p = trace.prof
    if p is None or not p.units.get("wavegram_bound_s") or "wavegram" not in p.device_s_by_span:
        return None
    spent = p.device_s_by_span["wavegram"]
    return 100.0 * p.units["wavegram_bound_s"] / spent if spent > 0 else None
