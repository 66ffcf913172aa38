"""Device time of Wavegram_Logmel_Cnn14's waveform branch a packed clip, in
ms: every kernel, copy and fill that the program's ``wavegram`` spans
(``pre_conv0`` through ``pre_block4``, inside each ``pann_encode``)
launched in the profiled call, over the call's files. A program without
the span reads nothing."""


def read(trace):
    p = trace.prof
    if p is None or not p.units.get("clips") or "wavegram" not in p.device_s_by_span:
        return None
    return 1e3 * p.device_s_by_span["wavegram"] / p.units["clips"]
