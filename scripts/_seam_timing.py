#!/usr/bin/env python3
"""Where a seam call's time goes on the card, at the three seams of a
request of 8 x 10 s clips (and the 1 s corpus bucket's, batch 8).

    python3 scripts/_seam_timing.py

For each shape it prints, as one JSON line:
- ``device_us``: each device kernel's time a call (``torch.profiler``, mean
  over 50 back-to-back calls), for the pack and the seam kernel;
- ``host_us``: the host's time a ``fused_downsample`` call with the queue
  kept busy (mean of 200 calls enqueued back to back, no synchronisation
  inside), of ``launch_seam`` on prepared operands and of the C entry
  point alone (its two launches), each the mean of 200 calls, and of the
  Python parts alone (``prepare_seam_operands``, ``seam_plan``, the
  output allocation, the stream lookup, the check of ``x``), each the
  mean of 2000 calls;
- ``event_ms``: the call timed alone between two CUDA events, as
  ``chip_smoke.py`` times it (median of 25).
The card's name and power limit come first.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(8, 252, 56, 96), (8, 126, 28, 192), (8, 63, 14, 384),
          (8, 27, 56, 96), (8, 13, 28, 192), (8, 6, 14, 384)]


def host_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from conette_torch.kernels import _build
    from conette_torch.kernels.convnext_block import sm_count
    from conette_torch.kernels.downsample import (
        downsample_reference, fused_downsample, launch_seam, prepare_seam_operands, seam_plan,
    )

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for b, t, f, c in SHAPES:
        args = tuple(a.to(dev) for a in (
            torch.randn(c, generator=gen) * 0.1 + 1, torch.randn(c, generator=gen) * 0.05,
            torch.randn((2, 2, c, 2 * c), generator=gen) * 0.05, torch.randn(2 * c, generator=gen) * 0.05))
        x = (torch.randn((b, t, f, c), generator=gen) * 0.5).to(dev, torch.bfloat16)
        got = fused_downsample(x, *args)
        err = float((got.float() - downsample_reference(x, *args).float()).abs().max())
        for _ in range(20):
            fused_downsample(x, *args)
        torch.cuda.synchronize()

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fused_downsample(x, *args)
            torch.cuda.synchronize()
        device = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                name = "pack" if "seam_pack_kernel" in e.key else "seam" if "seam_kernel" in e.key else e.key[:40]
                device[name] = device.get(name, 0.0) + e.self_device_time_total / 50
        torch.cuda.synchronize()

        n_out = b * (t // 2) * (f // 2)
        ops = prepare_seam_operands(*args)
        plan = seam_plan(n_out, c, sm_count(dev))
        work = torch.empty(8 * c * c, dtype=torch.bfloat16, device=dev)
        out = torch.empty((b, t // 2, f // 2, 2 * c), dtype=torch.bfloat16, device=dev)
        fn = _build.entry("conette_downsample", 7, 7)
        ptrs = (x.data_ptr(), *(o.data_ptr() for o in ops), work.data_ptr(), out.data_ptr())
        stream = _build.stream_of(x)
        host = {
            "call": host_us(lambda: fused_downsample(x, *args), 200),
            "launch_seam": host_us(lambda: launch_seam(x, ops, plan), 200),
            "c_entry": host_us(lambda: fn(*ptrs, b, t, f, c, plan.slices, plan.ctas, x.device.index,
                                            1e-6, stream),
                               200),
            "require_x": host_us(lambda: _build.require(x, "x", torch.bfloat16, (b, t, f, c), x.device), 2000),
            "prepare_seam_operands": host_us(lambda: prepare_seam_operands(*args), 2000),
            "seam_plan": host_us(lambda: seam_plan(n_out, c, sm_count(dev)), 2000),
            "alloc": host_us(lambda: torch.empty(n_out * 2 * c + 8 * c * c, dtype=torch.bfloat16,
                                                 device=dev), 2000),
            "stream": host_us(lambda: _build.stream_of(x), 2000),
        }
        torch.cuda.synchronize()
        times = []
        for _ in range(28):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fused_downsample(x, *args)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        print(json.dumps({"shape": [b, t, f, c], "slices": seam_plan(n_out, c, sm_count(dev)).slices,
                          "max_abs_err": err, "device_us": device, "host_us": host,
                          "event_ms": statistics.median(times[3:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
