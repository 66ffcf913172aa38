#!/usr/bin/env python3
"""Where the seam kernel's time goes, on the card.

    python3 scripts/_seam_kernel_phases.py

Builds variants of ``conette_torch/csrc/downsample.cu`` with ``nvcc`` into
``build/seam_phases/``: the launch as it is (``full``: the pack kernel and
the seam kernel); the launch cut after the pack kernel (``pack_only``); the
seam kernel without the LayerNorm pass over its A buffers (``no_ln``),
without the input copies into them (``no_x``), without the products
(``no_mma``: the ring still streams W), and without the weight copies
(``no_w``: the producer marks each stage full without filling it), the
weight stream alone (``w_only``: no LayerNorm warps, the products' warps
release each stage as it lands), the input copies and LayerNorm alone
(``ln_only``: no producer, no products), and
returning once its barriers are set up (``empty``: the pack, the two
launches and the CTAs' start). A ``trace`` build has thread 0 of each CTA
write the global timer at each step (``TRACE_MARKS``); its entry gives each
step's mean time a CTA, the spread of the CTAs' starts and the launch's
span in µs. Each is launched through its C entry point
on the same operands at the three seams of a 10 s clip at batch 8 and the
1 s corpus bucket's third seam, with the wrapper's ``seam_plan``, and timed
as device time: 20 launches captured in a CUDA graph (so the host's calls
do not set the pace), CUDA events around a replay, the median of 5
replays, divided by 20. The variants compute wrong seams: they exist to
time the parts; the full one is held against the plain version here too.
Every build has a watchdog (``-DCONETTE_WATCHDOG``): a barrier wait of
about a second traps instead of hanging.
Prints the card's name and power limit, then one JSON line of times in ms.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


SHAPES = [(8, 252, 56, 96), (8, 126, 28, 192), (8, 63, 14, 384), (8, 6, 14, 384)]


def _edit(src: str, edits) -> str:
    for needle, text in edits:
        if src.count(needle) != 1:
            raise SystemExit(f"the kernel source changed; update this script: {needle!r}")
        src = src.replace(needle, text)
    return src


def variants(src: str) -> dict[str, str]:
    after_pack = "  const auto* xb = static_cast<const __nv_bfloat16*>(x);"
    ln = ("      cp_async_wait<K::NA - 2>();\n",
          "      fence_proxy_async();  // the stores, to the products' reads\n")
    copy = "        cp_async16(a + 2 * a_off(m, c), src + (valid ? c : 0), valid ? 16 : 0);\n"
    mma = ("          wgmma_bf16<NS>(acc, smem_desc(a_addr + (st * K::KS + kk) * kA16),\n"
           "                         smem_desc(stage + kk * NS * 32));\n")
    fill = "          mbar_expect_tx(full + 8 * s, K::STAGE_BYTES);\n"
    start = "  const int lane = threadIdx.x % 32;\n"
    ln_role = "  if (threadIdx.x >= K::MMA_THREADS) {  // ---- LayerNorm warpgroups\n"
    producer = "  if (threadIdx.x >= K::MMA_THREADS + K::LN_THREADS) {  // ---- producer warp\n"
    got_a = "      mbar_wait(a_full + 8 * (pc % K::NA), (pc / K::NA) & 1);\n"
    free_a = "      if (lane == 0) mbar_arrive(a_empty + 8 * (pc % K::NA));  // the buffer is free\n"
    stages = "      for (int st = 0; st < K::SPP; ++st, ++it) {\n"
    return {
        "full": src,
        "pack_only": _edit(src, [(after_pack, "  return cudaSuccess;\n" + after_pack)]),
        "no_ln": _edit(src, [(ln[0], ln[0] + "      if (n_out < 0) {\n"), (ln[1], "      }\n" + ln[1])]),
        "no_x": _edit(src, [(copy, "")]),
        "no_mma": _edit(src, [(mma, "")]),
        "no_w": _edit(src, [(fill, "          mbar_arrive(full + 8 * s);\n          continue;\n")]),
        "empty": _edit(src, [(start, "  if (n_out > 0) return;\n" + start)]),
        "w_only": _edit(src, [(ln_role, ln_role + "    if (n_out > 0) return;\n"), (got_a, ""),
                              (mma, ""), (free_a, "")]),
        "ln_only": _edit(src, [(producer, producer + "    if (n_out > 0) return;\n"),
                               (stages, stages.replace("st < K::SPP", "st < K::SPP && n_out < 0"))]),
    }


TRACE_MARKS = ["start"] + [f"{k}_{q}" for q in range(4) for k in ("ln", "mma")] + ["stored", "end"]
TRACE_DEFS = """
__device__ unsigned long long g_seam_trace[1 << 16];
__device__ __forceinline__ unsigned long long seam_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
extern "C" int seam_trace_copy(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_seam_trace, sizeof(unsigned long long) * n));
}
"""


def traced(src: str) -> str:
    """The kernel with thread 0 of each CTA (the products' first thread)
    writing the global timer at ``TRACE_MARKS`` into ``g_seam_trace``, 12
    slots a CTA: its start; for its first work item, when each position's
    LayerNorm was ready (``ln_q``) and its products done (``mma_q``), and
    when the item was stored; the CTA's end; and its number of items."""
    mark = "  if (threadIdx.x == 0 && i == 0) trace[{}] = seam_clock();\n"
    epilogue = ("          *reinterpret_cast<const uint4*>(os + row * K::O_ROW + c8 * 16);\n"
                "    }\n  }\n}\n")
    return _edit(src, [
        ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + TRACE_DEFS),
        ("  const int lane = threadIdx.x % 32;\n",
         "  unsigned long long* trace = g_seam_trace + blockIdx.x * 12;\n"
         "  if (threadIdx.x == 0) trace[0] = seam_clock();\n  const int lane = threadIdx.x % 32;\n"),
        ("      mbar_wait(a_full + 8 * (pc % K::NA), (pc / K::NA) & 1);\n",
         "      mbar_wait(a_full + 8 * (pc % K::NA), (pc / K::NA) & 1);\n  " + mark.format("1 + 2 * q")),
        ("      if (lane == 0) mbar_arrive(a_empty + 8 * (pc % K::NA));  // the buffer is free\n",
         "      if (lane == 0) mbar_arrive(a_empty + 8 * (pc % K::NA));  // the buffer is free\n  "
         + mark.format("2 + 2 * q")),
        (epilogue, epilogue[:-len("  }\n}\n")] + "  " + mark.format(9) + "  }\n"
         "  if (threadIdx.x == 0) {\n    trace[10] = seam_clock();\n    trace[11] = my_items;\n  }\n}\n"),
    ])


def trace_summary(fn_copy, n_cta: int) -> dict:
    """Mean time of each step of a CTA's first work item (µs), the CTA's
    whole time and items, and the launch's span from the first start to
    the last end."""
    import numpy as np

    buf = (ctypes.c_ulonglong * (n_cta * 12))()
    if fn_copy(ctypes.cast(buf, ctypes.c_void_p), n_cta * 12):
        raise RuntimeError("seam_trace_copy failed")
    raw = np.frombuffer(buf, dtype=np.uint64).reshape(n_cta, 12)
    items = raw[:, 11].astype(np.int64)
    t = raw[:, :11].astype(np.float64) / 1e3
    t -= t[:, 0].min()
    steps = {f"{a}->{b}": float(np.mean(t[:, i + 1] - t[:, i]))
             for i, (a, b) in enumerate(zip(TRACE_MARKS[:-1], TRACE_MARKS[1:-1]))}
    return {"first_item_steps_us": steps, "cta_us": float(np.mean(t[:, 10] - t[:, 0])),
            "items_per_cta": [int(items.min()), int(items.max())],
            "start_us_max": float(t[:, 0].max()), "span_us": float(t[:, 10].max())}


def build(out: Path) -> dict:
    from conette_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "downsample.cu").read_text()
    procs = {}
    for name, text in {**variants(src), "trace": traced(src)}.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-DCONETTE_WATCHDOG", "-I", str(_build.CSRC_DIR),
             "-shared",
             str(out / f"{name}.cu"), "-o", str(out / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = lib.conette_downsample
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        if name == "trace":
            lib.seam_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.seam_trace_copy.restype = ctypes.c_int
            fns["trace_copy"] = lib.seam_trace_copy
    return fns


def device_ms(fn, launches: int = 20, runs: int = 5) -> float:
    """Device time of one launch: ``launches`` launches captured in a CUDA
    graph, so no host time sits between them; CUDA events around a replay,
    the median of ``runs``, divided by ``launches``."""
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("_seam_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from conette_torch.kernels.convnext_block import sm_count
    from conette_torch.kernels.downsample import (
        downsample_reference, prepare_seam_operands, seam_plan,
    )

    fns = build(REPO / "build" / "seam_phases")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []
    for b, t, f, c in SHAPES:
        def rand(*shape, scale=0.05):
            return (torch.randn(shape, generator=gen) * scale).to(dev)

        ops = prepare_seam_operands(rand(c) + 1, rand(c), rand(2, 2, c, 2 * c), rand(2 * c))
        x = (torch.randn((b, t, f, c), generator=gen) * 0.5).to(dev, torch.bfloat16)
        plan = seam_plan(b * (t // 2) * (f // 2), c, sm_count(dev))
        work = torch.empty(8 * c * c, dtype=torch.bfloat16, device=dev)
        out = torch.empty((b, t // 2, f // 2, 2 * c), dtype=torch.bfloat16, device=dev)
        row = {"shape": [b, t, f, c], "slices": plan.slices, "ctas": plan.ctas}
        trace_copy = fns.pop("trace_copy")
        for name, fn in fns.items():
            def launch(fn=fn, name=name):
                code = fn(x.data_ptr(), *(o.data_ptr() for o in ops), work.data_ptr(),
                          out.data_ptr(), b, t, f, c, plan.slices, plan.ctas, x.device.index, 1e-6,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name} launch failed: {code}")
            if name == "full":  # the build timed here computes the seam
                launch()
                torch.cuda.synchronize()
                want = downsample_reference(x, *ops).float()
                row["full_rel_err"] = float((out.float() - want).abs().max() / want.abs().max())
                if row["full_rel_err"] >= 0.02:
                    raise SystemExit(f"the full build disagrees with the plain version: {row}")
            if name == "trace":
                for _ in range(3):
                    launch()
                torch.cuda.synchronize()
                row[name] = trace_summary(trace_copy, plan.ctas)
            else:
                row[name] = device_ms(launch)
        fns["trace_copy"] = trace_copy
        print(f"  {row}", flush=True)
        rows.append(row)
    print(json.dumps({"seam_kernel_phases_ms": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
