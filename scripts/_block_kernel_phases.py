#!/usr/bin/env python3
"""Where the block kernel's time goes, on the card: phase A against the MLP.

    python3 scripts/_block_kernel_phases.py

Builds variants of ``conette_torch/csrc/convnext_block.cu`` with ``nvcc``
into ``build/block_phases/``: the launch as it is (``full``: the pack
kernel, phase A's kernel, the block kernel and, where the plan splits, the
reduction); the launch cut after the pack kernel (``pack_only``) and after
phase A (``to_phase_a``); the block kernel without its hidden chunks
(``no_mlp``: no weight copies, no products; the epilogue writes
``x + scale · b2``); and with GELU taken out of the hidden layer
(``no_gelu``: Hc + b1 goes to the second product as it is). Each is launched through
its C entry point on the same operands at the four stage shapes of a 10 s
clip at batch 8, with the wrapper's ``block_plan``, and timed as device
time: CUDA events around 20 back-to-back launches after a warm-up, the
median of 5 such runs, divided by 20 (the host's calls overlap the
device's work; ``chip_smoke.py`` times each call alone instead). The variants
compute wrong blocks: they exist to time the phases, and only the full one
is held against the plain version (by ``chip_smoke.py``). Prints the
card's name and power limit, then one JSON line of times in ms.
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

STAGES = [(252, 56, 96), (126, 28, 192), (63, 14, 384), (31, 7, 768)]
BATCH = 8


def variants(src: str) -> dict[str, str]:
    chunks = "for (int ch = ch0; ch < ch1; ++ch) {"
    stages = "const int n_stages = (ch1 - ch0) * 2 * K::P;"
    gelu = "__floats2bfloat162_rn(gelu_erf(h0), gelu_erf(h1))"
    after_pack = "  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);"
    block_grid = "  const dim3 grid((n_pix + kRows - 1) / kRows, n_split);"
    for needle in (chunks, stages, gelu, after_pack, block_grid):
        if needle not in src:
            raise SystemExit(f"the kernel source changed; update this script: {needle!r}")
    return {
        "full": src,
        "pack_only": src.replace(after_pack, "  return cudaSuccess;\n" + after_pack),
        "to_phase_a": src.replace(block_grid, "  return cudaSuccess;\n" + block_grid),
        "no_mlp": src.replace(chunks, "for (int ch = ch0; ch < ch0; ++ch) {").replace(
            stages, "const int n_stages = 0;"),
        "no_gelu": src.replace(gelu, "__floats2bfloat162_rn(h0, h1)"),
    }


def build(out: Path) -> dict:
    from conette_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    src = (REPO / "conette_torch/csrc/convnext_block.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
             str(out / f"{name}.cu"), "-o", str(out / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).conette_convnext_block
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(fn, launches: int = 20, runs: int = 5) -> float:
    """Device time of one launch: CUDA events around ``launches``
    back-to-back launches after a warm-up, the median of ``runs``."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("_block_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from conette_torch.kernels.convnext_block import (
        block_plan, prepare_block_operands, sm_count, work_size,
    )

    fns = build(REPO / "build" / "block_phases")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []
    for t, f, c in STAGES:
        h = 4 * c

        def rand(*shape, scale=0.05):
            return (torch.randn(shape, generator=gen) * scale).to(dev)

        args = (rand(7, 7, 1, c), rand(c), rand(c) + 1, rand(c), rand(c, h), rand(h), rand(h, c),
                rand(c), rand(c))
        x = (torch.randn((BATCH, t, f, c), generator=gen) * 0.5).to(dev, torch.bfloat16)
        ops = prepare_block_operands(*args)
        plan = block_plan(BATCH * t * f, c, sm_count(dev))
        work = torch.empty(work_size(c), dtype=torch.bfloat16, device=dev)
        y = torch.empty((plan.tiles * plan.tile_rows, c), dtype=torch.bfloat16, device=dev)
        out = torch.empty_like(x)
        scratch = (torch.empty(plan.scratch_shape, device=dev) if plan.scratch_shape else None)
        row = {"shape": [BATCH, t, f, c], "splits": plan.splits}
        for name, fn in fns.items():
            def launch(fn=fn, name=name):
                code = fn(x.data_ptr(), *(o.data_ptr() for o in ops), work.data_ptr(),
                          y.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                          BATCH, t, f, c, plan.splits, 1e-6,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name} launch failed: {code}")
            row[name] = device_ms(launch)
        print(f"  {row}", flush=True)
        rows.append(row)
    print(json.dumps({"block_kernel_phases_ms": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
