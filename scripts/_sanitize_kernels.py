#!/usr/bin/env python3
"""The block kernel at (8, 3, 7, 768) and the seam kernel at (2, 126, 28,
192) under ``compute-sanitizer``'s ``initcheck`` and ``racecheck`` tools.

    python3 scripts/_sanitize_kernels.py

Runs itself once under each tool (``--launch``: build the kernels, launch
each shape twice on the same inputs, compare the bits, synchronise) and
prints one JSON line with the card, each tool's exit code, its own lines
(its error summary, or why it did not run) and the program's last. Exits
non-zero when a tool reports an error; a tool that cannot run on the card
is reported as such.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TOOLS = ("initcheck", "racecheck")
TIMEOUT_S = 300  # a tool that runs longer is reported as such
EPS = 1e-6


def launch() -> int:
    import torch

    from conette_torch.kernels import _build
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample

    _build.library()

    def randn(rng, shape, scale, dtype=torch.float32, shift=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to("cuda", dtype)

    rng = np.random.default_rng(7)
    c = 768
    block = (randn(rng, (7, 7, 1, c), 0.1), randn(rng, (c,), 0.1), randn(rng, (c,), 0.1, shift=1.0),
             randn(rng, (c,), 0.1), randn(rng, (c, 4 * c), 0.05), randn(rng, (4 * c,), 0.05),
             randn(rng, (4 * c, c), 0.05), randn(rng, (c,), 0.05), randn(rng, (c,), 0.1))
    block_x = randn(rng, (8, 3, 7, c), 0.5, torch.bfloat16)
    seam = (randn(rng, (192,), 0.1, shift=1.0), randn(rng, (192,), 0.05),
            randn(rng, (2, 2, 192, 384), 0.05), randn(rng, (384,), 0.05))
    seam_x = randn(rng, (2, 126, 28, 192), 0.5, torch.bfloat16)
    same = {}
    for name, fn in (("block_8x3x7x768", lambda: fused_convnext_block(block_x, *block, eps=EPS)),
                     ("seam_2x126x28x192", lambda: fused_downsample(seam_x, *seam, eps=EPS))):
        a, b = fn().clone(), fn().clone()
        torch.cuda.synchronize()
        same[name] = bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
    print(json.dumps({"same_bits_twice": same}), flush=True)
    return 0 if all(same.values()) else 1


def main() -> int:
    if "--launch" in sys.argv:
        return launch()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    out, failed = {"card": smi, "sanitizer": tool}, False
    for name in TOOLS:
        try:
            proc = subprocess.run([tool, "--tool", name, sys.executable, os.path.abspath(__file__),
                                   "--launch"], capture_output=True, text=True, timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            out[name], failed = {"rc": None, "tail": [f"no end in {TIMEOUT_S} s"]}, True
            continue
        lines = [ln for ln in (proc.stdout + proc.stderr).splitlines() if ln.strip()]
        # the tool's own lines begin with "=========", the program's follow
        out[name] = {"rc": proc.returncode, "tool": [ln for ln in lines if ln.startswith("=====")][:8],
                     "tail": lines[-3:]}
        failed |= proc.returncode != 0 and not any("not supported" in ln for ln in lines)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
