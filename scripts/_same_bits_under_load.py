#!/usr/bin/env python3
"""Same bits under load: the block kernel at (8, 3, 7, 768) and the seam
kernel at (2, 126, 28, 192), launched again and again while a second
process keeps the card busy with captioning requests.

    python3 scripts/_same_bits_under_load.py [--launches 240] [--poison-every 8]

The second process loads a full-width CoNeTTE (built from seeds as
``chip_smoke.py`` phase 3 builds it) with the bf16 encoder and answers
requests of 8 clips of 10 s in a loop until this script stops it. Here each
kernel is launched ``--launches`` times on the same inputs and every output
is compared bit for bit with the first; every ``--poison-every``-th launch
runs on memory that the caching allocator hands over filled with 0xFF or
0x00 (alternately). Prints one JSON line with the card, the launch counts,
the number of launches whose bits differed, the load's request count over
the run and the wall time; exits non-zero on any difference.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EPS = 1e-6

LOAD = r"""
import os, sys, tempfile, time
sys.path.insert(0, {repo!r})
import numpy as np, torch
import conette_torch
from chip_smoke import build_model, make_clips
work = tempfile.mkdtemp(dir={build!r})
model = conette_torch.conette(build_model(work), compute_dtype=torch.bfloat16)
rng = np.random.default_rng(3)
clips = make_clips(rng, 8, 10.0, 44100)
tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
n = 0
while not os.path.exists({stop!r}):
    model(clips, sr=44100, task=tasks)
    torch.cuda.synchronize()
    n += 1
    if n == 1:
        open({ready!r}, "w").close()
print(n, flush=True)
"""


def recycle(byte: int) -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.empty(1 << 30, dtype=torch.uint8, device="cuda")]
    blocks += [torch.empty(1 << 20, dtype=torch.uint8, device="cuda") for _ in range(64)]
    for blk in blocks:
        blk.fill_(byte)
    del blocks
    torch.cuda.synchronize()


def randn(rng, shape, scale, dtype=None, shift=0.0):
    import torch

    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to("cuda", dtype or torch.float32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=240)
    ap.add_argument("--poison-every", type=int, default=8)
    args = ap.parse_args()

    import torch

    from conette_torch.kernels import _build
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.library()

    rng = np.random.default_rng(7)
    c = 768
    block_args = (
        randn(rng, (7, 7, 1, c), 0.1), randn(rng, (c,), 0.1), randn(rng, (c,), 0.1, shift=1.0),
        randn(rng, (c,), 0.1), randn(rng, (c, 4 * c), 0.05), randn(rng, (4 * c,), 0.05),
        randn(rng, (4 * c, c), 0.05), randn(rng, (c,), 0.05), randn(rng, (c,), 0.1),
    )
    block_x = randn(rng, (8, 3, 7, c), 0.5, torch.bfloat16)
    rng = np.random.default_rng(8)
    seam_args = (randn(rng, (192,), 0.1, shift=1.0), randn(rng, (192,), 0.05),
                 randn(rng, (2, 2, 192, 384), 0.05), randn(rng, (384,), 0.05))
    seam_x = randn(rng, (2, 126, 28, 192), 0.5, torch.bfloat16)
    calls = {
        "block_8x3x7x768": lambda: fused_convnext_block(block_x, *block_args, eps=EPS),
        "seam_2x126x28x192": lambda: fused_downsample(seam_x, *seam_args, eps=EPS),
    }
    first = {k: fn().clone() for k, fn in calls.items()}
    torch.cuda.synchronize()

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    stop, ready = os.path.join(build, "_load.stop"), os.path.join(build, "_load.ready")
    for p in (stop, ready):
        if os.path.exists(p):
            os.remove(p)
    load = subprocess.Popen(
        [sys.executable, "-c", LOAD.format(repo=REPO, build=build, stop=stop, ready=ready)],
        stdout=subprocess.PIPE, text=True)
    t_wait = time.perf_counter()
    while not os.path.exists(ready):
        if load.poll() is not None:
            print("the load process ended before its first request", file=sys.stderr)
            return 1
        if time.perf_counter() - t_wait > 600:
            load.kill()
            print("the load process did not answer a request in 600 s", file=sys.stderr)
            return 1
        time.sleep(0.5)

    t0 = time.perf_counter()
    counts = {k: {"launches": 0, "poisoned": 0, "differed": 0} for k in calls}
    try:
        for i in range(args.launches):
            poison = args.poison_every > 0 and i % args.poison_every == args.poison_every - 1
            for name, fn in calls.items():
                if poison:
                    recycle(0xFF if (i // args.poison_every) % 2 == 0 else 0x00)
                out = fn()
                torch.cuda.synchronize()
                rec = counts[name]
                rec["launches"] += 1
                rec["poisoned"] += int(poison)
                if not torch.equal(first[name].view(torch.int16), out.view(torch.int16)):
                    rec["differed"] += 1
    finally:
        open(stop, "w").close()
        try:
            requests = int(load.communicate(timeout=120)[0].split()[-1])
        except Exception:
            load.kill()
            load.wait()
            requests = -1
    wall = time.perf_counter() - t0
    print(json.dumps({"card": smi, "kernels": counts, "load_requests": requests,
                      "load": "a second process answering requests of 8 x 10 s clips, bf16",
                      "wall_s": wall}), flush=True)
    return 0 if all(r["differed"] == 0 for r in counts.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
