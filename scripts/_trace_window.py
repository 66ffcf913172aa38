#!/usr/bin/env python3
"""Which kernels does a ``torch.profiler`` trace keep? Traces of the port's
warm request, of the eager bf16 encoder and of that encoder captured as a
bare CUDA graph, each taken with the active window opened by 0, 8, 32 or
128 one-element kernels, or by ``utils/profiling.active_step``.

    python3 scripts/_trace_window.py [--reps 3]

The traces are taken where ``chip_smoke.py`` takes its phase 8 trace: the
script runs ``chip_smoke.py``'s phases 1-4 (the same output) and then, in
place of phase 8, loads that full-width model again (bf16 encoder; 8 clips
of 10 s) and traces each scope ``--reps`` times under each variant. A
variant ``opening_N`` warms the profiler up with one kernel (discarded),
opens its active step, launches ``N`` kernels of ``torch.cuda._sleep``
(``spin_kernel``), synchronises and runs the scope; ``active_step`` is the
port's, which opens with ``OPENING_KERNELS``. For each trace the script
counts the kernel events of the scope (all but ``spin_kernel``), the
``spin_kernel`` events and the log-mel kernel's events, and prints one line
a trace and, last, one JSON line with the card and, per variant and scope,
the fewest scope kernels kept, the most kept, the traces that kept the
log-mel kernel and the opening kernels kept.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def opening(n: int):
    @contextlib.contextmanager
    def window(prof):
        import torch

        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            torch.cuda._sleep(10)
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
        prof.step()

    return window


def captured(run):
    """``run`` captured as a bare CUDA graph; returns its replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return graph.replay


def experiment(reps: int, card: str):
    def phase(ckpt, corpus, work_dir, smi):
        import torch

        import chip_smoke
        import conette_torch
        from conette_torch.models.convnext import convnext_apply
        from conette_torch.utils.profiling import OPENING_KERNEL_NAME, active_step, profiler

        model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
        tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
        clips = chip_smoke.make_clips(np.random.default_rng(8), 8, 10.0, 44100)
        model(clips, sr=44100, task=tasks)
        wav, lens = model.preprocessor.load_resample(clips, 44100)
        wav_t = torch.from_numpy(wav).cuda()
        lens_t = torch.from_numpy(np.asarray(lens)).cuda().long()

        def encoder():
            return convnext_apply(model.encoder_params, wav_t, lens_t, compute_dtype=torch.bfloat16)

        variants = {f"opening_{n}": opening(n) for n in (0, 8, 32, 128)}
        variants["active_step"] = active_step
        tally: dict = {}
        path = os.path.join(work_dir, "trace.json")
        with torch.inference_mode():
            scopes = {"graph_encoder": captured(encoder), "eager_encoder": encoder,
                      "request": lambda: model(clips, sr=44100, task=tasks)}
            for vname, window in variants.items():
                for sname, run in scopes.items():
                    for rep in range(reps):
                        prof = profiler()
                        prof.start()
                        with window(prof):
                            run()
                        prof.stop()
                        prof.export_chrome_trace(path)
                        with open(path) as f:
                            kernels = [e["name"] for e in json.load(f)["traceEvents"]
                                       if e.get("cat") == "kernel"]
                        opened = sum(OPENING_KERNEL_NAME in k for k in kernels)
                        got = {"scope_kernels": len(kernels) - opened, "opening_kernels": opened,
                               "logmel": sum("logmel_bf16_kernel" in k for k in kernels)}
                        print(json.dumps({"variant": vname, "scope": sname, "rep": rep, **got}),
                              flush=True)
                        t = tally.setdefault(f"{vname}/{sname}", {
                            "traces": 0, "fewest_scope_kernels": None, "most_scope_kernels": 0,
                            "kept_logmel": 0, "opening_kernels_kept": []})
                        t["traces"] += 1
                        fewest = t["fewest_scope_kernels"]
                        t["fewest_scope_kernels"] = (got["scope_kernels"] if fewest is None
                                                     else min(fewest, got["scope_kernels"]))
                        t["most_scope_kernels"] = max(t["most_scope_kernels"], got["scope_kernels"])
                        t["kept_logmel"] += got["logmel"] > 0
                        t["opening_kernels_kept"].append(opened)
        print(json.dumps({"card": card, "torch": torch.__version__, "reps": reps, "tally": tally}),
              flush=True)
        raise SystemExit(0)

    return phase


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import subprocess

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("_trace_window: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    chip_smoke.parallel_phase = experiment(args.reps, card)
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
