#!/usr/bin/env python3
"""Where the log-mel kernel's time goes, on the card.

    python3 scripts/_logmel_kernel_phases.py            # every variant, timed
    python3 scripts/_logmel_kernel_phases.py --check    # the full build, checked only

Builds variants of ``conette_torch/csrc/logmel.cu`` with ``nvcc`` into
``build/logmel_phases/``: the kernel as it is (``full``); the basis ring
alone (``ring_only``: the producer streams every stage, the consumers wait
for each and release it, no span, no products); the DFT without the band
products (``no_mel``: the power is formed, the mel sum stays zero); without
the epilogue's stores (``no_epilogue``); without the span load
(``no_span``: the products read whatever shared memory holds); without the
basis copies (``no_copy``: the producer marks each stage full without
filling it, so the products run on stale stages); all four cuts at once
(``dft_only``: the DFT loop and its barriers); without the A fragments'
``ldmatrix`` after each chunk's first stage (``no_ldmatrix``); without the
DFT products (``no_wgmma``); two design alternatives that compute the
same log-mel, each chunk's 128 columns as two independent n64 accumulator
chains (``split_n``) and one product group in flight instead of two
(``one_group``); and returning once its barriers are set up (``empty``:
the launch and the CTAs' start). Each is
launched through its C entry point on the same operands (bf16 with the
bn0 affine, the wrapper's packed operands) at batch 8 x 10 s and at the
1 s corpus bucket, and timed as device time: 20
launches captured in a CUDA graph (so the host's calls do not set the
pace), CUDA events around a replay, the median of 5 replays, divided by
20. The variants compute wrong log-mels: they exist to time the parts; the
full one is held against the plain version here too. Every build has a
watchdog (``-DCONETTE_WATCHDOG``): a barrier wait of about a second traps
instead of hanging.

``--check`` builds the full variant alone, prints its ``ptxas`` report,
and holds it against ``logmel_reference`` at every card-test shape (bf16
and f32, with the affine), with the same bits over two launches; it times
nothing.
Prints the card's name and power limit, then one JSON line.
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

TIMED_SHAPES = [(8, 320_000), (8, 32_000)]
ALTERNATIVES = ("split_n", "one_group")  # variants that compute the full log-mel
# (B, S, fmax): the card tests' shapes
CHECK_SHAPES = [(8, 320_000, 14_000.0), (8, 32_000, 14_000.0), (2, 50_000, 14_000.0),
                (3, 12_800, 14_000.0), (2, 513, 14_000.0), (2, 22_400, 16_000.0)]


def _edit(src: str, edits) -> str:
    for needle, text in edits:
        if src.count(needle) != 1:
            raise SystemExit(f"the kernel source changed; update this script: {needle!r}")
        src = src.replace(needle, text)
    return src


def variants(src: str) -> dict[str, str]:
    consumer = "  } else {  // ---- consumer warpgroup: threads 0 .. 127\n"
    ring_loop = (
        "    if (S > 0) {\n"
        "      for (int g = 0; g < n_stages; ++g) {\n"
        "        mbar_wait(full + 8 * (g % ring), (g / ring) & 1);\n"
        "        __syncwarp();\n"
        "        if (lane == 0) mbar_arrive(empty + 8 * (g % ring));\n"
        "      }\n"
        "      mbar_wait(fb_bar, 0);\n"
        "      return;\n"
        "    }\n")
    band = "      switch (__ldg(bands + 3 * j + 2)) {\n"
    store = "    for (int i0 = 0; i0 < kQuads; i0 += kEpi) {\n"
    span = "      for (int q0 = threadIdx.x; q0 < quads; q0 += kU * kConsumers) {\n"
    fill = "        mbar_expect_tx(full + 8 * s, kStageBytes);\n"
    start = "  const int lane = threadIdx.x % 32;\n  if (threadIdx.x >= kConsumers) {"
    ldsm = "        ldmatrix_x4(a[kk], a_base + 2 * koff[st * kStageSteps + kk]);\n"
    mma = "        wgmma_bf16<128>(acc, a[kk], smem_desc(stage_addr + kk * kStepBytes));\n"
    no_copy = (fill, "        mbar_arrive(full + 8 * s);\n        continue;\n")
    no_span = (span, span.replace("q0 < quads", "S < 0 && q0 < quads"))
    no_mel = (band, band.replace("switch", "if (S < 0) switch"))
    no_epilogue = (store, store.replace("(int i0 = 0; i0", "(int i0 = S < 0 ? 0 : kQuads; i0"))
    return {
        "full": src,
        "ring_only": _edit(src, [(consumer, consumer + ring_loop)]),
        "no_mel": _edit(src, [no_mel]),
        "no_epilogue": _edit(src, [no_epilogue]),
        "no_span": _edit(src, [no_span]),
        "no_copy": _edit(src, [no_copy]),
        "dft_only": _edit(src, [no_copy, no_span, no_mel, no_epilogue]),
        "no_ldmatrix": _edit(src, [(ldsm, "        if (st == 0)\n" + ldsm)]),
        "no_wgmma": _edit(src, [(mma, "")]),
        "split_n": _edit(src, [(mma, (
            "      {\n"
            "        wgmma_bf16<64>(*reinterpret_cast<float(*)[8][4]>(&acc[0]), a[kk],\n"
            "                       smem_desc(stage_addr + kk * kStepBytes));\n"
            "        wgmma_bf16<64>(*reinterpret_cast<float(*)[8][4]>(&acc[8]), a[kk],\n"
            "                       smem_desc(stage_addr + kk * kStepBytes + kStepBytes / 2));\n"
            "      }\n"))]),
        "one_group": _edit(src, [("      wgmma_wait<2>();\n      if (st >= 2) release();\n",
                                  "      wgmma_wait<1>();\n      if (st >= 1) release();\n"),
                                 ("      fence_regs(acc);\n      release();\n      release();\n",
                                  "      fence_regs(acc);\n      release();\n")]),
        "empty": _edit(src, [(start, "  if (S > 0) return;\n" + start)]),
    }


def build(out: Path, names=None) -> tuple[dict, str]:
    from conette_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "logmel.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        if names and name not in names:
            continue
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-DCONETTE_WATCHDOG", "-I", str(_build.CSRC_DIR),
             "-shared", str(out / f"{name}.cu"), "-o", str(out / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{logs[name]}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).conette_logmel
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, logs.get("full", "")


def device_ms(fn, launches: int = 20, runs: int = 5) -> float:
    """Device time of one launch: ``launches`` launches captured in a CUDA
    graph, CUDA events around a replay, the median of ``runs``, divided by
    ``launches``."""
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


def _inputs(b: int, s: int, dev, seed: int = 0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = np.arange(s) / 32000
    x = 0.05 * rng.standard_normal((b, s)) + 0.3 * np.sin(2 * np.pi * 440 * t * (1 + t))
    x[-1, s - s // 4:] = 0.0
    scale = torch.from_numpy((1.0 + 0.3 * rng.standard_normal(224)).astype(np.float32)).to(dev)
    shift = torch.from_numpy(rng.standard_normal(224).astype(np.float32)).to(dev)
    return torch.from_numpy(x.astype(np.float32)).to(dev), scale, shift


def _launcher(fn, x, ops, scale, shift, out, cfg):
    import torch

    from conette_torch.kernels.logmel import log_ref

    b, s = x.shape
    use_bf16 = ops.bands is not None

    def launch():
        code = fn(x.data_ptr(), ops.basis.data_ptr(), ops.fb.data_ptr(),
                  ops.bands.data_ptr() if use_bf16 else None, scale.data_ptr(), shift.data_ptr(),
                  out.data_ptr(), b, s, 1 + s // cfg.hop_length, cfg.hop_length, ops.n_chunks,
                  ops.fb_elems, int(use_bf16), cfg.amin, log_ref(cfg),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
    return launch


def check(fn) -> list[dict]:
    """The full build against the plain version at every shape, and the
    same bits over two launches; raises on a disagreement."""
    import torch

    from conette_torch.kernels.logmel import _operands, logmel_reference
    from conette_torch.ops.frontend import LogMelConfig

    dev = torch.device("cuda")
    rows = []
    for b, s, fmax in CHECK_SHAPES:
        cfg = LogMelConfig(fmax=fmax)
        x, scale, shift = _inputs(b, s, dev, seed=s)
        t = 1 + s // cfg.hop_length
        row = {"shape": [b, s], "fmax": fmax}
        for dtype in (torch.bfloat16, torch.float32):
            ops = _operands(cfg, dev, dtype)
            want = logmel_reference(x, cfg, scale, shift, compute_dtype=dtype)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            out, again = (torch.full((b, t, 224), float("nan"), device=dev) for _ in range(2))
            _launcher(fn, x, ops, scale, shift, out, cfg)()
            _launcher(fn, x, ops, scale, shift, again, cfg)()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            row[f"{name}_abs_err"] = err
            if dtype == torch.bfloat16:
                ok = err <= 0.05 * float(scale.abs().max())
            else:
                ok = bool(torch.allclose(out, want, atol=2e-3, rtol=1e-4))
            row[f"{name}_same_bits_twice"] = bool(torch.equal(out.view(torch.int32),
                                                              again.view(torch.int32)))
            row[f"{name}_ok"] = ok and row[f"{name}_same_bits_twice"]
        print(f"  {row}", flush=True)
        rows.append(row)
        if not (row["bf16_ok"] and row["f32_ok"]):
            raise SystemExit(f"the full build disagrees with the plain version: {row}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("_logmel_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from conette_torch.kernels.logmel import _operands
    from conette_torch.ops.frontend import DEFAULT_LOGMEL

    only_check = "--check" in sys.argv[1:]
    fns, log = build(REPO / "build" / "logmel_phases", {"full"} if only_check else None)
    print("\n".join(line for line in log.splitlines()
                    if "logmel" in line or "registers" in line or "spill" in line
                    or "wgmma" in line.lower()), flush=True)
    checked = check(fns["full"])
    if only_check:
        print(json.dumps({"logmel_kernel_check": checked}), flush=True)
        return 0

    dev = torch.device("cuda")
    ops = _operands(DEFAULT_LOGMEL, dev, torch.bfloat16)
    rows = []
    for b, s in TIMED_SHAPES:
        x, scale, shift = _inputs(b, s, dev)
        out = torch.empty((b, 1 + s // 320, 224), device=dev)
        row = {"shape": [b, s]}
        # the design alternatives compute the same log-mel: the same bits
        ref = torch.empty_like(out)
        _launcher(fns["full"], x, ops, scale, shift, ref, DEFAULT_LOGMEL)()
        for name in ALTERNATIVES:
            _launcher(fns[name], x, ops, scale, shift, out, DEFAULT_LOGMEL)()
            torch.cuda.synchronize()
            row[f"{name}_same_bits"] = bool(torch.equal(ref.view(torch.int32), out.view(torch.int32)))
        row["device_ms"] = {name: device_ms(_launcher(fn, x, ops, scale, shift, out, DEFAULT_LOGMEL))
                            for name, fn in fns.items()}
        print(f"  {row}", flush=True)
        rows.append(row)
    print(json.dumps({"logmel_kernel_phases_ms": rows, "check": checked}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
