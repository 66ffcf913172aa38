#!/usr/bin/env python3
"""Smoke run of conette_torch on one NVIDIA H100: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. print the card (``nvidia-smi`` name and power limit), require sm_90,
   build the CUDA kernels from ``conette_torch/csrc`` into ``build/``;
2. hold each kernel against its plain PyTorch version at every main-path
   shape (bf16, batch 8, layer scale N(0, 0.1)), max relative error < 0.02,
   and time both with CUDA events (median of 25 runs after a warm-up);
3. build a full-width CoNeTTE (ConvNeXt-Tiny, 6-layer 256-wide decoder,
   8 heads, ff 2048, beam 3, 3..20 tokens) from a seed, with a tokenizer
   fitted on ~4000 generated words, ``save_pretrained`` it, load it back
   with ``conette_torch.conette(path, compute_dtype=torch.bfloat16)`` and
   answer 3 requests of 8 clips of 10 s at 44.1 kHz; each request must run
   18 block and 3 seam kernel launches; the kernel encoder is held against
   the plain bf16 encoder on one request, and the f32 path on the card
   against the f32 path on the CPU on two short clips;
4. print a details JSON line, the card line, the ``kernels`` JSON line
   and, last, the device JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH = 8
# (T, F, C, blocks) of each stage for a 10 s clip, and the seam inputs
STAGES = [(252, 56, 96, 3), (126, 28, 192, 3), (63, 14, 384, 9), (31, 7, 768, 3)]
SEAMS = [(252, 56, 96), (126, 28, 192), (63, 14, 384)]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL = 0.02
REPO = os.path.dirname(os.path.abspath(__file__))


def time_ms(fn, runs: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` runs after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def errors(want, got) -> tuple[float, float]:
    diff = (want.float() - got.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-6)


def randn(gen, shape, scale, device, dtype=None, shift=0.0):
    import torch

    t = torch.randn(shape, generator=gen) * scale + shift
    return t.to(device, dtype or torch.float32)


def check_kernels(dev) -> list[dict]:
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns per-shape records."""
    import torch

    from conette_torch.kernels.convnext_block import convnext_block_reference, fused_convnext_block
    from conette_torch.kernels.downsample import downsample_reference, fused_downsample

    gen = torch.Generator().manual_seed(0)
    records = []
    for t, f, c, depth in STAGES:
        h = 4 * c
        args = (
            randn(gen, (7, 7, 1, c), 0.1, dev), randn(gen, (c,), 0.1, dev),
            randn(gen, (c,), 0.1, dev, shift=1.0), randn(gen, (c,), 0.1, dev),
            randn(gen, (c, h), 0.05, dev), randn(gen, (h,), 0.05, dev),
            randn(gen, (h, c), 0.05, dev), randn(gen, (c,), 0.05, dev),
            randn(gen, (c,), 0.1, dev),  # layer scale N(0, 0.1)
        )
        x = randn(gen, (BATCH, t, f, c), 0.5, dev, torch.bfloat16)
        got = fused_convnext_block(x, *args)
        want = convnext_block_reference(x, *args)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(want, got)
        p = t * f
        flops = BATCH * (2 * p * c * 2 * h + 98 * p * c)
        nbytes = BATCH * 2 * p * c * 2 + 2 * c * h * 2 + 4 * (49 * c + 5 * c + h)
        bms, by = bound_ms(flops, nbytes)
        records.append(dict(
            kernel="convnext_block", shape=[BATCH, t, f, c], per_request=depth,
            max_abs_err=abs_err, max_rel_err=rel_err,
            ms=time_ms(lambda: fused_convnext_block(x, *args)),
            plain_ms=time_ms(lambda: convnext_block_reference(x, *args)),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        ))
    for t, f, c in SEAMS:
        args = (
            randn(gen, (c,), 0.1, dev, shift=1.0), randn(gen, (c,), 0.05, dev),
            randn(gen, (2, 2, c, 2 * c), 0.05, dev), randn(gen, (2 * c,), 0.05, dev),
        )
        x = randn(gen, (BATCH, t, f, c), 0.5, dev, torch.bfloat16)
        got = fused_downsample(x, *args)
        want = downsample_reference(x, *args)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(want, got)
        p_out = (t // 2) * (f // 2)
        flops = BATCH * 2 * p_out * 4 * c * 2 * c
        nbytes = BATCH * (t * f * c + p_out * 2 * c) * 2 + 4 * c * 2 * c * 2 + 4 * 4 * c
        bms, by = bound_ms(flops, nbytes)
        records.append(dict(
            kernel="downsample", shape=[BATCH, t, f, c], per_request=1,
            max_abs_err=abs_err, max_rel_err=rel_err,
            ms=time_ms(lambda: fused_downsample(x, *args)),
            plain_ms=time_ms(lambda: downsample_reference(x, *args)),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        ))
    for r in records:
        print(f"  {r['kernel']:15s} {r['shape']}: rel err {r['max_rel_err']:.2e}, "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        if not r["max_rel_err"] < TOL:
            raise AssertionError(f"{r['kernel']} at {r['shape']} disagrees with its plain version")
    return records


def fit_tokenizer(n_words: int = 4000):
    """A tokenizer fitted on a generated corpus of ``n_words`` distinct words."""
    from conette_torch.tokenization import AACTokenizer

    rng = np.random.default_rng(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, size=rng.integers(4, 9))) for _ in range(2 * n_words)})
    words = words[:n_words]
    sentences = [" ".join(words[i:i + 10]) for i in range(0, n_words, 10)]
    sentences += [" ".join(rng.choice(words, size=12)) for _ in range(200)]
    tok = AACTokenizer()
    tok.fit(sentences)
    return tok


def make_clips(rng: np.random.Generator, n: int, seconds: float, sr: int) -> list[np.ndarray]:
    """Tones, chirps and noise, different in every clip."""
    t = np.arange(int(seconds * sr)) / sr
    clips = []
    for _ in range(n):
        sig = 0.02 * rng.standard_normal(t.shape[0])
        for _ in range(3):
            f0, t0 = rng.uniform(200, 6000), rng.uniform(0, seconds)
            env = np.exp(-((t - t0) ** 2) / (2 * rng.uniform(0.1, 1.0) ** 2))
            sig += rng.uniform(0.05, 0.3) * env * np.sin(2 * np.pi * f0 * t * (1 + 0.1 * t))
        clips.append(sig.astype(np.float32))
    return clips


def plain_encoder(params, wav, compute_dtype):
    """The encoder composed from the kernels' plain versions (what
    ``convnext_apply`` computes off the kernel route), for the same inputs."""
    from conette_torch.kernels.convnext_block import convnext_block_reference
    from conette_torch.kernels.downsample import downsample_reference
    from conette_torch.models.convnext import (
        LN_EPS, STEM_PADDING, STEM_STRIDE, block_args, convnext_heads, seam_args,
    )
    from conette_torch.models.layers import batch_norm_inference, conv2d, layer_norm
    from conette_torch.ops.frontend import logmel_spectrogram

    mel = batch_norm_inference(params["bn0"], logmel_spectrogram(wav, compute_dtype=compute_dtype))
    y = conv2d(params["stem"]["conv"], mel[..., None].to(compute_dtype),
               stride=STEM_STRIDE, padding=STEM_PADDING)
    y = layer_norm(params["stem"]["norm"], y, eps=LN_EPS)
    for i, stage in enumerate(params["stages"]):
        if i:
            y = downsample_reference(y, *seam_args(params["downsample"][i - 1]), eps=LN_EPS)
        for block in stage:
            y = convnext_block_reference(y, *block_args(block), eps=LN_EPS)
    frames, clip = convnext_heads(params, y)
    return frames.transpose(1, 2), clip


def main_path(dev, work_dir: str) -> dict:
    """Phase 3: build, save, load and serve a full-width model."""
    import torch

    import conette_torch
    from conette_torch.huggingface.config import CoNeTTEConfig
    from conette_torch.huggingface.model import CoNeTTEModel
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample
    from conette_torch.models.convnext import convnext_apply, convnext_init

    tok = fit_tokenizer()
    gen = torch.Generator().manual_seed(1)
    encoder = convnext_init(gen)
    for stage in encoder["stages"]:
        for block in stage:  # non-trivial layer scales so the MLPs show
            block["scale"] = torch.randn(block["scale"].shape, generator=gen) * 0.1
    config = CoNeTTEConfig(beam_size=3, min_pred_size=3, max_pred_size=20)
    built = CoNeTTEModel(config, encoder_params=encoder, tokenizer=tok, seed=2, device=dev)
    ckpt = os.path.join(work_dir, "ckpt")
    built.save_pretrained(ckpt)
    del built
    model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
    vocab = model.model_cfg.vocab_size
    print(f"  model: vocab {vocab}, device {model.device}", flush=True)

    rng = np.random.default_rng(3)
    tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
    fused_convnext_block.launches = 0
    fused_downsample.launches = 0
    latencies, outputs = [], []
    for r in range(3):
        clips = make_clips(rng, BATCH, 10.0, 44100)
        b0, s0 = fused_convnext_block.launches, fused_downsample.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(clips, sr=44100, task=tasks)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        blocks = fused_convnext_block.launches - b0
        seams = fused_downsample.launches - s0
        assert blocks == 18 and seams == 3, (blocks, seams)
        assert len(out["cands"]) == BATCH and all(isinstance(c, str) for c in out["cands"])
        assert len(out["tags"]) == BATCH and out["tags_probs"].shape == (BATCH, 527)
        assert np.isfinite(out["lprobs"]).all() and np.isfinite(out["tags_probs"]).all()
        outputs.append(out)
        print(f"  request {r}: {latencies[-1] * 1e3:.1f} ms, {BATCH / latencies[-1]:.2f} clips/s, "
              f"{blocks} block + {seams} seam launches; cand 0: {out['cands'][0]!r}", flush=True)
    launches = {"convnext_block": fused_convnext_block.launches,
                "downsample": fused_downsample.launches}

    # the kernel encoder against the plain bf16 encoder, one request's inputs
    with torch.inference_mode():
        wav, lens = model.preprocessor.load_resample(make_clips(rng, BATCH, 10.0, 44100), 44100)
        wav_t = torch.from_numpy(wav).to(dev)
        got = convnext_apply(model.encoder_params, wav_t, torch.from_numpy(lens).to(dev),
                             compute_dtype=torch.bfloat16)
        want_fe, want_clip = plain_encoder(model.encoder_params, wav_t, torch.bfloat16)
        fe_err = errors(want_fe, got["frame_embs"])[1]
        clip_err = (want_clip - got["clipwise_output"]).abs().max().item()
    print(f"  kernel vs plain bf16 encoder: frame_embs rel {fe_err:.2e}, "
          f"clipwise abs {clip_err:.2e}", flush=True)
    assert fe_err < TOL and clip_err < TOL, (fe_err, clip_err)

    # the f32 path on the card against the f32 path on the CPU
    short = make_clips(rng, 2, 1.5, 44100)
    card = conette_torch.conette(ckpt)(short, sr=44100)
    cpu = conette_torch.conette(ckpt, device="cpu")(short, sr=44100)
    tag_err = float(np.abs(card["tags_probs"] - cpu["tags_probs"]).max())
    print(f"  f32 card vs cpu: cands equal {card['cands'] == cpu['cands']}, "
          f"tags_probs abs {tag_err:.2e}", flush=True)
    assert card["cands"] == cpu["cands"], (card["cands"], cpu["cands"])
    assert tag_err < 1e-4
    np.testing.assert_allclose(card["lprobs"], cpu["lprobs"], atol=1e-3)

    stages = breakdown(model, make_clips(rng, BATCH, 10.0, 44100))
    print("  one request's stages (median of 3, ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()), flush=True)
    profiled = device_busy(model, make_clips(rng, BATCH, 10.0, 44100), tasks)
    print(f"  profiled request: {profiled['wall_ms']:.1f} ms wall, "
          f"{profiled['device_ms']:.1f} ms of kernels (busy share {profiled['busy_share']:.3f}); "
          f"top: {profiled['top']}", flush=True)

    total = sum(latencies)
    return dict(
        latency_ms=[x * 1e3 for x in latencies], clips_per_s=3 * BATCH / total, stages_ms=stages,
        profiled_request=profiled,
        launches=launches, encoder_frame_embs_rel_err=fe_err, encoder_clip_abs_err=clip_err,
        f32_card_vs_cpu_tags_abs_err=tag_err, vocab=vocab,
        cands=[o["cands"] for o in outputs],
    )


def breakdown(model, clips: list[np.ndarray]) -> dict:
    """Host clock around each stage of one request, synchronised: host
    load + resample, the bf16 encoder, projection + beam search."""
    import torch

    from conette_torch.models.conette import encode_audio, forward_generate
    from conette_torch.models.convnext import convnext_apply

    dev = model.device
    bos = torch.full((len(clips),), model.task_token_ids["clotho"], device=dev)
    times: dict[str, list[float]] = {"host_load_resample": [], "encoder": [], "decoder": []}
    with torch.inference_mode():
        for _ in range(3):
            t0 = time.perf_counter()
            wav, lens = model.preprocessor.load_resample(clips, 44100)
            t1 = time.perf_counter()
            enc = convnext_apply(model.encoder_params, torch.from_numpy(wav).to(dev),
                                 torch.from_numpy(lens).to(dev), compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            memory, pad = encode_audio(model.params, model.model_cfg,
                                       enc["frame_embs"].transpose(1, 2), enc["frame_embs_lens"])
            forward_generate(model.params, model.model_cfg, memory, pad, bos,
                             forbid_rep_mask=model.forbid_rep_mask)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, v in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
                times[k].append(v * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def device_busy(model, clips: list[np.ndarray], tasks: list[str]) -> dict:
    """One request under ``torch.profiler``: the kernels' summed device time
    against the request's wall time (one stream, so the sum is the busy
    time; the profiler's own cost lengthens the wall time, so the share is
    a lower bound), and the five kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(clips, sr=44100, task=tasks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: CPU op rows carry their kernels' time as well
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    device = sum(ms for _, ms in rows)
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "top": [[k[:60], round(ms, 3)] for k, ms in top]}


def kernel_line(records: list[dict], launches: dict) -> dict:
    meta = {
        "convnext_block": ("conette_torch/csrc/convnext_block.cu",
                           "conette_tpu/ops/pallas/convnext_block.py:568"),
        "downsample": ("conette_torch/csrc/downsample.cu",
                       "conette_tpu/ops/pallas/downsample.py:213"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        rs = [r for r in records if r["kernel"] == name]
        ops_ms = sum(r["per_request"] * r["flops"] / PEAK_BF16_FLOPS * 1e3 for r in rs)
        bytes_ms = sum(r["per_request"] * r["bytes"] / PEAK_BYTES * 1e3 for r in rs)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "max_rel_err": max(r["max_rel_err"] for r in rs),
            # per request of 8 x 10 s clips: every launch at its stage's shape
            "ms": sum(r["per_request"] * r["ms"] for r in rs),
            "plain_ms": sum(r["per_request"] * r["plain_ms"] for r in rs),
            "bound_ms": sum(r["per_request"] * r["bound_ms"] for r in rs),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "shapes": [{k: r[k] for k in ("shape", "per_request", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "max_rel_err")} for r in rs],
        })
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if torch.cuda.get_device_capability(0) != (9, 0):
        print(f"chip_smoke: needs an sm_90 card, got {torch.cuda.get_device_name(0)}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from conette_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)

    print("phase 2: kernels vs plain versions, bf16, batch 8", flush=True)
    records = check_kernels(dev)

    print("phase 3: main path, 3 requests x 8 clips x 10 s at 44.1 kHz, bf16 encoder", flush=True)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        summary = main_path(dev, work)
    print(f"  clips/s over the 3 requests: {summary['clips_per_s']:.2f}", flush=True)

    line = kernel_line(records, summary["launches"])
    for k in line["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    print(json.dumps({"card": smi, "records": records, "main_path": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
