#!/usr/bin/env python3
"""Smoke run of conette_torch on one NVIDIA H100: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. print the card (``nvidia-smi`` name and power limit), require sm_90,
   build the CUDA kernels from ``conette_torch/csrc`` into ``build/``;
2. hold each kernel against its plain PyTorch version at every main-path
   shape (batch 8; block and seam in bf16 with layer scale N(0, 0.1), max
   relative error < 0.02; the block also at two ragged shapes, stage 4 of
   a 1 s clip at batch 8 and stage 1 at batch 1, and bit-equal over two
   launches; log-mel on 8 x 10 s of waveform at f32 and bf16
   compute, with and without the bn0 affine, within the tolerances at
   ``LOGMEL_F32_TOL`` and ``LOGMEL_BF16_ATOL``), and time both with CUDA
   events (median of 25 runs after a warm-up): the block both through its
   wrapper (``ms``) and as the launch alone on operands prepared outside
   the timed region (``launch_ms``), and at other splits of its hidden
   layer where its tiles do not fill the card; the log-mel kernel also
   against the unfused bf16 frontend it replaces;
3. build a full-width CoNeTTE (ConvNeXt-Tiny, 6-layer 256-wide decoder,
   8 heads, ff 2048, beam 3, 3..20 tokens) from a seed, with a tokenizer
   fitted on ~4000 generated words, ``save_pretrained`` it, load it back
   with ``conette_torch.conette(path, compute_dtype=torch.bfloat16)`` and
   answer 3 requests of 8 clips of 10 s at 44.1 kHz; each request must run
   1 log-mel, 18 block and 3 seam kernel launches; the kernel encoder is
   held against the plain bf16 encoder on one request, and the f32 path on
   the card against the f32 path on the CPU on two short clips;
4. serve a corpus of 32 WAV and FLAC files (0.8..9.5 s at 44.1 and 32 kHz,
   4 length buckets of 8, so no batch holds silence rows) with
   ``conette_torch.serving``: ``warmup`` for the buckets, then
   ``caption_corpus(..., batch_size=8)`` with a task per clip, 3 times,
   with the host's file decode timed inside each call; results in input
   order with their tasks, and every batch runs 1 + 18 + 3 kernel launches;
5. print a details JSON line, the card line, the ``kernels`` JSON line
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
# block shapes off the 10 s path, checked but not counted a request: stage 4
# of the 1 s corpus bucket at batch 8 (168 pixels, a ragged last tile) and
# stage 1 at batch 1; (B, T, F, C, blocks)
RAGGED_BLOCKS = [(8, 3, 7, 768, 0), (1, 252, 56, 96, 0)]
SPLITS_TRIED = (1, 2, 3, 4, 5, 6, 8)  # hidden-layer splits timed where tiles < SMs
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL = 0.02
LOGMEL_SAMPLES = 320_000  # 10 s at 32 kHz -> 1001 frames
# log-mel, in dB: at f32 the JAX envelope of its kernel; at bf16 the kernel
# and its plain version round at the same points and differ by f32 summation
# order, which can flip one bf16 rounding of a power bin (about 0.017 dB on
# the mel bins that hold it); the affine multiplies differences by its scale
LOGMEL_F32_TOL = dict(atol=2e-3, rtol=1e-4)
LOGMEL_BF16_ATOL = 0.05
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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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

    from conette_torch.kernels.convnext_block import (
        block_plan, convnext_block_reference, fused_convnext_block, launch_block,
        prepare_block_operands, sm_count,
    )
    from conette_torch.kernels.downsample import downsample_reference, fused_downsample

    gen = torch.Generator().manual_seed(0)
    records = []
    for b, t, f, c, depth in [(BATCH, *s) for s in STAGES] + RAGGED_BLOCKS:
        h = 4 * c
        args = (
            randn(gen, (7, 7, 1, c), 0.1, dev), randn(gen, (c,), 0.1, dev),
            randn(gen, (c,), 0.1, dev, shift=1.0), randn(gen, (c,), 0.1, dev),
            randn(gen, (c, h), 0.05, dev), randn(gen, (h,), 0.05, dev),
            randn(gen, (h, c), 0.05, dev), randn(gen, (c,), 0.05, dev),
            randn(gen, (c,), 0.1, dev),  # layer scale N(0, 0.1)
        )
        x = randn(gen, (b, t, f, c), 0.5, dev, torch.bfloat16)
        got = fused_convnext_block(x, *args)
        again = fused_convnext_block(x, *args)
        want = convnext_block_reference(x, *args)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(want, got)
        same_bits = bool(torch.equal(got.view(torch.int16), again.view(torch.int16)))
        p = b * t * f
        flops = 2 * p * c * 2 * h + 98 * p * c
        nbytes = 2 * p * c * 2 + 2 * c * h * 2 + 4 * (49 * c + 5 * c + h)
        bms, by = bound_ms(flops, nbytes)
        # the launch alone, on operands prepared outside the timed region
        ops = prepare_block_operands(*args)
        plan = block_plan(p, c, sm_count(dev))
        rec = dict(
            kernel="convnext_block", shape=[b, t, f, c], per_request=depth, splits=plan.splits,
            max_abs_err=abs_err, max_rel_err=rel_err, ok=rel_err < TOL and same_bits,
            same_bits_twice=same_bits,
            ms=time_ms(lambda: fused_convnext_block(x, *args)),
            launch_ms=time_ms(lambda: launch_block(x, ops, plan)),
            plain_ms=time_ms(lambda: convnext_block_reference(x, *args)),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        )
        if plan.tiles < sm_count(dev) and depth:  # the launch at other splits of the hidden layer
            rec["launch_ms_by_splits"] = {
                s: time_ms(lambda: launch_block(x, ops, plan._replace(
                    splits=s, scratch_shape=(s, p, c) if s > 1 else None)))
                for s in SPLITS_TRIED if s <= h // 64
            }
        records.append(rec)
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
            max_abs_err=abs_err, max_rel_err=rel_err, ok=rel_err < TOL,
            ms=time_ms(lambda: fused_downsample(x, *args)),
            plain_ms=time_ms(lambda: downsample_reference(x, *args)),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        ))
    records += check_logmel(dev, gen)
    for r in records:
        print(f"  {r['kernel']:15s} {r['shape']}{r.get('variant', '')}: abs err "
              f"{r['max_abs_err']:.2e}, rel err {r['max_rel_err']:.2e}, "
              f"kernel {r['ms']:.4f} ms"
              + (f" (launch {r['launch_ms']:.4f} ms, S={r['splits']})" if "launch_ms" in r else "")
              + f", plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", unfused frontend {r['unfused_ms']:.4f} ms" if "unfused_ms" in r else "")
              + (f", launch ms by splits {r['launch_ms_by_splits']}"
                 if "launch_ms_by_splits" in r else ""),
              flush=True)
        if not r["ok"]:
            raise AssertionError(f"{r['kernel']} at {r['shape']} disagrees with its plain version")
    return records


def random_bn0(gen, dev) -> dict:
    import torch

    return {
        "weight": randn(gen, (224,), 0.2, dev, shift=1.0),
        "bias": randn(gen, (224,), 0.3, dev),
        "running_mean": randn(gen, (224,), 5.0, dev, shift=-40.0),
        "running_var": torch.rand((224,), generator=gen).to(dev) * 150 + 50,
    }


def check_logmel(dev, gen) -> list[dict]:
    """The log-mel kernel against ``logmel_reference`` on 8 x 10 s of
    waveform (noise and a chirp; the last clip ends in a second of
    silence), at both compute types, with and without the bn0 affine. The
    main path runs bf16 with the affine (1 launch a request); the unfused
    bf16 frontend that route replaces (``logmel_spectrogram`` +
    ``batch_norm_inference``) is timed beside it."""
    import torch

    from conette_torch.kernels.logmel import fused_logmel, logmel_reference
    from conette_torch.models.convnext import bn0_affine
    from conette_torch.models.layers import batch_norm_inference
    from conette_torch.ops.frontend import DEFAULT_LOGMEL, _mel_matrix, logmel_spectrogram
    from conette_torch.ops.stft import dft_basis

    n = LOGMEL_SAMPLES
    t = torch.arange(n, dtype=torch.float64) / 32000
    chirp = (0.3 * torch.sin(2 * torch.pi * 440 * t * (1 + t))).float()
    x = (torch.randn((BATCH, n), generator=gen) * 0.05 + chirp).to(dev)
    x[-1, n - 32000:] = 0.0
    bn = random_bn0(gen, dev)
    scale, shift = bn0_affine(bn)
    frames = 1 + n // 320
    # the least work: a multiply-add for each nonzero entry of the windowed
    # DFT basis (1024 x 1026, a zero row and two zero columns) and of the
    # mel filterbank (513 x 224, over 99 % zeros), for each frame
    nnz = int(np.count_nonzero(dft_basis(1024))), int(np.count_nonzero(_mel_matrix(DEFAULT_LOGMEL)))
    flops = BATCH * frames * 2 * sum(nnz)
    records = []
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for affine in (True, False):
            kw = dict(bn_scale=scale, bn_shift=shift) if affine else {}
            got = fused_logmel(x, compute_dtype=dtype, **kw)
            want = logmel_reference(x, compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            abs_err, rel_err = errors(want, got)
            if dtype == torch.float32:
                ok = bool(torch.allclose(got, want, **LOGMEL_F32_TOL))
            else:
                gain = float(scale.abs().max()) if affine else 1.0
                ok = abs_err <= LOGMEL_BF16_ATOL * gain
            width = 2 if dtype == torch.bfloat16 else 4
            nbytes = BATCH * n * 4 + BATCH * frames * 224 * 4 + width * sum(nnz)
            bms, by = bound_ms(flops, nbytes,
                               PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
            rec = dict(
                kernel="logmel", shape=[BATCH, n], variant=f" {name}{' +bn0' if affine else ''}",
                per_request=int(dtype == torch.bfloat16 and affine),
                max_abs_err=abs_err, max_rel_err=rel_err, ok=ok,
                ms=time_ms(lambda: fused_logmel(x, compute_dtype=dtype, **kw)),
                plain_ms=time_ms(lambda: logmel_reference(x, compute_dtype=dtype, **kw)),
                bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
            )
            if dtype == torch.bfloat16 and affine:
                rec["unfused_ms"] = time_ms(lambda: batch_norm_inference(
                    bn, logmel_spectrogram(x, compute_dtype=torch.bfloat16)))
            records.append(rec)
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
    from conette_torch.kernels.logmel import logmel_reference
    from conette_torch.models.convnext import (
        LN_EPS, STEM_PADDING, STEM_STRIDE, block_args, bn0_affine, convnext_heads, seam_args,
    )
    from conette_torch.models.layers import conv2d, layer_norm

    scale, shift = bn0_affine(params["bn0"])
    mel = logmel_reference(wav, bn_scale=scale, bn_shift=shift, compute_dtype=compute_dtype)
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


def main_path(dev, work_dir: str):
    """Phase 3: build, save, load and serve a full-width model; returns the
    summary and the loaded bf16 model."""
    import torch

    import conette_torch
    from conette_torch.huggingface.config import CoNeTTEConfig
    from conette_torch.huggingface.model import CoNeTTEModel
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample
    from conette_torch.kernels.logmel import fused_logmel
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
    fused_logmel.launches = 0
    fused_convnext_block.launches = 0
    fused_downsample.launches = 0
    latencies, outputs = [], []
    for r in range(3):
        clips = make_clips(rng, BATCH, 10.0, 44100)
        m0, b0, s0 = fused_logmel.launches, fused_convnext_block.launches, fused_downsample.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(clips, sr=44100, task=tasks)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        mels = fused_logmel.launches - m0
        blocks = fused_convnext_block.launches - b0
        seams = fused_downsample.launches - s0
        assert (mels, blocks, seams) == (1, 18, 3), (mels, blocks, seams)
        assert len(out["cands"]) == BATCH and all(isinstance(c, str) for c in out["cands"])
        assert len(out["tags"]) == BATCH and out["tags_probs"].shape == (BATCH, 527)
        assert np.isfinite(out["lprobs"]).all() and np.isfinite(out["tags_probs"]).all()
        outputs.append(out)
        print(f"  request {r}: {latencies[-1] * 1e3:.1f} ms, {BATCH / latencies[-1]:.2f} clips/s, "
              f"{mels} log-mel + {blocks} block + {seams} seam launches; "
              f"cand 0: {out['cands'][0]!r}", flush=True)
    launches = {"logmel": fused_logmel.launches, "convnext_block": fused_convnext_block.launches,
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
    print("  one request's stages (median of 4, ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()), flush=True)
    profiled = device_busy(model, make_clips(rng, BATCH, 10.0, 44100), tasks)
    print(f"  profiled request: {profiled['wall_ms']:.1f} ms wall, "
          f"{profiled['device_ms']:.1f} ms of kernels (busy share {profiled['busy_share']:.3f}); "
          f"top: {profiled['top']}; the port's kernels (ms): {profiled['ours_ms']}", flush=True)

    total = sum(latencies)
    return dict(
        latency_ms=[x * 1e3 for x in latencies], clips_per_s=3 * BATCH / total, stages_ms=stages,
        profiled_request=profiled,
        launches=launches, encoder_frame_embs_rel_err=fe_err, encoder_clip_abs_err=clip_err,
        f32_card_vs_cpu_tags_abs_err=tag_err, vocab=vocab,
        cands=[o["cands"] for o in outputs],
    ), model


# phase 4's corpus: 8 clips in each of the 1, 3, 5 and 10 s buckets, so
# every batch of 8 is full; each bucket holds 2 of each of WAV / FLAC at
# 44.1 / 32 kHz
CORPUS_SECONDS = (0.8, 2.5, 4.5, 9.5)
CORPUS_FILES = 8 * len(CORPUS_SECONDS)
CORPUS_TASKS = ("clotho", "audiocaps", "macs", "wavcaps_freesound")
CORPUS_RUNS = 3


def serve_corpus(model, work_dir: str) -> dict:
    """Phase 4: write the corpus, warm the buckets up, caption it
    ``CORPUS_RUNS`` times; the host's file decode and resample inside each
    call (every ``load_resample``: the bucket pass for FLAC, then each
    batch's loads) is timed apart from the call."""
    import torch

    from conette_torch.huggingface.preprocessor import bucket_length
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample
    from conette_torch.kernels.logmel import fused_logmel
    from conette_torch.serving import CaptionResult, caption_corpus, warmup
    from conette_torch.utils.audio_io import save_wav
    from conette_torch.utils.flac import save_flac

    rng = np.random.default_rng(5)
    paths, tasks, buckets = [], [], {}
    for i in range(CORPUS_FILES):
        secs = CORPUS_SECONDS[i % 4]
        sr = 44100 if (i // 4) % 2 else 32000
        kind = "flac" if (i // 8) % 2 else "wav"
        path = os.path.join(work_dir, f"clip_{i:02d}.{kind}")
        (save_flac if kind == "flac" else save_wav)(path, make_clips(rng, 1, secs, sr)[0], sr)
        paths.append(path)
        tasks.append(CORPUS_TASKS[(i // 2) % 4])
        blen = bucket_length(int(secs * 32000))
        buckets[blen] = buckets.get(blen, 0) + 1
    n_batches = sum(-(-count // BATCH) for count in buckets.values())
    assert len(buckets) >= 3 and all(count % BATCH == 0 for count in buckets.values()), buckets

    t0 = time.perf_counter()
    warmup(model, bucket_seconds=sorted(b // 32000 for b in buckets), batch_size=BATCH)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    pre = model.preprocessor
    load = pre.load_resample
    decode = [0.0]

    def timed_load(*args, **kwargs):
        t = time.perf_counter()
        out = load(*args, **kwargs)
        decode[0] += time.perf_counter() - t
        return out

    pre.load_resample = timed_load  # instance attribute, removed below
    runs = []
    try:
        for _ in range(CORPUS_RUNS):
            decode[0] = 0.0
            fused_logmel.launches = fused_convnext_block.launches = fused_downsample.launches = 0
            t0 = time.perf_counter()
            results = caption_corpus(model, paths, task=tasks, batch_size=BATCH)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {"logmel": fused_logmel.launches,
                        "convnext_block": fused_convnext_block.launches,
                        "downsample": fused_downsample.launches}
            assert launches == {"logmel": n_batches, "convnext_block": 18 * n_batches,
                                "downsample": 3 * n_batches}, (launches, n_batches)
            assert [r.fname for r in results] == paths
            assert [r.task for r in results] == tasks
            assert all(isinstance(r, CaptionResult) and isinstance(r.caption, str)
                       and np.isfinite(r.lprob) for r in results)
            runs.append(dict(seconds=seconds, clips_per_s=len(paths) / seconds,
                             host_decode_s=decode[0], rest_s=seconds - decode[0]))
    finally:
        del pre.load_resample
    median = statistics.median(r["clips_per_s"] for r in runs)
    print(f"  {len(paths)} files in {len(buckets)} buckets, {n_batches} full batches of {BATCH}: "
          f"warmup {warmup_s:.2f} s; caption_corpus "
          + ", ".join(f"{r['seconds']:.2f} s (host decode {r['host_decode_s']:.2f} s)" for r in runs)
          + f", median {median:.2f} clips/s; {launches} a run; "
          f"first: {results[0].caption!r} ({results[0].task})", flush=True)
    return dict(files=len(paths), buckets=len(buckets), batches=n_batches, warmup_s=warmup_s,
                runs=runs, clips_per_s_median=median, launches=launches,
                captions=[[r.task, r.caption, r.lprob] for r in results])


def breakdown(model, clips: list[np.ndarray]) -> dict:
    """Host clock around each stage of one request, synchronised: host
    load + resample, the bf16 encoder, projection + beam search; and, in
    the same loop and in alternating order, the bf16 encoder with the
    unfused frontend that the log-mel kernel replaces (composed here: the
    plain frontend and bn0, then the same stem, kernel stages and heads)."""
    import torch

    from conette_torch.models.conette import encode_audio, forward_generate
    from conette_torch.models.convnext import convnext_apply, convnext_features, convnext_heads
    from conette_torch.models.layers import batch_norm_inference
    from conette_torch.ops.frontend import logmel_spectrogram

    dev = model.device
    params = model.encoder_params
    bos = torch.full((len(clips),), model.task_token_ids["clotho"], device=dev)
    times: dict[str, list[float]] = {"host_load_resample": [], "encoder": [],
                                     "encoder_unfused_frontend": [], "decoder": []}

    def unfused(wav):
        mel = batch_norm_inference(params["bn0"], logmel_spectrogram(wav, compute_dtype=torch.bfloat16))
        frames, clip = convnext_heads(params, convnext_features(params, mel[..., None].to(torch.bfloat16)))
        return {"frame_embs": frames.transpose(1, 2), "clipwise_output": clip}

    def encoder(wav, lens, fused: bool):
        t0 = time.perf_counter()
        wav_t = torch.from_numpy(wav).to(dev)
        if fused:
            out = convnext_apply(params, wav_t, torch.from_numpy(lens).to(dev),
                                 compute_dtype=torch.bfloat16)
        else:
            out = unfused(wav_t)
        torch.cuda.synchronize()
        times["encoder" if fused else "encoder_unfused_frontend"].append(
            (time.perf_counter() - t0) * 1e3)
        return out

    enc = None
    with torch.inference_mode():
        for i in range(4):
            t0 = time.perf_counter()
            wav, lens = model.preprocessor.load_resample(clips, 44100)
            times["host_load_resample"].append((time.perf_counter() - t0) * 1e3)
            for fused in ((False, True) if i % 2 else (True, False)):
                out = encoder(wav, lens, fused)
                enc = out if fused else enc
            t0 = time.perf_counter()
            memory, pad = encode_audio(model.params, model.model_cfg,
                                       enc["frame_embs"].transpose(1, 2), enc["frame_embs_lens"])
            forward_generate(model.params, model.model_cfg, memory, pad, bos,
                             forbid_rep_mask=model.forbid_rep_mask)
            torch.cuda.synchronize()
            times["decoder"].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def device_busy(model, clips: list[np.ndarray], tasks: list[str]) -> dict:
    """One request under ``torch.profiler``: the kernels' summed device time
    against the request's wall time (one stream, so the sum is the busy
    time; the profiler's own cost lengthens the wall time, so the share is
    a lower bound), the five kernels that take the most of it, and the
    device time of each of the port's own kernels in the request."""
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
    kernels = {"logmel_bf16": ("logmel_bf16_kernel",),
               "convnext_block": ("block_pack_kernel", "block_dwln_kernel",
                                  "convnext_block_kernel", "block_reduce_kernel"),
               "downsample": ("downsample_kernel",)}
    ours = {name: sum(ms for k, ms in rows if any(n in k for n in names))
            for name, names in kernels.items()}
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "top": [[k[:60], round(ms, 3)] for k, ms in top], "ours_ms": ours}


def kernel_line(records: list[dict], launches: dict) -> dict:
    meta = {
        "logmel": ("conette_torch/csrc/logmel.cu", "conette_tpu/ops/pallas/logmel.py:81"),
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
            **({"launch_ms": sum(r["per_request"] * r["launch_ms"] for r in rs)}
               if all("launch_ms" in r for r in rs) else {}),
            "bound_ms": sum(r["per_request"] * r["bound_ms"] for r in rs),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "shapes": [{k: r[k] for k in ("shape", "variant", "per_request", "splits", "ms",
                                          "launch_ms", "plain_ms", "unfused_ms", "bound_ms",
                                          "bound_by", "max_abs_err", "max_rel_err") if k in r}
                       for r in rs],
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

    print("phase 2: kernels vs plain versions, batch 8", flush=True)
    records = check_kernels(dev)

    print("phase 3: main path, 3 requests x 8 clips x 10 s at 44.1 kHz, bf16 encoder", flush=True)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        summary, model = main_path(dev, work)
        print(f"  clips/s over the 3 requests: {summary['clips_per_s']:.2f}", flush=True)
        print(f"phase 4: corpus serving, {CORPUS_FILES} WAV and FLAC files, batch 8", flush=True)
        served = serve_corpus(model, work)

    line = kernel_line(records, summary["launches"])
    for k in line["kernels"]:
        k["serving_launches"] = served["launches"][k["name"]]
        if k["launches"] <= 0 or k["serving_launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on a path")
    print(json.dumps({"card": smi, "records": records, "main_path": summary,
                      "serving": served}), flush=True)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
