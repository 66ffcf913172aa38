#!/usr/bin/env python3
"""Smoke run of conette_torch on one NVIDIA H100: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. print the card (``nvidia-smi`` name and power limit), require sm_90,
   build the CUDA kernels from ``conette_torch/csrc`` into ``build/``;
2. hold each kernel against its plain PyTorch version at every main-path
   shape (batch 8; block and seam in bf16 with layer scale N(0, 0.1), max
   relative error < 0.02; the block also at the 1 s corpus bucket's four
   stages and at stage 1 at batch 1, the seam also at the 1 s bucket's
   three seams (odd T, ragged tiles) and at (2, 126, 28, 192); log-mel on
   8 x 10 s of waveform at f32 and bf16 compute, with and without the bn0
   affine, and on the 1 s corpus bucket at bf16 with it, within the
   tolerances at ``LOGMEL_F32_TOL`` and ``LOGMEL_BF16_ATOL``, its silent
   tail on the -100 dB floor; every kernel bit-equal over two launches,
   over the 28 launches of its timed wrapper calls and on memory that the
   caching allocator hands over poisoned with 0xFF bytes against zeroed
   memory), and time them with CUDA events (median of 25 runs after a
   warm-up): the block and the seam both through their wrappers (``ms``)
   and as the launch alone on operands prepared outside the timed region
   (``launch_ms``), and at other splits of the block's hidden layer or
   slices of the seam's columns where their tiles do not fill the card;
   the seam beside ``F.layer_norm`` + ``F.conv2d`` (``library_ms``, two
   calls); the log-mel kernel also against the unfused bf16 frontend it
   replaces;
3. build a full-width CoNeTTE (ConvNeXt-Tiny, 6-layer 256-wide decoder,
   8 heads, ff 2048, beam 3, 3..20 tokens) from a seed, with a tokenizer
   fitted on ~4000 generated words, ``save_pretrained`` it, load it back
   with ``conette_torch.conette(path, compute_dtype=torch.bfloat16)`` and
   answer 3 requests of 8 clips of 10 s at 44.1 kHz: the first captures
   the encoder graph and the decode graph (each kernel launched for the
   warm-up and once in the capture), the others replay them; a replayed
   request's profile must show 1 log-mel, 18 block and 3 seam kernels;
   the replays of the decode graph at beam 3 and greedy, under
   ``torch.cuda.set_sync_debug_mode("error")``, are held against eager
   calls of ``encode_audio`` and ``forward_generate`` / ``forward_greedy``
   on the same encoder output (equal tokens, lprobs within 1e-5); the
   kernel encoder is held against the plain bf16 encoder on one request,
   and the f32 path on the card against the f32 path on the CPU on two
   short clips; a request of 3 clips must replay the same programs (padded
   to their 8 rows) and capture nothing; stage times, capture times, graph
   memory and the device's busy share of a replayed request; then the
   decode's early exit (``guarded_decode``): the projection and beam 3
   captured with each step under a CUDA graph conditional node against
   the same program running every step, with caption lengths forced by
   ``eos_schedule`` at ``target_lengths`` (the JAX bench's Clotho draws,
   seed 7) for 1, 3 and 8 clips on f32 and bf16 memory: the same bits
   (also after a full-length replay and when captured on memory poisoned
   with 0xFF and 0x00), the steps run equal to the longest scripted length
   among the real rows (a counting twin), and each replay's device time
   guarded against fixed-step in 20 turns of one replay each, each replay
   behind a ~1 ms spin so that its events hold no host launch (each
   program's minimum and median, and the median of the turns' ratios), at
   each size and at full length (random weights), printed with the card's
   name and power limit; the cost of the conditional nodes alone, around
   bodies of 1 and of 300 kernels (``conditional_node_cost_us``); and the
   model's own request decode (beam 3 and greedy), corpus batch and
   sharded caption function, guarded against fixed-step, bit-equal at full
   length and with every caption ended at ``min_pred_size`` by the
   classifier's EOS bias;
   without conditional nodes the run fails;
4. serve a corpus of 32 WAV and FLAC files (0.8..9.5 s at 44.1 and 32 kHz,
   4 length buckets of 8, so no batch holds silence rows) with
   ``conette_torch.serving``: ``warmup`` for the buckets (which captures
   their programs), then ``caption_corpus(..., batch_size=8)`` with a task
   per clip, 3 times, with the host's file decode timed inside each call,
   and once more under the profiler, where every batch must run 1 + 18 +
   3 kernels; results in input order with their tasks;
5. export the model at batch 8 x 10 s with ``conette_torch.export``, save
   it, load it and replay it: its log-mel node must compute in bf16, its
   tokens must equal the live graph path's on the same padded batch, its
   clip probabilities and lprobs must agree with them within 1e-6 and
   1e-5, and its profile must show 1 + 18 + 3 custom-op calls and 18 + 3
   block and seam kernels (its log-mel kernel rows are printed: the trace
   loses them at random late in the run);
6. train: pack a corpus with ``conette_torch/data/hdf.py`` (4 x 512 train
   items of (31, 768) f32 embeddings, 128 val and 128 test items with 5
   captions each, 3..20 of ``fit_tokenizer``'s 4000 words a caption);
   hold one training step on the card against the same step on the CPU
   (batch 512, dropout 0, a fixed mixup (λ, pairing), no augmentation:
   loss within 1e-5, gradients and post-step parameters within 1e-4, each
   relative to its largest value, the elements whose gradient sign is
   rounding held to 2·lr apart); time the production step (CUDA events
   around 10 steps after a warm-up; samples/s, peak memory) and check that
   the loss falls over 8 steps on one repeated batch; run ``main_train``
   with ``expt=hp_clotho_v2`` (pl/conette's d_model 256 x 6 layers, 8
   heads, ff 2048, dropout 0.2 / 0.5, mixup 0.4, label smoothing 0.2;
   AdamW lr 5e-4, wd 2.0 with the split, cos_decay, clip 1, SpecAugmentRatio
   on the embeddings; bsize 512), 2 epochs, checkpoints on the validation
   loss, validation and test at beam 3; then load the run directory with
   ``CoNeTTEModel.from_pretrained(run_dir, device="cuda")`` and the bf16
   encoder, caption 8 x 10 s clips (2 + 36 + 6 wrapper launches as the
   first request captures, 18 + 3 block and seam kernels in a profiled
   replay, its log-mel call held as phase 5 holds it: the eager bf16
   encoder on its waveforms launches 1 + 18 + 3 and gives its clip
   probabilities; the decode replay held against eager calls);
7. prepare, host audio and the PANN encoders: write a local corpus (96
   WAV clips of 1-29.5 s at 44.1, 48 and 32 kHz, mono and stereo, and 32
   FLAC clips of 1-2 s; dev, val and test subsets with a captions CSV
   each); build the native audio loader and hold ``load_batch`` against
   the numpy route on 32 of the WAVs (2e-5); pack each subset with
   ``conette_torch.prepare.main_prepare([..., "--debug"])`` on the default
   device (the full-width ConvNeXt-Tiny at f32 through the preprocessor's
   captured encoder programs, batch 8; no kernel launch, the f32 route is
   the plain one), timing the host's decode and resample apart from the
   encoder calls; read the packs back and hold 4 dev rows against the f32
   encoder on the CPU over the same batch (1e-4); run ``main_train`` on
   the packs for 1 epoch of 2 steps (``dm.bsize`` 32) and caption 2 files
   from its run directory on the card; run Cnn10, Cnn14,
   Cnn14_DecisionLevelAtt and the 16 architectures and heads of
   ``models/pann_zoo.py`` (``ZOO_NAMES``: ResNet22/38/54, MobileNetV1/V2,
   Cnn6, the three Wavegram encoders, LeeNet11/24, DaiNet19,
   Res1dNet31/51, Cnn14_DecisionLevelMax/Avg; their batch norms
   randomised, their conv biases zero) at full width on 8 x 10 s clips at
   f32 (time a call: median of 5) and hold each against the CPU on one
   clip (1e-4 of the largest value); stage the registry's 8 zoo
   checkpoints in the reference's layout under ``CONETTE_CKPT_DIR``, load
   each with ``load_registry_pann`` (equal to the staged tree bit for bit)
   and run it on the card against the same CPU reference; run
   ``get_frontend`` for all six names on one clip, card against CPU;
8. the parallel layer (run right after phase 4, on its corpus): (a) in a
   one-process NCCL group at full width, ``make_sharded_caption_fn`` on a
   1 x 1 mesh over 8 x 10 s clips gives ``caption_batch``'s tokens bit for
   bit, launches every kernel as it captures and runs 1 log-mel, 18 block
   and 3 seam kernels in a profiled call; ``utils/profiling.trace`` around
   a warm request writes a trace that names the three kernels; and
   ``make_sharded_train_step`` at batch 512 equals ``make_train_step``
   (``STEP_TOL``); (b) two processes spawned on the one card over gloo: the
   DP = 2 step (256 rows a rank) against the one-process step, and
   ``caption_corpus(mesh=)`` over phase 4's 32 files against one process
   captioning 4 rows a program (each rank's share of a batch of 8); (c)
   ``train/tune.find_max_batch_size`` on the production step from 512 rows;
9. the encoders' training mode (after phase 7): (a) a full-width
   ConvNeXt-Tiny (layer scales N(0, 0.1), bn0 drawn) trains on 8 x 10 s at
   32 kHz through ``convnext_apply(deterministic=False,
   drop_path_rate=0.1, gen=..., spec_augment_fn=<SpecAugmentRatio>)``,
   binary cross-entropy of the clip probabilities against random
   multi-hot targets, a global-norm clip and the port's AdamW: 5 timed
   steps at f32 and 5 at bf16 compute (median CUDA-event step, peak
   memory); a profiled bf16 step runs no custom op and no kernel of ours
   (its route is the plain ops, as the JAX package's); the deterministic
   bf16 encoder on the same waveforms, before and after the steps, launches
   1 + 18 + 3 kernels and gives the same bits; one step at 2 x 10 s, f32,
   card against CPU (``ENC_TRAIN_TOL``); (b) Cnn14 trains 5 timed steps
   through ``pann_apply(deterministic=False, gen=...)`` with its dropout;
   the zoo's training-mode forwards (batch statistics, no dropout) and the
   gradients of Cnn14 (the same dropout masks, drawn on the CPU),
   ResNet38, MobileNetV2, Res1dNet51 and Wavegram-Logmel-Cnn14, card
   against CPU at 2 x 10 s, f32 (``PANN_REL_TOL``, ``ENC_TRAIN_TOL``, and
   past them the conditioning bound at ``COND``);
10. print a details JSON line (also written to
   ``chiprun_out/chip_smoke_details.json``), the card line, the ``kernels``
   JSON line and, last, the device JSON line.

Beside ``main``: ``parallel_alone()`` runs phase 8 on its own, and
``multicard()`` holds the parallel layer across the four cards of a host
(NCCL, one process a card) to one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

BATCH = 8
# (T, F, C, blocks) of each stage for a 10 s clip, and the seam inputs
STAGES = [(252, 56, 96, 3), (126, 28, 192, 3), (63, 14, 384, 9), (31, 7, 768, 3)]
SEAMS = [(252, 56, 96), (126, 28, 192), (63, 14, 384)]
# the seam inputs of the 1 s corpus bucket at batch 8 (101 frames, 27 rows
# after the stem): odd T at the first two seams, a ragged last tile at all
RAGGED_SEAMS = [(27, 56, 96), (13, 28, 192), (6, 14, 384)]
# block shapes off the 10 s path, checked but not counted a request: the 1 s
# corpus bucket's four stages at batch 8 (stage 4: 168 pixels, a ragged
# last tile, split 44 ways) and stage 1 at batch 1; (B, T, F, C, blocks)
RAGGED_BLOCKS = [(8, 27, 56, 96, 0), (8, 13, 28, 192, 0), (8, 6, 14, 384, 0),
                 (8, 3, 7, 768, 0), (1, 252, 56, 96, 0)]
# seam shapes of the card tests, checked here too: (B, T, F, C)
CARD_SEAMS = [(2, 126, 28, 192)]
SPLITS_TRIED = (1, 2, 3, 4, 5, 6, 8)  # hidden-layer splits timed where tiles < SMs
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL = 0.02
LOGMEL_SAMPLES = 320_000  # 10 s at 32 kHz -> 1001 frames
LOGMEL_BUCKET_SAMPLES = 32_000  # the 1 s corpus bucket -> 101 frames
# log-mel, in dB: at f32 the JAX envelope of its kernel; at bf16 the kernel
# and its plain version round at the same points and differ by f32 summation
# order, which can flip one bf16 rounding of a power bin (about 0.017 dB on
# the mel bins that hold it); the affine multiplies differences by its scale
LOGMEL_F32_TOL = dict(atol=2e-3, rtol=1e-4)
LOGMEL_BF16_ATOL = 0.05
REPO = os.path.dirname(os.path.abspath(__file__))


def time_ms(fn, runs: int = 25, check=None) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` runs after a warm-up;
    ``check``, if given, is called on what each call returned, outside the
    timed region."""
    import torch

    for _ in range(3):
        out = fn()
        if check is not None:
            check(out)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if check is not None:
            check(out)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def same_bits(a, b) -> bool:
    import torch

    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(bits), b.view(bits)))


def timed_same_bits(fn, first) -> tuple[float, bool]:
    """``time_ms(fn)``, and whether each of its 28 calls gave ``first``'s
    bits: launches back to back, as a request makes them."""
    seen = []
    ms = time_ms(fn, check=lambda out: seen.append(same_bits(first, out)))
    return ms, all(seen)


def recycle(byte: int) -> None:
    """Fill a large and many small cached blocks of the caching allocator
    with ``byte`` and free them, so that the next call's allocations get
    that memory (0xFF is NaN in bf16 and f32)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.empty(1 << 30, dtype=torch.uint8, device="cuda")]
    blocks += [torch.empty(1 << 20, dtype=torch.uint8, device="cuda") for _ in range(64)]
    for blk in blocks:
        blk.fill_(byte)
    del blocks
    torch.cuda.synchronize()


def same_bits_poisoned(fn, first) -> bool:
    """Whether ``fn`` gives ``first``'s bits on zeroed and on 0xFF-poisoned
    recycled memory, twice each."""
    import torch

    outs = []
    for byte in (0x00, 0xFF, 0x00, 0xFF):
        recycle(byte)
        outs.append(fn().clone())
    torch.cuda.synchronize()
    return all(same_bits(first, o) for o in outs)


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
        twice = same_bits(got, again)
        poisoned = same_bits_poisoned(lambda: fused_convnext_block(x, *args), got)
        ms, repeated = timed_same_bits(lambda: fused_convnext_block(x, *args), got)
        p = b * t * f
        flops = 2 * p * c * 2 * h + 98 * p * c
        nbytes = 2 * p * c * 2 + 2 * c * h * 2 + 4 * (49 * c + 5 * c + h)
        bms, by = bound_ms(flops, nbytes)
        # the launch alone, on operands prepared outside the timed region
        ops = prepare_block_operands(*args)
        plan = block_plan(p, c, sm_count(dev))
        rec = dict(
            kernel="convnext_block", shape=[b, t, f, c], per_request=depth, splits=plan.splits,
            max_abs_err=abs_err, max_rel_err=rel_err,
            ok=rel_err < TOL and twice and repeated and poisoned,
            same_bits_twice=twice, same_bits_repeated=repeated, same_bits_poisoned=poisoned, ms=ms,
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
    records += check_seams(dev, gen)
    records += check_logmel(dev, gen)
    for r in records:
        print(f"  {r['kernel']:15s} {r['shape']}{r.get('variant', '')}: abs err "
              f"{r['max_abs_err']:.2e}, rel err {r['max_rel_err']:.2e}, "
              f"kernel {r['ms']:.4f} ms"
              + (f" (launch {r['launch_ms']:.4f} ms, S={r['splits']})" if "splits" in r else "")
              + (f" (launch {r['launch_ms']:.4f} ms, {r['slices']} slices)" if "slices" in r else "")
              + (f" (launch {r['launch_ms']:.4f} ms)"
                 if r["kernel"] == "logmel" and "launch_ms" in r else "")
              + f", plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", unfused frontend {r['unfused_ms']:.4f} ms" if "unfused_ms" in r else "")
              + (f", layer_norm + conv2d {r['library_ms']:.4f} ms" if "library_ms" in r else "")
              + (f", launch ms by splits {r['launch_ms_by_splits']}"
                 if "launch_ms_by_splits" in r else "")
              + (f", launch ms by slices {r['launch_ms_by_slices']}"
                 if "launch_ms_by_slices" in r else "")
              + (f", bound over all columns {r['bound_ms_all_columns']:.4f} ms"
                 if "bound_ms_all_columns" in r else "")
              + (f", L2 basis {r['l2_basis_mb']:.1f} MB" if "l2_basis_mb" in r else "")
              + f", same bits twice {r['same_bits_twice']}, repeated {r['same_bits_repeated']}"
              f", poisoned {r['same_bits_poisoned']}",
              flush=True)
        if not r["ok"]:
            raise AssertionError(
                f"{r['kernel']} at {r['shape']}{r.get('variant', '')} fails its check: error "
                f"{r['max_abs_err']:.3e} abs, {r['max_rel_err']:.3e} rel, same bits twice "
                f"{r['same_bits_twice']}, repeated {r['same_bits_repeated']}, poisoned "
                f"{r['same_bits_poisoned']}")
    return records


def library_seam(x, ln_w, ln_b, conv_w, conv_b, eps: float = 1e-6):
    """The seam as two PyTorch calls, the yardstick: ``F.layer_norm`` over C
    on the channels-last bf16 tensor, then cuDNN's ``F.conv2d`` with an OIHW
    bf16 weight, returned as NHWC (a view, no copy). The port never calls
    these."""
    import torch.nn.functional as F

    t = x.shape[1] - x.shape[1] % 2
    y = F.layer_norm(x[:, :t], (x.shape[-1],), ln_w, ln_b, eps)
    return F.conv2d(y.permute(0, 3, 1, 2), conv_w, conv_b, stride=2).permute(0, 2, 3, 1)


def check_seams(dev, gen) -> list[dict]:
    """The seam kernel against ``downsample_reference`` at the main path's
    three seams (batch 8, 10 s clips) and at the 1 s corpus bucket's (odd T
    at the first two, ragged last tiles), the same bits over two launches;
    timed through its wrapper (``ms``), as the launch alone on operands
    prepared outside the timed region (``launch_ms``), at the other slice
    counts where its tiles do not fill the card, and beside the two-call
    PyTorch yardstick (``library_ms``)."""
    import torch

    from conette_torch.kernels.convnext_block import sm_count
    from conette_torch.kernels.downsample import (
        downsample_reference, fused_downsample, launch_seam, prepare_seam_operands, seam_plan,
        slice_counts,
    )

    records = []
    rows = ([(BATCH, *s, 1) for s in SEAMS] + [(BATCH, *s, 0) for s in RAGGED_SEAMS]
            + [(*s, 0) for s in CARD_SEAMS])
    for b, t, f, c, per_request in rows:
        args = (
            randn(gen, (c,), 0.1, dev, shift=1.0), randn(gen, (c,), 0.05, dev),
            randn(gen, (2, 2, c, 2 * c), 0.05, dev), randn(gen, (2 * c,), 0.05, dev),
        )
        x = randn(gen, (b, t, f, c), 0.5, dev, torch.bfloat16)
        got = fused_downsample(x, *args)
        again = fused_downsample(x, *args)
        want = downsample_reference(x, *args)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(want, got)
        twice = same_bits(got, again)
        poisoned = same_bits_poisoned(lambda: fused_downsample(x, *args), got)
        ms, repeated = timed_same_bits(lambda: fused_downsample(x, *args), got)
        p_out = (t // 2) * (f // 2)
        flops = b * 2 * p_out * 4 * c * 2 * c
        nbytes = b * ((t - t % 2) * f * c + p_out * 2 * c) * 2 + 4 * c * 2 * c * 2 + 4 * 4 * c
        bms, by = bound_ms(flops, nbytes)
        ops = prepare_seam_operands(*args)
        plan = seam_plan(b * p_out, c, sm_count(dev))
        # the yardstick's operands, prepared outside its timed region
        lib = (args[0].to(torch.bfloat16), args[1].to(torch.bfloat16),
               args[2].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                   memory_format=torch.channels_last), args[3].to(torch.bfloat16))
        lib_err = errors(want, library_seam(x, *lib))[1]
        rec = dict(
            kernel="downsample", shape=[b, t, f, c], per_request=per_request,
            slices=plan.slices, max_abs_err=abs_err, max_rel_err=rel_err,
            ok=rel_err < TOL and twice and repeated and poisoned, same_bits_twice=twice,
            same_bits_repeated=repeated, same_bits_poisoned=poisoned, ms=ms,
            launch_ms=time_ms(lambda: launch_seam(x, ops, plan)),
            plain_ms=time_ms(lambda: downsample_reference(x, *args)),
            library_ms=time_ms(lambda: library_seam(x, *lib)), library_rel_err=lib_err,
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        )
        if plan.tiles < sm_count(dev) and b == BATCH:  # the launch at the other slice counts
            rec["launch_ms_by_slices"] = {
                s: time_ms(lambda: launch_seam(x, ops, seam_plan(b * p_out, c, sm_count(dev), s)))
                for s in slice_counts(c)
            }
        records.append(rec)
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
    silence, which must sit on the -100 dB floor without the affine), at
    both compute types, with and without the bn0 affine, and at the 1 s
    corpus bucket (8 x 32 000 samples) at bf16 with the affine; the same
    bits over two launches and over the timed calls; the launch alone
    (``launch_ms``, operands and ``x`` prepared outside the timed region).
    The main path runs bf16 with the affine (1 launch a request); there the
    records also carry the L2 bytes of basis that its CTAs read (from
    shapes: each CTA reads every live column once) and the unfused bf16
    frontend that route replaces (``logmel_spectrogram`` +
    ``batch_norm_inference``) is timed beside it."""
    import torch

    from conette_torch.kernels.logmel import (
        TILE_FRAMES, _identity_affine, _operands, fused_logmel, launch_logmel, live_range,
        logmel_reference,
    )
    from conette_torch.models.convnext import bn0_affine
    from conette_torch.models.layers import batch_norm_inference
    from conette_torch.ops.frontend import DEFAULT_LOGMEL, _mel_matrix, logmel_spectrogram
    from conette_torch.ops.stft import dft_basis

    n = LOGMEL_SAMPLES
    t = torch.arange(n, dtype=torch.float64) / 32000
    chirp = (0.3 * torch.sin(2 * torch.pi * 440 * t * (1 + t))).float()
    x = (torch.randn((BATCH, n), generator=gen) * 0.05 + chirp).to(dev)
    x[-1, n - 32000:] = 0.0
    waves = {n: x, LOGMEL_BUCKET_SAMPLES: x[:, :LOGMEL_BUCKET_SAMPLES].contiguous()}
    bn = random_bn0(gen, dev)
    scale, shift = bn0_affine(bn)
    # the least work: a multiply-add a frame for each nonzero basis entry of
    # the frequencies that the filterbank reads (its live rows: 446 x 2 x
    # 1023 at fmax 14 kHz) and for each nonzero filterbank entry (884);
    # bound_ms_all_columns counts every nonzero basis entry (1024 x 1026, a
    # zero row and two zero columns) instead
    first, last = live_range(DEFAULT_LOGMEL)
    basis = dft_basis(1024)
    live_nnz = int(np.count_nonzero(basis[:, first:last + 1])
                   + np.count_nonzero(basis[:, 513 + first:513 + last + 1]))
    all_nnz = int(np.count_nonzero(basis))
    fb_nnz = int(np.count_nonzero(_mel_matrix(DEFAULT_LOGMEL)))
    cases = [(n, torch.bfloat16, True), (n, torch.bfloat16, False), (n, torch.float32, True),
             (n, torch.float32, False), (LOGMEL_BUCKET_SAMPLES, torch.bfloat16, True)]
    records = []
    for samples, dtype, affine in cases:
        xs = waves[samples]
        frames = 1 + samples // 320
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        kw = dict(bn_scale=scale, bn_shift=shift) if affine else {}
        got = fused_logmel(xs, compute_dtype=dtype, **kw)
        again = fused_logmel(xs, compute_dtype=dtype, **kw)
        want = logmel_reference(xs, compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(want, got)
        twice = same_bits(got, again)
        poisoned = same_bits_poisoned(lambda: fused_logmel(xs, compute_dtype=dtype, **kw), got)
        ms, repeated = timed_same_bits(lambda: fused_logmel(xs, compute_dtype=dtype, **kw), got)
        if dtype == torch.float32:
            ok = bool(torch.allclose(got, want, **LOGMEL_F32_TOL))
        else:
            gain = float(scale.abs().max()) if affine else 1.0
            ok = abs_err <= LOGMEL_BF16_ATOL * gain
        floor_err = None
        if not affine:  # the last second of the last clip is silent: frames -40.. lie in it
            floor_err = float((got[-1, -40:] + 100.0).abs().max())
            ok = ok and floor_err <= 1e-4
        width = 2 if dtype == torch.bfloat16 else 4
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        flops = BATCH * frames * 2 * (live_nnz + fb_nnz)
        nbytes = BATCH * samples * 4 + BATCH * frames * 224 * 4 + width * (live_nnz + fb_nnz)
        bms, by = bound_ms(flops, nbytes, peak)
        bms_all = bound_ms(BATCH * frames * 2 * (all_nnz + fb_nnz),
                           nbytes + width * (all_nnz - live_nnz), peak)[0]
        ops = _operands(DEFAULT_LOGMEL, xs.device, dtype)
        sc, sh = (scale.contiguous(), shift.contiguous()) if affine else _identity_affine(xs.device)
        rec = dict(
            kernel="logmel", shape=[BATCH, samples], variant=f" {name}{' +bn0' if affine else ''}",
            per_request=int(samples == n and dtype == torch.bfloat16 and affine),
            max_abs_err=abs_err, max_rel_err=rel_err, ok=ok and twice and repeated and poisoned,
            same_bits_twice=twice, same_bits_repeated=repeated, same_bits_poisoned=poisoned, ms=ms,
            launch_ms=time_ms(lambda: launch_logmel(xs, ops, sc, sh)),
            plain_ms=time_ms(lambda: logmel_reference(xs, compute_dtype=dtype, **kw)),
            bound_ms=bms, bound_by=by, bound_ms_all_columns=bms_all, flops=flops, bytes=nbytes,
        )
        if floor_err is not None:
            rec["silent_floor_abs_err"] = floor_err
        if dtype == torch.bfloat16 and affine:
            rec["l2_basis_mb"] = BATCH * -(-frames // TILE_FRAMES) * ops.basis.numel() * 2 / 1e6
            if samples == n:
                rec["unfused_ms"] = time_ms(lambda: batch_norm_inference(
                    bn, logmel_spectrogram(xs, compute_dtype=torch.bfloat16)))
        records.append(rec)
    return records


def corpus_words(rng: np.random.Generator, n_words: int = 4000) -> list[str]:
    """``n_words`` distinct generated words, drawn from ``rng``."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, size=rng.integers(4, 9))) for _ in range(2 * n_words)})
    return words[:n_words]


def fit_tokenizer(n_words: int = 4000):
    """A tokenizer fitted on a generated corpus of ``n_words`` distinct words."""
    from conette_torch.tokenization import AACTokenizer

    rng = np.random.default_rng(0)
    words = corpus_words(rng, n_words)
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


def count_launches() -> dict:
    """The three wrappers' launch counts."""
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample
    from conette_torch.kernels.logmel import fused_logmel

    return {"logmel": fused_logmel.launches, "convnext_block": fused_convnext_block.launches,
            "downsample": fused_downsample.launches}


def reset_launches() -> None:
    from conette_torch.kernels.convnext_block import fused_convnext_block
    from conette_torch.kernels.downsample import fused_downsample
    from conette_torch.kernels.logmel import fused_logmel

    fused_logmel.launches = fused_convnext_block.launches = fused_downsample.launches = 0


# a kernel call's one launch of each kernel's main CUDA function, by name in
# a profile (the block's and seam's pack, phase-A and reduction launches are
# part of the same call)
CALL_MARKERS = {"logmel": "logmel_bf16_kernel", "convnext_block": "convnext_block_kernel<",
                "downsample": "seam_kernel<"}
# a train step's kernels by what they do, by name in a profile: the random
# draws (``torch.rand``'s kernel), NCCL's all-reduce and all-gather
STEP_KINDS = {"draws": ("distribution_elementwise",), "all_reduce": ("AllReduce",),
              "all_gather": ("AllGather",)}
OUR_KERNELS = {"logmel": ("logmel_bf16_kernel",),
               "convnext_block": ("block_pack_kernel", "block_dwln_kernel",
                                  "convnext_block_kernel", "block_reduce_kernel"),
               "downsample": ("seam_pack_kernel", "seam_kernel")}


def profiled(run) -> dict:
    """``run()`` under ``torch.profiler``: its wall time, the kernels' summed
    device time (one stream, so the busy time; the profiler's own cost
    lengthens the wall time, so the share is a lower bound), the five
    kernels that take the most, the device time of the port's kernels and
    the number of calls of each (``CALL_MARKERS``)."""
    import torch
    from torch.autograd import DeviceType

    from conette_torch.utils.profiling import OPENING_KERNEL_NAME, active_step, profiler

    # the run as the profiler's one active step, after the kernels that open
    # the window (a trace loses its window's first kernel records)
    with profiler() as prof, active_step(prof):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernel rows only: CPU op rows carry their kernels' time as well
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")
            and OPENING_KERNEL_NAME not in e.key]
    device = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return {
        "wall_ms": wall, "device_ms": device, "busy_share": device / wall,
        "top": [[k[:60], round(ms, 3)] for k, ms, _ in top],
        "ours_ms": {name: sum(ms for k, ms, _ in rows if any(n in k for n in names))
                    for name, names in OUR_KERNELS.items()},
        "calls": {name: sum(n for k, _, n in rows if marker in k)
                  for name, marker in CALL_MARKERS.items()},
        "kinds_ms": {kind: sum(ms for k, ms, _ in rows if any(n in k for n in names))
                     for kind, names in STEP_KINDS.items()},
        # every kernel row of either log-mel kernel (bf16 or f32)
        "logmel_rows": [[k, n, round(ms, 4)] for k, ms, n in rows if "logmel" in k],
        # the custom ops' calls, as the dispatcher records them (none in a
        # graph replay, which bypasses it)
        "op_calls": {name: sum(e.count for e in events if e.key == f"conette_torch::{name}")
                     for name in CALL_MARKERS},
    }


def bos_ids(model, tasks: list[str]) -> np.ndarray:
    """The (B,) BOS ids of ``tasks``, as ``CoNeTTEModel.forward`` maps them."""
    from conette_torch.models.conette import tasks_to_bos_ids

    datasets = [t.split("_")[0] for t in tasks]
    sources = ["_".join(t.split("_")[1:]) or None for t in tasks]
    return tasks_to_bos_ids(model.model_cfg, model.task_token_ids, datasets, sources)


def build_model(work_dir: str) -> str:
    """A full-width checkpoint from seeds, saved under ``work_dir``."""
    import torch

    from conette_torch.huggingface.config import CoNeTTEConfig
    from conette_torch.huggingface.model import CoNeTTEModel
    from conette_torch.models.convnext import convnext_init

    tok = fit_tokenizer()
    gen = torch.Generator().manual_seed(1)
    encoder = convnext_init(gen)
    for stage in encoder["stages"]:
        for block in stage:  # non-trivial layer scales so the MLPs show
            block["scale"] = torch.randn(block["scale"].shape, generator=gen) * 0.1
    config = CoNeTTEConfig(beam_size=3, min_pred_size=3, max_pred_size=20)
    built = CoNeTTEModel(config, encoder_params=encoder, tokenizer=tok, seed=2, device="cpu")
    ckpt = os.path.join(work_dir, "ckpt")
    built.save_pretrained(ckpt)
    return ckpt


def main_path(dev, work_dir: str, smi: str):
    """Phase 3: load and serve a full-width model through its captured
    programs; returns the summary and the loaded bf16 model."""
    import torch

    import conette_torch
    from conette_torch.models.convnext import convnext_apply

    ckpt = build_model(work_dir)
    model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
    vocab = model.model_cfg.vocab_size
    print(f"  model: vocab {vocab}, device {model.device}", flush=True)

    rng = np.random.default_rng(3)
    tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
    reset_launches()
    latencies, outputs, per_request = [], [], []
    for r in range(3):
        clips = make_clips(rng, BATCH, 10.0, 44100)
        before = count_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(clips, sr=44100, task=tasks)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        per_request.append({k: v - before[k] for k, v in count_launches().items()})
        assert len(out["cands"]) == BATCH and all(isinstance(c, str) for c in out["cands"])
        assert len(out["tags"]) == BATCH and out["tags_probs"].shape == (BATCH, 527)
        assert np.isfinite(out["lprobs"]).all() and np.isfinite(out["tags_probs"]).all()
        outputs.append(out)
        print(f"  request {r}: {latencies[-1] * 1e3:.1f} ms, {BATCH / latencies[-1]:.2f} clips/s, "
              f"wrapper launches {per_request[-1]}; cand 0: {out['cands'][0]!r}", flush=True)
    launches = count_launches()
    # the first request runs each kernel for the encoder graph's warm-up and
    # once in its capture; the others replay the graphs, where no wrapper runs
    assert per_request[0] == {"logmel": 2, "convnext_block": 36, "downsample": 6}, per_request
    assert per_request[1] == per_request[2] == {k: 0 for k in launches}, per_request

    # a replayed request: 1 log-mel, 18 block and 3 seam kernel calls
    replay = profiled(lambda: model(make_clips(rng, BATCH, 10.0, 44100), sr=44100, task=tasks))
    print(f"  replayed request under the profiler: {replay['wall_ms']:.1f} ms wall, "
          f"{replay['device_ms']:.1f} ms of kernels (busy share {replay['busy_share']:.3f}); "
          f"kernel calls {replay['calls']}; top: {replay['top']}; the port's kernels (ms): "
          f"{replay['ours_ms']}", flush=True)
    assert replay["calls"] == {"logmel": 1, "convnext_block": 18, "downsample": 3}, replay["calls"]
    # the profiler lengthens the wall time; against the median warm request
    # unprofiled (busy_share above is the profiled request's own)
    replay["busy_share_of_warm_request"] = (replay["device_ms"]
                                            / (statistics.median(latencies[1:]) * 1e3))
    print(f"  its {replay['device_ms']:.1f} ms of kernels against the median warm request: busy "
          f"share {replay['busy_share_of_warm_request']:.3f}", flush=True)

    # fewer clips than the programs' rows: padded, replayed, nothing captured
    # and its stages: host load + resample, encoder, projection + search
    keys = (list(model.preprocessor.graphs.programs), list(model.graphs.programs))
    small_ms, small_stages = [], []
    for n in (3, 3, 8):
        clips = make_clips(rng, n, 10.0, 44100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        small = model(clips, sr=44100, task=tasks[:n])
        torch.cuda.synchronize()
        small_ms.append((time.perf_counter() - t0) * 1e3)
        assert len(small["cands"]) == n and small["preds"].shape[0] == n, small["preds"].shape
        t = [time.perf_counter()]
        wav, lens = model.preprocessor.load_resample(clips, 44100)
        t.append(time.perf_counter())
        audio, a_lens, _ = model.preprocessor.encode(wav, lens)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        cfg = model.model_cfg
        model._generate(audio, a_lens, bos_ids(model, tasks[:n]), model.forbid_rep_mask,
                        cfg.beam_size, cfg.min_pred_size, cfg.max_pred_size)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        small_stages.append([round((b - a) * 1e3, 2) for a, b in zip(t, t[1:])])
    assert (list(model.preprocessor.graphs.programs), list(model.graphs.programs)) == keys
    assert count_launches() == launches, count_launches()
    print(f"  requests of 3, 3 and 8 clips replayed the 8-row programs, no capture: "
          f"{small_ms[0]:.1f}, {small_ms[1]:.1f}, {small_ms[2]:.1f} ms; their stages again "
          f"(load + resample, encoder, decode; ms): {small_stages}", flush=True)

    versus = graphs_vs_eager(model, make_clips(rng, BATCH, 10.0, 44100), tasks)

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

    # the f32 path on the card (its own graphs) against the f32 path on the CPU
    short = make_clips(rng, 2, 1.5, 44100)
    card = conette_torch.conette(ckpt)(short, sr=44100)
    cpu = conette_torch.conette(ckpt, device="cpu")(short, sr=44100)
    tag_err = float(np.abs(card["tags_probs"] - cpu["tags_probs"]).max())
    print(f"  f32 card vs cpu: cands equal {card['cands'] == cpu['cands']}, "
          f"tags_probs abs {tag_err:.2e}", flush=True)
    assert card["cands"] == cpu["cands"], (card["cands"], cpu["cands"])
    assert tag_err < 1e-4
    np.testing.assert_allclose(card["lprobs"], cpu["lprobs"], atol=1e-3)

    stages = breakdown(model, make_clips(rng, BATCH, 10.0, 44100), tasks)
    print("  one request's stages (median of 4, ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    graphs = graph_records(model)
    print(f"  graphs: {graphs}", flush=True)

    guarded = guarded_decode(model, rng, tasks, smi)

    total = sum(latencies)
    return dict(
        latency_ms=[x * 1e3 for x in latencies], clips_per_s=3 * BATCH / total, stages_ms=stages,
        small_requests_ms=small_ms, small_request_stages_ms=small_stages,
        replayed_request=replay, graphs_vs_eager=versus, graphs=graphs, guarded_decode=guarded,
        launches=launches, launches_by_request=per_request, encoder_frame_embs_rel_err=fe_err,
        encoder_clip_abs_err=clip_err, f32_card_vs_cpu_tags_abs_err=tag_err, vocab=vocab,
        cands=[o["cands"] for o in outputs],
    ), model


def graph_records(model) -> dict:
    """Each captured program's key, capture time (its ``capture`` span,
    ``utils/profiling.py``) and device memory (its private pool and static
    inputs)."""
    from conette_torch.utils import profiling

    held = {}
    for owner, cache in (("encoder", model.preprocessor.graphs), ("model", model.graphs)):
        for key, nbytes in cache.memory_bytes().items():
            held[repr(key)] = (owner, nbytes)
    out = {}
    for rec in profiling.records():
        if rec.name == "capture" and rec.attrs["key"] in held:
            owner, nbytes = held[rec.attrs["key"]]
            out[f"{owner}:{rec.attrs['key']}"] = {"capture_s": rec.seconds, "memory_mb": nbytes / 1e6}
    return out


def graphs_vs_eager(model, clips: list[np.ndarray], tasks: list[str]) -> dict:
    """The encoder and decode graphs replayed under
    ``set_sync_debug_mode("error")`` (a host sync raises), and the decode
    replay at beam 3 and greedy against eager calls of ``encode_audio`` and
    ``forward_generate`` / ``forward_greedy`` at f32 on the same encoder
    output: equal tokens, lprobs within 1e-5."""
    import torch

    from conette_torch.models.conette import encode_audio, forward_generate, forward_greedy

    cfg = model.model_cfg
    dev = model.device
    bos = torch.from_numpy(bos_ids(model, tasks)).to(dev)
    forbid = model.forbid_rep_mask
    wav, lens = model.preprocessor.load_resample(clips, 44100)
    model.preprocessor(list(wav))  # the key of a 10 s request: captured by now
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = model.preprocessor(list(wav), x_shapes=np.stack([np.ones(BATCH), lens], 1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    audio, a_lens = batch["audio"].float(), batch["audio_shape"][:, -1]
    out = {}
    for name, beam in (("beam3", 3), ("greedy", 1)):
        args = (audio, a_lens, bos, forbid, beam, cfg.min_pred_size, cfg.max_pred_size)
        model._generate(*args)  # captured on first use
        torch.cuda.synchronize()
        steps: list = []  # the steps run, counted on the card: no host sync either
        torch.cuda.set_sync_debug_mode("error")
        try:
            preds, lprobs, mult_preds, mult_lprobs = model._generate(*args, steps_out=steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        with torch.inference_mode():
            memory, pad = encode_audio(model.params, cfg, audio, a_lens)
            if beam > 1:
                res = forward_generate(model.params, cfg, memory, pad, bos, beam_size=beam,
                                       forbid_rep_mask=forbid)
                want = (res.best_preds, res.best_avg_lprobs, res.global_preds,
                        res.global_avg_lprobs)
            else:
                g = forward_greedy(model.params, cfg, memory, pad, bos, forbid_rep_mask=forbid)
                lp = torch.log_softmax(g.logits.transpose(1, 2), dim=-1)
                sel = lp.gather(-1, g.preds[..., None])[..., 0]
                valid = g.preds != cfg.pad_id
                avg = torch.where(valid, sel, 0.0).sum(dim=1) / valid.sum(dim=1).clamp_min(1)
                want = (g.preds, avg, g.preds[:, None, :], avg[:, None])
        torch.cuda.synchronize()
        equal = bool(torch.equal(preds, want[0]) and torch.equal(mult_preds, want[2]))
        err = max(float((lprobs - want[1]).abs().max()), float((mult_lprobs - want[3]).abs().max()))
        out[name] = {"tokens_equal": equal, "lprobs_max_abs_diff": err,
                     "lengths": (preds != cfg.pad_id).sum(dim=1).tolist(),
                     "decode_steps": int(steps[0][0])}
        assert 1 <= out[name]["decode_steps"] <= cfg.max_pred_size, out[name]
        print(f"  {name}: graph replay (no host sync) vs eager at f32: tokens equal {equal}, "
              f"lprobs max abs diff {err:.2e}", flush=True)
        assert equal and err <= 1e-5, out[name]
    return out


# phase 3's guarded decode: caption lengths (EOS included) drawn as the JAX
# bench draws them from the released checkpoint's Clotho lengths (bench.py,
# not imported: it imports JAX), forced by an EOS bias from step length - 1
LEN_MEAN, LEN_STD, LEN_MIN, LEN_MAX = 11.6, 2.6, 5, 18
LEN_SEED = 7
EOS_FORCE = 1.0e4
GUARD_CLIPS = (1, 3, 8)
GUARD_TURNS = 20
# a spin of ~1 ms at the H100's 1.98 GHz, ahead of each timed replay: longer
# than the host takes to launch a decode graph
SPIN_CYCLES = 2_000_000
# kernels in a body of conditional_node_cost_us: one, and about one decode
# step's (a 20-step decode replay launches ~6 000)
NODE_BODY_KERNELS = (1, 300)


def target_lengths(n: int) -> np.ndarray:
    rng = np.random.default_rng(LEN_SEED)
    return np.clip(np.round(rng.normal(LEN_MEAN, LEN_STD, n)), LEN_MIN, LEN_MAX).astype(np.int32)


def eos_schedule(lengths: np.ndarray, max_pred: int) -> np.ndarray:
    """An EOS bias from step ``length - 1`` on, so that every beam of a clip
    ends after exactly ``length`` tokens."""
    steps = np.arange(max_pred)[None, :]
    return np.where(steps >= lengths[:, None] - 1, EOS_FORCE, 0.0).astype(np.float32)


def counted(guard, steps):
    """``guard``, whose steps also add one to the 0-dim device tensor
    ``steps`` when they run: the count of the steps that a replay ran."""
    def run(flag, body):
        def counted_body():
            body()
            steps.add_(1)
        guard(flag, counted_body)
    return run


def outputs_same_bits(a, b) -> bool:
    """Whether two programs' outputs (float and integer tensors) have the
    same bits."""
    import torch

    return all(same_bits(x, y) if x.is_floating_point() else bool(torch.equal(x, y))
               for x, y in zip(a, b))


def paired_replays_ms(progs: dict, turns: int = GUARD_TURNS) -> dict:
    """CUDA-event times (ms) of ``turns`` turns, each of which replays every
    captured program of ``progs`` once (the order reversed every other
    turn), after one replay each. Each replay is queued behind a spin of
    ``SPIN_CYCLES`` clock cycles, so that the event times hold the card's
    work and not the host's launch of the graph, and is waited for before
    the next: replays queued back to back ran 0.3-0.4 ms slower in second
    place. A program's speed on the card shifts between stretches of a
    process (the decode replay sits near 21 or near 25 ms), so the programs
    are compared turn by turn: each one's times, minimum and median, the
    median host time of its ``graph.replay()`` call (``launch_ms``), and
    for each program after the first the medians over the turns of its time
    over the first's (``ratio_median``) and less the first's
    (``diff_median_ms``)."""
    import torch

    names = list(progs)
    for name in names:
        progs[name].graph.replay()
    torch.cuda.synchronize()
    times: dict = {name: [] for name in names}
    launch: dict = {name: [] for name in names}
    for turn in range(turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            t0 = time.perf_counter()
            progs[name].graph.replay()
            launch[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    out = {"ms": times, "min": {n: min(t) for n, t in times.items()},
           "median": {n: statistics.median(t) for n, t in times.items()},
           "launch_ms": {n: statistics.median(t) for n, t in launch.items()}}
    first = times[names[0]]
    out["ratio_median"] = {n: statistics.median(b / a for a, b in zip(first, times[n]))
                           for n in names[1:]}
    out["diff_median_ms"] = {n: statistics.median(b - a for a, b in zip(first, times[n]))
                             for n in names[1:]}
    return out


def guarded_decode(model, rng: np.random.Generator, tasks: list[str], smi: str) -> dict:
    """Phase 3's early exit: the projection and beam search captured with
    each step under a graph *if* node (``decoding/guard.py``) against the
    same program with every step run, on one request's encoder outputs.

    (a) Scripted lengths: ``forward_generate`` with ``eos_schedule`` of
    ``target_lengths(n)`` for 1, 3 and 8 clips of 10 s, beam 3, on f32 and
    bf16 memory, through ``GraphCache.run_batched`` (8 rows: a short batch
    is padded by repeating its first row). The guarded program gives the
    fixed-step program's bits (best and global tokens and lprobs), also
    when each replay follows one at full length, and when the guarded
    program is captured on memory poisoned with 0xFF and with 0x00; a
    counting twin (``counted``) runs exactly the longest scripted length
    among the real rows. Each program holds ``max_pred_size`` conditional
    nodes. The device time of a replay, fixed-step and guarded in
    ``GUARD_TURNS`` turns (``paired_replays_ms``), at each size and at full
    length (random weights: every beam runs 20 steps).

    (b) The model's own programs: the request decode (``_generate``, beam 3
    and greedy), the corpus batch (``serving.caption_batch``) and
    ``make_sharded_caption_fn`` (no mesh), captured into fresh caches as
    they are (``conditional_step``) and with ``every_step`` in its place
    (``model_programs_guard``): the
    same bits at full length and with the classifier's EOS bias raised by
    ``EOS_FORCE`` (every caption ends at ``min_pred_size``); the request
    decode's replay time, guarded against fixed, at full length."""
    import torch

    from conette_torch.decoding.guard import every_step
    from conette_torch.graphs import REQUEST_BATCH, GraphCache, conditional_step
    from conette_torch.models.conette import encode_audio, forward_generate

    dev = model.device
    cfg = model.model_cfg
    max_p = cfg.max_pred_size
    wav, lens = model.preprocessor.load_resample(make_clips(rng, BATCH, 10.0, 44100), 44100)
    audio, a_lens, _ = model.preprocessor.encode(wav, lens)
    bos = torch.from_numpy(bos_ids(model, tasks)).to(dev)
    out: dict = {"lengths": {n: target_lengths(n).tolist() for n in GUARD_CLIPS}}

    def scripted_fn(guard, dtype):
        def fn(audio, a_lens, bos, sched):
            memory, pad = encode_audio(model.params, cfg, audio, a_lens)
            res = forward_generate(model.params, cfg, memory.to(dtype), pad, bos,
                                   forbid_rep_mask=model.forbid_rep_mask,
                                   eos_bias_schedule=sched, guard=guard)
            return tuple(res)
        return fn

    def inputs(n, sched):
        return (audio[:n], a_lens[:n], bos[:n], torch.from_numpy(sched[:n]).to(dev))

    full = np.zeros((BATCH, max_p), np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        caches = {k: GraphCache(1) for k in ("fixed", "guarded", "counted")}
        fns = {"fixed": scripted_fn(every_step, dtype),
               "guarded": scripted_fn(conditional_step, dtype),
               "counted": scripted_fn(counted(conditional_step, steps), dtype)}

        def run(kind, xs, cache=None):
            return (cache or caches[kind]).run_batched(("scripted", name), fns[kind], xs, dev,
                                                       n_batched=4)

        rec = {}
        for n in GUARD_CLIPS + ("full",):
            lengths = target_lengths(BATCH if n == "full" else n)
            sched = full if n == "full" else eos_schedule(lengths, max_p)
            xs = inputs(BATCH if n == "full" else n, sched)
            want = run("fixed", xs)
            run("guarded", inputs(BATCH, full))  # a full-length replay first
            got = run("guarded", xs)
            run("counted", xs)  # captured on first use: its warm-up counts too
            steps.zero_()
            counted_out = run("counted", xs)
            ran = int(steps)
            expect = max_p if n == "full" else int(lengths.max())
            r = {"same_bits": outputs_same_bits(want, got),
                 "counted_same_bits": outputs_same_bits(want, counted_out),
                 "steps_run": ran, "steps_expected": expect,
                 "lengths": [int(x) for x in (got[2] != cfg.pad_id).sum(-1).max(-1).values]}
            # the device time of a replay on these inputs (both programs
            # hold them from their last call), in turns
            r["replay"] = t = paired_replays_ms(
                {kind: caches[kind].programs[(REQUEST_BATCH, "scripted", name)]
                 for kind in ("fixed", "guarded")})
            rec[str(n)] = r
            print(f"  guarded decode, {name} memory, {n} clips: lengths {r['lengths']}, steps "
                  f"run {ran} (expected {expect}), same bits {r['same_bits']} (counting twin "
                  f"{r['counted_same_bits']}); replay in {GUARD_TURNS} turns, min "
                  f"{t['min']} ms, median {t['median']} ms, guarded / fixed-step median of the "
                  f"turns {t['ratio_median']['guarded']:.4f} "
                  f"({t['diff_median_ms']['guarded']:+.4f} ms); host launch {t['launch_ms']} ms",
                  flush=True)
            assert r["same_bits"] and r["counted_same_bits"] and ran == expect, r
        nodes = {k: c.programs[(REQUEST_BATCH, "scripted", name)].conditional_nodes
                 for k, c in caches.items()}
        assert nodes == {"fixed": 0, "guarded": max_p, "counted": max_p}, nodes
        # the guarded program captured on poisoned memory: a tensor that a
        # skipped body allocated would hold the poison
        xs = inputs(BATCH, eos_schedule(target_lengths(BATCH), max_p))
        want = run("fixed", xs)
        poisoned = []
        for byte in (0xFF, 0x00):
            recycle(byte)
            poisoned.append(outputs_same_bits(want, run("guarded", xs, GraphCache(1))))
        rec["same_bits_poisoned"] = all(poisoned)
        print(f"  guarded decode, {name} memory, captured on memory poisoned with 0xFF and "
              f"0x00: same bits {poisoned}", flush=True)
        assert rec["same_bits_poisoned"], poisoned
        out[name] = rec

    out["model_programs"] = guarded_model_programs(model, wav, lens, bos, smi)
    out["node_cost_us"] = cost = conditional_node_cost_us(dev, max_p)
    for kernels, c in cost.items():
        print(f"  {max_p} conditional nodes around {kernels} one-element adds each: "
              f"{c['per_node_us']:.2f} us a node over the same adds unguarded (median of the "
              f"turns' differences; min {c['min_us']} us, median {c['median_us']} us, host "
              f"launch {c['launch_us']} us) on {smi}", flush=True)
    out["card"] = smi
    table = {name: {n: {"guarded_min_ms": out[name][n]["replay"]["min"]["guarded"],
                        "fixed_min_ms": out[name][n]["replay"]["min"]["fixed"],
                        "guarded_median_ms": out[name][n]["replay"]["median"]["guarded"],
                        "fixed_median_ms": out[name][n]["replay"]["median"]["fixed"],
                        "ratio_median": out[name][n]["replay"]["ratio_median"]["guarded"],
                        "launch_ms": out[name][n]["replay"]["launch_ms"],
                        "steps": out[name][n]["steps_run"]}
                    for n in [str(c) for c in GUARD_CLIPS] + ["full"]}
             for name in ("float32", "bfloat16")}
    out["replay_ms"] = table
    print(f"  decode replay in {GUARD_TURNS} turns of fixed-step and guarded (CUDA events, ms), "
          f"by memory dtype and clips: {json.dumps(table)} on {smi}", flush=True)
    return out


def conditional_node_cost_us(dev, nodes: int) -> dict:
    """What ``nodes`` *if* nodes cost a replay, for bodies of each count of
    ``NODE_BODY_KERNELS`` one-element adds: a program of ``nodes`` bodies,
    each under ``conditional_step`` on a set flag, against the same adds
    unguarded, in ``GUARD_TURNS`` turns (``paired_replays_ms``)."""
    import torch

    from conette_torch.decoding.guard import every_step
    from conette_torch.graphs import GraphCache, conditional_step

    def program(guard, kernels):
        def fn(x):
            flag = torch.ones((), dtype=torch.bool, device=x.device)
            for _ in range(nodes):
                guard(flag, lambda: [x.add_(1) for _ in range(kernels)])
            return (x,)
        return fn

    out = {}
    for kernels in NODE_BODY_KERNELS:
        cache = GraphCache(2)
        x = torch.zeros((), device=dev)
        for kind, guard in (("unguarded", every_step), ("guarded", conditional_step)):
            cache.run((kind,), program(guard, kernels), (x,), dev)
        t = paired_replays_ms({kind: cache.programs[(kind,)] for kind in ("unguarded", "guarded")})
        out[kernels] = {"min_us": {k: v * 1e3 for k, v in t["min"].items()},
                        "median_us": {k: v * 1e3 for k, v in t["median"].items()},
                        "launch_us": {k: v * 1e3 for k, v in t["launch_ms"].items()},
                        "per_node_us": t["diff_median_ms"]["guarded"] * 1e3 / nodes}
    return out


@contextlib.contextmanager
def model_programs_guard(guard):
    """The model's captured searches (``CoNeTTEModel._generate`` and
    ``serving._caption_batch_eager``) with ``guard`` in the place of the
    ``conditional_step`` that they call: the check's seam for their
    fixed-step twins, which are captured into a cache of their own (the
    cache's keys do not hold the guard)."""
    from conette_torch import serving
    from conette_torch.huggingface import model as model_module

    saved = model_module.conditional_step, serving.conditional_step
    model_module.conditional_step = serving.conditional_step = guard
    try:
        yield
    finally:
        model_module.conditional_step, serving.conditional_step = saved


def guarded_model_programs(model, wav, lens, bos, smi: str) -> dict:
    """Part (b) of :func:`guarded_decode`: the model's request decode,
    corpus batch and sharded caption function, guarded against fixed-step."""
    import torch

    from conette_torch.decoding.guard import every_step
    from conette_torch.graphs import GraphCache, conditional_step
    from conette_torch.huggingface.model import MAX_MODEL_GRAPHS
    from conette_torch.serving import caption_batch, make_sharded_caption_fn

    cfg = model.model_cfg
    audio, a_lens, _ = model.preprocessor.encode(wav, lens)
    bos_np = bos.cpu().numpy()
    eos_bias = model.params["decoder"]["classifier"]["bias"]
    eos_saved = eos_bias[cfg.eos_id].clone()  # put back bit for bit
    saved = model.graphs
    paths = {
        "request_beam3": lambda: model._generate(audio, a_lens, bos, model.forbid_rep_mask, 3,
                                                 cfg.min_pred_size, cfg.max_pred_size),
        "request_greedy": lambda: model._generate(audio, a_lens, bos, model.forbid_rep_mask, 1,
                                                  cfg.min_pred_size, cfg.max_pred_size),
        "corpus_batch": lambda: caption_batch(model, wav, lens, bos_np, cfg.beam_size),
        "sharded_caption": lambda: make_sharded_caption_fn(model, None)(wav, lens, bos_np),
    }

    def outputs(res):
        if isinstance(res[0], torch.cuda.Event) or res[0] is None:
            done, *tensors = res
            if done is not None:
                done.synchronize()
            return [t.clone() for t in tensors]
        return [t.clone() for t in res]

    caches = {"fixed": GraphCache(MAX_MODEL_GRAPHS), "guarded": GraphCache(MAX_MODEL_GRAPHS)}
    guards = {"fixed": every_step, "guarded": conditional_step}
    out = {}
    try:
        for length in ("full", "short"):
            if length == "short":  # every caption ends as soon as min_pred_size allows
                eos_bias[cfg.eos_id] += EOS_FORCE
            try:
                for name, call in paths.items():
                    got = {}
                    for kind in ("fixed", "guarded"):
                        model.graphs = caches[kind]
                        with model_programs_guard(guards[kind]):
                            got[kind] = outputs(call())
                    torch.cuda.synchronize()
                    lengths = (got["guarded"][0] != cfg.pad_id).sum(-1)
                    out[f"{name}_{length}"] = r = {
                        "same_bits": outputs_same_bits(got["fixed"], got["guarded"]),
                        "longest": int(lengths.max()), "shortest": int(lengths.min())}
                    print(f"  {name} at {length} length: guarded against fixed-step, same bits "
                          f"{r['same_bits']}, caption lengths {r['shortest']}..{r['longest']}",
                          flush=True)
                    assert r["same_bits"], (name, length)
            finally:
                if length == "short":
                    eos_bias[cfg.eos_id].copy_(eos_saved)
        nodes = {kind: {str(k): p.conditional_nodes for k, p in c.programs.items()}
                 for kind, c in caches.items()}
        out["conditional_nodes"] = nodes
        decode_keys = [k for k in caches["guarded"].programs if "generate" in k or "corpus" in k]
        assert len(decode_keys) == 3 and all(
            caches["guarded"].programs[k].conditional_nodes == cfg.max_pred_size
            for k in decode_keys), nodes["guarded"]
        assert all(n == 0 for n in nodes["fixed"].values()), nodes["fixed"]
        # the request decode at beam 3 and full length (random weights; both
        # programs hold the request's inputs), in turns
        key = next(k for k in caches["fixed"].programs if k[1] == "generate" and k[4] == 3)
        out["request_beam3_full_replay"] = t = paired_replays_ms(
            {kind: caches[kind].programs[key] for kind in ("fixed", "guarded")})
        print(f"  request decode replay at beam 3, full length (random weights), in "
              f"{GUARD_TURNS} turns: min {t['min']} ms, median {t['median']} ms, guarded / "
              f"fixed-step median of the turns {t['ratio_median']['guarded']:.4f} "
              f"({t['diff_median_ms']['guarded']:+.4f} ms), host launch {t['launch_ms']} ms "
              f"on {smi}", flush=True)
    finally:
        model.graphs = saved
    return out


# phase 4's corpus: 8 clips in each of the 1, 3, 5 and 10 s buckets, so
# every batch of 8 is full; each bucket holds 2 of each of WAV / FLAC at
# 44.1 / 32 kHz
CORPUS_SECONDS = (0.8, 2.5, 4.5, 9.5)
CORPUS_FILES = 8 * len(CORPUS_SECONDS)
CORPUS_TASKS = ("clotho", "audiocaps", "macs", "wavcaps_freesound")
CORPUS_RUNS = 3


def write_corpus(work_dir: str) -> tuple[list[str], list[str], dict[int, int]]:
    """Phase 4's ``CORPUS_FILES`` WAV and FLAC files: their paths, tasks and
    the count of files in each length bucket."""
    from conette_torch.huggingface.preprocessor import bucket_length
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
    return paths, tasks, buckets


def serve_corpus(model, work_dir: str) -> dict:
    """Phase 4: write the corpus, warm the buckets up (capturing their
    programs), caption it ``CORPUS_RUNS`` times, then once more under the
    profiler, which counts the kernel calls of the replayed batches; the
    host's file decode and resample inside each call (every
    ``load_resample``: the bucket pass for FLAC, then each batch's loads)
    is timed apart from the call."""
    import torch

    from conette_torch.serving import CaptionResult, caption_corpus, warmup

    paths, tasks, buckets = write_corpus(work_dir)
    n_batches = sum(-(-count // BATCH) for count in buckets.values())
    assert len(buckets) >= 3 and all(count % BATCH == 0 for count in buckets.values()), buckets

    reset_launches()
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
            t0 = time.perf_counter()
            results = caption_corpus(model, paths, task=tasks, batch_size=BATCH)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            assert [r.fname for r in results] == paths
            assert [r.task for r in results] == tasks
            assert all(isinstance(r, CaptionResult) and isinstance(r.caption, str)
                       and np.isfinite(r.lprob) for r in results)
            runs.append(dict(seconds=seconds, clips_per_s=len(paths) / seconds,
                             host_decode_s=decode[0], rest_s=seconds - decode[0]))
    finally:
        del pre.load_resample
    launches = count_launches()  # the warm-up's: every batch since replays its program
    prof = profiled(lambda: caption_corpus(model, paths, task=tasks, batch_size=BATCH))
    want = {"logmel": n_batches, "convnext_block": 18 * n_batches, "downsample": 3 * n_batches}
    assert prof["calls"] == want, (prof["calls"], want)
    assert all(v > 0 for v in launches.values()), launches
    median = statistics.median(r["clips_per_s"] for r in runs)
    print(f"  {len(paths)} files in {len(buckets)} buckets, {n_batches} full batches of {BATCH}: "
          f"warmup {warmup_s:.2f} s (wrapper launches {launches}); caption_corpus "
          + ", ".join(f"{r['seconds']:.2f} s (host decode {r['host_decode_s']:.2f} s)" for r in runs)
          + f", median {median:.2f} clips/s; kernel calls of a profiled call {prof['calls']}; "
          f"first: {results[0].caption!r} ({results[0].task})", flush=True)
    graphs = {k: v for k, v in graph_records(model).items() if "corpus" in k}
    print(f"  corpus graphs: {graphs}", flush=True)
    return dict(paths=paths, tasks=tasks, files=len(paths), buckets=len(buckets), batches=n_batches,
                warmup_s=warmup_s,
                graphs=graphs, runs=runs, clips_per_s_median=median, launches=launches,
                replay_calls=prof["calls"], profiled_call_busy_share=prof["busy_share"],
                captions=[[r.task, r.caption, r.lprob] for r in results])


def export_phase(model, work_dir: str) -> dict:
    """Phase 5: export the bf16 model at batch 8 x 10 s, save, load and
    replay it. The loaded program's log-mel node must compute in bf16; its
    tokens must equal the live graph path's on the same padded batch, its
    clip probabilities and lprobs agree within 1e-6 and 1e-5 (the f32
    encoder's clip probabilities are printed beside, as the gap a dtype
    that drifted would show); its profile must count 1 + 18 + 3 custom-op
    calls and wrapper launches, and 18 + 3 block and seam kernel calls.
    The log-mel kernel's rows are printed, beside those of a profile of the
    eager bf16 encoder on the same batch: before the profile's window was
    opened by kernels of its own (``utils/profiling.active_step``) this
    replay's lacked it in every run (``PERF.md`` §6)."""
    import torch

    from conette_torch.export import ExportedCaptioner, save_exported
    from conette_torch.models.convnext import convnext_apply

    dev = model.device
    art = os.path.join(work_dir, "export")
    t0 = time.perf_counter()
    save_exported(model, art, batch_size=BATCH, clip_seconds=10.0)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap = ExportedCaptioner(art)
    load_s = time.perf_counter() - t0
    logmel_dtypes = [str(n.args[-1]) for n in cap.program.graph.nodes
                     if "conette_torch.logmel" in str(n.target)]
    tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
    rng = np.random.default_rng(7)
    wavs, _ = model.preprocessor.load_resample(make_clips(rng, BATCH, 10.0, 44100), 44100)
    batch, lens, bos = cap.prepare_batch(list(wavs), task=tasks)
    cap.run(batch, lens, bos)  # first use
    torch.cuda.synchronize()
    reset_launches()
    out = []
    prof = profiled(lambda: out.append(cap.run(batch, lens, bos)))
    launches = count_launches()
    wav_t, lens_t = torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev).long()
    with torch.inference_mode():
        eager = profiled(lambda: convnext_apply(model.encoder_params, wav_t, lens_t,
                                                compute_dtype=torch.bfloat16))
    preds, avg, _, _, clip = out[0]
    live = model.preprocessor(list(batch), sr=32000, x_shapes=np.stack([np.ones(BATCH), lens], 1))
    cfg = model.model_cfg
    want = model._generate(live["audio"].float(), live["audio_shape"][:, -1], bos.astype(np.int64),
                           model.forbid_rep_mask, cfg.beam_size, cfg.min_pred_size,
                           cfg.max_pred_size)
    with torch.inference_mode():
        f32_clip = convnext_apply(model.encoder_params, wav_t, lens_t,
                                  compute_dtype=torch.float32)["clipwise_output"]
    equal = bool(torch.equal(preds, want[0]))
    clip_err = float((clip - live["clip_probs"]).abs().max())
    lprob_err = float((avg - want[1]).abs().max())
    f32_gap = float((f32_clip - live["clip_probs"]).abs().max())
    size_mb = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art)) / 1e6
    print(f"  exported at batch {BATCH} x 10 s in {export_s:.1f} s ({size_mb:.1f} MB), loaded in "
          f"{load_s:.1f} s; log-mel nodes at {logmel_dtypes}; replay {prof['wall_ms']:.1f} ms, "
          f"custom-op calls {prof['op_calls']}, wrapper launches {launches}; tokens equal to the "
          f"live graph path: {equal}, clip_probs max abs diff {clip_err:.2e} (the f32 encoder: "
          f"{f32_gap:.2e}), avg lprobs {lprob_err:.2e}", flush=True)
    for name, p in (("the replay", prof), ("the eager bf16 encoder", eager)):
        print(f"  profile of {name}: kernel calls {p['calls']}, log-mel rows {p['logmel_rows']}",
              flush=True)
    assert logmel_dtypes == ["torch.bfloat16"], logmel_dtypes
    assert equal, (preds, want[0])
    assert clip_err <= 1e-6 and lprob_err <= 1e-5, (clip_err, lprob_err)
    want_calls = {"logmel": 1, "convnext_block": 18, "downsample": 3}
    assert prof["op_calls"] == launches == want_calls, (prof["op_calls"], launches)
    # the log-mel call is held by its custom-op row, its wrapper launch and
    # the bit-equal clip probabilities above: its kernel row may be missing
    assert {k: prof["calls"][k] for k in ("convnext_block", "downsample")} == {
        "convnext_block": 18, "downsample": 3}, prof["calls"]
    return dict(export_s=export_s, load_s=load_s, size_mb=size_mb, replay_ms=prof["wall_ms"],
                logmel_dtypes=logmel_dtypes, op_calls=prof["op_calls"], launches=launches,
                kernel_calls=prof["calls"], logmel_rows=prof["logmel_rows"],
                eager_encoder_calls=eager["calls"],
                tokens_equal=equal, clip_probs_max_abs_diff=clip_err,
                avg_lprobs_max_abs_diff=lprob_err, f32_encoder_clip_gap=f32_gap,
                busy_share=prof["busy_share"])


def breakdown(model, clips: list[np.ndarray], tasks: list[str]) -> dict:
    """Host clock around each stage of one request, synchronised: host
    load + resample; the bf16 encoder through its graph and eagerly; the
    projection + beam search through its graph and eagerly (the same f32
    computation); the public API's default f32 encoder (the plain
    frontend) through its graph and eagerly. Graph and eager run in
    alternating order in the same loop. The bf16 encoder's graph stage is
    split: ``encoder_copy_in`` copies the waveforms and lengths into the
    graph's inputs as a request does (through its pinned staging), of which
    ``encoder_stage_host`` is the host's copy into the staging buffers
    (``encoder_stage_host_numpy`` the same by ``np.copyto``, timed only);
    ``encoder_copy_in_pageable`` copies them straight from pageable memory
    (timed only: that copy waits for the stream); ``*_replay`` is the device
    time of a replay alone (CUDA events) and ``*_replay_host`` the host
    clock of the replay call; ``encoder_copy_out`` copies the outputs'
    rows. ``encoder_eager_copy_in`` is the eager path's copy of the same
    arrays."""
    import torch

    from conette_torch.huggingface.preprocessor import CoNeTTEPreprocessor
    from conette_torch.models.conette import encode_audio, forward_generate
    from conette_torch.models.convnext import convnext_apply

    dev = model.device
    cfg = model.model_cfg
    pre = model.preprocessor
    bos = torch.from_numpy(bos_ids(model, tasks)).to(dev)
    f32_pre = CoNeTTEPreprocessor(model.encoder_params, device=dev, compute_dtype=torch.float32)
    times: dict[str, list[float]] = {k: [] for k in (
        "host_load_resample", "encoder", "encoder_copy_in", "encoder_stage_host",
        "encoder_stage_host_numpy", "encoder_copy_in_pageable", "encoder_replay",
        "encoder_replay_host", "encoder_copy_out", "encoder_eager",
        "encoder_eager_copy_in", "encoder_f32", "encoder_f32_replay", "encoder_f32_replay_host",
        "encoder_f32_eager", "decoder", "decoder_replay", "decoder_replay_host",
        "decoder_eager")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def last(cache):
        return next(reversed(cache.programs.values()))  # the program used last

    def replay(name, cache):
        prog = last(cache)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        prog.graph.replay()
        times[name + "_host"].append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end))

    def copy_in(wav, lens):
        with torch.inference_mode():
            last(pre.graphs)._copy_in((wav, lens))

    def stage_host(wav, lens, numpy=False):
        with torch.inference_mode():
            for stage, x in zip(last(pre.graphs).staging, (wav, lens)):
                if numpy:
                    np.copyto(stage.numpy(), x)
                else:
                    stage.copy_(torch.from_numpy(x))

    def copy_in_pageable(wav, lens):
        with torch.inference_mode():
            for dst, x in zip(last(pre.graphs).static_inputs, (wav, lens)):
                dst.copy_(torch.from_numpy(x))

    def copy_out():
        with torch.inference_mode():
            return [o[:BATCH].clone() for o in last(pre.graphs).outputs]

    def eager_encoder(wav, lens, dtype):
        with torch.inference_mode():
            return convnext_apply(model.encoder_params, torch.from_numpy(wav).to(dev),
                                  torch.from_numpy(lens).to(dev), compute_dtype=dtype)

    def eager_decoder(audio, a_lens):
        with torch.inference_mode():
            memory, pad = encode_audio(model.params, cfg, audio, a_lens)
            return forward_generate(model.params, cfg, memory, pad, bos,
                                    forbid_rep_mask=model.forbid_rep_mask)

    for i in range(5):  # the first round captures the f32 encoder: not kept
        wav, lens = timed("host_load_resample", lambda: pre.load_resample(clips, 44100))
        order = (False, True) if i % 2 else (True, False)
        for graph in order:
            if graph:
                audio, a_lens, _ = timed("encoder", lambda: pre.encode(wav, lens))
                timed("encoder_copy_in", lambda: copy_in(wav, lens))
                replay("encoder_replay", pre.graphs)
                timed("encoder_copy_out", copy_out)
                timed("encoder_stage_host", lambda: stage_host(wav, lens))
                timed("encoder_stage_host_numpy", lambda: stage_host(wav, lens, numpy=True))
                timed("encoder_copy_in_pageable", lambda: copy_in_pageable(wav, lens))
                timed("encoder_f32", lambda: f32_pre.encode(wav, lens))
                replay("encoder_f32_replay", f32_pre.graphs)
            else:
                timed("encoder_eager_copy_in",
                      lambda: (torch.from_numpy(wav).to(dev), torch.from_numpy(lens).to(dev)))
                timed("encoder_eager", lambda: eager_encoder(wav, lens, torch.bfloat16))
                timed("encoder_f32_eager", lambda: eager_encoder(wav, lens, torch.float32))
        for graph in order:
            if graph:
                timed("decoder", lambda: model._generate(
                    audio, a_lens, bos, model.forbid_rep_mask, cfg.beam_size, cfg.min_pred_size,
                    cfg.max_pred_size))
                replay("decoder_replay", model.graphs)
            else:
                timed("decoder_eager", lambda: eager_decoder(audio, a_lens))
    return {k: statistics.median(v[1:]) for k, v in times.items()}


# phase 6: the training corpus (10 s clips: 31 frames of 768), as packs of
# ``conette_torch/data/hdf.py``, and the run's settings
TRAIN_BATCHES, EVAL_ITEMS, BSIZE, FRAMES = 4, 128, 512, 31
STEP_TOL = {"loss": 1e-5, "grads": 1e-4, "params": 1e-4}


def pack_corpus(root: str) -> dict:
    """Train (4 x 512 items, one caption each drawn per epoch from 5), val
    and test (128 items, 5 captions each) packs of random (31, 768) f32
    embeddings and captions of 3..20 of ``fit_tokenizer``'s 4000 words."""
    from conette_torch.data.datasets import DictDataset
    from conette_torch.data.hdf import pack_to_hdf

    words = np.asarray(corpus_words(np.random.default_rng(0)))
    out = {}
    for subset, n, seed in (("dev", TRAIN_BATCHES * BSIZE, 11), ("val", EVAL_ITEMS, 12),
                            ("eval", EVAL_ITEMS, 13)):
        rng = np.random.default_rng(seed)
        caps = [[" ".join(rng.choice(words, size=rng.integers(3, 21))) for _ in range(5)]
                for _ in range(n)]
        ds = DictDataset({
            "audio": list(rng.standard_normal((n, FRAMES, 768), dtype=np.float32)),
            "audio_lens": [FRAMES] * n, "captions": caps, "dataset": ["clotho"] * n,
            "subset": [subset] * n, "source": [None] * n,
            "fname": [f"{subset}_{i}.wav" for i in range(n)],
        })
        out[subset] = pack_to_hdf(ds, os.path.join(root, f"clotho_{subset}_emb.hdf"))
    return out


def train_batch(model_cfg, rng: np.random.Generator, b: int = BSIZE) -> dict:
    """A batch as the datamodule gives it: (B, 31, 768) embeddings, lengths,
    and captions (a task token, 3..20 words, EOS, PAD) in the model's vocab."""
    length = 22
    caps = np.full((b, length), model_cfg.pad_id, np.int64)
    for i in range(b):
        n = int(rng.integers(3, 21))
        caps[i, 0] = model_cfg.bos_id
        caps[i, 1:n + 1] = rng.integers(10, model_cfg.vocab_size, n)
        caps[i, n + 1] = model_cfg.eos_id
    return {"audio": rng.standard_normal((b, FRAMES, 768), dtype=np.float32),
            "audio_lens": np.full(b, FRAMES, np.int64), "captions": caps}


def step_card_vs_cpu(model_cfg) -> dict:
    """One training step of the port on the card and on the CPU, from the
    same weights and batch, dropout 0, a fixed (λ, perm), no augmentation,
    clip 1 and AdamW at lr 5e-4, wd 2.0 with the split: the loss, the
    largest gradient difference and the largest post-step parameter
    difference, each relative to the largest value of its kind.

    Adam's first step moves an element by about ``lr·sign(g)``, so where
    the two devices' f32 gradients differ by as much as the gradient itself
    (its sign is rounding: the attention key biases, whose gradient is zero
    in exact arithmetic, and elements of the projection's gradient, a sum
    over 512 x 31 rows of random embeddings that cancels), the step is not
    determined at f32 on either device. Those elements are counted and held
    to 2·lr apart; the parameter ratio is taken over the rest."""
    import torch

    from conette_torch.models.conette import conette_init
    from conette_torch.train import optim, step
    from conette_torch.train.objective import training_loss
    from conette_torch.weights import named_leaves, to_torch

    cfg = model_cfg._replace(proj_dropout_p=0.0, decoder_dropout_p=0.0)
    init = conette_init(torch.Generator().manual_seed(21), cfg)
    batch = train_batch(cfg, np.random.default_rng(22))
    perm = np.random.default_rng(23).permutation(BSIZE)
    perm = perm[(np.argsort(perm) + 1) % BSIZE]  # no fixed point
    lbd, lr = 0.7, 5e-4
    out = {}
    for name, dev in (("cuda", torch.device("cuda")), ("cpu", torch.device("cpu"))):
        params = to_torch(init, dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        override = (lbd, torch.from_numpy(perm).to(dev))

        def loss_fn(p, b, gen):
            return training_loss(p, cfg, b, gen, mixup_override=override)

        opt, _ = optim.get_optimizer(params, lr=lr, weight_decay=2.0, sched_name="none")
        state = step.init_train_state(params, opt)
        leaves = [t for _, t in named_leaves(params)]
        grads = torch.autograd.grad(loss_fn(params, tb, None), leaves)
        state, metrics = step.make_train_step(cfg, grad_clip_norm=1.0, loss_fn=loss_fn)(state, tb, None)
        out[name] = {"loss": metrics["train/loss"].item(),
                     "grads": {k: g.cpu() for (k, _), g in zip(named_leaves(params), grads)},
                     "params": {k: t.detach().cpu() for k, t in named_leaves(state.params)}}
    card, cpu = out["cuda"], out["cpu"]
    gdiff = {k: (card["grads"][k] - cpu["grads"][k]).abs() for k in cpu["grads"]}
    pdiff = {k: (card["params"][k] - cpu["params"][k]).abs() for k in cpu["params"]}
    sign_rounding = {k: (gdiff[k] > 0) & (gdiff[k] >= cpu["grads"][k].abs()) for k in gdiff}
    rounding = {k: int(m.sum()) for k, m in sign_rounding.items() if m.any()}
    res = {
        "loss_card": card["loss"], "loss_cpu": cpu["loss"],
        "loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        "grads": max(float(d.max()) for d in gdiff.values())
        / max(float(g.abs().max()) for g in cpu["grads"].values()),
        "params": max(float(torch.where(sign_rounding[k], 0.0, pdiff[k]).max()) for k in pdiff)
        / max(float(p.abs().max()) for p in cpu["params"].values()),
        "sign_rounding_elements": rounding,
        "sign_rounding_max_abs_diff": max((float(pdiff[k][sign_rounding[k]].max()) for k in rounding),
                                          default=0.0),
        "largest_leaf_grad_rel": sorted(((float(gdiff[k].max() / cpu["grads"][k].abs().max().clamp_min(1e-30)), k)
                                         for k in gdiff), reverse=True)[:3],
    }
    print(f"  one step, card vs cpu (batch {BSIZE}, dropout 0, λ {lbd}, fixed pairing): loss "
          f"{card['loss']:.7f} vs {cpu['loss']:.7f} (rel {res['loss']:.2e}, tol {STEP_TOL['loss']}), "
          f"grads rel {res['grads']:.2e} (tol {STEP_TOL['grads']}), post-step params rel "
          f"{res['params']:.2e} (tol {STEP_TOL['params']}) over all but "
          f"{sum(rounding.values())} elements whose gradient sign is rounding {rounding}: those "
          f"{res['sign_rounding_max_abs_diff']:.2e} apart (tol {2 * lr}); leaves with the largest "
          f"gradient difference to their own largest value: {res['largest_leaf_grad_rel']}", flush=True)
    for k, tol in STEP_TOL.items():
        assert res[k] <= tol, (k, res[k], tol)
    assert res["sign_rounding_max_abs_diff"] <= 2 * lr, res
    return res


def step_timing(model_cfg, aug_fn) -> dict:
    """The production step at full width on the card (dropout, mixup with
    drawn λ and pairing, SpecAugmentRatio on the embeddings, clip 1, AdamW):
    CUDA events around each of 10 steps after a warm-up step, the median,
    samples/s and the peak device memory; then 8 steps on one repeated
    batch with the optimizer live, whose loss must fall."""
    import torch

    from conette_torch.models.conette import conette_init
    from conette_torch.train import optim, step
    from conette_torch.weights import to_torch

    dev = torch.device("cuda")
    params = to_torch(conette_init(torch.Generator().manual_seed(31), model_cfg), dev)
    opt, _ = optim.get_optimizer(params, lr=5e-4, weight_decay=2.0, sched_name="cos_decay",
                                 sched_n_steps=2)
    state = step.init_train_state(params, opt)
    fn = step.make_train_step(model_cfg, grad_clip_norm=1.0)
    gen, aug_gen = torch.Generator(dev).manual_seed(32), torch.Generator(dev).manual_seed(33)
    rng = np.random.default_rng(34)
    batches = []
    for _ in range(11):
        b = {k: torch.from_numpy(v).pin_memory() for k, v in train_batch(model_cfg, rng).items()}
        batches.append(b)

    def one(b):
        tb = {k: v.to(dev, non_blocking=True) for k, v in b.items()}
        tb["audio"] = aug_fn(aug_gen, tb["audio"], time_valid=tb["audio_lens"])
        return fn(state, tb, gen)[1]

    one(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, issue = [], []
    for b in batches[1:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        one(b)
        issue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = [a.elapsed_time(e) for a, e in events]
    peak = torch.cuda.max_memory_allocated() / 2**20
    med = statistics.median(times)
    # one step under the profiler: its kernels' summed device time against
    # the host's time to issue a step (the step's own Python and dispatch)
    prof = profiled(lambda: one(batches[1]))
    losses = [float(one(batches[0])["train/loss"]) for _ in range(8)]
    print(f"  training step at batch {BSIZE} (production settings): median {med:.2f} ms over "
          f"{len(times)} steps (min {min(times):.2f}, max {max(times):.2f}), "
          f"{BSIZE / med * 1e3:.0f} samples/s, peak device memory {peak:.0f} MiB; the host issues a "
          f"step in {statistics.median(issue):.2f} ms (median); a profiled step: "
          f"{prof['device_ms']:.2f} ms of kernels in {prof['wall_ms']:.2f} ms, top {prof['top']}; "
          f"{threading.active_count()} threads alive; loss on one repeated batch over 8 steps: "
          f"{[round(x, 4) for x in losses]}", flush=True)
    assert losses[-1] < losses[0] and np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    return {"step_ms": times, "median_step_ms": med, "samples_per_s": BSIZE / med * 1e3,
            "issue_ms": issue, "profiled_step_device_ms": prof["device_ms"],
            "profiled_step_wall_ms": prof["wall_ms"], "profiled_step_top": prof["top"],
            "threads": threading.active_count(), "peak_memory_mib": peak,
            "repeated_batch_losses": losses}


def training_phase(work_dir: str) -> dict:
    """Phase 6: ``conette-train`` at full width on one card, then captioning
    from its run directory through the three kernels."""
    import torch

    from conette_torch.huggingface.model import CoNeTTEModel
    from conette_torch.metrics.functional import bert_score, fense
    from conette_torch.models.conette import ConetteConfig
    from conette_torch.train.main import _spec_aug_fn, main_train

    t0 = time.perf_counter()
    hdf_root = os.path.join(work_dir, "hdf")
    packs = pack_corpus(hdf_root)
    pack_s = time.perf_counter() - t0
    print(f"  packed {TRAIN_BATCHES * BSIZE} train and 2 x {EVAL_ITEMS} eval items in "
          f"{pack_s:.1f} s ({sum(os.path.getsize(p) for p in packs.values()) / 1e6:.0f} MB)",
          flush=True)
    from conette_torch.config import load_config

    argv = ["expt=hp_clotho_v2", "ckpts.monitor=val/loss", "ckpts.fallback_monitor=val/loss",
            "ckpts.mode=min", "trainer.max_epochs=2", f"dm.hdf_root={hdf_root}",
            "dm.train_hdfs=[clotho_dev_emb.hdf]", "dm.val_hdfs=[clotho_val_emb.hdf]",
            "dm.test_hdfs=[clotho_eval_emb.hdf]", f"log_root={os.path.join(work_dir, 'logs')}"]
    cfg = load_config("train", argv)
    pl = cfg["pl"]
    print(f"  config: d_model {pl['d_model']} x {pl['num_decoder_layers']} layers, {pl['nhead']} heads, "
          f"ff {pl['dim_feedforward']}, dropout {pl['decoder_dropout_p']}/{pl.get('proj_dropout_p', 0.5)}, "
          f"mixup {pl['mixup_alpha']}, label smoothing {pl['label_smoothing']}, "
          f"{pl['optim_name']} lr {pl['lr']} wd {pl['weight_decay']} {pl['sched_name']}, clip "
          f"{cfg['trainer']['grad_clip_norm']}, bsize {cfg['dm']['bsize']}, beam {pl['beam_size']}, "
          f"train transform {cfg['audio_t']['train'].get('_target_')}", flush=True)
    assert cfg["dm"]["bsize"] == BSIZE and pl["d_model"] == 256 and pl["num_decoder_layers"] == 6

    vocab = 4000 + 4 + len(pl["task_names"])
    model_cfg = ConetteConfig(vocab_size=vocab, task_names=tuple(pl["task_names"]))
    card_vs_cpu = step_card_vs_cpu(model_cfg)
    timing = step_timing(model_cfg, _spec_aug_fn(cfg))

    for cache, key in ((bert_score._CACHE, "embed"), (fense._CACHE, "model")):
        cache[key] = None  # no model weights for these metrics here: never fetch them
    t0 = time.perf_counter()
    out = main_train(argv)
    train_s = time.perf_counter() - t0
    fit = out["fit"]
    run_dir = out["run_dir"]
    best = os.path.join(run_dir, "checkpoints", "best")
    artifacts = sorted(os.listdir(run_dir))
    wait_share = fit.batch_wait_s / sum(fit.epoch_train_s)
    fit_rate = fit.global_step * BSIZE / sum(fit.epoch_train_s)
    print(f"  main_train: {train_s:.1f} s wall, {fit.global_step} steps ({fit_rate:.0f} samples/s "
          "over the training passes), epochs "
          f"{[round(x, 2) for x in fit.epoch_s]} s (training passes "
          f"{[round(x, 2) for x in fit.epoch_train_s]} s), waiting on the host's batch "
          f"{fit.batch_wait_s:.2f} s ({wait_share:.3f} of the passes); best val/loss "
          f"{out['best']:.4f}; test {next(iter(out['test'].values()))['cider_d']:.4f} CIDEr-D; "
          f"run dir {artifacts}", flush=True)
    assert fit.global_step == 2 * TRAIN_BATCHES and np.isfinite(out["best"])
    assert os.path.isfile(os.path.join(best, "params.npz")), best
    for name in ("tokenizer.json", "vocab.csv", "hparams.yaml", "metrics.yaml", "endfile.txt"):
        assert name in artifacts, (name, artifacts)

    # captioning from the run directory: the first request captures the
    # graphs (2 + 36 + 6 wrapper launches); a replayed request runs 18 block
    # and 3 seam kernels in its profile. Late in a run the trace drops the
    # log-mel kernel's row at random (PERF.md §7), so its call is held as
    # phase 5 holds it: the eager bf16 encoder on the same waveforms runs
    # 1 + 18 + 3 wrapper launches and gives the replay's clip probabilities
    from conette_torch.models.convnext import convnext_apply

    reset_launches()
    model = CoNeTTEModel.from_pretrained(run_dir, device="cuda", compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(35)
    tasks = ["clotho"] * BATCH
    first = model(make_clips(rng, BATCH, 10.0, 44100), sr=44100, task=tasks)
    launches = count_launches()
    clips = make_clips(rng, BATCH, 10.0, 44100)
    replayed = []
    replay = profiled(lambda: replayed.append(model(clips, sr=44100, task=tasks)))
    wav, lens = model.preprocessor.load_resample(clips, 44100)
    reset_launches()
    with torch.inference_mode():
        eager = convnext_apply(model.encoder_params, torch.from_numpy(wav).cuda(),
                               torch.from_numpy(lens).cuda(), compute_dtype=torch.bfloat16)
    eager_launches = count_launches()
    clip_err = float(np.abs(eager["clipwise_output"].float().cpu().numpy()
                            - replayed[0]["tags_probs"]).max())
    versus = graphs_vs_eager(model, make_clips(rng, BATCH, 10.0, 44100), tasks)
    print(f"  captions from the run directory: {first['cands'][:2]}; wrapper launches {launches}, "
          f"a replayed request's kernel calls {replay['calls']} (log-mel rows "
          f"{replay['logmel_rows']}); the eager bf16 encoder on its waveforms: wrapper launches "
          f"{eager_launches}, clip probabilities max abs diff {clip_err:.2e}", flush=True)
    assert launches == {"logmel": 2, "convnext_block": 36, "downsample": 6}, launches
    assert {k: replay["calls"][k] for k in ("convnext_block", "downsample")} == {
        "convnext_block": 18, "downsample": 3}, replay["calls"]
    assert replay["calls"]["logmel"] in (0, 1), replay["calls"]
    assert eager_launches == {"logmel": 1, "convnext_block": 18, "downsample": 3}, eager_launches
    assert clip_err <= 1e-6, clip_err
    assert len(first["cands"]) == BATCH and np.isfinite(first["lprobs"]).all()
    return dict(pack_s=pack_s, card_vs_cpu=card_vs_cpu, timing=timing, main_train_s=train_s,
                epoch_s=fit.epoch_s, epoch_train_s=fit.epoch_train_s, batch_wait_s=fit.batch_wait_s,
                fit_samples_per_s=fit_rate,
                batch_wait_share=wait_share, best_val_loss=out["best"], test=out["test"],
                artifacts=artifacts, launches=launches, replay_calls=replay["calls"],
                eager_encoder_launches=eager_launches, replay_vs_eager_clip_abs_err=clip_err,
                graphs_vs_eager=versus, cands=first["cands"])


# phase 7: a local corpus for conette-prepare: 96 WAV and 32 FLAC files in
# the dev, val and test subsets (a CSV of 5 captions a file for each); WAV
# clips of 1-29.5 s at 44.1, 48 and 32 kHz, half of them stereo; FLAC
# clips of 1-2 s, mono (the FLAC decoder is pure Python: ~0.25 s of host
# time a second of audio on the card's machine, read twice a pack, PERF.md
# §5); dev holds two batches of dm.bsize 32
PREP_SUBSETS = (("dev", 48, 16), ("val", 24, 8), ("test", 24, 8))  # (subset, WAV, FLAC)
PREP_RATES = (44_100, 48_000, 32_000)
PREP_BATCH, PREP_TRAIN_BSIZE = 8, 32
PREP_ROWS_CHECKED = 4
# f32 on the card (TF32 off) against f32 on the CPU: summation order only;
# the packed rows to the debug check's absolute 1e-4; the PANN encoders and
# the encoder frontends to 1e-4 of their largest value; the dB frontends
# (spectrogram, gammatonegram) to 0.05 dB: a DFT bin that holds only the
# noise floor sums 1024 terms carrying tones up to ~50 dB louder, whose f32
# rounding (~sqrt(1024)·6e-8 of their sum) is up to ~2e-3 of the bin's
# amplitude, ~0.02 dB (0.0054 dB measured at the worst bin of a 10 s clip)
PREP_ROW_ATOL = 1e-4
PANN_REL_TOL = 1e-4
DB_ATOL = 0.05
PANN_NAMES = ("cnn10", "cnn14", "cnn14_att")
# the architectures and heads of models/pann_zoo.py, on the same clips, their
# batch norms randomised (a residual branch's last BN weight is zero at init,
# where a wrong branch would add nothing) and their conv biases zero, as in
# the reference's checkpoints
ZOO_NAMES = ("cnn6", "cnn14_decisionlevelavg", "cnn14_decisionlevelmax", "dainet19", "leenet11",
             "leenet24", "mobilenetv1", "mobilenetv2", "res1dnet31", "res1dnet51", "resnet22",
             "resnet38", "resnet54", "wavegram_cnn14", "wavegram_logmel128_cnn14",
             "wavegram_logmel_cnn14")
# the PANN_REGISTRY checkpoints of those architectures, loaded from staged files
REGISTRY_ZOO = ("Cnn6", "MobileNetV1", "MobileNetV2", "ResNet22", "ResNet38", "ResNet54",
                "Wavegram_Cnn14", "Wavegram_Logmel_Cnn14")


def write_prepare_corpus(root: str) -> dict:
    """Phase 7's corpus: the audio under ``root/audio``, a captions CSV for
    each subset; returns {subset: (csv path, [file names])}."""
    import csv

    from conette_torch.utils.audio_io import save_wav
    from conette_torch.utils.flac import save_flac

    rng = np.random.default_rng(71)
    words = np.asarray(corpus_words(np.random.default_rng(0)))
    audio_dir = os.path.join(root, "audio")
    os.makedirs(audio_dir, exist_ok=True)
    out = {}
    for subset, n_wav, n_flac in PREP_SUBSETS:
        rows, names = [], []
        for i in range(n_wav + n_flac):
            flac = i >= n_wav
            sr = PREP_RATES[i % 3]
            secs = float(rng.uniform(1.0, 2.0) if flac else rng.uniform(1.0, 29.5))
            x = make_clips(rng, 2 if (not flac and (i // 3) % 2) else 1, secs, sr)
            name = f"{subset}_{i:03d}.{'flac' if flac else 'wav'}"
            (save_flac if flac else save_wav)(os.path.join(audio_dir, name),
                                              np.stack(x) if len(x) > 1 else x[0], sr)
            names.append(name)
            rows += [{"file_name": name,
                      "caption": " ".join(rng.choice(words, size=rng.integers(3, 21)))}
                     for _ in range(5)]
        csv_path = os.path.join(root, f"{subset}.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
            w.writeheader()
            w.writerows(rows)
        out[subset] = (csv_path, names)
    return out


class MethodTimer:
    """Host seconds spent inside each wrapped function while active
    (``encode`` ends in a synchronise, so it holds its device time too)."""

    def __init__(self, targets: dict) -> None:
        self.targets = targets  # {label: (owner, attribute, synchronise)}
        self.seconds = dict.fromkeys(targets, 0.0)
        self.saved = {}

    def __enter__(self):
        import torch

        for label, (owner, attr, sync) in self.targets.items():
            fn = getattr(owner, attr)
            self.saved[label] = fn

            def timed(*args, _fn=fn, _label=label, _sync=sync, **kwargs):
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                if _sync:
                    torch.cuda.synchronize()
                self.seconds[_label] += time.perf_counter() - t0
                return out

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr, _) in self.targets.items():
            setattr(owner, attr, self.saved[label])


def native_loader_check(audio_dir: str, names: list[str]) -> dict:
    """Build the native loader, then decode and resample 32 WAVs with
    ``load_batch`` and with the numpy route (decode, resample, mean)."""
    from conette_torch.native import loader
    from conette_torch.ops.resample import resample_numpy
    from conette_torch.utils.audio_io import load_audio

    t0 = time.perf_counter()
    path = loader.library_path()
    loader.build(path)
    loader.library()
    build_s = time.perf_counter() - t0
    paths = [os.path.join(audio_dir, n) for n in names if n.endswith(".wav")][:32]
    t0 = time.perf_counter()
    native = loader.load_batch(paths, 32_000)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = []
    for p in paths:
        wav, sr = load_audio(p)
        plain.append(resample_numpy(wav, sr, 32_000).mean(axis=0))
    numpy_s = time.perf_counter() - t0
    kinds = sorted({(loader.wav_info(p)[0], loader.wav_info(p)[1]) for p in paths})
    err = max(float(np.abs(a - b).max()) for a, b in zip(native, plain))
    seconds = sum(len(a) for a in native) / 32_000
    print(f"  native loader: built in {build_s:.2f} s ({path.name}); {len(paths)} WAVs "
          f"({seconds:.0f} s of audio; (rate, channels) {kinds}) through load_batch in "
          f"{native_s:.3f} s, through numpy in {numpy_s:.3f} s; max abs diff {err:.2e} "
          f"(tol 2e-5)", flush=True)
    assert len(kinds) == 6 and [len(a) for a in native] == [len(b) for b in plain]
    assert err <= 2e-5, err
    return dict(build_s=build_s, files=len(paths), audio_s=seconds, load_batch_s=native_s,
                numpy_s=numpy_s, max_abs_err=err)


def random_batch_norms(tree, rng: np.random.Generator):
    """A numpy PANN tree with every batch norm drawn from ``rng`` (weight
    and running variance in [0.5, 1.5), bias and running mean N(0, 0.1));
    other leaves as they are."""
    if isinstance(tree, dict):
        if "running_var" in tree:
            n = len(tree["weight"])
            return {"weight": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "running_mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "running_var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        return {k: random_batch_norms(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [random_batch_norms(v, rng) for v in tree]
    return tree


def without_conv_biases(tree):
    """A numpy PANN tree with every 2-D conv's bias zero, as the converter
    makes it from the reference's bias-free convs."""
    if isinstance(tree, dict):
        if np.ndim(tree.get("weight")) == 4:
            return dict(tree, bias=np.zeros_like(tree["bias"]))
        return {k: without_conv_biases(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [without_conv_biases(v) for v in tree]
    return tree


def reference_pann_state(tree) -> dict:
    """The reference's torch state dict of a numpy PANN tree (the inverse
    of ``convert_pann``, for every name of ``PANN_ZOO_NAMES``): 2-D conv
    biases dropped (the reference's convs have none), with the BN counters
    and a frontend buffer that the converter skips."""
    sd = {"spectrogram_extractor.stft.conv_real.weight": np.zeros((513, 1, 1024), np.float32)}

    def put(prefix: str, p) -> None:
        if "running_var" in p:  # BatchNorm
            sd.update({f"{prefix}.{k}": np.asarray(v) for k, v in p.items()})
            sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
        elif "weight" in p and "bias" in p and np.ndim(p["weight"]) == 2:  # Linear
            sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["weight"]).T)
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        elif "weight" in p:  # HWIO conv2d → OIHW, WIO conv1d → (out, in, k)
            w = np.asarray(p["weight"])
            sd[f"{prefix}.weight"] = np.ascontiguousarray(
                w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.transpose(2, 1, 0))
        else:  # a block: its convs and BNs by name, a ResNet downsample by index
            for k, v in p.items():
                if k == "downsample" and "conv" in v:
                    i = int(p["stride"] != 1)  # (AvgPool,) conv, BN
                    put(f"{prefix}.downsample.{i}", v["conv"])
                    put(f"{prefix}.downsample.{i + 1}", v["bn"])
                elif isinstance(v, dict):
                    put(f"{prefix}.{k}", v)

    if "features" in tree:  # MobileNetV1: conv_bn (0, 2), conv_dw (0, 2, 4, 5)
        for i, f in enumerate(tree["features"]):
            names = (("conv", 0), ("bn", 2)) if f["kind"] == "bn" else (
                ("dwconv", 0), ("bn1", 2), ("pwconv", 4), ("bn2", 5))
            for k, j in names:
                put(f"features.{i}.{j}", f[k])
        tree = {k: tree[k] for k in ("bn0", "fc1", "fc_audioset")}
    elif "stem_conv" in tree:  # MobileNetV2
        put("features.0.0", tree["stem_conv"])
        put("features.0.2", tree["stem_bn"])
        for i, b in enumerate(tree["blocks"], 1):
            idx = ((("dwconv", 0), ("dw_bn", 2), ("project_conv", 4), ("project_bn", 5))
                   if b["expand"] == 1 else
                   (("expand_conv", 0), ("expand_bn", 1), ("dwconv", 3), ("dw_bn", 5),
                    ("project_conv", 7), ("project_bn", 8)))
            for k, j in idx:
                put(f"features.{i}.conv.{j}", b[k])
        put(f"features.{len(tree['blocks']) + 1}.0", tree["head_conv"])
        put(f"features.{len(tree['blocks']) + 1}.1", tree["head_bn"])
        tree = {k: tree[k] for k in ("bn0", "fc1", "fc_audioset")}
    # Wavegram_Cnn14 keeps the log-mel branch's conv_block1, so its blocks
    # are conv_block2..6
    first = 2 if "blocks" in tree and "conv_block1" in tree else 1
    for k, v in tree.items():
        if k == "blocks":
            for i, b in enumerate(v):
                put(f"conv_block{i + first}", b)
        elif k == "layers":
            for li, stage in enumerate(v, 1):
                for bi, b in enumerate(stage):
                    put(f"resnet.layer{li}.{bi}", b)
        elif k == "att":  # AttBlock's Conv1d k1 heads
            for h in ("att", "cla"):
                sd[f"att_block.{h}.weight"] = np.ascontiguousarray(np.asarray(v[h]["weight"]).T)[:, :, None]
                sd[f"att_block.{h}.bias"] = np.asarray(v[h]["bias"])
        elif isinstance(v, dict):
            put(k, v)
    return sd


def pann_check(dev, work_dir: str) -> dict:
    """Cnn10, Cnn14, Cnn14_DecisionLevelAtt and every name of ``ZOO_NAMES``
    at full width on 8 x 10 s clips on the card (median CUDA-event time of
    5 calls), each held against the CPU on the first clip; then the
    ``REGISTRY_ZOO`` checkpoints, staged under ``CONETTE_CKPT_DIR`` in the
    reference's layout, loaded with ``load_registry_pann`` (equal to the
    staged tree bit for bit) and run on the card."""
    import torch

    from conette_torch.huggingface.convert_pann import load_registry_pann
    from conette_torch.models.pann import apply_pann_model, build_pann_model
    from conette_torch.models.registries import PANN_REGISTRY
    from conette_torch.weights import named_leaves, to_numpy, to_torch

    rng = np.random.default_rng(72)
    wav = torch.from_numpy(np.stack(make_clips(rng, BATCH, 10.0, 32_000)))
    lens = torch.full((BATCH,), wav.shape[1])
    registry_archs = {PANN_REGISTRY[reg].architecture.lower() for reg in REGISTRY_ZOO}
    out, trees, cpu_refs = {}, {}, {}

    def check(name, params, cpu) -> dict:
        with torch.inference_mode():
            def run():
                return apply_pann_model(name, params, wav.to(dev), lens.to(dev))

            ms = time_ms(run, runs=5)
            card = run()
        errs = {}
        for k, want in cpu.items():
            got = card[k][:1].cpu()
            assert got.shape == want.shape, (name, k, got.shape, want.shape)
            assert torch.isfinite(card[k].float()).all(), (name, k)
            errs[k] = errors(want, got)[1] if want.is_floating_point() else float((got != want).sum())
        assert max(errs.values()) <= PANN_REL_TOL, (name, errs)
        return dict(ms=ms, rel_err=errs, frame_embs=list(card["frame_embs"].shape))

    for i, name in enumerate(PANN_NAMES + ZOO_NAMES):
        tree, width = build_pann_model(name, torch.Generator().manual_seed(73 + i))
        if name in ZOO_NAMES:
            tree = to_numpy(tree)
            tree = to_torch(without_conv_biases(random_batch_norms(tree, np.random.default_rng(73 + i))))
        with torch.inference_mode():
            cpu = apply_pann_model(name, tree, wav[:1], lens[:1])
        out[name] = check(name, to_torch(tree, dev), cpu)
        if name in registry_archs:
            trees[name], cpu_refs[name] = tree, cpu
        print(f"  {name}: 8 x 10 s on the card {out[name]['ms']:.2f} ms a call; frame_embs "
              f"{tuple(out[name]['frame_embs'])}; card vs CPU on one clip, max error relative to "
              f"the largest value {({k: f'{v:.1e}' for k, v in out[name]['rel_err'].items()})} "
              f"(tol {PANN_REL_TOL})", flush=True)
        assert out[name]["frame_embs"][:2] == [BATCH, width]

    ckpt_dir = os.path.join(work_dir, "pann_ckpts")
    os.makedirs(ckpt_dir, exist_ok=True)
    saved_env = os.environ.get("CONETTE_CKPT_DIR")
    os.environ["CONETTE_CKPT_DIR"] = ckpt_dir
    try:
        for reg in REGISTRY_ZOO:
            name = PANN_REGISTRY[reg].architecture.lower()
            want = to_numpy(trees[name])
            path = os.path.join(ckpt_dir, PANN_REGISTRY[reg].fname)
            torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_pann_state(want).items()}},
                       path)
            t0 = time.perf_counter()
            loaded = load_registry_pann(reg)
            load_s = time.perf_counter() - t0
            os.remove(path)
            got, staged = dict(named_leaves(loaded)), dict(named_leaves(want))
            assert got.keys() == staged.keys() and all(
                np.asarray(v).tobytes() == np.asarray(staged[k]).tobytes() for k, v in got.items()), reg
            rec = check(name, to_torch(loaded, dev), cpu_refs[name])
            out[f"registry/{reg}"] = dict(rec, load_s=load_s)
            print(f"  load_registry_pann({reg!r}) from a staged reference state dict in "
                  f"{load_s:.2f} s, equal to the staged tree; on the card {rec['ms']:.2f} ms a "
                  f"call, max error relative to the CPU {max(rec['rel_err'].values()):.1e}", flush=True)
    finally:
        if saved_env is None:
            os.environ.pop("CONETTE_CKPT_DIR")
        else:
            os.environ["CONETTE_CKPT_DIR"] = saved_env
    return out


def frontends_check(dev) -> dict:
    """``get_frontend`` for every name on one 10 s clip at 44.1 kHz, the
    card against the CPU."""
    from conette_torch.ops.frontend_factories import FRONTENDS, get_frontend

    clip = make_clips(np.random.default_rng(74), 1, 10.0, 44_100)[0]
    out = {}
    for name in FRONTENDS:
        fn_card, width = get_frontend(name, seed=3, device=dev)
        fn_cpu, _ = get_frontend(name, seed=3, device="cpu")
        t0 = time.perf_counter()
        got = fn_card(clip, 44_100)
        card_s = time.perf_counter() - t0
        want = fn_cpu(clip, 44_100)
        diff = float(np.abs(got - want).max())
        db = name.endswith(("spectrogram", "gammatonegram"))
        tol = DB_ATOL if db else PANN_REL_TOL * float(np.abs(want).max())
        out[name] = dict(shape=list(got.shape), width=width, max_abs_err=diff, tol=tol,
                         card_s=card_s)
        assert got.shape == want.shape and got.shape[1] == width and np.isfinite(got).all()
        assert diff <= tol, (name, diff, tol)
    print("  get_frontend, card vs CPU on one 10 s clip: " + "; ".join(
        f"{k.removeprefix('resample_mean_')} {tuple(v['shape'])} max abs diff "
        f"{v['max_abs_err']:.1e} (tol {v['tol']:.1e})" for k, v in out.items()), flush=True)
    return out


def prepare_phase(work_dir: str) -> dict:
    """Phase 7: the host audio loader, conette-prepare on a written corpus
    (each subset packed by ``main_prepare`` with ``--debug`` on the default
    device), the packs read back and held against the CPU encoder, a
    training run on them and captions from its run directory, then the
    PANN encoders and the frontend factories, card against CPU."""
    import torch

    from conette_torch.data.hdf import HDFDataset
    from conette_torch.huggingface.model import CoNeTTEModel
    from conette_torch.huggingface.preprocessor import CoNeTTEPreprocessor
    from conette_torch.metrics.functional import bert_score, fense
    from conette_torch.models.convnext import convnext_init
    from conette_torch.prepare import ConvNeXtFrontend, main_prepare, scan_local_dataset
    from conette_torch.train.main import main_train
    from conette_torch.utils import audio_io

    t0 = time.perf_counter()
    corpus = write_prepare_corpus(work_dir)
    audio_dir = os.path.join(work_dir, "audio")
    write_s = time.perf_counter() - t0
    print(f"  wrote {sum(len(n) for _, n in corpus.values())} files in {write_s:.1f} s", flush=True)
    native = native_loader_check(audio_dir, corpus["dev"][1] + corpus["val"][1])

    hdf_root = os.path.join(work_dir, "hdf")
    packs, calls = {}, {}
    reset_launches()
    for subset, (csv_path, names) in corpus.items():
        timer = MethodTimer({"decode": (audio_io, "load_audio", False),
                             "resample": (CoNeTTEPreprocessor, "load_resample", False),
                             "encode": (CoNeTTEPreprocessor, "encode", True)})
        t0 = time.perf_counter()
        with timer:
            rc = main_prepare(["--audio_dir", audio_dir, "--captions_csv", csv_path,
                               "--dataset", "clotho", "--subset", subset, "--out_dir", hdf_root,
                               "--batch_size", str(PREP_BATCH), "--debug"])
        wall = time.perf_counter() - t0
        assert rc == 0, rc
        packs[subset] = os.path.join(hdf_root, f"clotho_{subset}_resample_mean_convnext_ident.hdf")
        host = wall - timer.seconds["encode"]
        calls[subset] = dict(files=len(names), wall_s=wall, files_per_s=len(names) / wall,
                             host_share=host / wall, **{f"{k}_s": v for k, v in timer.seconds.items()})
        print(f"  main_prepare {subset}: {len(names)} files in {wall:.2f} s ({len(names) / wall:.1f} "
              f"files/s), --debug check passed; host decode {timer.seconds['decode']:.2f} s, "
              f"resample + pad {timer.seconds['resample']:.2f} s, encoder calls (captures "
              f"included, synchronised) {timer.seconds['encode']:.2f} s: host share "
              f"{host / wall:.3f}", flush=True)
    prepare_launches = count_launches()
    assert prepare_launches == dict.fromkeys(prepare_launches, 0), prepare_launches

    # the packs read back, and the first rows against the f32 encoder on the
    # CPU over the same batch of clips (the pack's first batch)
    for subset, path in packs.items():
        ds = HDFDataset(path)
        csv_path, names = corpus[subset]
        assert [ds.at(i, "fname") for i in range(len(ds))] == sorted(names)
        for i in range(len(ds)):
            a = ds.at(i, "audio")
            assert a.shape == (ds.at(i, "audio_lens"), 768) and np.isfinite(a).all()
            assert len(ds.at(i, "captions")) == 5 and ds.at(i, "subset") == subset
    dev_ds = scan_local_dataset(audio_dir, corpus["dev"][0], "clotho", "dev")
    t0 = time.perf_counter()
    cpu_rows = ConvNeXtFrontend(device="cpu").encode_dataset_batched(
        dev_ds, list(range(PREP_BATCH)), PREP_BATCH)[:PREP_ROWS_CHECKED]
    cpu_s = time.perf_counter() - t0
    packed = HDFDataset(packs["dev"])
    row_err = max(float(np.abs(packed.at(i, "audio") - r).max()) for i, r in enumerate(cpu_rows))
    print(f"  packs read back ({', '.join(f'{k} {len(HDFDataset(p))}' for k, p in packs.items())} "
          f"rows, frames {[int(packed.at(i, 'audio_lens')) for i in range(PREP_ROWS_CHECKED)]} ...); "
          f"{PREP_ROWS_CHECKED} dev rows against the f32 encoder on the CPU ({cpu_s:.1f} s): max abs "
          f"diff {row_err:.2e} (tol {PREP_ROW_ATOL}); wrapper launches while packing "
          f"{prepare_launches} (the f32 route is the plain one)", flush=True)
    assert all(r.shape == packed.at(i, "audio").shape for i, r in enumerate(cpu_rows))
    assert row_err <= PREP_ROW_ATOL, row_err

    # conette-train on the packs, then captions from its run directory, with
    # the encoder that packed them (prepare's, from seed 0)
    for cache, key in ((bert_score._CACHE, "embed"), (fense._CACHE, "model")):
        cache[key] = None  # no model weights for these metrics here: never fetch them
    name = "clotho_{}_resample_mean_convnext_ident.hdf"
    argv = ["expt=hp_clotho_v2", "ckpts.monitor=val/loss", "ckpts.fallback_monitor=val/loss",
            "ckpts.mode=min", "trainer.max_epochs=1", f"dm.bsize={PREP_TRAIN_BSIZE}",
            f"dm.hdf_root={hdf_root}", f"dm.train_hdfs=[{name.format('dev')}]",
            f"dm.val_hdfs=[{name.format('val')}]", f"dm.test_hdfs=[{name.format('test')}]",
            f"log_root={os.path.join(work_dir, 'logs')}"]
    t0 = time.perf_counter()
    out = main_train(argv)
    train_s = time.perf_counter() - t0
    fit = out["fit"]
    assert fit.global_step == 2 and np.isfinite(out["best"]), (fit.global_step, out["best"])
    model = CoNeTTEModel.from_pretrained(out["run_dir"], device="cuda",
                                         encoder_params=convnext_init(torch.Generator().manual_seed(0)))
    files = [os.path.join(audio_dir, n) for n in (corpus["test"][1][0], corpus["test"][1][-1])]
    t0 = time.perf_counter()
    captions = model(files)
    caption_s = time.perf_counter() - t0
    print(f"  main_train on the packs: {train_s:.1f} s, {fit.global_step} steps of "
          f"{PREP_TRAIN_BSIZE}, best val/loss {out['best']:.4f}; captions of "
          f"{[os.path.basename(f) for f in files]} from its run directory in {caption_s:.2f} s: "
          f"{captions['cands']}", flush=True)
    assert len(captions["cands"]) == 2 and np.isfinite(captions["lprobs"]).all()
    del model

    panns = pann_check(torch.device("cuda"), work_dir)
    frontends = frontends_check(torch.device("cuda"))
    return dict(write_s=write_s, native=native, prepare=calls, prepare_launches=prepare_launches,
                rows_checked=PREP_ROWS_CHECKED, row_max_abs_err=row_err, cpu_rows_s=cpu_s,
                main_train_s=train_s, best_val_loss=out["best"], caption_s=caption_s,
                cands=captions["cands"], pann=panns, frontends=frontends)


# phase 9: the encoders' training mode. ConvNeXt-Tiny at full width (layer
# scales N(0, 0.1), bn0 drawn) trains on 8 x 10 s at 32 kHz with drop-path
# 0.1 and SpecAugmentRatio on the mel; Cnn14 with its dropout. Card against
# CPU at 2 x 10 s, f32: the loss to 1e-5 of its value; each gradient leaf
# to 1e-4 of its largest value; bn0's running statistics to 1e-6 of theirs
ENC_TRAIN_STEPS = 5
ENC_TRAIN_TOL = {"loss": 1e-5, "grads": 1e-4, "bn0_stats": 1e-6}
ENC_TRAIN_SECONDS, ENC_CHECK_CLIPS = 10.0, 2
# batch statistics over few values are ill-conditioned (the PANN zoo's last
# stages normalise over tens of values a channel at 2 x 10 s), and a ReLU
# network's gradient moves by a whole term wherever a rounding difference
# flips a unit across zero: a PANN output that misses its tolerance is held
# to COND times the card's own change when the waveform is scaled by 1 +
# NUDGE·N(0, 1) (as tests/test_torch_pann_train*.py hold the port to JAX),
# and a gradient leaf to COND_GRAD times the card's own change when the
# waveform and every float leaf are scaled by 1 + NUDGE_GRAD·N(0, 1), about
# how far the two devices' f32 convolutions (cuDNN's algorithms against the
# CPU's) differ a layer; a 2-D conv's bias, whose gradient is zero in exact
# arithmetic (a batch norm follows the conv), is held below BIAS_NOISE of
# its weight's largest gradient on both devices (1.3e-4 seen on the card, at
# Wavegram-Logmel-Cnn14's first conv: a sum of 128 000 terms that cancel)
NUDGE, NUDGE_GRAD, COND, COND_GRAD, BIAS_NOISE = 1e-7, 1e-6, 4.0, 8.0, 1e-3
PANN_GRAD_NAMES = ("cnn14", "resnet38", "mobilenetv2", "res1dnet51", "wavegram_logmel_cnn14")


def encoder_train_params(seed: int) -> dict:
    """Full-width ConvNeXt-Tiny from a seed, on the CPU: layer scales
    N(0, 0.1) as phase 3 sets them, bn0 drawn as phase 2 draws it."""
    import torch

    from conette_torch.models.convnext import convnext_init

    gen = torch.Generator().manual_seed(seed)
    params = convnext_init(gen)
    for stage in params["stages"]:
        for block in stage:
            block["scale"] = torch.randn(block["scale"].shape, generator=gen) * 0.1
    params["bn0"] = random_bn0(gen, "cpu")
    return params


def float_leaves(tree) -> list:
    """(name, leaf) of every floating-point tensor leaf."""
    import torch

    from conette_torch.weights import named_leaves

    return [(k, t) for k, t in named_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def multi_hot(rng: np.random.Generator, b: int) -> np.ndarray:
    """(b, 527) targets with 1-4 classes on a row."""
    y = np.zeros((b, 527), np.float32)
    for row in y:
        row[rng.choice(527, size=rng.integers(1, 5), replace=False)] = 1.0
    return y


def timed_steps(one, n: int) -> dict:
    """``one()`` once to warm up, then ``n`` times between CUDA events: the
    step times, their median, the peak device memory of the timed steps
    and the losses."""
    import torch

    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(one())
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = [a.elapsed_time(e) for a, e in events]
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), losses
    return {"step_ms": times, "median_step_ms": statistics.median(times), "losses": losses,
            "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20}


def convnext_step_fn(params, wav, targets, compute_dtype, gen, aug_gen, drop_path_rate=0.1):
    """The port's train step over ConvNeXt-Tiny: ``convnext_apply`` in
    training mode (drop-path from ``gen``, SpecAugmentRatio from
    ``aug_gen`` unless it is None), binary cross-entropy of the clip
    probabilities, a global-norm clip at 1 and AdamW; bn0's running
    statistics written back after each forward. Returns ``step() ->
    loss``."""
    import functools

    import torch
    import torch.nn.functional as F

    from conette_torch.models.convnext import convnext_apply
    from conette_torch.train import optim, step
    from conette_torch.train.augment import spec_augment_ratio

    aug = None if aug_gen is None else functools.partial(spec_augment_ratio, aug_gen)

    def loss_fn(p, batch, g):
        out = convnext_apply(p, batch["wav"], deterministic=False, drop_path_rate=drop_path_rate,
                             gen=g, compute_dtype=compute_dtype, spec_augment_fn=aug)
        with torch.no_grad():
            for k in ("running_mean", "running_var"):
                p["bn0"][k].copy_(out["bn0_stats"][k])
        return F.binary_cross_entropy(out["clipwise_output"], batch["targets"])

    opt, _ = optim.get_optimizer(params, lr=1e-4, weight_decay=0.05, sched_name="none")
    state = step.init_train_state(params, opt)
    fn = step.make_train_step(None, grad_clip_norm=1.0, loss_fn=loss_fn)
    batch = {"wav": wav, "targets": targets}

    def one():
        return fn(state, batch, gen)[1]["train/loss"]

    return one


def encoder_card_vs_cpu(params_cpu, wav, targets) -> dict:
    """One ConvNeXt-Tiny training step's loss, gradients and bn0 running
    statistics on the card against the CPU (f32, no drop-path, no
    augmentation, from the same weights)."""
    import torch
    import torch.nn.functional as F

    from conette_torch.models.convnext import convnext_apply
    from conette_torch.weights import to_torch

    out = {}
    for dev in ("cuda", "cpu"):
        params = to_torch(params_cpu, dev)
        leaves = float_leaves(params)
        for _, t in leaves:
            t.requires_grad_()
        res = convnext_apply(params, torch.from_numpy(wav).to(dev), deterministic=False)
        loss = F.binary_cross_entropy(res["clipwise_output"], torch.from_numpy(targets).to(dev))
        grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                                    materialize_grads=True)
        out[dev] = {"loss": loss.item(), "grads": {k: g.cpu() for (k, _), g in zip(leaves, grads)},
                    "stats": {k: res["bn0_stats"][k].detach().cpu()
                              for k in ("running_mean", "running_var")}}
    card, cpu = out["cuda"], out["cpu"]
    leaf_rel = {k: errors(cpu["grads"][k], card["grads"][k])[1] for k in cpu["grads"]}
    res = {"loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "grads": max(leaf_rel.values()),
           "worst_leaves": sorted(((v, k) for k, v in leaf_rel.items()), reverse=True)[:3],
           "bn0_stats": max(errors(cpu["stats"][k], card["stats"][k])[1] for k in cpu["stats"])}
    print(f"  ConvNeXt-Tiny, one step card vs cpu ({ENC_CHECK_CLIPS} x {ENC_TRAIN_SECONDS:.0f} s, f32, "
          f"no drop-path or augment): loss {card['loss']:.7f} vs {cpu['loss']:.7f} (rel "
          f"{res['loss']:.2e}, tol {ENC_TRAIN_TOL['loss']}); gradients, each leaf relative to its "
          f"largest value, at most {res['grads']:.2e} (tol {ENC_TRAIN_TOL['grads']}; "
          f"{res['worst_leaves']}); bn0 running statistics {res['bn0_stats']:.2e} (tol "
          f"{ENC_TRAIN_TOL['bn0_stats']})", flush=True)
    for k, tol in ENC_TRAIN_TOL.items():
        assert res[k] <= tol, (k, res[k], tol)
    return res


def convnext_training(dev, smi: str) -> dict:
    """Phase 9 (a): ConvNeXt-Tiny in training mode on the card."""
    import torch

    from conette_torch.models.convnext import convnext_apply
    from conette_torch.weights import to_torch

    rng = np.random.default_rng(91)
    wav_np = np.stack(make_clips(rng, BATCH, ENC_TRAIN_SECONDS, 32_000))
    targets_np = multi_hot(rng, BATCH)
    init = encoder_train_params(92)
    wav, lens = torch.from_numpy(wav_np).to(dev), torch.full((BATCH,), wav_np.shape[1], device=dev)
    frozen = to_torch(init, dev)  # the weights of the deterministic calls

    def deterministic_call() -> tuple[dict, dict]:
        reset_launches()
        with torch.inference_mode():
            out = convnext_apply(frozen, wav, lens, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in out.items()}, count_launches()

    before, before_launches = deterministic_call()
    timings, profile = {}, None
    reset_launches()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(dev).manual_seed(93)
        aug_gen = torch.Generator(dev).manual_seed(94)
        one = convnext_step_fn(to_torch(init, dev), wav, torch.from_numpy(targets_np).to(dev),
                               dtype, gen, aug_gen)
        timings[name] = timed_steps(one, ENC_TRAIN_STEPS)
        if name == "bf16":
            profile = profiled(one)
        del one
        print(f"  ConvNeXt-Tiny training step at {name} ({BATCH} x {ENC_TRAIN_SECONDS:.0f} s, drop-path "
              f"0.1, SpecAugmentRatio, AdamW, clip 1): median {timings[name]['median_step_ms']:.2f} ms "
              f"over {ENC_TRAIN_STEPS} steps ({[round(t, 2) for t in timings[name]['step_ms']]}), "
              f"peak device memory {timings[name]['peak_memory_mib']:.0f} MiB, losses "
              f"{[round(x, 4) for x in timings[name]['losses']]}; {smi}", flush=True)
    train_launches = count_launches()
    print(f"  a profiled bf16 training step: {profile['device_ms']:.2f} ms of kernels in "
          f"{profile['wall_ms']:.2f} ms; custom op calls {profile['op_calls']}, kernel calls "
          f"{profile['calls']}; wrapper launches over the training steps {train_launches}; top "
          f"{profile['top']}", flush=True)
    assert train_launches == dict.fromkeys(train_launches, 0), train_launches
    assert profile["op_calls"] == dict.fromkeys(profile["op_calls"], 0), profile["op_calls"]
    assert profile["calls"] == dict.fromkeys(profile["calls"], 0), profile["calls"]

    after, after_launches = deterministic_call()
    same = {k: same_bits(before[k], after[k]) for k in before}
    print(f"  the deterministic bf16 encoder on the same waveforms, before and after the training "
          f"steps (on memory they recycled): wrapper launches {before_launches} and "
          f"{after_launches}, same bits {same}", flush=True)
    want = {"logmel": 1, "convnext_block": 18, "downsample": 3}
    assert before_launches == after_launches == want, (before_launches, after_launches)
    assert all(same.values()), same
    del frozen, wav, before, after
    torch.cuda.empty_cache()
    versus = encoder_card_vs_cpu(init, wav_np[:ENC_CHECK_CLIPS], targets_np[:ENC_CHECK_CLIPS])
    return {"timing": timings, "profiled_bf16_step": profile, "training_launches": train_launches,
            "deterministic_launches": after_launches, "deterministic_same_bits": same,
            "card_vs_cpu": versus}


@contextlib.contextmanager
def replayed_masks(masks: list, record: bool):
    """Dropout masks as ``layers._keep_mask`` draws them: with ``record``,
    drawn as usual and appended to ``masks`` (on the CPU); else ``masks``
    given back in order, on the caller's device."""
    from conette_torch.models import layers

    draw, it = layers._keep_mask, iter(list(masks))

    def keep_mask(gen, shape, keep, device, cols=None):
        if record:
            masks.append(draw(gen, shape, keep, device, cols).cpu())
            return masks[-1].to(device)
        return next(it).to(device)

    layers._keep_mask = keep_mask
    try:
        yield masks
    finally:
        layers._keep_mask = draw


def pann_outputs(name, tree, wav, dev, gen=None):
    """A PANN encoder's training-mode outputs: ``apply_pann_model``, or for
    Cnn14 (dropout) ``pann_apply`` with ``gen``."""
    import torch

    from conette_torch.models.pann import apply_pann_model, pann_apply

    w = torch.from_numpy(wav).to(dev)
    lens = torch.full((len(wav),), wav.shape[1], device=dev)
    if name == "cnn14":
        return pann_apply(tree, w, lens, deterministic=False, gen=gen)
    return apply_pann_model(name, tree, w, lens, deterministic=False)


def nudged_np(a: np.ndarray, scale: float = NUDGE) -> np.ndarray:
    """``a`` scaled by 1 + ``scale``·N(0, 1), drawn from a seed."""
    return (a * (1 + scale * np.random.default_rng(0).standard_normal(a.shape))).astype(np.float32)


def pann_grads(name, tree_np, wav, dev, masks=None, record=False, nudge=False) -> dict:
    """Gradients over the float leaves of Σ(frame_embs · w), w drawn from a
    seed, on ``dev``: the frame embeddings, which a captioning model trains
    through (the clip head's max over frames would route a gradient to
    whichever frame rounding makes the larger of two near-equal ones, on
    either device). Cnn14's dropout masks are drawn from a CPU generator and
    appended to ``masks`` with ``record``, else given back from ``masks``;
    with ``nudge``, the waveform and every float leaf are scaled by 1 +
    NUDGE_GRAD·N(0, 1)."""
    import torch

    from conette_torch.weights import to_torch

    tree = to_torch(tree_np, dev)
    leaves = float_leaves(tree)
    if nudge:
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for _, t in leaves:
                t.mul_(1 + NUDGE_GRAD * torch.randn(t.shape, generator=g).to(dev))
    for _, t in leaves:
        t.requires_grad_()
    scope = contextlib.nullcontext() if masks is None else replayed_masks(masks, record)
    with scope:
        out = pann_outputs(name, tree, nudged_np(wav, NUDGE_GRAD) if nudge else wav, dev,
                           gen=torch.Generator().manual_seed(99))
    w = np.random.default_rng(100).standard_normal(tuple(out["frame_embs"].shape))
    loss = (out["frame_embs"] * torch.from_numpy(w.astype(np.float32)).to(dev)).sum()
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                                materialize_grads=True)
    return {k: g.cpu() for (k, _), g in zip(leaves, grads)}


def conv_bias_of(grads: dict, k: str) -> bool:
    """Whether leaf ``k`` is a 2-D conv's bias (its sibling weight 4-D)."""
    weight = grads.get(k.removesuffix("bias") + "weight")
    return k.endswith("/bias") and weight is not None and weight.ndim == 4


def pann_training(dev, smi: str) -> dict:
    """Phase 9 (b): Cnn14 trains on the card; the zoo's training-mode
    forwards and five encoders' gradients, card against CPU."""
    import torch
    import torch.nn.functional as F

    from conette_torch.models.pann import build_pann_model, pann_apply
    from conette_torch.train import optim, step
    from conette_torch.weights import to_numpy, to_torch

    rng = np.random.default_rng(95)
    wav_np = np.stack(make_clips(rng, BATCH, ENC_TRAIN_SECONDS, 32_000))
    targets = torch.from_numpy(multi_hot(rng, BATCH)).to(dev)
    wav = torch.from_numpy(wav_np).to(dev)
    lens = torch.full((BATCH,), wav_np.shape[1], device=dev)
    params = to_torch(build_pann_model("cnn14", torch.Generator().manual_seed(96))[0], dev)

    def loss_fn(p, batch, g):
        out = pann_apply(p, wav, lens, deterministic=False, gen=g)
        return F.binary_cross_entropy(out["clipwise_output"], targets)

    opt, _ = optim.get_optimizer(params, lr=1e-4, weight_decay=0.05, sched_name="none")
    state = step.init_train_state(params, opt)
    fn = step.make_train_step(None, grad_clip_norm=1.0, loss_fn=loss_fn)
    gen = torch.Generator(dev).manual_seed(97)
    cnn14 = timed_steps(lambda: fn(state, {}, gen)[1]["train/loss"], ENC_TRAIN_STEPS)
    print(f"  Cnn14 training step (f32, {BATCH} x {ENC_TRAIN_SECONDS:.0f} s, dropout 0.2 / 0.5, AdamW, "
          f"clip 1): median {cnn14['median_step_ms']:.2f} ms over {ENC_TRAIN_STEPS} steps "
          f"({[round(t, 2) for t in cnn14['step_ms']]}), peak device memory "
          f"{cnn14['peak_memory_mib']:.0f} MiB, losses {[round(x, 4) for x in cnn14['losses']]}; "
          f"{smi}", flush=True)
    del state, opt, fn, params
    torch.cuda.empty_cache()

    check = wav_np[:ENC_CHECK_CLIPS]
    # the decision-level heads run Cnn14's body, whose dropout needs a
    # generator that apply_pann_model does not take: Cnn14's gradients below
    no_dropout = [n for n in ZOO_NAMES if not n.startswith("cnn14_decisionlevel")]
    trees = {}
    for i, name in enumerate(dict.fromkeys(no_dropout + list(PANN_GRAD_NAMES))):
        tree = to_numpy(build_pann_model(name, torch.Generator().manual_seed(98 + i))[0])
        trees[name] = without_conv_biases(random_batch_norms(tree, np.random.default_rng(98 + i)))
    forward = {}
    for name in no_dropout:
        with torch.no_grad():
            cpu = pann_outputs(name, to_torch(trees[name]), check, "cpu")
            card = pann_outputs(name, to_torch(trees[name], dev), check, dev)
        rec = {}
        for k, want in cpu.items():
            got = card[k].cpu()
            assert got.shape == want.shape and torch.isfinite(got.float()).all(), (name, k)
            if not want.is_floating_point():
                assert torch.equal(got, want), (name, k)
                continue
            rec[k] = {"rel_err": errors(want, got)[1]}
        if max(r["rel_err"] for r in rec.values()) > PANN_REL_TOL:
            with torch.no_grad():
                again = pann_outputs(name, to_torch(trees[name], dev), nudged_np(check), dev)
            for k, r in rec.items():
                r["nudge_rel"] = errors(card[k].cpu(), again[k].cpu())[1]
                assert r["rel_err"] <= max(PANN_REL_TOL, COND * r["nudge_rel"]), (name, k, r)
        forward[name] = rec
    print("  training-mode forwards, card vs CPU (2 x 10 s, f32), max error relative to the largest "
          "value (and the card's own change on a nudged waveform, where it exceeds "
          f"{PANN_REL_TOL}): " + "; ".join(
              f"{n} " + ", ".join(f"{k} {r['rel_err']:.1e}" + (f" ({r['nudge_rel']:.1e})"
                                                              if "nudge_rel" in r else "")
                                  for k, r in rec.items()) for n, rec in forward.items()), flush=True)

    grads = {}
    for name in PANN_GRAD_NAMES:
        masks = [] if name == "cnn14" else None
        cpu = pann_grads(name, trees[name], check, "cpu", masks, record=True)
        card = pann_grads(name, trees[name], check, dev, masks)
        again, over, noise, rel, l2, over_tol = None, 0.0, 0.0, {}, {}, []
        for k, want in cpu.items():
            if conv_bias_of(cpu, k):
                ratio = max(want.abs().max().item(), card[k].abs().max().item()) / max(
                    cpu[k.removesuffix("bias") + "weight"].abs().max().item(), 1e-30)
                noise = max(noise, ratio)
                assert ratio <= BIAS_NOISE, (name, k, ratio)
                continue
            rel[k] = errors(want, card[k])[1]
            l2[k] = float((want - card[k]).norm() / want.norm().clamp_min(1e-30))
            if rel[k] > ENC_TRAIN_TOL["grads"]:
                if again is None:
                    again = pann_grads(name, trees[name], check, dev, masks, nudge=True)
                sens = errors(card[k], again[k])[1]
                assert rel[k] <= COND_GRAD * sens, (name, k, rel[k], sens)
                over = max(over, rel[k] / sens)
                over_tol.append(k)
        grads[name] = {"max_rel_err": max(rel.values()), "worst_leaf": max(rel, key=rel.get),
                       "max_rel_l2": max(l2.values()), "leaves": len(rel),
                       "leaves_over_tol": over_tol, "over_tol_vs_nudge": over,
                       "conv_bias_noise": noise, "dropout_masks": 0 if masks is None else len(masks)}
        print(f"  {name} gradients, card vs CPU (2 x 10 s, f32"
              f"{'' if masks is None else f', the same {len(masks)} dropout masks'}): largest leaf "
              f"error relative to its largest value {grads[name]['max_rel_err']:.2e} "
              f"({grads[name]['worst_leaf']}; in norm {grads[name]['max_rel_l2']:.2e}); "
              f"{len(over_tol)} of {len(rel)} leaves over {ENC_TRAIN_TOL['grads']}, at most "
              f"{over:.2f} times the card's own change under a {NUDGE_GRAD} nudge (tol "
              f"{COND_GRAD}); conv-bias noise {noise:.1e} of their weights' largest gradient "
              f"(tol {BIAS_NOISE})", flush=True)
    return {"cnn14_timing": cnn14, "forward_card_vs_cpu": forward, "grads_card_vs_cpu": grads}


def encoder_training_phase(smi: str) -> dict:
    """Phase 9: the encoders' training mode at full width on the card."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {"convnext": convnext_training(dev, smi)}
    torch.cuda.empty_cache()
    out["pann"] = pann_training(dev, smi)
    out["phase_s"] = time.perf_counter() - t0
    return out


# phase 8: the parallel layer. The machine has one card, and NCCL takes one
# rank a device: a one-process NCCL group drives the mesh path at full
# width, and two processes share the card over gloo for the collectives.
PARALLEL_LR = 5e-4
PARALLEL_TIMEOUT_S = 300
TUNE_START, TUNE_CAP = 512, 65536


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_step(model_cfg, mesh=None, timed: int = 5, dev=None, split: bool = False) -> dict:
    """One production step (dropout, mixup with drawn λ and pairing, clip 1,
    AdamW at ``PARALLEL_LR``, wd 2.0) at batch ``BSIZE`` from seeds on this
    process's card, alone or, with ``mesh``, sharded: the global loss, the
    global batch's gradient (drawn from a copy of the generator's state)
    and the parameters after the step, whole, as numpy arrays; then the
    wall time of ``timed`` more steps, each synchronised (the median);
    with ``split``, one more step under the profiler (``profiled``: its
    random draws, all-reduce and all-gather kernels apart).
    ``dev``: this process's card unless given (the CPU rehearses it)."""
    import torch

    from conette_torch.models.conette import conette_init
    from conette_torch.parallel.distributed import all_reduce
    from conette_torch.parallel.mesh import axis, full_value, leaf_sharding, shard_batch
    from conette_torch.train import optim, step
    from conette_torch.train.objective import training_loss
    from conette_torch.weights import named_leaves, to_torch

    dev = dev or torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = to_torch(conette_init(torch.Generator().manual_seed(41), model_cfg), dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(model_cfg, np.random.default_rng(42)).items()}
    opt, _ = optim.get_optimizer(params, lr=PARALLEL_LR, weight_decay=2.0, sched_name="none")
    state = step.init_train_state(params, opt)
    if mesh is None:
        fn = step.make_train_step(model_cfg, grad_clip_norm=1.0)
    else:
        batch = shard_batch(batch, mesh)
        state, fn = step.make_sharded_train_step(model_cfg, opt, mesh, state, batch,
                                                 grad_clip_norm=1.0)
    gen = torch.Generator(dev).manual_seed(43)
    start = gen.get_state()
    named = named_leaves(state.params)
    grads = torch.autograd.grad(training_loss(state.params, model_cfg, batch, gen, mesh=mesh),
                                [t for _, t in named])
    if mesh is not None:  # the whole gradient of the global batch
        grads = [full_value(all_reduce(g, axis(mesh, "data").group), leaf_sharding(k, g, mesh), mesh)
                 for (k, _), g in zip(named, grads)]
    gen.set_state(start)
    sync()
    t0 = time.perf_counter()
    state, metrics = fn(state, batch, gen)
    loss = metrics["train/loss"].item()
    seconds = time.perf_counter() - t0
    out = {"loss": loss, "seconds": seconds,
           "grads": {k: g.cpu().numpy() for (k, _), g in zip(named, grads)},
           # copies: the timed steps below update the leaves in place
           "params": {k: t.detach().cpu().numpy().copy()
                      for k, t in named_leaves(step.gather_params(state.params, mesh))}}
    times = []
    for _ in range(timed):
        sync()
        t0 = time.perf_counter()
        fn(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t0)
    out["step_ms"] = statistics.median(times) * 1e3
    if split:
        prof = profiled(lambda: fn(state, batch, gen))
        out["split"] = {k: prof[k] for k in ("wall_ms", "device_ms", "kinds_ms", "top")}
    return out


def same_step(want: dict, got: dict, what: str) -> dict:
    """``got`` against ``want`` as ``step_card_vs_cpu`` holds them: the loss,
    the gradient and the parameters relative to the largest value of their
    kind; elements whose gradient sign is rounding (the two differ by as
    much as the gradient) are held to 2·lr apart."""
    gdiff = {k: np.abs(got["grads"][k] - want["grads"][k]) for k in want["grads"]}
    pdiff = {k: np.abs(got["params"][k] - want["params"][k]) for k in want["params"]}
    rounding = {k: (gdiff[k] > 0) & (gdiff[k] >= np.abs(want["grads"][k])) for k in gdiff}
    res = {
        "loss_want": want["loss"], "loss_got": got["loss"],
        "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "grads": max(float(d.max()) for d in gdiff.values())
        / max(float(np.abs(g).max()) for g in want["grads"].values()),
        "params": max(float(np.where(rounding[k], 0.0, pdiff[k]).max()) for k in pdiff)
        / max(float(np.abs(p).max()) for p in want["params"].values()),
        "sign_rounding_elements": {k: int(m.sum()) for k, m in rounding.items() if m.any()},
        "sign_rounding_max_abs_diff": max((float(pdiff[k][m].max()) for k, m in rounding.items()
                                           if m.any()), default=0.0),
    }
    print(f"  {what}: loss {res['loss_got']:.7f} vs {res['loss_want']:.7f} (rel {res['loss']:.2e}, "
          f"tol {STEP_TOL['loss']}), grads rel {res['grads']:.2e} (tol {STEP_TOL['grads']}), "
          f"params rel {res['params']:.2e} (tol {STEP_TOL['params']}), sign-rounding elements "
          f"{sum(res['sign_rounding_elements'].values())} at most "
          f"{res['sign_rounding_max_abs_diff']:.2e} apart (tol {2 * PARALLEL_LR})", flush=True)
    for k, tol in STEP_TOL.items():
        assert res[k] <= tol, (what, k, res[k], tol)
    assert res["sign_rounding_max_abs_diff"] <= 2 * PARALLEL_LR, (what, res)
    return res


def parallel_rank(rank: int, world: int, port: int, ckpt: str, paths: list, tasks: list,
                  model_cfg) -> dict:
    """One of two processes sharing the card over gloo: the DP = 2 step on
    its 256 rows, then ``caption_corpus(mesh=)`` over the corpus."""
    import torch

    import conette_torch
    from conette_torch.parallel.distributed import initialize
    from conette_torch.parallel.mesh import make_mesh
    from conette_torch.serving import caption_corpus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(f"127.0.0.1:{port}", world, rank, local_rank=0, device="cuda", backend="gloo",
               timeout_s=PARALLEL_TIMEOUT_S)
    mesh = make_mesh(world)
    step_res = parallel_step(model_cfg, mesh)
    model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    results = caption_corpus(model, paths, task=tasks, batch_size=BATCH, mesh=mesh)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    return {"step": step_res if rank == 0 else {"loss": step_res["loss"]},
            "step_s": step_res["seconds"], "step_ms": step_res["step_ms"], "corpus_s": corpus_s,
            "captions": [[r.fname, r.task, r.caption, r.lprob] for r in results]}


def rank_entry(work, rank: int, world: int, port: int, args: tuple, out) -> None:
    """``work(rank, world, port, *args)`` in a spawned process: its result, or
    its traceback, goes to ``out``; its process group is destroyed on the
    way out."""
    import traceback

    import torch.distributed as dist

    try:
        out.put((rank, None, work(rank, world, port, *args)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(work, world: int, args: tuple, meanwhile=lambda: None) -> tuple[list, Any]:
    """``work`` in ``world`` spawned processes (``rank_entry``), and
    ``meanwhile()`` in this one while they run; a failure or a group that
    outlives ``PARALLEL_TIMEOUT_S`` fails the phase, and no process is
    left."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_entry, args=(work, r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    here = None
    try:
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        here = meanwhile()
        while len(results) < world:
            rank, err, res = out.get(timeout=max(deadline - time.monotonic(), 1.0))
            if err is not None:
                raise AssertionError(f"rank {rank} failed:\n{err}")
            results[rank] = res
    except queue.Empty:
        raise AssertionError(f"the {world} processes did not finish in {PARALLEL_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)], here


def trace_names(path: str) -> dict:
    """How many events of each kernel's main function a Chrome trace holds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {name: sum(1 for e in events if marker in str(e.get("name", "")) and e.get("cat") == "kernel")
            for name, marker in CALL_MARKERS.items()}


def parallel_phase(ckpt: str, corpus: dict, work_dir: str, smi: str) -> dict:
    """Phase 8: (a) a one-process NCCL group at full width: the 1 x 1 mesh's
    ``make_sharded_caption_fn`` against ``caption_batch`` (bit-equal tokens,
    18 + 3 + 1 kernels in a profiled call) and ``make_sharded_train_step``
    against ``make_train_step`` at batch 512; (b) two processes sharing the
    card over gloo: the DP = 2 step (256 rows a rank) and
    ``caption_corpus(mesh=)`` over phase 4's files against one process;
    (c) ``utils/profiling.trace`` around a warm request and
    ``train/tune.find_max_batch_size`` on the production step."""
    import torch
    import torch.distributed as dist

    import conette_torch
    from conette_torch.models.conette import ConetteConfig, conette_init
    from conette_torch.parallel.distributed import initialize
    from conette_torch.parallel.mesh import make_mesh
    from conette_torch.serving import caption_batch, caption_corpus, make_sharded_caption_fn
    from conette_torch.train.tune import tune_batch_size_for_model
    from conette_torch.utils.profiling import trace
    from conette_torch.weights import to_torch

    t_phase = time.perf_counter()
    model_cfg = ConetteConfig(vocab_size=4000 + 4 + 4)
    out: dict = {"card": smi}

    # (a) one process, NCCL, full width
    initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda", backend="nccl")
    try:
        mesh = make_mesh(1)
        model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
        tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
        rng = np.random.default_rng(8)
        wav, lens = model.preprocessor.load_resample(make_clips(rng, BATCH, 10.0, 44100), 44100)
        bos = bos_ids(model, tasks)
        reset_launches()
        fn = make_sharded_caption_fn(model, mesh, beam_size=3)
        t0 = time.perf_counter()
        preds, lprobs = fn(wav, lens, bos)
        first_ms = (time.perf_counter() - t0) * 1e3
        out["launches"] = count_launches()
        done, want_preds, want_lprobs = caption_batch(model, wav, lens, bos, 3)
        done.synchronize()
        assert torch.equal(preds, want_preds) and torch.equal(lprobs, want_lprobs), "1 x 1 mesh tokens"
        prof = profiled(lambda: fn(wav, lens, bos))
        assert prof["calls"] == {"logmel": 1, "convnext_block": 18, "downsample": 3}, prof["calls"]
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(wav, lens, bos)
            warm.append((time.perf_counter() - t0) * 1e3)
        out["sharded_caption"] = {"first_ms": first_ms, "warm_ms": warm, "calls": prof["calls"],
                                  "tokens_equal_caption_batch": True}
        print(f"  (a) one-process NCCL group, 1 x 1 mesh: make_sharded_caption_fn on 8 x 10 s "
              f"equals caption_batch bit for bit; first call {first_ms:.1f} ms (captures; wrapper "
              f"launches {out['launches']}), warm {[round(x, 1) for x in warm]} ms; a profiled "
              f"call's kernels {prof['calls']}", flush=True)
        assert all(v > 0 for v in out["launches"].values()), out["launches"]

        # (c) first part: a trace around one warm request
        clips = make_clips(rng, BATCH, 10.0, 44100)
        model(clips, sr=44100, task=tasks)
        trace_dir = os.path.join(work_dir, "trace")
        t0 = time.perf_counter()
        with trace(trace_dir):
            model(clips, sr=44100, task=tasks)
        out["trace"] = {"seconds": time.perf_counter() - t0,
                        "kernel_events": trace_names(os.path.join(trace_dir, "trace.json"))}
        print(f"  (c) utils/profiling.trace around a warm request: {out['trace']['seconds']:.2f} s, "
              f"kernel events in its trace.json {out['trace']['kernel_events']}", flush=True)
        assert all(v > 0 for v in out["trace"]["kernel_events"].values()), out["trace"]
        del model

        single = parallel_step(model_cfg)
        sharded = parallel_step(model_cfg, mesh)
        out["step_1x1"] = same_step(single, sharded, "(a) make_sharded_train_step on a 1 x 1 mesh "
                                    f"against make_train_step, batch {BSIZE}")
        out["step_1x1"]["seconds"] = {"single": single["seconds"], "sharded": sharded["seconds"]}
        out["step_1x1"]["step_ms"] = {"single": single["step_ms"], "sharded": sharded["step_ms"]}
        print(f"  (a) warm steps (median of 5): alone {single['step_ms']:.2f} ms, on the 1 x 1 mesh "
              f"{sharded['step_ms']:.2f} ms", flush=True)
    finally:
        dist.destroy_process_group()

    # (b) two processes sharing the card over gloo; meanwhile, this process
    # captions the corpus alone at each rank's 4 rows a program
    def one_process():
        model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        results = caption_corpus(model, corpus["paths"], task=corpus["tasks"], batch_size=BATCH // 2)
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0

    t0 = time.perf_counter()
    ranks, (one_4, one_s) = spawn_ranks(parallel_rank, 2, (ckpt, corpus["paths"], corpus["tasks"],
                                                         model_cfg), one_process)
    two_s = time.perf_counter() - t0
    out["dp2_step"] = same_step(single, ranks[0]["step"], "(b) DP = 2 over gloo, 256 rows a rank, "
                                "against the one-process step")
    assert ranks[1]["step"]["loss"] == ranks[0]["step"]["loss"]
    want4 = [[r.fname, r.task, r.caption, r.lprob] for r in one_4]
    assert ranks[0]["captions"] == ranks[1]["captions"] == want4, "two-process corpus"
    same8 = sum(a[2] == b[1] for a, b in zip(ranks[0]["captions"], corpus["captions"]))
    out["dp2"] = {"seconds": two_s, "step_s": [r["step_s"] for r in ranks],
                  "step_ms": [r["step_ms"] for r in ranks],
                  "corpus_s": [r["corpus_s"] for r in ranks], "one_process_corpus_s": one_s,
                  "files": len(corpus["paths"]),
                  "captions_equal_one_process_4_rows": True,
                  "captions_equal_phase4_8_rows": same8}
    print(f"  (b) two processes over gloo on one card: captions of the {len(corpus['paths'])} files "
          f"equal one process's at 4 rows a program (each rank's share of a batch of 8), "
          f"{same8}/{len(corpus['paths'])} equal phase 4's at 8 rows; step "
          f"{[round(x, 3) for x in out['dp2']['step_s']]} s (warm {[round(x, 1) for x in out['dp2']['step_ms']]} "
          f"ms), corpus "
          f"{[round(x, 2) for x in out['dp2']['corpus_s']]} s a rank (one process alone, at the "
          f"same time: {one_s:.2f} s), {two_s:.1f} s with start-up "
          f"({smi}). Two ranks sharing one card is no scaling number; multi-card numbers come from "
          f"multicard() on a host of four cards.", flush=True)

    # (c) second part: the batch-size search on the production step
    params = to_torch(conette_init(torch.Generator().manual_seed(44), model_cfg), torch.device("cuda"))
    t0 = time.perf_counter()
    largest = tune_batch_size_for_model(model_cfg, params, start=TUNE_START, max_bsize=TUNE_CAP)
    del params
    torch.cuda.empty_cache()
    stop = "the cap" if largest * 2 > TUNE_CAP else "out of memory"
    out["tune"] = {"largest": largest, "stopped_on": stop, "seconds": time.perf_counter() - t0,
                   "start": TUNE_START, "cap": TUNE_CAP}
    print(f"  (c) train/tune.find_max_batch_size on the production step: largest batch {largest}, "
          f"stopped on {stop}, {out['tune']['seconds']:.1f} s", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out




def parallel_alone() -> dict:
    """Phase 8 on its own, with what it takes from phases 1, 3 and 4 (the
    kernels, the full-width checkpoint, the corpus and its captions at 8
    rows a program):
    ``python3 -c 'import chip_smoke as c; c.parallel_alone()'``."""
    import torch

    import conette_torch
    from conette_torch.kernels import _build
    from conette_torch.serving import caption_corpus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as work:
        ckpt = build_model(work)
        paths, tasks, _ = write_corpus(work)
        results = caption_corpus(conette_torch.conette(ckpt, compute_dtype=torch.bfloat16), paths,
                                 task=tasks, batch_size=BATCH)
        corpus = {"paths": paths, "tasks": tasks,
                  "captions": [[r.task, r.caption, r.lprob] for r in results]}
        out = parallel_phase(ckpt, corpus, work, smi)
    print(json.dumps(out, default=float), flush=True)
    return out


# the parallel layer across the cards of one host (not part of ``main``,
# which needs one card): one process a card over NCCL
MULTICARD_CARDS = 4
MAIN_TRAIN_EPOCHS = 2
MAIN_TRAIN_LR = 5e-4  # expt=hp_clotho_v2's pl.lr
FIT_PARAM_TOL = 1e-4


def multicard_rank(rank: int, world: int, port: int, ckpt: str, model_cfg, batch_npz: str) -> dict:
    """One process a card over NCCL: the data-parallel and the 2-way
    tensor-parallel steps, then ``make_sharded_caption_fn`` over
    ``world`` x 8 clips (8 rows a card)."""
    import torch

    import conette_torch
    from conette_torch.parallel.distributed import initialize
    from conette_torch.parallel.mesh import make_mesh
    from conette_torch.serving import make_sharded_caption_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(f"127.0.0.1:{port}", world, rank, local_rank=rank, device="cuda",
               timeout_s=PARALLEL_TIMEOUT_S)
    out = {}
    for mp in (1, 2):
        res = parallel_step(model_cfg, make_mesh(world, mp), split=True)
        out[f"data{world // mp}_model{mp}"] = (
            res if rank == 0 else {k: res[k] for k in ("loss", "step_ms", "split")})
    model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
    batch = np.load(batch_npz)
    fn = make_sharded_caption_fn(model, make_mesh(world), beam_size=3)
    preds, lprobs = fn(batch["wav"], batch["lens"], batch["bos"])  # captures
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(batch["wav"], batch["lens"], batch["bos"])
        warm.append((time.perf_counter() - t0) * 1e3)
    out["captions"] = {"preds": preds.numpy(), "lprobs": lprobs.numpy(), "warm_ms": warm}
    return out


def fit_record(run_dir: str) -> dict:
    """A run directory's per-step train losses, fit seconds, and the best
    checkpoint's parameters and Adam first moments."""
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in sorted((r for r in recs if "train/loss" in r),
                                             key=lambda r: r["step"])]
    fit = next(r for r in recs if "fit_duration_s" in r)
    best = os.path.join(run_dir, "checkpoints", "best")
    with np.load(os.path.join(best, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    with np.load(os.path.join(best, "opt_state.npz")) as z:
        moments = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
    return {"losses": losses, "fit_s": fit["fit_duration_s"], "wait_s": fit["fit_batch_wait_s"],
            "steps": fit["fit_global_step"], "params": params, "moments": moments}


def same_fit(a: dict, b: dict, lr: float) -> dict:
    """The best parameters of two runs of ``fit_record``, as ``same_step``
    holds a step's: within ``FIT_PARAM_TOL`` of each other (the JAX
    package's bound for a multi-process fit), apart from the elements whose
    first moment is rounding (the two runs' ``exp_avg`` differ by as much as
    it), which are held to Adam's reach, 2·lr a step. The five elements
    that differ most are listed with both runs' moments."""
    rows = []
    res = {"param_max_abs": 0.0, "rounding_elements": {}, "rounding_max_abs": 0.0}
    for k in a["params"]:
        diff = np.abs(a["params"][k] - b["params"][k]).reshape(-1)
        m_a, m_b = (r["moments"][f"{k}/exp_avg"].reshape(-1) for r in (a, b))
        rounding = (np.abs(m_a - m_b) > 0) & (np.abs(m_a - m_b) >= np.abs(m_a))
        held = np.where(rounding, 0.0, diff)
        res["param_max_abs"] = max(res["param_max_abs"], float(held.max()))
        if rounding.any():
            res["rounding_elements"][k] = int(rounding.sum())
            res["rounding_max_abs"] = max(res["rounding_max_abs"], float(diff[rounding].max()))
        for i in np.argsort(-diff)[:5]:
            v_a, v_b = (r["moments"][f"{k}/exp_avg_sq"].reshape(-1)[i] for r in (a, b))
            rows.append({"leaf": k, "index": int(i), "diff": float(diff[i]),
                         "param": float(a["params"][k].reshape(-1)[i]), "exp_avg": [float(m_a[i]),
                         float(m_b[i])], "exp_avg_sq": [float(v_a), float(v_b)],
                         "rounding": bool(rounding[i])})
    res["largest"] = sorted(rows, key=lambda r: -r["diff"])[:5]
    res["reach"] = 2 * lr * a["steps"]
    return res


def multicard(cards: int = MULTICARD_CARDS) -> dict:
    """The parallel layer across ``cards`` cards of one host, one process a
    card over NCCL (run it in a call that holds them:
    ``python3 -c 'import chip_smoke as c; c.multicard()'``):
    the DP = ``cards`` and (``cards`` / 2) x 2 steps at batch ``BSIZE``
    against one card (``same_step``), ``make_sharded_caption_fn`` over
    ``cards`` x 8 clips against ``caption_batch`` on one card, 8 rows at a
    time (bit-equal), and ``torchrun`` of ``conette_torch.train.main`` over
    the cards against one process on one card (train-b512's packs, the pad
    shapes fixed: per-step losses within ``STEP_TOL``, the best
    checkpoint's parameters as ``same_fit`` holds them). Each step is also
    profiled once on one card and on every rank, its random draws,
    all-reduce and all-gather kernels apart."""
    import torch

    import conette_torch
    from conette_torch.kernels import _build
    from conette_torch.models.conette import ConetteConfig
    from conette_torch.serving import caption_batch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        raise SystemExit(f"multicard: needs {cards} CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    _build.library()
    model_cfg = ConetteConfig(vocab_size=4000 + 4 + 4)
    out: dict = {"cards": smi}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as work:
        ckpt = build_model(work)
        model = conette_torch.conette(ckpt, compute_dtype=torch.bfloat16)
        tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * (2 * cards)
        wav, lens = model.preprocessor.load_resample(
            make_clips(np.random.default_rng(9), BATCH * cards, 10.0, 44100), 44100)
        bos = bos_ids(model, tasks)
        want, one_ms = [], []
        for _ in range(4):  # the first captures
            t0 = time.perf_counter()
            want = [caption_batch(model, wav[i:i + BATCH], lens[i:i + BATCH], bos[i:i + BATCH], 3)
                    for i in range(0, len(wav), BATCH)]
            for done, _, _ in want:
                done.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
        want_preds = np.concatenate([p.numpy() for _, p, _ in want])
        want_lprobs = np.concatenate([lp.numpy() for _, _, lp in want])
        del model
        batch_npz = os.path.join(work, "batch.npz")
        np.savez(batch_npz, wav=wav, lens=lens, bos=bos)
        single = parallel_step(model_cfg, split=True)

        t0 = time.perf_counter()
        ranks, _ = spawn_ranks(multicard_rank, cards, (ckpt, model_cfg, batch_npz))
        out["ranks_s"] = time.perf_counter() - t0
        out["step_ms"] = {"one_card": single["step_ms"]}
        for name in (f"data{cards}_model1", f"data{cards // 2}_model2"):
            out[name] = same_step(single, ranks[0][name], f"{name} over {cards} cards (NCCL) against "
                                  f"one card, batch {BSIZE}")
            out["step_ms"][name] = [r[name]["step_ms"] for r in ranks]
        out["step_split"] = {"one_card": single["split"]} | {
            name: [r[name]["split"] for r in ranks]
            for name in (f"data{cards}_model1", f"data{cards // 2}_model2")}
        for name, splits in out["step_split"].items():
            for i, sp in enumerate(splits if isinstance(splits, list) else [splits]):
                kinds = sp["kinds_ms"]
                print(f"  a profiled step, {name}{f' rank {i}' if isinstance(splits, list) else ''}: "
                      f"wall {sp['wall_ms']:.2f} ms, kernels {sp['device_ms']:.2f} ms: random draws "
                      f"{kinds['draws']:.2f}, all-reduce {kinds['all_reduce']:.2f}, all-gather "
                      f"{kinds['all_gather']:.2f}, the rest "
                      f"{sp['device_ms'] - sum(kinds.values()):.2f}", flush=True)
        for r in ranks:
            assert np.array_equal(r["captions"]["preds"], want_preds), "sharded tokens"
            assert np.array_equal(r["captions"]["lprobs"], want_lprobs), "sharded lprobs"
        out["captions"] = {"rows": len(wav), "one_card_ms": one_ms[1:],
                           "cards_ms": [r["captions"]["warm_ms"] for r in ranks]}
        print(f"  steps at batch {BSIZE} (warm, median of 5): one card {single['step_ms']:.2f} ms; "
              + "; ".join(f"{k} {[round(x, 2) for x in v]} ms a rank"
                          for k, v in out["step_ms"].items() if k != "one_card")
              + f". make_sharded_caption_fn over {len(wav)} clips of 10 s: the tokens and lprobs of "
              f"caption_batch on one card 8 rows at a time, bit for bit; {cards} cards "
              f"{[round(x, 1) for x in out['captions']['cards_ms'][0]]} ms a call, one card "
              f"{[round(x, 1) for x in one_ms[1:]]} ms", flush=True)

        hdf = os.path.join(work, "hdf")
        os.makedirs(hdf)
        pack_corpus(hdf)
        argv = ["expt=hp_clotho_v2", "ckpts.monitor=val/loss", "ckpts.fallback_monitor=val/loss",
                "ckpts.mode=min", f"trainer.max_epochs={MAIN_TRAIN_EPOCHS}",
                "trainer.log_every_n_steps=1", f"dm.hdf_root={hdf}",
                "dm.train_hdfs=[clotho_dev_emb.hdf]", "dm.val_hdfs=[clotho_val_emb.hdf]",
                "dm.test_hdfs=[]", "dm.fixed_shapes=true"]
        env = dict(os.environ, HF_HUB_OFFLINE="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        runs = {}
        for name, launch, extra, visible in (
                ("one_card", [], [f"dm.bsize={BSIZE}"], "0"),
                (f"torchrun_{cards}", ["-m", "torch.distributed.run", "--nproc-per-node", str(cards),
                                       "--master-port", str(free_port())],
                 [f"dm.bsize={BSIZE // cards}"], ",".join(map(str, range(cards))))):
            log_root = os.path.join(work, f"logs_{name}")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *launch, "-m", "conette_torch.train.main", *argv,
                                   *extra, f"log_root={log_root}"], cwd=REPO, capture_output=True,
                                  text=True, timeout=PARALLEL_TIMEOUT_S,
                                  env=env | {"CUDA_VISIBLE_DEVICES": visible})
            assert proc.returncode == 0, (name, proc.stderr[-4000:])
            (run_dir,) = [os.path.join(log_root, d) for d in os.listdir(log_root)]
            runs[name] = fit_record(run_dir) | {"wall_s": time.perf_counter() - t0}
        a, b = runs["one_card"], runs[f"torchrun_{cards}"]
        loss_rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
        fit_cmp = same_fit(a, b, MAIN_TRAIN_LR)
        out["main_train"] = {
            name: {k: v for k, v in r.items() if k not in ("params", "moments")}
            for name, r in runs.items()}
        out["main_train"].update(loss_rel=loss_rel, **fit_cmp)
        print(f"  torchrun of conette_torch.train.main over {cards} cards (dm.bsize "
              f"{BSIZE // cards} a rank) against one card (dm.bsize {BSIZE}), {a['steps']} steps: "
              f"losses rel {loss_rel:.2e} (tol {STEP_TOL['loss']}), best parameters "
              f"{fit_cmp['param_max_abs']:.2e} apart at most (tol {FIT_PARAM_TOL}) but "
              f"{sum(fit_cmp['rounding_elements'].values())} elements whose first moment is "
              f"rounding, {fit_cmp['rounding_max_abs']:.2e} apart at most (Adam's reach "
              f"{fit_cmp['reach']:.1e}); fit {b['fit_s']:.2f} s against {a['fit_s']:.2f} s "
              f"(waiting on the host's batch {b['wait_s']:.2f} s against {a['wait_s']:.2f} s), wall "
              f"{b['wall_s']:.1f} s against {a['wall_s']:.1f} s", flush=True)
        for r in fit_cmp["largest"]:
            print(f"    {r['leaf']}[{r['index']}]: {r['diff']:.3e} apart (value {r['param']:.4e}; "
                  f"exp_avg {r['exp_avg'][0]:.3e} / {r['exp_avg'][1]:.3e}, exp_avg_sq "
                  f"{r['exp_avg_sq'][0]:.3e} / {r['exp_avg_sq'][1]:.3e}; rounding {r['rounding']})",
                  flush=True)
    print(json.dumps(out, default=float), flush=True)
    assert len(a["losses"]) == len(b["losses"]) == a["steps"] == b["steps"], (a["steps"], b["steps"])
    assert loss_rel <= STEP_TOL["loss"], loss_rel
    assert fit_cmp["param_max_abs"] <= FIT_PARAM_TOL, fit_cmp
    assert fit_cmp["rounding_max_abs"] <= fit_cmp["reach"], fit_cmp
    return out


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
            # the seam's yardstick is two calls (F.layer_norm, then F.conv2d)
            "library_ms": (sum(r["per_request"] * r["library_ms"] for r in rs)
                           if all("library_ms" in r for r in rs) else None),
            **({"library_calls": "F.layer_norm + F.conv2d"} if name == "downsample" else {}),
            "shapes": [{k: r[k] for k in ("shape", "variant", "per_request", "splits", "slices",
                                          "ms", "launch_ms", "plain_ms", "library_ms",
                                          "unfused_ms", "bound_ms", "bound_by", "max_abs_err",
                                          "max_rel_err", "same_bits_twice", "same_bits_repeated",
                                          "same_bits_poisoned",
                                          "launch_ms_by_splits", "launch_ms_by_slices") if k in r}
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
        summary, model = main_path(dev, work, smi)
        print(f"  clips/s over the 3 requests: {summary['clips_per_s']:.2f}", flush=True)
        print(f"phase 4: corpus serving, {CORPUS_FILES} WAV and FLAC files, batch 8", flush=True)
        served = serve_corpus(model, work)
        print("phase 8 (run here, while phase 4's corpus is on disk): the parallel layer", flush=True)
        parallel = parallel_phase(os.path.join(work, "ckpt"), served, work, smi)
        print(f"  phase 8 took {parallel['phase_s']:.1f} s", flush=True)
        print("phase 5: export at batch 8 x 10 s, save, load, replay", flush=True)
        exported = export_phase(model, work)
        del model
        print(f"phase 6: training at batch {BSIZE} (pl/conette, expt/hp_clotho_v2), 2 epochs, "
              "then captioning from the run directory", flush=True)
        trained = training_phase(work)
        print("phase 7: prepare, host audio and the PANN encoders", flush=True)
        t0 = time.perf_counter()
        prepared = prepare_phase(work)
        prepared["phase_s"] = time.perf_counter() - t0
        print(f"  phase 7 took {prepared['phase_s']:.1f} s", flush=True)
        print("phase 9: the encoders' training mode (ConvNeXt-Tiny and Cnn14 at full width)",
              flush=True)
        enc_train = encoder_training_phase(smi)
        print(f"  phase 9 took {enc_train['phase_s']:.1f} s", flush=True)

    line = kernel_line(records, summary["launches"])
    for k in line["kernels"]:
        # wrapper launches: the warm-up and capture of each path's graphs;
        # replay_calls: the kernel's calls in a profiled replay of the path
        k["replay_calls_per_request"] = summary["replayed_request"]["calls"][k["name"]]
        k["serving_launches"] = served["launches"][k["name"]]
        k["serving_replay_calls"] = served["replay_calls"][k["name"]]
        k["export_launches"] = exported["launches"][k["name"]]
        # phase 6: the capture's wrapper launches, the eager encoder's on the
        # replayed waveforms, and the replay's kernel rows (log-mel's may be
        # missing from the trace, PERF.md §7)
        k["training_launches"] = trained["launches"][k["name"]]
        k["training_eager_launches"] = trained["eager_encoder_launches"][k["name"]]
        k["training_replay_calls"] = trained["replay_calls"][k["name"]]
        # phase 7: prepare's f32 encoder takes the plain route (asserted 0)
        k["prepare_launches"] = prepared["prepare_launches"][k["name"]]
        # phase 8: the 1 x 1 mesh's make_sharded_caption_fn as it captures,
        # and its kernel calls in a profiled call
        k["parallel_launches"] = parallel["launches"][k["name"]]
        k["parallel_replay_calls"] = parallel["sharded_caption"]["calls"][k["name"]]
        # phase 9: the deterministic bf16 encoder after the training steps
        # (which launch none)
        k["encoder_training_launches"] = enc_train["convnext"]["deterministic_launches"][k["name"]]
        if min(k["launches"], k["replay_calls_per_request"], k["serving_launches"],
               k["serving_replay_calls"], k["export_launches"], k["training_launches"],
               k["training_eager_launches"], k["parallel_launches"],
               k["parallel_replay_calls"], k["encoder_training_launches"]) <= 0:
            raise AssertionError(f"{k['name']} never launched on a path")
    details = json.dumps({"card": smi, "records": records, "main_path": summary,
                          "serving": served, "export": exported, "training": trained,
                          "prepare": prepared, "parallel": parallel,
                          "encoder_training": enc_train}, default=float)
    # the whole line, which is longer than the end of the output that a
    # caller may keep
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_details.json"), "w") as f:
        f.write(details + "\n")
    print(details, flush=True)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
