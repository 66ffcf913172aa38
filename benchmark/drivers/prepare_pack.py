"""Back-to-back ``conette-prepare`` packs of a corpus through a frozen
encoder, as a researcher packs a dataset's frame embeddings before
training.

Set-up draws the encoder's weights on the device from the seed, writes one
corpus of ``files_per_call`` mono 16-bit WAV files at ``sample_rate`` under
``TMPDIR`` (their lengths the fixed set that ``lengths`` gives; the seed
draws their contents and their order) with a captions CSV of
``captions_per_file`` captions of ``caption_words`` words each, scans it
with ``prepare.scan_local_dataset`` and packs it once (which builds the
native loader and meets every shape). The window calls
``prepare.pack_dataset_to_hdf`` again and again over the whole corpus,
with the cell's ``audio_t`` at ``batch_size``, overwriting one pack.
``corpus_clips_per_s``: the files of every completed call over the time
from the first call's start to the last call's end.

The check, after the window, reads the last call's pack: ``rows`` (exact),
the rows that are not the corpus's files in its order with their captions;
``lens`` (exact), the rows whose frame count is not the reference's for
the file's length; ``frames``, over a seeded sample of ``check_rows`` rows
that holds the shortest and the longest file, the worst row's largest gap
to the reference's frames (``benchmark/reference/pann.py``, from the WAV
file, the clip alone at its own length) over the reference's largest
magnitude.
"""

from __future__ import annotations

import csv
import gc
import math
import os
import shutil
import sys
import tempfile
import time
import wave

import numpy as np
import torch

from benchmark import gen, roofline_pann
from benchmark.drivers.common import judged, mono_of_wav, set_f32
from benchmark.harness import Parts, Profile, Trace, Tracer, profiled
from benchmark.reference import audio as ref_audio
from benchmark.reference import pann as ref_pann
from benchmark.reference.precision import rounder

SPANS = ("pack_dataset", "native_load", "pann_encode", "pack_collect", "pack_write")


def cnn14_tree(cfg: dict) -> dict:
    """Cnn14's parameters in the program's layout: He-normal 3×3 kernels
    (std sqrt(2 / fan_in), so that the activations keep their scale through
    the twelve convolutions), zero convolution biases (PANNs' convolutions
    have none), batch norms with drawn statistics, bn0's fitting log-mel
    values in dB; the clip head's fc1 and fc_audioset, which a pack does not
    read, at torch's default scales."""
    chans, n_mels = cfg["channels"], cfg["n_mels"]

    def bn(dim):
        return {"weight": gen.normal((dim,), 0.1, 1.0), "bias": gen.normal((dim,), 0.1),
                "running_mean": gen.normal((dim,), 0.1),
                "running_var": gen.Leaf((dim,), "uniform", 0.5, 1.5)}

    def conv(cin, cout):
        return {"weight": gen.normal((3, 3, cin, cout), math.sqrt(2.0 / (9 * cin))),
                "bias": gen.normal((cout,), 0.0)}

    def lin(cin, cout):
        return {"weight": gen.uniform((cin, cout), 1 / math.sqrt(cin)),
                "bias": gen.uniform((cout,), 1 / math.sqrt(cin))}

    blocks, cin = [], 1
    for c in chans:
        blocks.append({"conv1": conv(cin, c), "bn1": bn(c), "conv2": conv(c, c), "bn2": bn(c)})
        cin = c
    return {
        "bn0": {"weight": gen.normal((n_mels,), 0.1, 1.0), "bias": gen.normal((n_mels,), 0.1),
                "running_mean": gen.normal((n_mels,), 10.0, -30.0),
                "running_var": gen.Leaf((n_mels,), "uniform", 50.0, 300.0)},
        "blocks": blocks,
        "fc1": lin(chans[-1], chans[-1]),
        "fc_audioset": lin(chans[-1], cfg["num_classes"]),
    }


def wav_frames(path: str) -> int:
    """The frames of a WAV file, from its header."""
    with wave.open(path, "rb") as f:
        return f.getnframes()


class Cell:
    def __init__(self, bench, seed: int, device: torch.device) -> None:
        # a program without the masked Cnn route has no make_frontend: the
        # cell stops here, not at a pack of another encoder's rows
        from conette_torch.prepare import make_frontend, scan_local_dataset  # noqa: F401

        self.cfg, self.wl, self.seed, self.device = bench.config, bench.cell, seed, device
        cfg, wl = self.cfg, self.wl
        self.parts = part = Parts()
        set_f32(device)
        with part("weights"):
            self.params = self.weights()
        rng = np.random.default_rng(seed)
        sr, n = wl["sample_rate"], wl["files_per_call"]
        lengths = gen.stratified_lengths(wl["lengths"], n)
        self.lengths = [lengths[i] for i in rng.permutation(n)]
        self.tmp = tempfile.mkdtemp(prefix="bench_prepare_")
        audio_dir = os.path.join(self.tmp, "audio")
        os.makedirs(audio_dir)
        self.fnames = [f"file_{i:04d}.wav" for i in range(n)]  # sorted, as the scan orders them
        self.paths = [os.path.join(audio_dir, f) for f in self.fnames]
        words = gen.corpus_words(cfg["vocab_words"])
        per = wl["captions_per_file"]
        caps = gen.sentences(rng, words, n * per, *wl["caption_words"])
        self.captions = [caps[i * per:(i + 1) * per] for i in range(n)]
        g = torch.Generator(device).manual_seed(seed + 1)
        with part("files"):
            for secs in sorted(set(self.lengths)):
                idx = [i for i, s in enumerate(self.lengths) if s == secs]
                made = gen.clips(g, len(idx), int(round(secs * sr)), sr).cpu().numpy()
                for j, i in enumerate(idx):
                    gen.write_wav(self.paths[i], made[j], sr)
            csv_path = os.path.join(self.tmp, "captions.csv")
            with open(csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
                w.writeheader()
                w.writerows({"file_name": fn, "caption": c} for fn, cs in zip(self.fnames, self.captions)
                            for c in cs)
        # each file's length at 32 kHz, as the reference resamples it
        self.samples = [ref_audio.resampled_length(wav_frames(p), sr, ref_audio.TARGET_SR)
                        for p in self.paths]
        self.dataset = scan_local_dataset(audio_dir, csv_path, wl["dataset"], wl["subset"])
        self.out_dir = os.path.join(self.tmp, "hdf")
        self.pack_path: str | None = None
        with part("warm"):
            self.call()

    def weights(self) -> dict:
        g = torch.Generator(self.device).manual_seed(self.seed)
        return gen.materialize(cnn14_tree(self.cfg["encoder"]), g)

    def call(self) -> str:
        from conette_torch.prepare import pack_dataset_to_hdf

        self.pack_path = pack_dataset_to_hdf(
            self.dataset, self.out_dir, audio_t_name=self.wl["audio_t"], encoder_params=self.params,
            batch_size=self.wl["batch_size"], overwrite=True, device=self.device)
        return self.pack_path

    def bound_s(self) -> float:
        """A call's least time: each file's frame embeddings at the peaks."""
        chans = tuple(self.cfg["encoder"]["channels"])
        return sum(roofline_pann.cnn14_bound_s(s, chans) for s in self.samples)

    def window(self, seconds: float, tracer: Tracer) -> dict:
        n = len(self.paths)
        bound_s = self.bound_s()
        profiles: list[Profile] = []
        calls, clips, failed = 0, 0, 0
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            profile_now = tracer.on and calls == self.wl["profile_at"]
            tracer.keep = not profile_now
            ok = True
            try:
                if profile_now:
                    with profiled(profiles, SPANS), tracer.span("pack_dataset"):
                        self.call()
                else:
                    with tracer.span("pack_dataset"):
                        self.call()
            except Exception as err:  # a call that fails counts; the run is not correct
                print(f"pack_dataset_to_hdf failed: {err!r}", file=sys.stderr, flush=True)
                failed += 1
                ok = False
            end = time.perf_counter()
            calls += 1
            clips += n if ok else 0
        tracer.keep = True
        tracer.close()
        self.failed, self.done = failed, calls - failed
        prof = profiles[0] if profiles else None
        if prof is not None:
            prof.units = {"clips": n, "bound_s": bound_s}
        self.trace = Trace(tracer.spans, {"call_bound_s": bound_s}, prof)
        return {"metrics": {"corpus_clips_per_s": clips / (end - start)},
                "attempted": calls * n, "failed": failed * n}

    def release(self) -> None:
        del self.params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample_rows(self) -> list[int]:
        """A seeded choice of ``check_rows`` rows, the shortest and the
        longest file among them."""
        n = len(self.paths)
        order = np.argsort(self.samples, kind="stable")
        rng = np.random.default_rng(self.seed + 2)
        rest = [int(i) for i in rng.permutation(n) if i not in (order[0], order[-1])]
        return sorted({int(order[0]), int(order[-1]), *rest[: self.wl["check_rows"] - 2]})

    def batch_longest(self, row: int) -> int:
        """Samples at 32 kHz of the longest file of ``row``'s batch."""
        bs = self.wl["batch_size"]
        start = row - row % bs
        return max(self.samples[start:start + bs])

    def check(self, control: dict | None = None) -> list[tuple[str, float, float]]:
        """The last call's pack: its rows against the corpus in order, each
        row's frame count, and a sample of rows against the reference.
        ``control`` puts the reference so computed in the program's place:
        ``rnd_fmt``, its products at a lower precision; ``unmasked``, the
        clip zero-padded to its batch's longest and the padding not
        masked (the reference's first T' frames of that)."""
        from conette_torch.data.hdf import HDFDataset

        if self.failed or not self.done or self.pack_path is None:
            return [("failed_calls", float(self.failed or 1), 0.0)]
        pack = HDFDataset(self.pack_path)
        n = len(self.paths)
        rows = abs(len(pack) - n) + sum(
            pack.at(r, "fname") != self.fnames[r] or pack.at(r, "captions") != self.captions[r]
            or pack.at(r, "dataset") != self.wl["dataset"] or pack.at(r, "subset") != self.wl["subset"]
            for r in range(min(len(pack), n)))
        blocks = len(self.cfg["encoder"]["channels"])
        want_lens = [ref_pann.frame_count(s, blocks) for s in self.samples]
        lens = sum(int(pack.at(r, "audio_lens")) != want_lens[r] for r in range(min(len(pack), n)))
        numbers = {"rows": float(rows), "lens": float(lens)}
        if rows or lens:
            return judged(numbers | {"frames": 0.0}, self.wl["limits"])
        set_f32(self.device)
        params = self.weights()
        worst = 0.0
        with torch.no_grad():
            for r in self.sample_rows():
                mono = mono_of_wav(self.paths[r], self.device)
                ref = ref_pann.frames(params, mono[None])[0]
                if control is None:
                    prog = torch.as_tensor(pack.at(r, "audio"), device=self.device)
                elif control.get("unmasked"):
                    padded = torch.zeros((1, self.batch_longest(r)), device=self.device)
                    padded[0, : mono.shape[0]] = mono
                    prog = ref_pann.frames(params, padded)[0, : ref.shape[0]]
                else:
                    prog = ref_pann.frames(params, mono[None], rounder(control["rnd_fmt"]))[0]
                gap = float((prog - ref).abs().max() / ref.abs().max())
                worst = max(worst, gap if math.isfinite(gap) else math.inf)
        numbers["frames"] = worst
        return judged(numbers, self.wl["limits"])

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)
