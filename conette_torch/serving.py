"""Bulk corpus captioning: the serving path over audio files.

Counterpart of ``conette_tpu/serving.py`` (``caption_corpus``, ``warmup``):

1. clips are grouped into **length buckets** (``bucket_length`` of their
   32 kHz length, read from WAV headers, decoded for other containers), so
   every batch of a bucket has one shape;
2. each bucket is cut into fixed-size batches; a tail batch is padded with
   silence rows, which are dropped after decoding;
3. every batch runs the bf16 encoder (on the card: the log-mel, block and
   seam kernels), the projection, and beam search over the projected memory
   rounded to bf16, with each clip's own task; results come back in input
   order.

Sharding batches over a device mesh (the JAX ``mesh`` argument and
``make_sharded_caption_fn``) comes with the port's parallelism slice.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.huggingface.preprocessor import bucket_length
from conette_torch.models.conette import encode_audio, forward_generate, tasks_to_bos_ids
from conette_torch.models.convnext import convnext_apply
from conette_torch.ops.resample import resampled_length
from conette_torch.utils.audio_io import wav_info

pylog = logging.getLogger(__name__)


@dataclass
class CaptionResult:
    fname: str
    caption: str
    lprob: float
    task: str


def caption_corpus(
    model: CoNeTTEModel,
    paths: Sequence[str],
    *,
    task: str | Sequence[str] = "clotho",
    batch_size: int = 32,
    beam_size: int | None = None,
    mesh: Any | None = None,
) -> list[CaptionResult]:
    """Caption a corpus of audio files (WAV, FLAC, mp3, Ogg) in length
    buckets of fixed-size batches.

    :param task: one task for every clip, or one a clip.
    :returns: results in the input order.
    """
    if mesh is not None:
        raise NotImplementedError(
            "Sharding caption_corpus over a mesh comes with the parallelism "
            "slice of conette_torch; call it without mesh."
        )
    n = len(paths)
    tasks = [task] * n if isinstance(task, str) else list(task)
    if len(tasks) != n:
        raise ValueError(f"{len(tasks)=} != {len(paths)=}")
    model._check_tasks(set(tasks))

    pre = model.preprocessor

    # bucket pass: 32 kHz lengths from WAV headers; other containers are
    # decoded (waveforms are loaded again per batch, so memory stays
    # O(batch) instead of O(corpus))
    def resampled_len(path: str) -> int:
        try:
            sr, _, frames = wav_info(path)
        except ValueError:
            return int(pre.load_resample(path)[1][0])
        return frames if sr == pre.target_sr else resampled_length(frames, sr, pre.target_sr)

    buckets: dict[int, list[int]] = {}
    for i, p in enumerate(paths):
        buckets.setdefault(bucket_length(resampled_len(p)), []).append(i)
    pylog.info(f"{n} clips → {len(buckets)} length buckets "
               f"({sorted(b // pre.target_sr for b in buckets)} s)")

    cfg = model.model_cfg
    beam = beam_size if beam_size is not None else cfg.beam_size
    dev = model.device

    def bos_for(chunk: list[int]) -> torch.Tensor:
        chunk_tasks = [tasks[i] for i in chunk]
        chunk_tasks += [chunk_tasks[0]] * (batch_size - len(chunk_tasks))
        datasets = [t.split("_")[0] for t in chunk_tasks]
        sources = ["_".join(t.split("_")[1:]) or None for t in chunk_tasks]
        if cfg.task_mode == "ds_src":
            ids = tasks_to_bos_ids(cfg, model.task_token_ids, datasets, sources)
        elif cfg.task_mode == "ds":
            ids = tasks_to_bos_ids(cfg, model.task_token_ids, datasets)
        else:
            ids = np.full((batch_size,), cfg.bos_id, np.int32)
        return torch.from_numpy(ids).to(dev)

    results: dict[int, CaptionResult] = {}
    for blen, idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            wav = np.zeros((batch_size, blen), np.float32)
            lens = np.full((batch_size,), blen, np.int64)
            for row, i in enumerate(chunk):
                w, wl = pre.load_resample(paths[i])
                m = min(int(wl[0]), blen)
                wav[row, :m] = w[0, :m]
                lens[row] = m
            with torch.inference_mode():
                outs = convnext_apply(
                    model.encoder_params, torch.from_numpy(wav).to(dev),
                    torch.from_numpy(lens).to(dev), compute_dtype=torch.bfloat16,
                )
                memory, pad_mask = encode_audio(
                    model.params, cfg, outs["frame_embs"].transpose(1, 2), outs["frame_embs_lens"]
                )
                res = forward_generate(
                    model.params, cfg, memory.to(torch.bfloat16), pad_mask, bos_for(chunk),
                    beam_size=beam, forbid_rep_mask=model.forbid_rep_mask,
                )
            preds = res.best_preds.to(torch.int32).cpu().numpy()
            lprobs = res.best_avg_lprobs.float().cpu().numpy()
            for row, i in enumerate(chunk):
                results[i] = CaptionResult(
                    fname=paths[i], caption=model._decode_pred(preds[row]),
                    lprob=float(lprobs[row]), task=tasks[i],
                )
    return [results[i] for i in range(n)]


def warmup(
    model: CoNeTTEModel,
    bucket_seconds: Sequence[int] = (1, 5, 10, 30),
    batch_size: int = 32,
    beam_size: int | None = None,
) -> None:
    """Run ``model.forward`` once for each length bucket on low noise, so
    that the kernel build and the libraries' first use fall before live
    traffic."""
    rng = np.random.default_rng(0)
    sr = model.preprocessor.target_sr
    for secs in bucket_seconds:
        wav = rng.standard_normal((batch_size, secs * sr)).astype(np.float32) * 0.01
        model.forward(wav, sr=sr, task=model.default_task, beam_size=beam_size)
        pylog.info(f"warmup: ran the {secs} s bucket (batch {batch_size})")
