"""Bulk corpus captioning: the serving path over audio files.

Counterpart of ``conette_tpu/serving.py`` (``caption_corpus``, ``warmup``):

1. clips are grouped into **length buckets** (``bucket_length`` of their
   32 kHz length, read from WAV headers by the native loader, decoded for
   other containers; a file that cannot be read raises), so
   every batch of a bucket has one shape;
2. each bucket is cut into fixed-size batches; a tail batch is padded with
   silence rows, which are dropped after decoding;
3. every batch runs the bf16 encoder (on the card: the log-mel, block and
   seam kernels), the projection, and beam search over the projected memory
   rounded to bf16, with each clip's own task; results come back in input
   order.

On the card a batch is one captured program (``conette_torch/graphs.py``),
one for each (batch, bucket length, beam, forbid mask present), cached on
the model: the counterpart of the JAX package's ``caption_batch``, one
``jax.jit`` program. ``warmup`` captures the programs of its buckets. The
tokens of a batch are copied to pinned host memory behind its replay, and
detokenized while the next batch's replay runs, as the JAX package
drains the previous batch while the next one is dispatched.

Over a device mesh (``parallel/mesh.py``, one process a card) the rows of
each batch are split over its ``data`` dim, with the parameters whole on
every process: each process runs its rows through the same captured
program as ``caption_batch``, and the tokens and lprobs are gathered after
its replay, outside the graph (``make_sharded_caption_fn``).
``caption_corpus(mesh=)`` is called with the same paths on every process;
each reads the headers of its share of the files and decodes only the
files of its rows, and every process returns the whole result list.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.huggingface.preprocessor import bucket_length
from conette_torch.models.conette import encode_audio, forward_generate, tasks_to_bos_ids
from conette_torch.models.convnext import convnext_apply
from conette_torch.native import loader as native_loader
from conette_torch.ops.resample import resampled_length
from conette_torch.parallel.distributed import all_gather_rows
from conette_torch.parallel.mesh import Axis, axis

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
    :param mesh: a ``("data", "model")`` device mesh: every process of it
        calls with the same arguments, and ``batch_size`` rows are split
        over ``data``.
    :returns: results in the input order.
    """
    data = _data_axis(mesh, batch_size)
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
        if not native_loader.is_riff(path):
            return int(pre.load_resample(path)[1][0])
        sr, _, frames = native_loader.wav_info(path)
        return frames if sr == pre.target_sr else resampled_length(frames, sr, pre.target_sr)

    # each process of ``data`` reads its share of the headers
    lengths = [resampled_len(p) if i % data.size == data.rank else 0 for i, p in enumerate(paths)]
    if data.size > 1:
        lengths = all_gather_rows(torch.tensor(lengths), data.group).reshape(data.size, n).sum(0).tolist()
    buckets: dict[int, list[int]] = {}
    for i, length in enumerate(lengths):
        buckets.setdefault(bucket_length(length), []).append(i)
    pylog.info(f"{n} clips → {len(buckets)} length buckets "
               f"({sorted(b // pre.target_sr for b in buckets)} s)")

    cfg = model.model_cfg
    beam = beam_size if beam_size is not None else cfg.beam_size

    def bos_for(chunk: list[int]) -> np.ndarray:
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
        return ids

    results: dict[int, CaptionResult] = {}
    pending: list[tuple[list[int], Any]] = []

    def drain(item: tuple[list[int], Any]) -> None:
        chunk, queued = item
        preds, lprobs = (t.numpy() for t in _gathered(queued, data))
        for row, i in enumerate(chunk):
            results[i] = CaptionResult(
                fname=paths[i], caption=model._decode_pred(preds[row]),
                lprob=float(lprobs[row]), task=tasks[i],
            )

    rows = slice(data.rank * (batch_size // data.size), (data.rank + 1) * (batch_size // data.size))
    for blen, idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            mine = range(batch_size)[rows]
            wav = np.zeros((len(mine), blen), np.float32)
            lens = np.full((len(mine),), blen, np.int64)
            for row, j in enumerate(mine):
                if j < len(chunk):
                    w, wl = pre.load_resample(paths[chunk[j]])
                    m = min(int(wl[0]), blen)
                    wav[row, :m] = w[0, :m]
                    lens[row] = m
            bos = bos_for(chunk)[rows]
            pending.append((chunk, caption_batch(model, wav, lens, bos, beam)))
            # detokenize the previous batch while this one runs on the card
            if len(pending) > 1:
                drain(pending.pop(0))
    for item in pending:
        drain(item)
    return [results[i] for i in range(n)]


def _data_axis(mesh: Any, batch_size: int) -> Any:
    """The mesh's ``data`` dim as this process sees it (one process, rank 0,
    without a mesh); ``batch_size`` must split evenly over it."""
    if mesh is None:
        return Axis(None, 0, 1)
    data = axis(mesh, "data")
    if batch_size % data.size != 0:
        raise ValueError(f"{batch_size=} not divisible by mesh data={data.size}")
    return data


def _gathered(queued: tuple, data: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """A queued ``caption_batch``'s tokens and lprobs on the host, once its
    copy is done, gathered over ``data`` in row order."""
    done, preds, lprobs = queued
    if done is not None:
        done.synchronize()
    if data.size > 1:
        preds, lprobs = all_gather_rows(preds, data.group), all_gather_rows(lprobs, data.group)
    return preds, lprobs


def make_sharded_caption_fn(model: CoNeTTEModel, mesh: Any, beam_size: int | None = None):
    """The waveform → tokens pipeline of ``caption_corpus`` with the rows of
    a batch split over the mesh's ``data`` dim. Every process of the mesh
    calls the returned ``fn(waveform (B, S), lens (B,), bos_ids (B,)) →
    (preds (B, max_pred_size) int32, lprobs (B,) f32)`` with the whole
    batch; it captions its rows through ``caption_batch``'s captured
    program and returns the whole batch's results (host tensors) on every
    process. Unlike the JAX function, whose program leaves the memory in
    f32 and the log-mel on its plain ops, this runs what ``caption_batch``
    runs (the encoder's kernels, beam search over bf16 memory), so its
    tokens are ``caption_batch``'s on the same rows."""
    cfg = model.model_cfg
    beam = beam_size if beam_size is not None else cfg.beam_size

    def fn(waveform: np.ndarray, lens: np.ndarray, bos_ids: np.ndarray):
        data = _data_axis(mesh, len(waveform))
        b = len(waveform) // data.size
        rows = slice(data.rank * b, (data.rank + 1) * b)
        queued = caption_batch(model, np.asarray(waveform, np.float32)[rows],
                               np.asarray(lens)[rows], np.asarray(bos_ids)[rows], beam)
        return _gathered(queued, data)

    return fn


def caption_batch(model: CoNeTTEModel, wav: np.ndarray, lens: np.ndarray, bos_ids: np.ndarray,
                  beam: int) -> tuple[torch.cuda.Event | None, torch.Tensor, torch.Tensor]:
    """One batch of ``caption_corpus``: (B, S) waveforms, (B,) lengths and
    (B,) BOS ids → (an event that marks the copy to the host, or None on
    the CPU; (B, max_pred_size) int32 best tokens; (B,) f32 lprobs), the two
    in pinned host memory on the card. The batch is queued, not waited on."""
    dev = model.device
    forbid = model.forbid_rep_mask
    key = ("corpus", *wav.shape, beam, forbid is not None)
    fn = functools.partial(_caption_batch_eager, model, beam=beam)
    inputs = (wav, np.asarray(lens, np.int64), np.asarray(bos_ids, np.int64))
    inputs += (forbid,) if forbid is not None else ()
    with torch.inference_mode():
        preds, lprobs = model.graphs.run(key, fn, inputs, dev)
        if dev.type != "cuda":
            return None, preds.to(torch.int32), lprobs.float()
        preds_h = torch.empty(preds.shape, dtype=torch.int32, pin_memory=True)
        lprobs_h = torch.empty(lprobs.shape, dtype=torch.float32, pin_memory=True)
        preds_h.copy_(preds, non_blocking=True)
        lprobs_h.copy_(lprobs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return done, preds_h, lprobs_h


def _caption_batch_eager(model: CoNeTTEModel, wav: torch.Tensor, lens: torch.Tensor,
                         bos_ids: torch.Tensor, forbid: torch.Tensor | None = None, *,
                         beam: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 encoder, the projection and beam search over bf16 memory."""
    cfg = model.model_cfg
    outs = convnext_apply(model.encoder_params, wav, lens, compute_dtype=torch.bfloat16)
    memory, pad_mask = encode_audio(
        model.params, cfg, outs["frame_embs"].transpose(1, 2), outs["frame_embs_lens"]
    )
    res = forward_generate(
        model.params, cfg, memory.to(torch.bfloat16), pad_mask, bos_ids,
        beam_size=beam, forbid_rep_mask=forbid,
    )
    return res.best_preds.to(torch.int32), res.best_avg_lprobs.float()


def warmup(
    model: CoNeTTEModel,
    bucket_seconds: Sequence[int] = (1, 5, 10, 30),
    batch_size: int = 32,
    beam_size: int | None = None,
) -> None:
    """Run ``model.forward`` once for each length bucket on low noise, and
    capture ``caption_corpus``'s program of each bucket, so that the
    kernel build, the libraries' first use and the captures fall before
    live traffic."""
    rng = np.random.default_rng(0)
    sr = model.preprocessor.target_sr
    cfg = model.model_cfg
    beam = beam_size if beam_size is not None else cfg.beam_size
    bos = np.full((batch_size,), model.task_token_ids.get(model.default_task, cfg.bos_id))
    for secs in bucket_seconds:
        wav = rng.standard_normal((batch_size, secs * sr)).astype(np.float32) * 0.01
        model.forward(wav, sr=sr, task=model.default_task, beam_size=beam_size)
        done, _, _ = caption_batch(model, wav, np.full((batch_size,), secs * sr), bos, beam)
        if done is not None:
            done.synchronize()
        pylog.info(f"warmup: ran and captured the {secs} s bucket (batch {batch_size})")
