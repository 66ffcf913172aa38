"""Ahead-of-time export of the caption pipeline with ``torch.export``.

Counterpart of ``conette_tpu/export.py``: the whole waveform → tokens
program (log-mel frontend, ConvNeXt encoder, projection, task-conditioned
beam search, or greedy search at beam <= 1) at one static (batch, samples)
bucket, with the weights and the forbid-repetition mask as buffers of the
program, saved so that it replays without this package's model classes.
Artifact layout (``save_exported``)::

    <out_dir>/
      caption.pt2      # torch.export.save of the ExportedProgram
      tokenizer.json   # AACTokenizer txt state
      meta.json        # shapes, decode config, task -> BOS-id map

The program runs on the device it was exported on. Exported on the card
at bf16 (``compute_dtype=torch.bfloat16``), the encoder's log-mel, block
and seam calls are the custom ops ``conette_torch::logmel``,
``conette_torch::convnext_block`` and ``conette_torch::downsample``, one
node each; at f32 and on the CPU the program holds plain operators only.
The search runs all ``max_pred_size`` steps (its default guard,
``decoding/guard.py::every_step``), so the program has no data-dependent
control flow: an exported program carries no CUDA graph node, so it does
not leave the loop early as the captured programs do. Its tokens equal
theirs, since a step after the last beam retires changes no output.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from conette_torch.models.conette import (
    encode_audio,
    forward_generate,
    forward_greedy,
    task_names_to_bos_ids,
)
from conette_torch.models.convnext import convnext_apply

ARTIFACT_NAME = "caption.pt2"


def _layout(tree: Any, buffers: dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``tree`` with each tensor replaced by a buffer name, the tensor put
    in ``buffers`` under that name."""
    if isinstance(tree, dict):
        return {k: _layout(v, buffers, f"{prefix}{k}__") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v, buffers, f"{prefix}{i}__") for i, v in enumerate(tree)]
    buffers[prefix[:-2]] = tree
    return prefix[:-2]


class CaptionProgram(torch.nn.Module):
    """``forward(wav (B, S) f32, lens (B,) i32, bos_ids (B,) i32) -> (preds,
    avg_lprobs, mult_preds, mult_lprobs, clip_probs)``, as the live model
    computes them; the weights and the forbid mask are buffers."""

    def __init__(self, model: Any, beam: int, min_p: int, max_p: int) -> None:
        super().__init__()
        self.cfg = model.model_cfg
        self.beam, self.min_p, self.max_p = beam, min_p, max_p
        self.compute_dtype = model.preprocessor.compute_dtype
        buffers: dict[str, torch.Tensor] = {}
        self._layout = _layout({"encoder": model.encoder_params, "model": model.params}, buffers)
        for name, t in buffers.items():
            self.register_buffer(name, t)
        forbid = model.forbid_rep_mask
        if forbid is None:
            forbid = torch.zeros((self.cfg.vocab_size,), dtype=torch.bool, device=model.device)
        self.register_buffer("forbid", forbid)

    def _tree(self, layout: Any) -> Any:
        """The parameter tree rebuilt from this module's buffers."""
        if isinstance(layout, dict):
            return {k: self._tree(v) for k, v in layout.items()}
        if isinstance(layout, list):
            return [self._tree(v) for v in layout]
        return getattr(self, layout)

    def forward(self, wav: torch.Tensor, lens: torch.Tensor, bos_ids: torch.Tensor):
        trees = self._tree(self._layout)
        cfg = self.cfg
        outs = convnext_apply(trees["encoder"], wav, lens, compute_dtype=self.compute_dtype)
        memory, pad_mask = encode_audio(
            trees["model"], cfg, outs["frame_embs"].transpose(1, 2), outs["frame_embs_lens"]
        )
        if self.beam <= 1:
            g = forward_greedy(trees["model"], cfg, memory, pad_mask, bos_ids,
                               min_pred_size=self.min_p, max_pred_size=self.max_p,
                               forbid_rep_mask=self.forbid)
            lp = torch.log_softmax(g.logits.transpose(1, 2), dim=-1)
            sel = lp.gather(-1, g.preds[..., None])[..., 0]
            valid = g.preds != cfg.pad_id
            avg = torch.where(valid, sel, 0.0).sum(dim=1) / valid.sum(dim=1).clamp_min(1)
            return g.preds, avg, g.preds[:, None, :], avg[:, None], outs["clipwise_output"]
        res = forward_generate(trees["model"], cfg, memory, pad_mask, bos_ids,
                               beam_size=self.beam, min_pred_size=self.min_p,
                               max_pred_size=self.max_p, forbid_rep_mask=self.forbid)
        return (res.best_preds, res.best_avg_lprobs, res.global_preds, res.global_avg_lprobs,
                outs["clipwise_output"])


def build_caption_fn(model: Any, beam_size: int | None = None,
                     min_pred_size: int | None = None,
                     max_pred_size: int | None = None) -> tuple[CaptionProgram, dict[str, int]]:
    """The waveform → tokens module that gets exported, and its decode
    settings: ``fn(wav (B, S) f32, lens (B,) i32, bos_ids (B,) i32) ->
    (preds, avg_lprobs, mult_preds, mult_lprobs, clip_probs)``."""
    beam = beam_size if beam_size is not None else model.config.beam_size
    min_p = min_pred_size if min_pred_size is not None else model.config.min_pred_size
    max_p = max_pred_size if max_pred_size is not None else model.config.max_pred_size
    fn = CaptionProgram(model, beam, min_p, max_p)
    return fn, {"beam_size": beam, "min_pred_size": min_p, "max_pred_size": max_p}


def _task_bos_map(model: Any) -> dict[str, int]:
    tasks = list(model.config.task_names)
    ids = task_names_to_bos_ids(model.model_cfg, model.task_token_ids, tasks)
    return {task: int(i) for task, i in zip(tasks, ids)}


def export_caption_program(
    model: Any,
    batch_size: int,
    clip_seconds: float,
    sample_rate: int = 32_000,
    platforms: Sequence[str] | None = None,
    **decode_kwargs: Any,
) -> tuple[torch.export.ExportedProgram, dict[str, Any]]:
    """Export the caption pipeline at one (batch, clip-length) bucket on the
    model's device. Returns ``(exported_program, meta)``. ``platforms``,
    where given, must name only that device's type (``["cuda"]`` or
    ``["cpu"]``): an exported program runs where it was exported."""
    dev = model.device
    if platforms is not None and set(platforms) != {dev.type}:
        raise ValueError(f"the program runs on the model's device ({dev.type}); "
                         f"platforms={list(platforms)} names another")
    fn, decode_meta = build_caption_fn(model, **decode_kwargs)
    n_samples = int(round(clip_seconds * sample_rate))
    example = (
        torch.zeros((batch_size, n_samples), dtype=torch.float32, device=dev),
        torch.full((batch_size,), n_samples, dtype=torch.int32, device=dev),
        torch.full((batch_size,), model.model_cfg.bos_id, dtype=torch.int32, device=dev),
    )
    with torch.no_grad():
        exported = torch.export.export(fn, example)
    meta = {
        "batch_size": batch_size,
        "clip_seconds": clip_seconds,
        "sample_rate": sample_rate,
        "n_samples": n_samples,
        "eos_id": int(model.model_cfg.eos_id),
        "pad_id": int(model.model_cfg.pad_id),
        "default_task": model.default_task,
        "task_bos_ids": _task_bos_map(model),
        **decode_meta,
    }
    return exported, meta


def save_exported(
    model: Any,
    out_dir: str,
    batch_size: int = 32,
    clip_seconds: float = 10.0,
    sample_rate: int = 32_000,
    platforms: Sequence[str] | None = None,
    **decode_kwargs: Any,
) -> str:
    os.makedirs(out_dir, exist_ok=True)
    exported, meta = export_caption_program(
        model, batch_size, clip_seconds, sample_rate, platforms=platforms, **decode_kwargs
    )
    torch.export.save(exported, os.path.join(out_dir, ARTIFACT_NAME))
    model.tokenizer.save_file(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ExportedCaptioner:
    """Replay a ``save_exported`` artifact: pads or crops float32 waveforms
    to the exported bucket, maps task names to BOS ids, runs the loaded
    program on the device it was exported on, detokenizes.

    Replay needs ``torch`` and the artifact; a program exported on the card
    at bf16 calls the kernels' custom ops, so ``import conette_torch.kernels``
    first registers them (this class does, when it loads). The tokenizer is
    this package's ``AACTokenizer``, read from ``tokenizer.json``.
    ``program`` is the loaded ``torch.export.ExportedProgram``."""

    def __init__(self, art_dir: str) -> None:
        import conette_torch.kernels  # noqa: F401  (registers the custom ops)
        from conette_torch.tokenization import AACTokenizer

        self.program = torch.export.load(os.path.join(art_dir, ARTIFACT_NAME))
        self._fn = self.program.module()
        tensors = list(self.program.state_dict.values()) + list(self.program.constants.values())
        self.device = next(t.device for t in tensors if isinstance(t, torch.Tensor))
        with open(os.path.join(art_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.tokenizer = AACTokenizer.from_file(os.path.join(art_dir, "tokenizer.json"))

    def prepare_batch(
        self,
        wavs: Sequence[np.ndarray] | np.ndarray,
        task: str | Sequence[str] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pad/crop float32 waveforms to the exported (batch, samples)
        bucket and map task names to BOS ids: the arrays the program takes."""
        b, s = self.meta["batch_size"], self.meta["n_samples"]
        wav_list = [np.asarray(w, np.float32).reshape(-1) for w in wavs]
        if len(wav_list) > b:
            raise ValueError(f"{len(wav_list)} clips > exported batch size {b}")
        if task is None:
            task = self.meta["default_task"]
        tasks = [task] * len(wav_list) if isinstance(task, str) else list(task)
        bos_map = self.meta["task_bos_ids"]
        for t in tasks:
            if t not in bos_map:
                raise ValueError(f"Invalid task {t!r} (not in {list(bos_map)})")

        batch = np.zeros((b, s), np.float32)
        lens = np.zeros((b,), np.int32)
        bos = np.full((b,), bos_map[tasks[0]], np.int32)
        for i, w in enumerate(wav_list):
            n = min(len(w), s)
            batch[i, :n] = w[:n]
            lens[i] = n
            bos[i] = bos_map[tasks[i]]
        return batch, lens, bos

    def decode_tokens(self, preds: np.ndarray) -> list[str]:
        """EOS-truncate and detokenize an (N, L) id matrix."""
        eos = self.meta["eos_id"]
        out = []
        for row in np.asarray(preds):
            toks = []
            for t in row.tolist():
                if t == eos:
                    break
                toks.append(t)
            out.append(self.tokenizer.decode_single(toks))
        return out

    def run(self, batch: np.ndarray, lens: np.ndarray, bos: np.ndarray) -> tuple[torch.Tensor, ...]:
        """The program on prepared arrays: its five outputs, on its device."""
        with torch.no_grad():
            return self._fn(*(torch.from_numpy(a).to(self.device) for a in (batch, lens, bos)))

    def __call__(
        self,
        wavs: Sequence[np.ndarray] | np.ndarray,
        task: str | Sequence[str] | None = None,
    ) -> list[str]:
        preds = self.run(*self.prepare_batch(wavs, task))[0]
        return self.decode_tokens(preds.cpu().numpy()[: len(wavs)])
