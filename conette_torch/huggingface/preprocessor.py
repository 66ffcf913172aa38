"""CoNeTTEPreprocessor — audio loading + the frozen ConvNeXt feature encoder.

Counterpart of ``conette_tpu/huggingface/preprocessor.py`` (reference
``huggingface/preprocessor.py:21-154``): accepts file paths, arrays, or
lists of either with per-item sample rates; resamples to 32 kHz on the host,
averages channels, pads to a length bucket (or, with ``use_buckets=False``,
to the longest clip) and stacks, then runs the encoder on the model's
device, returning ``{"audio": (B, T, 768), "audio_shape": (B, 2),
"clip_probs": (B, 527)}``. File paths are decoded, averaged and resampled
by the native loader (``conette_torch/native``) on a pool of threads, as
the JAX package does; arrays are averaged, then resampled by the same
native resample on a pool of threads (the JAX package resamples them with
numpy, then averages). So the host's ``g++``, which builds the native
library on first use, is needed for paths and for arrays at any rate but
32 kHz: without it they raise ``native.loader.CompilerNotFound``.

On a CUDA device the encoder is one CUDA graph for each padded length
(at the compute dtype, and ``REQUEST_BATCH`` rows: a request is padded to
them or cut into chunks of them), captured on first use and replayed after
(``conette_torch/graphs.py``): the counterpart of the JAX package's
``_encode_fn``, one ``jax.jit`` program. On the CPU it runs eagerly.
"""

from __future__ import annotations

from typing import Any, Iterable, Union

import numpy as np
import torch

from conette_torch.graphs import GraphCache
from conette_torch.models.convnext import convnext_apply, convnext_init
from conette_torch.native import loader as native_loader
from conette_torch.utils.profiling import span
from conette_torch.weights import to_torch

TARGET_SR = 32_000
FEAT_SIZE = 768

# Padding buckets (seconds at 32 kHz). Clips longer than the last bucket
# are padded up to the next 5 s multiple.
BUCKETS_S = (1, 2, 3, 5, 7, 10, 15, 20, 30)
# encoder graphs kept: with the rows (REQUEST_BATCH) and the compute dtype
# fixed, one for each bucket. Lengths past the last bucket, or any length
# with use_buckets=False, take the place of the least recently used.
MAX_ENCODER_GRAPHS = len(BUCKETS_S)

ArrayLike = Union[np.ndarray, torch.Tensor]
AudioInput = Union[str, ArrayLike, Iterable[str], Iterable[ArrayLike]]


def bucket_length(n_samples: int, sr: int = TARGET_SR) -> int:
    for s in BUCKETS_S:
        if n_samples <= s * sr:
            return s * sr
    step = 5 * sr
    return ((n_samples + step - 1) // step) * step


class CoNeTTEPreprocessor:
    """Frozen audio tagger frontend over the ConvNeXt parameter tree
    ``params`` (numpy arrays or tensors, moved to ``device``); without
    ``params``, a random ConvNeXt-Tiny from ``convnext_init`` and a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(
        self,
        params: Any | None = None,
        *,
        seed: int = 0,
        device: torch.device | str,
        compute_dtype: torch.dtype = torch.float32,
        use_buckets: bool = True,
    ) -> None:
        if params is None:
            params = convnext_init(torch.Generator().manual_seed(seed))
        self.device = torch.device(device)
        self.params = to_torch(params, self.device)
        self.compute_dtype = compute_dtype
        self.use_buckets = use_buckets
        self.graphs = GraphCache(MAX_ENCODER_GRAPHS)

    @property
    def target_sr(self) -> int:
        return TARGET_SR

    @property
    def feat_size(self) -> int:
        return FEAT_SIZE

    @span("load_resample")
    def load_resample(
        self,
        x: AudioInput,
        sr: Union[None, int, Iterable[int]] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (waveforms (B, T_max) float32 mono at 32 kHz, lengths (B,))."""
        if isinstance(x, str):
            x = [x]
        if isinstance(x, Iterable) and not hasattr(x, "shape"):
            x = list(x)

        if isinstance(x, list) and len(x) > 0 and isinstance(x[0], str):
            return self._pad_stack(native_loader.load_batch(x, TARGET_SR))
        if hasattr(x, "shape"):
            arr = _as_numpy(x)
            if arr.ndim == 1:
                arr = arr[None, None, :]
            elif arr.ndim == 2:
                arr = arr[None, :, :]
            elif arr.ndim != 3:
                raise ValueError(f"Invalid audio array shape {arr.shape}")
            waves = [arr[i] for i in range(arr.shape[0])]
        else:
            waves = [_as_numpy(w) for w in x]
            waves = [w[None, :] if w.ndim == 1 else w for w in waves]
        if sr is None:
            srs = [TARGET_SR] * len(waves)
        elif isinstance(sr, int):
            srs = [sr] * len(waves)
        else:
            srs = list(sr)
        if len(srs) == 1 and len(waves) != 1:
            srs = srs * len(waves)
        if len(waves) != len(srs) or len(waves) == 0:
            raise ValueError(f"Mismatched audio/sr counts ({len(waves)}/{len(srs)}).")

        for w in waves:
            if w.ndim != 2:
                raise ValueError(f"Expected (channels, time) clip, got {w.shape}")
        srs = [int(s) for s in srs]
        with span("resample", clips=len(waves)) as rs:
            # the widest band of the call's rates (0 and 0 where none resamples)
            rs.set(**max((native_loader.taps_attrs(r, TARGET_SR) for r in set(srs)),
                         key=lambda t: t["band_taps"]))
            mono = native_loader.resample_batch(waves, srs, TARGET_SR)
        return self._pad_stack(mono)

    @span("pad_bucket")
    def _pad_stack(self, mono: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """Mono clips → (B, padded length) zero-padded batch and (B,) lengths."""
        lens = np.asarray([len(m) for m in mono], np.int64)
        max_len = int(lens.max())
        pad_len = bucket_length(max_len) if self.use_buckets else max_len
        batch = np.zeros((len(mono), pad_len), np.float32)
        for i, m in enumerate(mono):
            batch[i, : len(m)] = m
        return batch, lens

    @torch.inference_mode()
    def __call__(
        self,
        x: AudioInput,
        sr: Union[None, int, Iterable[int]] = None,
        x_shapes: Any = None,
    ) -> dict[str, torch.Tensor]:
        wav, lens = self.load_resample(x, sr)
        if x_shapes is not None:
            lens = np.asarray(x_shapes)[:, -1]
        audio, n, clip = self.encode(wav, np.asarray(lens, np.int64))
        return {
            "audio": audio,
            "audio_shape": torch.stack([torch.full_like(n, FEAT_SIZE), n], dim=1),
            "clip_probs": clip,
        }

    @span("encode")
    def encode(self, wav: np.ndarray, lens: np.ndarray) -> tuple[torch.Tensor, ...]:
        """The encoder on loaded (B, S) waveforms and (B,) lengths: (B, T, 768)
        frame embeddings, (B,) frame counts, (B, 527) clip probabilities. On
        the card one captured program for each (REQUEST_BATCH, S, compute
        dtype), replayed over chunks of ``REQUEST_BATCH`` rows."""
        return self.graphs.run_batched((wav.shape[1], self.compute_dtype), self._encode,
                                       (wav, lens), self.device, n_batched=2)

    def _encode(self, wav: torch.Tensor, lens: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, S) waveforms and (B,) lengths → (B, T, 768) frame embeddings,
        (B,) frame counts, (B, 527) clip probabilities."""
        outs = convnext_apply(self.params, wav, lens, compute_dtype=self.compute_dtype)
        return (outs["frame_embs"].transpose(1, 2).contiguous(), outs["frame_embs_lens"],
                outs["clipwise_output"])


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)
