"""Log-mel audio frontend: waveform → (B, n_frames, n_mels).

Counterpart of ``conette_tpu/ops/frontend.py``: the reference's
Spectrogram + LogmelFilterBank pair (sr 32000, n_fft 1024, hop 320, 224 mels,
fmin 50, fmax 14000, ref 1.0, amin 1e-10, top_db None), as windowed-DFT
matmul → square-add → mel matmul → log10. The DFT basis and the mel
filterbank are uploaded once for each (cfg, device, dtype) and kept on
the device (:func:`mel_matrix_tensor`, ``ops/stft.py::basis_tensor``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from conette_torch.ops.mel import mel_filterbank
from conette_torch.ops.stft import power_spectrogram
from conette_torch.weights import device_constant

__all__ = ["LogMelConfig", "logmel_spectrogram", "power_to_logmel", "mel_matrix_tensor", "DEFAULT_LOGMEL"]


class LogMelConfig:
    """Static frontend hyperparameters (hashable)."""

    def __init__(
        self,
        sample_rate: int = 32_000,
        n_fft: int = 1024,
        hop_length: int = 320,
        n_mels: int = 224,
        fmin: float = 50.0,
        fmax: float = 14_000.0,
        ref: float = 1.0,
        amin: float = 1e-10,
        top_db: float | None = None,
    ) -> None:
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.fmin = fmin
        self.fmax = fmax
        self.ref = ref
        self.amin = amin
        self.top_db = top_db

    def _key(self) -> tuple:
        return (
            self.sample_rate,
            self.n_fft,
            self.hop_length,
            self.n_mels,
            self.fmin,
            self.fmax,
            self.ref,
            self.amin,
            self.top_db,
        )

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, LogMelConfig) and self._key() == other._key()


DEFAULT_LOGMEL = LogMelConfig()


@lru_cache(maxsize=8)
def _mel_matrix(cfg: LogMelConfig) -> np.ndarray:
    return mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)


@lru_cache(maxsize=16)
def mel_matrix_tensor(cfg: LogMelConfig, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (n_freqs, n_mels) filterbank rounded to ``dtype`` and held as
    f32 on ``device``, built once for each key."""
    return device_constant(_mel_matrix(cfg), device, dtype)


def logmel_spectrogram(
    x: torch.Tensor,
    cfg: LogMelConfig = DEFAULT_LOGMEL,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, T) waveform → (B, n_frames, n_mels) float32 log-mel spectrogram."""
    return power_to_logmel(power_spectrogram(x, cfg.n_fft, cfg.hop_length, compute_dtype=compute_dtype),
                           cfg)


def power_to_logmel(power: torch.Tensor, cfg: LogMelConfig = DEFAULT_LOGMEL) -> torch.Tensor:
    """(B, n_frames, n_freqs) power spectrogram → (B, n_frames, n_mels)
    float32 log-mel, as :func:`logmel_spectrogram` computes it."""
    fb = mel_matrix_tensor(cfg, power.device)
    mel = torch.matmul(power, fb)
    log_mel = 10.0 * torch.log10(torch.clamp_min(mel, cfg.amin))
    log_mel = log_mel - 10.0 * np.log10(max(cfg.amin, cfg.ref))
    if cfg.top_db is not None:
        peak = log_mel.amax(dim=(-2, -1), keepdim=True)
        log_mel = torch.maximum(log_mel, peak - cfg.top_db)
    return log_mel
