"""STFT / power spectrogram as one matmul against a windowed DFT basis.

Counterpart of ``conette_tpu/ops/stft.py``: the reference's
``torchlibrosa.stft.Spectrogram`` (n_fft 1024, hop 320, periodic Hann
window, center=True, reflect padding, power 2), computed as
``frames (B, T, n_fft) @ basis (n_fft, 2·n_freqs)`` followed by re² + im².
The basis is uploaded once for each (n_fft, device, dtype) and kept there
(:func:`basis_tensor`), so a call copies nothing from the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from conette_torch.weights import device_constant

__all__ = [
    "hann_window", "dft_basis", "basis_tensor", "num_frames", "frame_signal", "frame_rows",
    "frames_power", "power_spectrogram",
]


def hann_window(win_length: int, dtype: np.dtype = np.float32) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as used by librosa/torchlibrosa."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


@lru_cache(maxsize=8)
def dft_basis(n_fft: int, dtype: str = "float32") -> np.ndarray:
    """Windowed real-DFT basis, shape (n_fft, 2*(n_fft//2+1)): column k holds
    ``win[n]·cos(2πkn/N)`` (real part), column k+n_freqs ``win[n]·-sin(…)``."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * k * n / n_fft
    win = hann_window(n_fft, np.float64)[:, None]
    basis = np.concatenate([win * np.cos(angle), win * -np.sin(angle)], axis=1)
    return basis.astype(dtype)


@lru_cache(maxsize=16)
def basis_tensor(n_fft: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`dft_basis` rounded to ``dtype`` and held as f32 on ``device``,
    built once for each key."""
    return device_constant(dft_basis(n_fft), device, dtype)


def num_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Frame count with center padding: 1 + n_samples // hop."""
    return 1 + n_samples // hop_length


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T) waveform → (B, 1 + T // hop, n_fft) frames, center reflect pad."""
    pad = n_fft // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    return xp.unfold(-1, n_fft, hop_length)


def frame_rows(x: torch.Tensor, lens: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T) zero-padded rows of ``lens`` samples each → (B, 1 + T // hop,
    n_fft) frames, each row centred with reflect padding at its own end, so
    that a row's first ``1 + lens // hop`` frames are those that
    :func:`frame_signal` gives it alone (each ``lens`` > n_fft // 2). Its
    frames past those read the batch's padding."""
    pad = n_fft // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    # the reflection of each row's own end: padded position n + pad + k holds x[n - 2 - k]
    k = torch.arange(pad, device=x.device)
    n = lens.to(x.device, torch.long)[:, None]
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    xp[rows, n + pad + k] = x[rows, n - 2 - k]
    return xp.unfold(-1, n_fft, hop_length)


def frames_power(frames: torch.Tensor, n_fft: int = 1024,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, n_frames, n_fft) frames → (B, n_frames, n_freqs) float32 power
    spectrogram, as :func:`power_spectrogram` computes it."""
    n_freqs = n_fft // 2 + 1
    frames = frames.to(compute_dtype).float()
    basis = basis_tensor(n_fft, frames.device, compute_dtype)
    spec = torch.matmul(frames, basis)
    real, imag = spec[..., :n_freqs], spec[..., n_freqs:]
    return real * real + imag * imag


def power_spectrogram(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 320,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, T) waveform → (B, n_frames, n_freqs) float32 power spectrogram.

    Frames and basis are rounded to ``compute_dtype``, then multiplied with
    float32 accumulation (exact products for bf16 operands)."""
    return frames_power(frame_signal(x, n_fft, hop_length), n_fft, compute_dtype)
