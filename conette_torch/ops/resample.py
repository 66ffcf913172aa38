"""Polyphase windowed-sinc resampling on the host.

Counterpart of the numpy half of ``conette_tpu/ops/resample.py``: the
filter bank of ``torchaudio.functional.resample`` (Hann-windowed sincs,
lowpass_filter_width 6, rolloff 0.99) applied with one BLAS matmul. The
preprocessor resamples on the host, so this is all the serving path needs.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["resample_kernel", "resampled_length", "resample_numpy"]


@lru_cache(maxsize=32)
def resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    dtype: str = "float32",
) -> tuple[np.ndarray, int]:
    """Build the polyphase filter bank.

    Returns (kernels (new_freq/gcd, kernel_width), width) where
    ``kernels[p]`` is the filter producing output phase ``p``.
    """
    gcd = math.gcd(orig_freq, new_freq)
    orig_freq //= gcd
    new_freq //= gcd

    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(dtype), width


def resampled_length(n_samples: int, orig_freq: int, new_freq: int) -> int:
    gcd = math.gcd(orig_freq, new_freq)
    return int(math.ceil((new_freq // gcd) * n_samples / (orig_freq // gcd)))


def resample_numpy(waveform: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Resample (..., time) ``waveform`` from ``orig_freq`` to ``new_freq``."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    kernels, width = resample_kernel(orig_freq, new_freq)
    shape = waveform.shape
    length = shape[-1]
    x = waveform.reshape(-1, length).astype(np.float32)
    x = np.pad(x, ((0, 0), (width, width + orig)))
    k_len = kernels.shape[1]
    windows = np.lib.stride_tricks.sliding_window_view(x, k_len, axis=-1)[
        :, ::orig, :
    ]  # (B, frames, K)
    y = windows @ kernels.T  # (B, frames, new)
    y = y.reshape(x.shape[0], -1)
    target = resampled_length(length, orig_freq, new_freq)
    return y[:, :target].reshape(*shape[:-1], target)
