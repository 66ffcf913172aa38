"""Polyphase windowed-sinc resampling, on the host and on the device.

Counterpart of ``conette_tpu/ops/resample.py``: the filter bank of
``torchaudio.functional.resample`` (Hann-windowed sincs, lowpass_filter_width
6, rolloff 0.99), applied on the host with one BLAS matmul
(:func:`resample_numpy`: the offline frontends' route, and the reference
that tests hold the native loader's banded resample to) or to tensors as one
strided ``F.conv1d`` followed by a phase interleave (:func:`resample`).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from conette_torch.weights import device_constant

__all__ = ["resample", "resample_kernel", "resampled_length", "resample_numpy"]


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


@lru_cache(maxsize=16)
def _filter_bank(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float,
                 device: torch.device) -> torch.Tensor:
    """The (new, 1, K) phase filters as f32 on ``device``, built once for each key."""
    kernels, _ = resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    return device_constant(np.ascontiguousarray(kernels[:, None, :]), device)


def resample(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """Resample a (..., time) tensor from ``orig_freq`` to ``new_freq`` on its
    device, in its dtype: the filter bank as one convolution of stride
    ``orig / gcd``, whose ``new / gcd`` output channels are the phases."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    _, width = resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    filters = _filter_bank(orig_freq, new_freq, lowpass_filter_width, rolloff, waveform.device)

    shape = waveform.shape
    length = shape[-1]
    x = F.pad(waveform.reshape(-1, 1, length), (width, width + orig))
    y = F.conv1d(x, filters.to(waveform.dtype), stride=orig)  # (B, new, frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)  # phases interleaved
    target = resampled_length(length, orig_freq, new_freq)
    return y[:, :target].reshape(*shape[:-1], target)
