"""Mel filterbank construction (host-side numpy, computed once per config).

Reproduces the filterbank used by the reference frontend
(``torchlibrosa.stft.LogmelFilterBank`` with sr=32000, n_fft=1024,
n_mels=224, fmin=50, fmax=14000; wired at
``src/conette/nn/encoders/convnext.py:170-180``), which is
``librosa.filters.mel`` with the Slaney mel scale and Slaney area
normalization. The matrix is a static (n_freqs, n_mels) operand of the
log-mel matmul. A numpy copy of ``conette_tpu/ops/mel.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank", "power_to_db"]

# Slaney scale constants: linear below 1 kHz, logarithmic above.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    m = np.asanyarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype: np.dtype = np.float32,
) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, shape (n_freqs, n_mels)
    where n_freqs = n_fft//2 + 1. Transposed relative to librosa so it can be
    applied as ``power_spectrogram @ fb``."""
    if fmax is None:
        fmax = sr / 2.0

    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs, dtype=np.float64)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization (constant energy per channel).
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]

    return weights.T.astype(dtype)


def power_to_db(
    power: np.ndarray, ref: float = 1.0, amin: float = 1e-10, top_db: float | None = None
) -> np.ndarray:
    """Reference log-mel compression (``LogmelFilterBank`` semantics with
    ref=1.0, amin=1e-10, top_db=None): ``10*log10(clamp(power, amin))``."""
    log_spec = 10.0 * np.log10(np.maximum(amin, power))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec
