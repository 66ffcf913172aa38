"""Gammatonegram filterbank.

Twin of the reference's Gammatonegram frontend variants
(``src/conette/transforms/get.py:313-647``): an ERB-spaced bank of
4th-order gammatone magnitude responses applied to the power spectrogram
exactly like the mel filterbank (one (n_freqs, n_filters) matmul operand),
so the gammatonegram rides the same MXU path as the log-mel frontend.

Construction follows the classic ERB conventions (Glasberg & Moore):
ERB(f) = 24.7·(4.37·f/1000 + 1), center frequencies equally spaced on the
ERB-rate scale, per-channel bandwidth b = 1.019·ERB(cf), and the 4th-order
gammatone magnitude response |H(f)| = (1 + ((f−cf)/b)²)^(−2), peak-normalized.
"""

from __future__ import annotations

import numpy as np

__all__ = ["erb", "erb_space", "gammatone_filterbank"]

_EAR_Q = 9.26449
_MIN_BW = 24.7


def erb(frequencies: np.ndarray) -> np.ndarray:
    """Equivalent rectangular bandwidth at each frequency (Hz)."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    return f / _EAR_Q + _MIN_BW


def erb_space(fmin: float, fmax: float, n: int) -> np.ndarray:
    """``n`` center frequencies equally spaced on the ERB-rate scale,
    descending from fmax toward fmin (Slaney's ERBSpace), returned
    ascending."""
    i = np.arange(1, n + 1, dtype=np.float64)
    cfs = -(_EAR_Q * _MIN_BW) + np.exp(
        i * (-np.log(fmax + _EAR_Q * _MIN_BW) + np.log(fmin + _EAR_Q * _MIN_BW)) / n
    ) * (fmax + _EAR_Q * _MIN_BW)
    return cfs[::-1].copy()


def gammatone_filterbank(
    sr: int,
    n_fft: int,
    n_filters: int = 64,
    fmin: float = 50.0,
    fmax: float | None = None,
    order: int = 4,
    dtype: np.dtype = np.float32,
) -> np.ndarray:
    """(n_freqs, n_filters) gammatone weight matrix for
    ``power_spectrogram @ fb``."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    cfs = erb_space(fmin, fmax, n_filters)
    bw = 1.019 * erb(cfs)

    delta = (fftfreqs[:, None] - cfs[None, :]) / bw[None, :]
    weights = (1.0 + delta**2) ** (-order / 2.0)
    weights /= weights.max(axis=0, keepdims=True)
    # area normalization (like Slaney mel) so filter energies are comparable
    weights *= 2.0 / (weights.sum(axis=0, keepdims=True) * (sr / n_fft))
    return weights.astype(dtype)
