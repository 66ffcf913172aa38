"""The PANN zoo beyond Cnn10/Cnn14, on tensors: the part that
``models/pann.py`` needs so far.

Counterpart of ``conette_tpu/models/pann_zoo.py``, which holds the other
architectures of the reference's vendored PANN zoo
(``src/conette/nn/pann_utils/models.py``: ResNets, MobileNets, Wavegram,
LeeNet, DaiNet, Res1dNet, Cnn6, the decision-level heads). Here only the
frontend configurations of the Cnn14 variants and the time smoothing of
the decision-level attention head are ported; the architectures are ROADMAP
Queue 1 work, and ``models/pann.py`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conette_torch.ops.frontend import LogMelConfig

PANN_LOGMEL128 = LogMelConfig(n_mels=128)
PANN_LOGMEL32 = LogMelConfig(n_mels=32)
PANN_LOGMEL_16K = LogMelConfig(
    sample_rate=16_000, n_fft=512, hop_length=160, n_mels=64, fmax=8_000.0
)
PANN_LOGMEL_8K = LogMelConfig(
    sample_rate=8_000, n_fft=256, hop_length=80, n_mels=64, fmax=4_000.0
)


def _pool1d_same(x: torch.Tensor, kind: str, k: int = 3) -> torch.Tensor:
    """k3 s1 p1 max or average pool over the time axis of (B, T, C); the
    average divides by ``k`` everywhere (torch ``avg_pool1d`` with
    ``count_include_pad=True``), the max pads with -inf."""
    xc = x.transpose(1, 2)
    if kind == "max":
        y = F.max_pool1d(xc, k, stride=1, padding=k // 2)
    else:
        y = F.avg_pool1d(xc, k, stride=1, padding=k // 2, count_include_pad=True)
    return y.transpose(1, 2)
