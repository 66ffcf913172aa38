"""Plain PANNs Cnn14 frame embeddings (Kong et al., arXiv:1912.10211;
``qiuqiangkong/audioset_tagging_cnn``, ``pytorch/models.py::Cnn14``), NCHW,
f32, one clip at a time at its own length.

32 kHz audio → log-mel (``torchlibrosa``'s Spectrogram: n_fft 1024, hop
320, periodic Hann, centred with reflect padding, power 2; LogmelFilterBank:
64 Slaney bands with area normalisation, 50-14 000 Hz, 10·log10 of the power
clamped at 1e-10) → bn0 over the mel bands → six ConvBlocks (3×3 conv,
padding 1 → BN → ReLU, twice; a 2×2 average pool after blocks 1-5, odd
extents floored) at 64/128/256/512/1024/2048 channels → the mean over
frequency: (T', 2048) frames. Batch norms in inference mode (eps 1e-5).

Departures from ``Cnn14.forward``: no SpecAugment, mixup or dropout (they
act in training only); the clip head (max + mean over time, fc1,
fc_audioset) is left out, since a pack stores the frame embeddings only;
each convolution adds the weights' bias, which PANNs' bias-free
convolutions do not have (the benchmark draws it zero). Weights in the
program's tree layout (HWIO kernels; ``bn0``, ``blocks[i].conv1/bn1/
conv2/bn2``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.audio import mel_filterbank
from benchmark.reference.nn import conv2d, identity

N_FFT, HOP, N_MELS = 1024, 320, 64
EPS = 1e-5


def frame_count(n_samples: int, blocks: int = 6) -> int:
    """T' of a clip of ``n_samples`` at 32 kHz: its mel frames, halved
    (floored) by each pool."""
    t = 1 + n_samples // HOP
    for _ in range(blocks - 1 if blocks == 6 else blocks):
        t //= 2
    return t


def batch_norm(p: dict, x: torch.Tensor, dim: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[dim] = -1
    scale = p["weight"] / torch.sqrt(p["running_var"] + EPS)
    return (x - p["running_mean"].reshape(shape)) * scale.reshape(shape) + p["bias"].reshape(shape)


def logmel(wav: torch.Tensor, bn0: dict, rnd=identity) -> torch.Tensor:
    """(B, S) waveforms → (B, 1 + S // 320, 64) log-mel after bn0; ``rnd``
    rounds the operands of the two products (the DFT and the mel bands)."""
    pad = N_FFT // 2
    x = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)
    n = torch.arange(N_FFT, device=wav.device, dtype=torch.float64)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)
    k = torch.arange(N_FFT // 2 + 1, device=wav.device, dtype=torch.float64)
    ang = 2 * math.pi * n[:, None] * k[None, :] / N_FFT
    cos = (win[:, None] * torch.cos(ang)).float()
    sin = (win[:, None] * torch.sin(ang)).float()
    fr = rnd(frames.float())
    power = (fr @ rnd(cos)) ** 2 + (fr @ rnd(sin)) ** 2
    fb = torch.from_numpy(mel_filterbank(n_mels=N_MELS)).float().to(wav.device)
    db = 10.0 * torch.log10((rnd(power) @ rnd(fb)).clamp_min(1e-10))
    return batch_norm(bn0, db, -1)


def frames(params: dict, wav: torch.Tensor, rnd=identity) -> torch.Tensor:
    """(B, S) 32 kHz waveforms, every row S samples long → (B, T', C) frame
    embeddings."""
    x = logmel(wav, params["bn0"], rnd)[:, None]  # (B, 1, T, 64)
    blocks = params["blocks"]
    for i, blk in enumerate(blocks):
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            x = conv2d(x, blk[conv]["weight"], blk[conv]["bias"], rnd, padding=1)
            x = F.relu(batch_norm(blk[bn], x, 1))
        if i < len(blocks) - 1 or len(blocks) != 6:
            x = F.avg_pool2d(x, 2)
    return x.mean(dim=3).transpose(1, 2)
