"""Plain PANNs Wavegram_Logmel_Cnn14 frame embeddings (Kong et al.,
arXiv:1912.10211; ``qiuqiangkong/audioset_tagging_cnn``,
``pytorch/models.py::Wavegram_Logmel_Cnn14``), NCW / NCHW, f32, one clip at
a time at its own length.

Two branches on 32 kHz audio, as ``Wavegram_Logmel_Cnn14.forward``:

- the wavegram: ``pre_conv0`` (conv1d 1 → 64, kernel 11, stride 5,
  padding 5) → ``pre_bn0`` → ReLU; three ``ConvPreWavBlock``s (conv1d
  kernel 3, padding 1 → BN → ReLU → conv1d kernel 3, dilation 2, padding 2
  → BN → ReLU → max pool of 4) at 64 → 64, 64 → 128, 128 → 128; the 128
  channels reshaped to 4 groups × 32 "frequencies" (channel g·32 + f);
  ``pre_block4``, a ConvBlock 4 → 64 with a (2, 1) average pool;
- the log-mel: ``benchmark/reference/pann.py``'s log-mel and bn0, then
  ConvBlock 1 → 64 with a 2×2 average pool;

then both concatenated over channels (log-mel first) to 128, Cnn14's
ConvBlocks 2-6 at 128/256/512/1024/2048 (a 2×2 average pool after each but
the last) and the mean over frequency: (T', 2048) frames. Batch norms in
inference mode (eps 1e-5).

Departures from ``Wavegram_Logmel_Cnn14.forward``: no SpecAugment, mixup
or dropout (they act in training only); the clip head (max + mean over
time, fc1, fc_audioset) is left out, since a pack stores the frame
embeddings only; each 2-D convolution adds the weights' bias, which
PANNs' bias-free convolutions do not have (the benchmark draws it zero);
the two maps are cut to their common time extent before they are joined
(``torch.cat`` needs them equal, and at most lengths the wavegram is one
step shorter than the log-mel map; at 10 s, the checkpoint's training
length, they are equal). Weights in the program's tree layout (WIO conv1d
kernels, HWIO conv2d kernels; ``pre_conv0``, ``pre_bn0``,
``pre_block1..3.conv1/bn1/conv2/bn2``, ``pre_block4``, ``bn0``,
``blocks[i]``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import pann as ref_pann
from benchmark.reference.nn import conv2d, identity


def frame_count(n_samples: int) -> int:
    """T' of a clip of ``n_samples`` at 32 kHz: the lesser of the wavegram's
    steps (``(n - 1) // 5 + 1``, floored by three pools of 4 and one of 2)
    and the log-mel's frames (``1 + n // 320``, halved), halved (floored)
    by each of the four pools of blocks 2-5."""
    t = min(((n_samples - 1) // 5 + 1) // 4 // 4 // 4 // 2, (1 + n_samples // ref_pann.HOP) // 2)
    for _ in range(4):
        t //= 2
    return t


def conv1d(x: torch.Tensor, w_wio: torch.Tensor, rnd=identity, **kw) -> torch.Tensor:
    """NCW convolution with a WIO kernel and no bias."""
    return F.conv1d(rnd(x), rnd(w_wio.permute(2, 1, 0)), **kw)


def conv_block(p: dict, x: torch.Tensor, pool: tuple[int, int], rnd=identity) -> torch.Tensor:
    """PANNs' ConvBlock: (3×3 conv, padding 1 → BN → ReLU) twice, then an
    average pool of ``pool`` (odd extents floored)."""
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        x = conv2d(x, p[conv]["weight"], p[conv]["bias"], rnd, padding=1)
        x = F.relu(ref_pann.batch_norm(p[bn], x, 1))
    return F.avg_pool2d(x, pool) if pool != (1, 1) else x


def wavegram(params: dict, wav: torch.Tensor, rnd=identity) -> torch.Tensor:
    """(B, S) waveforms → (B, 64, T, 32) after ``pre_block4``."""
    a = F.relu(ref_pann.batch_norm(params["pre_bn0"],
                                   conv1d(wav[:, None], params["pre_conv0"]["weight"], rnd, stride=5, padding=5), 1))
    for name in ("pre_block1", "pre_block2", "pre_block3"):
        p = params[name]
        a = F.relu(ref_pann.batch_norm(p["bn1"], conv1d(a, p["conv1"]["weight"], rnd, padding=1), 1))
        a = F.relu(ref_pann.batch_norm(p["bn2"], conv1d(a, p["conv2"]["weight"], rnd, padding=2, dilation=2), 1))
        a = F.max_pool1d(a, 4)
    b, c, t = a.shape
    a = a.reshape(b, 4, c // 4, t).transpose(2, 3)
    return conv_block(params["pre_block4"], a, (2, 1), rnd)


def frames(params: dict, wav: torch.Tensor, rnd=identity) -> torch.Tensor:
    """(B, S) 32 kHz waveforms, every row S samples long → (B, T', 2048)
    frame embeddings. ``rnd`` rounds the operands of every product (the DFT,
    the mel bands and each convolution)."""
    a = wavegram(params, wav, rnd)
    x = conv_block(params["blocks"][0], ref_pann.logmel(wav, params["bn0"], rnd)[:, None], (2, 2), rnd)
    t = min(x.shape[2], a.shape[2])
    x = torch.cat([x[:, :, :t], a[:, :, :t]], dim=1)
    tail = params["blocks"][1:]
    for i, blk in enumerate(tail):
        x = conv_block(blk, x, (2, 2) if i < len(tail) - 1 else (1, 1), rnd)
    return x.mean(dim=3).transpose(1, 2)
