"""Operations and bytes of PANNs' Cnn14 frame embeddings, at a clip's own
length (``benchmark/reference/pann.py``'s work; the peaks are
``benchmark/roofline.py``'s).

Counts follow ``roofline.py``'s arithmetic: a multiply-add is two
operations; the log-mel's DFT (the cosine and sine products over
``1 + samples // 320`` frames of 1024) and mel bands (513 → 64), then each
3×3 convolution (padding 1) at its time × frequency extent, the extents
halved and floored by the 2×2 pool after each block but Cnn14's last. Bytes,
in f32: the clip's samples and each product's operands and output once (a
convolution's input and output feature maps and its weights). Only a clip's
own frames are counted, never a batch's padding, so a share of the roofline
reads the same work whatever computes it.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_F32, bound_s

HOP = 320
N_FFT = 1024
N_MELS = 64
CNN14_CHANNELS = (64, 128, 256, 512, 1024, 2048)


def conv_shapes(samples: int, channels=CNN14_CHANNELS, n_mels: int = N_MELS) -> list[tuple[int, int, int, int]]:
    """(T, F, C_in, C_out) of each 3×3 convolution of a clip of ``samples``
    at 32 kHz."""
    t, f, cin = 1 + samples // HOP, n_mels, 1
    out = []
    for i, c in enumerate(channels):
        out += [(t, f, cin, c), (t, f, c, c)]
        cin = c
        if i < len(channels) - 1 or len(channels) != 6:
            t, f = t // 2, f // 2
    return out


def cnn14_flops(samples: int, channels=CNN14_CHANNELS, n_mels: int = N_MELS) -> float:
    """Operations of one clip's frame embeddings."""
    frames = 1 + samples // HOP
    n_freq = N_FFT // 2 + 1
    total = frames * (2 * N_FFT * 2 * n_freq + 2 * n_freq * n_mels)
    return total + sum(2 * t * f * 9 * cin * cout for t, f, cin, cout in conv_shapes(samples, channels, n_mels))


def cnn14_bytes(samples: int, channels=CNN14_CHANNELS, n_mels: int = N_MELS) -> float:
    """f32 bytes one clip's frame embeddings must move at least."""
    frames = 1 + samples // HOP
    total = 4 * (samples + frames * n_mels)
    return total + sum(4 * (t * f * (cin + cout) + 9 * cin * cout)
                       for t, f, cin, cout in conv_shapes(samples, channels, n_mels))


def cnn14_bound_s(samples: int, channels=CNN14_CHANNELS) -> float:
    """The least time the card could take for one clip: its operations at
    f32's peak (TF32 is off) or its bytes at the memory's."""
    return bound_s(cnn14_flops(samples, channels), cnn14_bytes(samples, channels), PEAK_F32)
