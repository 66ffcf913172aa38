"""Operations and bytes of PANNs' Wavegram_Logmel_Cnn14 frame embeddings,
at a clip's own length (``benchmark/reference/wavegram.py``'s work; the
peaks are ``benchmark/roofline.py``'s).

Counts follow ``roofline_pann.py``'s arithmetic: a multiply-add is two
operations; bytes, in f32, are the clip's samples and each product's
operands and output once (a convolution's input and output maps and its
weights). The wavegram branch: ``pre_conv0`` (1 → 64, kernel 11, stride 5)
over ``(n - 1) // 5 + 1`` steps, each ``ConvPreWavBlock``'s two kernel-3
convolutions at its steps (floored by 4 after each block), and
``pre_block4``'s two 3×3 convolutions over (steps, 32). The log-mel branch:
the DFT and mel bands over ``1 + n // 320`` frames and the first ConvBlock.
The tail: Cnn14's blocks 2-6 over the joined map (the lesser of the two
branches' lengths, 32 frequencies), block 2 taking both branches' 128
channels. Only a clip's own steps are counted, never a batch's padding, so
a share of the roofline reads the same work whatever computes it.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_F32, bound_s

HOP = 320
N_FFT = 1024
N_MELS = 64
PRE_CHANNELS = (64, 64, 128, 128)  # pre_conv0, pre_block1-3
PRE_BLOCK4 = 64
CHANNELS = (64, 128, 256, 512, 1024, 2048)


def wave_conv_shapes(samples: int, pre=PRE_CHANNELS) -> list[tuple[int, int, int, int, int]]:
    """(input steps, output steps, kernel, C_in, C_out) of each 1-D
    convolution of the wavegram branch of a clip of ``samples`` at 32 kHz."""
    t = (samples - 1) // 5 + 1
    out, cin = [(samples, t, 11, 1, pre[0])], pre[0]
    for c in pre[1:]:
        out += [(t, t, 3, cin, c), (t, t, 3, c, c)]
        cin, t = c, t // 4
    return out


def wave_steps(samples: int) -> int:
    """Steps of the wavegram map after ``pre_block3``'s pool."""
    return ((samples - 1) // 5 + 1) // 4 // 4 // 4


def conv2d_shapes(samples: int, pre=PRE_CHANNELS, block4: int = PRE_BLOCK4, channels=CHANNELS,
                  n_mels: int = N_MELS) -> dict[str, list[tuple[int, int, int, int]]]:
    """(T, F, C_in, C_out) of each 3×3 convolution: ``pre_block4``'s, the
    log-mel branch's first block's, and the tail's (blocks 2-6)."""
    tw, fw = wave_steps(samples), pre[-1] // 4
    tm = 1 + samples // HOP
    t, f = min(tw // 2, tm // 2), min(fw, n_mels // 2)
    tail, cin = [], channels[0] + block4
    for i, c in enumerate(channels[1:]):
        tail += [(t, f, cin, c), (t, f, c, c)]
        cin = c
        if i < len(channels) - 2:
            t, f = t // 2, f // 2
    return {"pre_block4": [(tw, fw, 4, block4), (tw, fw, block4, block4)],
            "logmel_block1": [(tm, n_mels, 1, channels[0]), (tm, n_mels, channels[0], channels[0])],
            "tail": tail}


def _conv1d(shapes) -> tuple[float, float]:
    flops = sum(2 * t * k * cin * cout for _, t, k, cin, cout in shapes)
    nbytes = sum(4 * (t_in * cin + t * cout + k * cin * cout) for t_in, t, k, cin, cout in shapes)
    return flops, nbytes


def _conv2d(shapes) -> tuple[float, float]:
    flops = sum(2 * t * f * 9 * cin * cout for t, f, cin, cout in shapes)
    nbytes = sum(4 * (t * f * (cin + cout) + 9 * cin * cout) for t, f, cin, cout in shapes)
    return flops, nbytes


def wavegram_flops_bytes(samples: int, pre=PRE_CHANNELS, block4: int = PRE_BLOCK4) -> tuple[float, float]:
    """Operations and f32 bytes of one clip's wavegram branch, ``pre_conv0``
    through ``pre_block4`` (its input, the clip's samples, read once)."""
    f1, b1 = _conv1d(wave_conv_shapes(samples, pre))
    f2, b2 = _conv2d(conv2d_shapes(samples, pre, block4)["pre_block4"])
    return f1 + f2, b1 + b2


def wavegram_bound_s(samples: int, pre=PRE_CHANNELS, block4: int = PRE_BLOCK4) -> float:
    """The least time the card could take for one clip's wavegram branch:
    its operations at f32's peak (TF32 is off) or its bytes at the
    memory's."""
    return bound_s(*wavegram_flops_bytes(samples, pre, block4), PEAK_F32)


def model_flops_bytes(samples: int, pre=PRE_CHANNELS, block4: int = PRE_BLOCK4, channels=CHANNELS,
                      n_mels: int = N_MELS) -> tuple[float, float]:
    """Operations and f32 bytes of one clip's frame embeddings: the log-mel
    (DFT and mel bands), both branches and the tail."""
    frames = 1 + samples // HOP
    n_freq = N_FFT // 2 + 1
    flops = frames * (2 * N_FFT * 2 * n_freq + 2 * n_freq * n_mels)
    nbytes = 4 * frames * n_mels  # the samples: read once, by the wavegram's count
    fw, bw = wavegram_flops_bytes(samples, pre, block4)
    shapes = conv2d_shapes(samples, pre, block4, channels, n_mels)
    f2, b2 = _conv2d(shapes["logmel_block1"] + shapes["tail"])
    return flops + fw + f2, nbytes + bw + b2


def model_bound_s(samples: int, pre=PRE_CHANNELS, block4: int = PRE_BLOCK4, channels=CHANNELS) -> float:
    """The least time the card could take for one clip's frame
    embeddings."""
    return bound_s(*model_flops_bytes(samples, pre, block4, channels), PEAK_F32)
