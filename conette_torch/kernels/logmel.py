"""The fused log-mel frontend: CUDA kernel wrapper and its plain version.

``fused_logmel`` computes waveform → windowed DFT → power → mel filterbank
→ dB → optional per-mel affine (the inference bn0 folded in) with the
hand-written Hopper kernel ``conette_torch/csrc/logmel.cu``; it replaces
the TPU kernel ``conette_tpu/ops/pallas/logmel.py`` (``fused_logmel_frames``,
reached through ``fused_logmel``). The arithmetic follows the TPU kernel
(``_logmel_kernel``): frames and basis are rounded to ``compute_dtype`` and
multiplied with f32 accumulation; the power is rounded to ``compute_dtype``
before the mel product, which the plain frontend
(``conette_torch/ops/frontend.py``) does not do, so the plain version here
is :func:`logmel_reference` and not ``logmel_spectrogram``.

For a waveform on the CPU the wrapper runs :func:`logmel_reference`; for a
CUDA waveform it launches the kernel or raises. The TPU path ignores
``cfg.top_db`` silently; here a ``cfg`` with ``top_db`` set raises.

On the card the kernel is bound by operations (bf16 tensor cores, or f32
FMA at f32 compute); it keeps the spectrum, the power and the frames out of
device memory (see the note in ``csrc/logmel.cu``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from conette_torch.kernels import _build
from conette_torch.ops.frontend import DEFAULT_LOGMEL, LogMelConfig, _mel_matrix
from conette_torch.ops.stft import dft_basis, frame_signal

N_FFT = 1024
N_MELS = 224
CHUNK = 32  # frequencies per chunk of the kernel's basis layout
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check(cfg: LogMelConfig, compute_dtype: torch.dtype) -> None:
    if cfg.top_db is not None:
        raise ValueError(
            f"fused_logmel does not apply top_db (got {cfg.top_db}); use "
            "ops.frontend.logmel_spectrogram for a clamped dynamic range"
        )
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")


def log_ref(cfg: LogMelConfig) -> float:
    return float(10.0 * np.log10(max(cfg.amin, cfg.ref)))


def logmel_reference(
    x: torch.Tensor,
    cfg: LogMelConfig = DEFAULT_LOGMEL,
    bn_scale: torch.Tensor | None = None,
    bn_shift: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, S) waveform → (B, 1 + S // hop, n_mels) f32, in plain PyTorch,
    rounding to ``compute_dtype`` where the kernel rounds."""
    _check(cfg, compute_dtype)
    n_freqs = cfg.n_fft // 2 + 1
    frames = frame_signal(x.float(), cfg.n_fft, cfg.hop_length).to(compute_dtype).float()
    basis = torch.from_numpy(dft_basis(cfg.n_fft)).to(x.device, compute_dtype).float()
    spec = torch.matmul(frames, basis)
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    power = (re * re + im * im).to(compute_dtype).float()
    fb = torch.from_numpy(_mel_matrix(cfg)).to(x.device, compute_dtype).float()
    mel = torch.matmul(power, fb)
    log_mel = 10.0 * torch.log(torch.clamp_min(mel, cfg.amin)) / math.log(10.0) - log_ref(cfg)
    if bn_scale is not None:
        log_mel = log_mel * bn_scale.float() + bn_shift.float()
    return log_mel


@functools.lru_cache(maxsize=8)
def _operands(cfg: LogMelConfig, device: torch.device, dtype: torch.dtype):
    """The basis in the kernel's chunked layout (1024, 2·CHUNK·n_chunks) —
    chunk j holds the real columns of frequencies j·CHUNK .. +CHUNK-1, then
    their imaginary columns, zero past frequency 512 — and the filterbank
    (CHUNK·n_chunks, n_mels) with zero rows past 512, both in ``dtype`` on
    ``device``."""
    n_freqs = cfg.n_fft // 2 + 1
    n_chunks = -(-n_freqs // CHUNK)
    f_pad = n_chunks * CHUNK
    basis = dft_basis(cfg.n_fft)
    re = np.zeros((cfg.n_fft, f_pad), np.float32)
    im = np.zeros((cfg.n_fft, f_pad), np.float32)
    re[:, :n_freqs] = basis[:, :n_freqs]
    im[:, :n_freqs] = basis[:, n_freqs:]
    chunked = np.concatenate(
        [re.reshape(cfg.n_fft, n_chunks, 1, CHUNK), im.reshape(cfg.n_fft, n_chunks, 1, CHUNK)],
        axis=2,
    ).reshape(cfg.n_fft, 2 * f_pad)
    fb = np.zeros((f_pad, cfg.n_mels), np.float32)
    fb[:n_freqs] = _mel_matrix(cfg)
    return (
        torch.from_numpy(chunked).to(device, dtype).contiguous(),
        torch.from_numpy(fb).to(device, dtype).contiguous(),
    )


def fused_logmel(
    x: torch.Tensor,
    cfg: LogMelConfig = DEFAULT_LOGMEL,
    bn_scale: torch.Tensor | None = None,
    bn_shift: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, S) waveform → (B, 1 + S // hop, n_mels) f32 log-mel, with the
    optional affine ``· bn_scale + bn_shift`` per mel bin. S must exceed
    ``n_fft // 2`` (reflect padding). On the card the kernel takes n_fft
    1024, 224 mels and a hop that is a multiple of 16. Each launch adds one
    to ``fused_logmel.launches``."""
    _check(cfg, compute_dtype)
    if x.dim() != 2:
        raise ValueError(f"expected a (B, S) waveform, got {tuple(x.shape)}")
    if (bn_scale is None) != (bn_shift is None):
        raise ValueError("bn_scale and bn_shift come together")
    if x.device.type == "cpu":
        return logmel_reference(x, cfg, bn_scale, bn_shift, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_logmel runs on cuda or cpu, got {x.device}")
    if cfg.n_fft != N_FFT or cfg.n_mels != N_MELS or cfg.hop_length % 16:
        raise ValueError(
            f"the log-mel kernel takes n_fft {N_FFT}, {N_MELS} mels and a hop that is a "
            f"multiple of 16, got n_fft {cfg.n_fft}, {cfg.n_mels} mels, hop {cfg.hop_length}"
        )
    b, s = x.shape
    pad = cfg.n_fft // 2
    if s <= pad:
        raise ValueError(f"reflect padding needs more than {pad} samples, got {s}")
    dev = x.device
    f32 = torch.float32
    t = 1 + s // cfg.hop_length
    # a fresh (B, S + n_fft) buffer: contiguous and aligned for any slice x
    xp = F.pad(x.float()[:, None, :], (pad, pad), mode="reflect")[:, 0, :].contiguous()
    basis, fb = _operands(cfg, dev, compute_dtype)
    if bn_scale is None:
        scale = torch.ones(N_MELS, dtype=f32, device=dev)
        shift = torch.zeros(N_MELS, dtype=f32, device=dev)
    else:
        scale = bn_scale.to(dev, f32).contiguous()
        shift = bn_shift.to(dev, f32).contiguous()
    _build.require(xp, "padded waveform", f32, (b, s + 2 * pad), dev)
    _build.require(scale, "bn_scale", f32, (N_MELS,), dev)
    _build.require(shift, "bn_shift", f32, (N_MELS,), dev)
    out = torch.empty((b, t, N_MELS), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        fn = _build.entry("conette_logmel", 6, 5, 2)
        code = fn(
            xp.data_ptr(), basis.data_ptr(), fb.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, s + 2 * pad, t, cfg.hop_length,
            int(compute_dtype == torch.bfloat16), cfg.amin, log_ref(cfg), _build.stream_of(x),
        )
    _build.check(code, "conette_logmel")
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
