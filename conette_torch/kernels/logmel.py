"""The fused log-mel frontend: CUDA kernel wrapper and its plain version.

``fused_logmel`` computes waveform → windowed DFT → power → mel filterbank
→ dB → optional per-mel affine (the inference bn0 folded in) with the
hand-written Hopper kernel ``conette_torch/csrc/logmel.cu``; it replaces
the TPU kernel ``conette_tpu/ops/pallas/logmel.py`` (``fused_logmel_frames``,
reached through ``fused_logmel``). On the card the wrapper calls the custom
op ``conette_torch::logmel`` (:func:`logmel_op`), whose only implementation
is CUDA's: the kernel through :func:`launch_logmel`; its fake
implementation gives the output's shape, so ``torch.export`` and CUDA
graph capture see one node a call. The arithmetic follows the TPU kernel
(``_logmel_kernel``): frames and basis are rounded to ``compute_dtype`` and
multiplied with f32 accumulation; the power is rounded to ``compute_dtype``
before the mel product, which the plain frontend
(``conette_torch/ops/frontend.py``) does not do, so the plain version here
is :func:`logmel_reference` and not ``logmel_spectrogram``.

For a waveform on the CPU the wrapper runs :func:`logmel_reference`; for a
CUDA waveform it launches the kernel or raises. The TPU path ignores
``cfg.top_db`` silently; here a ``cfg`` with ``top_db`` set raises.

The bf16 kernel (the card's route; the source's head note has the whole of
its design) reflect-pads the waveform itself, reads the frames where they
lie, runs the DFT on ``wgmma`` with the basis streamed through a
shared-memory ring, and does the DFT and the mel product only for what the
filterbank reads. What it needs of a ``cfg`` is packed here once, in plain
numpy, and uploaded once per (cfg, device, dtype) by :func:`_operands`:

- :func:`live_range`: the first and last filterbank row with a nonzero
  entry (2 and 447 at the default cfg); the DFT runs over the chunks of
  ``CHUNK_FREQS`` frequencies that cover them (:func:`logmel_layout`);
- :func:`pack_basis`: those chunks' basis columns, re and im of each
  frequency side by side, in ``wgmma``'s K-major core-matrix order, so
  that every ring stage (64 samples x 128 columns) is one contiguous block;
- :func:`pack_filterbank`: each chunk's band of mels (its nonzero columns,
  widened to a ``BAND_WIDTHS`` width), rows in the order in which the
  kernel's power registers hold the frequencies (:func:`band_row_freq`),
  with the table of band offsets, first mels and widths.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from conette_torch.kernels import _build
from conette_torch.ops.frontend import (
    DEFAULT_LOGMEL, LogMelConfig, _mel_matrix, mel_matrix_tensor,
)
from conette_torch.ops.stft import basis_tensor, dft_basis, frame_signal

N_FFT = 1024
N_MELS = 224
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
TILE_FRAMES = 64            # frames a CTA
CHUNK_FREQS = 64            # frequencies a chunk of the bf16 kernel
BAND_WIDTHS = (16, 32, 64, 128)  # the band products' wgmma widths
F32_CHUNK = 32              # frequencies per chunk of the f32 kernel's dense layout


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
    basis = basis_tensor(cfg.n_fft, x.device, compute_dtype)
    spec = torch.matmul(frames, basis)
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    power = (re * re + im * im).to(compute_dtype).float()
    fb = mel_matrix_tensor(cfg, x.device, compute_dtype)
    mel = torch.matmul(power, fb)
    log_mel = 10.0 * torch.log(torch.clamp_min(mel, cfg.amin)) / math.log(10.0) - log_ref(cfg)
    if bn_scale is not None:
        log_mel = log_mel * bn_scale.float() + bn_shift.float()
    return log_mel


def live_range(cfg: LogMelConfig) -> tuple[int, int]:
    """The first and last row (frequency) of the mel filterbank with a
    nonzero entry: the DFT of any other frequency is multiplied by zeros."""
    rows = np.flatnonzero(_mel_matrix(cfg).any(axis=1))
    if rows.size == 0:
        raise ValueError("the mel filterbank of this cfg is all zeros")
    return int(rows[0]), int(rows[-1])


def band_row_freq(k: np.ndarray | int) -> np.ndarray | int:
    """The frequency (within its chunk) of row ``k`` of a chunk's packed
    filterbank band. The kernel's power of frequency 4t + c sits in n8 tile
    t, lane quad c, and enters the mel product as k = 16s + 8h + 2c + e
    for t = 4s + 2h + e: within each 8 rows the two low bits of k and its
    third swap places."""
    return k // 8 * 8 + k % 2 * 4 + k % 8 // 2


class LogmelLayout(NamedTuple):
    """What the bf16 kernel needs to know of a ``cfg``: the live rows of its
    filterbank, the ``n_chunks`` chunks of ``CHUNK_FREQS`` frequencies from
    ``f0`` that cover them, and for each chunk its band of mels: the first
    column ``band_start``, the ``band_width`` columns of its product (one
    of ``BAND_WIDTHS``, holding every nonzero column of the chunk's rows,
    inside the n_mels columns) and the element offset of its packed band."""

    first: int
    last: int
    f0: int
    n_chunks: int
    band_start: tuple[int, ...]
    band_width: tuple[int, ...]
    band_offset: tuple[int, ...]

    @property
    def fb_elems(self) -> int:
        return sum(CHUNK_FREQS * w for w in self.band_width)


@functools.lru_cache(maxsize=8)
def logmel_layout(cfg: LogMelConfig) -> LogmelLayout:
    first, last = live_range(cfg)
    f0 = first // CHUNK_FREQS * CHUNK_FREQS
    n_chunks = last // CHUNK_FREQS - first // CHUNK_FREQS + 1
    fb = _mel_matrix(cfg)
    starts, widths, offsets, off = [], [], [], 0
    for j in range(n_chunks):
        cols = np.flatnonzero(fb[f0 + j * CHUNK_FREQS:f0 + (j + 1) * CHUNK_FREQS].any(axis=0))
        lo, span = (int(cols[0]), int(cols[-1] - cols[0] + 1)) if cols.size else (0, 1)
        width = next((w for w in BAND_WIDTHS if w >= span and w <= cfg.n_mels), None)
        if width is None:
            raise ValueError(
                f"chunk {j} of the filterbank meets {span} mels; the log-mel kernel's band "
                f"products take at most {BAND_WIDTHS[-1]}"
            )
        starts.append(min(lo, cfg.n_mels - width))
        widths.append(width)
        offsets.append(off)
        off += CHUNK_FREQS * width
    return LogmelLayout(first, last, f0, n_chunks, tuple(starts), tuple(widths), tuple(offsets))


def _chunk_freqs(cfg: LogMelConfig) -> np.ndarray:
    """The frequency of each chunk position, chunk-major (may pass 512)."""
    lay = logmel_layout(cfg)
    return lay.f0 + np.arange(lay.n_chunks * CHUNK_FREQS)


def pack_basis(cfg: LogMelConfig = DEFAULT_LOGMEL, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The live chunks' basis columns, flat in the kernel's ring order: chunk
    j's (n_fft, 128) block has re of its frequency f in column 2f and im in
    2f + 1 (zeros past frequency n_fft / 2), laid out as 8×8 core matrices
    [k/16][n/8][k/8 % 2][n % 8][k % 8]; chunk after chunk, so ring stage g
    is the 16 KB from 8192·g on. Cast to ``dtype`` in the same copy."""
    n_freqs = cfg.n_fft // 2 + 1
    basis = dft_basis(cfg.n_fft)
    freqs = _chunk_freqs(cfg)
    live = freqs < n_freqs
    cols = np.zeros((cfg.n_fft, freqs.size, 2), np.float32)
    cols[:, live, 0] = basis[:, freqs[live]]
    cols[:, live, 1] = basis[:, n_freqs + freqs[live]]
    n_chunks = freqs.size // CHUNK_FREQS
    packed = torch.empty((n_chunks, cfg.n_fft // 16, 2 * CHUNK_FREQS // 8, 2, 8, 8), dtype=dtype)
    # row k = 16·kb + 8·kh + kc, column 128·j + 8·ng + nr
    packed.copy_(torch.from_numpy(cols).reshape(cfg.n_fft // 16, 2, 8, n_chunks, 16, 8)
                 .permute(3, 0, 4, 1, 5, 2))
    return packed.reshape(-1)


def pack_filterbank(cfg: LogMelConfig = DEFAULT_LOGMEL,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Each chunk's band of the filterbank, flat and chunk after chunk (from
    ``band_offset``): the (64, band_width) block of rows f0 + 64j +
    band_row_freq(k) and columns band_start .., as 8×8 core matrices
    [k/16][n/8][k/8 % 2][n % 8][k % 8]. Cast to ``dtype`` in the same copy."""
    lay = logmel_layout(cfg)
    fb = _mel_matrix(cfg)
    n_freqs = fb.shape[0]
    k = np.arange(CHUNK_FREQS)
    parts = []
    for j, (m0, w) in enumerate(zip(lay.band_start, lay.band_width)):
        rows = lay.f0 + j * CHUNK_FREQS + band_row_freq(k)
        block = np.zeros((CHUNK_FREQS, w), np.float32)
        ok = rows < n_freqs
        block[ok] = fb[rows[ok], m0:m0 + w]
        part = torch.empty((CHUNK_FREQS // 16, w // 8, 2, 8, 8), dtype=dtype)
        part.copy_(torch.from_numpy(block).reshape(CHUNK_FREQS // 16, 2, 8, w // 8, 8)
                   .permute(0, 3, 1, 4, 2))
        parts.append(part.reshape(-1))
    return torch.cat(parts)


def band_table(cfg: LogMelConfig = DEFAULT_LOGMEL) -> torch.Tensor:
    """(n_chunks, 3) int32: each chunk's packed band offset, first mel and
    width, as the kernel reads them."""
    lay = logmel_layout(cfg)
    return torch.tensor(list(zip(lay.band_offset, lay.band_start, lay.band_width)),
                        dtype=torch.int32)


def _dense_operands(cfg: LogMelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernel's layout: the basis (1024, 2·F32_CHUNK·n_chunks) —
    chunk j holds the real columns of frequencies j·F32_CHUNK .. +31, then
    their imaginary columns, zero past frequency 512 — and the filterbank
    (F32_CHUNK·n_chunks, n_mels) with zero rows past 512."""
    n_freqs = cfg.n_fft // 2 + 1
    n_chunks = -(-n_freqs // F32_CHUNK)
    f_pad = n_chunks * F32_CHUNK
    basis = dft_basis(cfg.n_fft)
    re = np.zeros((cfg.n_fft, f_pad), np.float32)
    im = np.zeros((cfg.n_fft, f_pad), np.float32)
    re[:, :n_freqs] = basis[:, :n_freqs]
    im[:, :n_freqs] = basis[:, n_freqs:]
    chunked = np.concatenate(
        [re.reshape(cfg.n_fft, n_chunks, 1, F32_CHUNK), im.reshape(cfg.n_fft, n_chunks, 1, F32_CHUNK)],
        axis=2,
    ).reshape(cfg.n_fft, 2 * f_pad)
    fb = np.zeros((f_pad, cfg.n_mels), np.float32)
    fb[:n_freqs] = _mel_matrix(cfg)
    return torch.from_numpy(chunked), torch.from_numpy(fb)


class LogmelOperands(NamedTuple):
    """A cfg's constants as a kernel takes them, on one device: at bf16 the
    live range, the packed basis, the banded filterbank and the band table;
    at f32 the dense basis and filterbank (``bands`` None)."""

    live: tuple[int, int]
    basis: torch.Tensor
    fb: torch.Tensor
    bands: torch.Tensor | None
    n_chunks: int
    fb_elems: int


@functools.lru_cache(maxsize=8)
def _operands(cfg: LogMelConfig, device: torch.device, dtype: torch.dtype) -> LogmelOperands:
    """Packed once per (cfg, device, dtype) by numpy and uploaded once: no
    launch of a request packs anything."""
    live = live_range(cfg)
    if dtype == torch.bfloat16:
        lay = logmel_layout(cfg)
        return LogmelOperands(
            live, pack_basis(cfg, dtype).to(device), pack_filterbank(cfg, dtype).to(device),
            band_table(cfg).to(device), lay.n_chunks, lay.fb_elems,
        )
    basis, fb = _dense_operands(cfg)
    return LogmelOperands(live, basis.to(device, dtype).contiguous(),
                          fb.to(device, dtype).contiguous(), None, 0, 0)


@functools.lru_cache(maxsize=8)
def _identity_affine(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.ones(N_MELS, dtype=torch.float32, device=device),
            torch.zeros(N_MELS, dtype=torch.float32, device=device))


def launch_logmel(
    x: torch.Tensor,
    ops: LogmelOperands,
    scale: torch.Tensor,
    shift: torch.Tensor,
    cfg: LogMelConfig = DEFAULT_LOGMEL,
) -> torch.Tensor:
    """Launch the kernel of ``ops``' type on a contiguous (B, S) f32 CUDA
    waveform and contiguous f32 (n_mels,) ``scale`` and ``shift`` (16-byte
    aligned). Returns (B, 1 + S // hop, n_mels) f32 and adds one to
    ``fused_logmel.launches``."""
    b, s = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the log-mel kernel takes a contiguous f32 waveform")
    dev = x.device
    _build.require(scale, "bn_scale", torch.float32, (N_MELS,), dev)
    _build.require(shift, "bn_shift", torch.float32, (N_MELS,), dev)
    use_bf16 = ops.bands is not None
    t = 1 + s // cfg.hop_length
    out = torch.empty((b, t, N_MELS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = _build.entry("conette_logmel", 7, 7, 2)
        code = fn(
            x.data_ptr(), ops.basis.data_ptr(), ops.fb.data_ptr(),
            ops.bands.data_ptr() if use_bf16 else None, scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, s, t, cfg.hop_length, ops.n_chunks, ops.fb_elems, int(use_bf16),
            cfg.amin, log_ref(cfg), _build.stream_of(x),
        )
    _build.check(code, "conette_logmel")
    fused_logmel.launches += 1
    return out


@torch.library.custom_op("conette_torch::logmel", mutates_args=(), device_types="cuda")
def logmel_op(
    x: torch.Tensor,
    bn_scale: torch.Tensor | None,
    bn_shift: torch.Tensor | None,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    ref: float,
    amin: float,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The log-mel kernel as a custom op on a CUDA waveform (no other
    device), the cfg given field by field (``top_db`` is None)."""
    cfg = LogMelConfig(sample_rate, n_fft, hop_length, n_mels, fmin, fmax, ref, amin)
    dev = x.device
    if bn_scale is None:
        scale, shift = _identity_affine(dev)
    else:
        scale = bn_scale.to(dev, torch.float32).contiguous()
        shift = bn_shift.to(dev, torch.float32).contiguous()
    return launch_logmel(x.float().contiguous(), _operands(cfg, dev, compute_dtype), scale, shift,
                         cfg)


@logmel_op.register_fake
def _logmel_fake(x, bn_scale, bn_shift, sample_rate, n_fft, hop_length, n_mels, fmin, fmax, ref,
                 amin, compute_dtype):
    return x.new_empty((x.shape[0], 1 + x.shape[1] // hop_length, n_mels), dtype=torch.float32)


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
    1024, 224 mels and a hop that is a multiple of 16, and the wrapper
    calls ``conette_torch::logmel``. Each launch adds one to
    ``fused_logmel.launches``."""
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
    if x.shape[1] <= cfg.n_fft // 2:
        raise ValueError(f"reflect padding needs more than {cfg.n_fft // 2} samples, "
                         f"got {x.shape[1]}")
    return torch.ops.conette_torch.logmel(
        x, bn_scale, bn_shift, cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.n_mels, cfg.fmin,
        cfg.fmax, cfg.ref, cfg.amin, compute_dtype,
    )


fused_logmel.launches = 0
