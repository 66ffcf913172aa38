"""Host-side audio I/O without required external dependencies.

The reference loads audio through torchaudio's native sox bindings
(``huggingface/preprocessor.py:79-80``). This module decodes RIFF/WAVE PCM
(8/16/24/32-bit int and 32/64-bit float) into float32 numpy arrays with the
same (channels, time) layout and [-1, 1] scaling torchaudio uses, and
dispatches FLAC, mp3 and Ogg Vorbis to ``utils/flac.py`` and
``utils/lossy.py``.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np

__all__ = ["load_audio", "load_wav", "wav_info", "save_wav", "generate_sample_wav"]


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Load an audio file → (waveform (channels, time) float32 in [-1, 1], sr).

    Dispatches on the container magic bytes, not the file extension, like
    sox/torchaudio do (the reference's ``huggingface/preprocessor.py:79-80``
    loads anything torchaudio reads; WavCaps ships FLAC): RIFF/WAVE → PCM
    WAV decoder, fLaC → pure-Python FLAC decoder (``utils/flac.py``), mp3
    (ID3 tag or MPEG frame sync) and Ogg Vorbis → optional SDL_mixer host
    backend (``utils/lossy.py``; actionable ImportError when pygame is
    absent).
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return load_wav(path)
    if magic == b"fLaC":
        from conette_torch.utils.flac import load_flac

        return load_flac(path)
    if magic[:3] == b"ID3" or (
        len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0
    ):
        from conette_torch.utils.lossy import load_mp3

        return load_mp3(path)
    if magic == b"OggS":
        from conette_torch.utils.lossy import load_ogg

        return load_ogg(path)
    raise ValueError(
        f"Unsupported audio container in {path!r} (magic {magic!r}); "
        "supported: RIFF/WAVE PCM, FLAC, mp3 and Ogg Vorbis (the latter "
        "two via the optional pygame/SDL_mixer backend)"
    )


def _wav_chunks(f, path: str, read_data: bool) -> tuple[bytes, int, bytes | None]:
    """Walk the RIFF chunks of an open WAV file → (fmt chunk, data chunk
    size, data bytes or None when ``read_data`` is False)."""
    header = f.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")
    fmt = None
    data_size = None
    data = None
    while True:
        chunk_header = f.read(8)
        if len(chunk_header) < 8:
            break
        chunk_id, size = struct.unpack("<4sI", chunk_header)
        if chunk_id == b"fmt ":
            fmt = f.read(size)
        elif chunk_id == b"data":
            data_size = size
            if read_data:
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
        if fmt is not None and data_size is not None:
            break
    if fmt is None or data_size is None:
        raise ValueError(f"Missing fmt/data chunk in {path}")
    return fmt, data_size, data


def wav_info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, channels, frames) from a WAV file's header alone; the
    data chunk is not read. Raises ``ValueError`` for other containers."""
    with open(path, "rb") as f:
        fmt, data_size, _ = _wav_chunks(f, path, read_data=False)
    _, n_channels, sample_rate, _, block_align, _ = struct.unpack("<HHIIHH", fmt[:16])
    return int(sample_rate), int(n_channels), data_size // max(block_align, 1)


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a WAV file → (waveform (channels, time) float32 in [-1, 1], sr).

    Matches ``torchaudio.load`` normalization: ints are scaled by
    1 / 2**(bits-1); floats pass through.
    """
    with open(path, "rb") as f:
        fmt, _, data = _wav_chunks(f, path, read_data=True)

    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM int
        if bits == 8:
            x = np.frombuffer(data, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits} in {path}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format code {audio_format} in {path}")

    n = (len(x) // n_channels) * n_channels
    x = x[:n].reshape(-1, n_channels).T  # (channels, time)
    return np.ascontiguousarray(x), int(sample_rate)


def save_wav(path: str, waveform: np.ndarray, sr: int) -> None:
    """Save float32 (channels, time) or (time,) waveform as 16-bit PCM WAV.

    Quantizes round-to-nearest with the same 1/32768 LSB that ``load_wav``
    divides by, so save→load round-trips exactly for representable values.
    """
    waveform = np.asarray(waveform, dtype=np.float32)
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    pcm = np.clip(np.rint(waveform.T * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(waveform.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def generate_sample_wav(
    path: str, sr: int = 44_100, duration_s: float = 10.0, seed: int = 1234
) -> str:
    """Create a deterministic synthetic sample clip (birdsong-like chirps over
    pink-ish noise) used by ``get_sample_path`` when no asset is bundled."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * duration_s)) / sr
    # pinkish noise via cumulative-filtered white noise
    white = rng.standard_normal(t.shape[0]).astype(np.float32)
    pink = np.convolve(white, np.ones(32, dtype=np.float32) / 32.0, mode="same")
    sig = 0.05 * pink
    for f0, t0 in [(2000.0, 1.0), (3200.0, 3.5), (2600.0, 6.0), (4100.0, 8.0)]:
        env = np.exp(-((t - t0) ** 2) / (2 * 0.15**2))
        sig = sig + 0.3 * env * np.sin(2 * np.pi * (f0 + 400 * np.sin(8 * t)) * t)
    save_wav(path, sig.astype(np.float32), sr)
    return path
