"""Optional host-side decode of lossy containers (mp3 / Ogg Vorbis).

Copy of ``conette_tpu/utils/lossy.py`` (the port imports nothing of the JAX
package). The reference never decodes lossy audio itself —
``torchaudio.load`` delegates to the native sox/ffmpeg libraries linked into
torchaudio (its ``huggingface/preprocessor.py:79-80``). This module makes
the equivalent choice without torchaudio: the
container *headers* are parsed here in pure Python (so we know the native
sample rate and channel count), and the actual bitstream decode is
delegated to SDL_mixer through the optional ``pygame`` package when it is
importable. WAV and FLAC — the formats of all four training corpora —
remain fully native (``utils/audio_io.py``, ``utils/flac.py``); without
pygame, lossy files raise an actionable error naming the dependency.

SDL_mixer converts decoded audio to the opened mixer spec, so the mixer
is (re)initialized at the file's OWN rate/channels before decoding —
the returned samples are the decoder's native-rate output, not an
SDL-resampled stream. Note the decode claims the process-global pygame
mixer; this only matters to applications that also use pygame for
playback.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

__all__ = ["parse_mp3_info", "parse_ogg_info", "load_mp3", "load_ogg"]

# MPEG audio sample-rate table: _MPEG_SR[version_key][sr_index]
# version_key: 1 = MPEG-1, 2 = MPEG-2, 25 = MPEG-2.5 (header version bits
# 3 / 2 / 0 respectively; bits value 1 is reserved).
_MPEG_SR = {
    1: (44_100, 48_000, 32_000),
    2: (22_050, 24_000, 16_000),
    25: (11_025, 12_000, 8_000),
}
_VERSION_BITS = {3: 1, 2: 2, 0: 25}


def parse_mp3_info(data: bytes) -> Tuple[int, int]:
    """(sample_rate, channels) from the first valid MPEG audio frame header.

    Skips a leading ID3v2 tag (syncsafe size), then scans for the 11-bit
    frame sync and validates the version / layer / bitrate / sample-rate
    index fields so random 0xFF bytes in tag padding are not mistaken for
    a header. Raises ``ValueError`` if no valid frame is found.
    """
    i = 0
    if data[:3] == b"ID3" and len(data) >= 10:
        size = (
            ((data[6] & 0x7F) << 21)
            | ((data[7] & 0x7F) << 14)
            | ((data[8] & 0x7F) << 7)
            | (data[9] & 0x7F)
        )
        i = 10 + size
    end = len(data) - 4
    while i <= end:
        if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0:
            version = (data[i + 1] >> 3) & 3
            layer = (data[i + 1] >> 1) & 3
            bitrate_idx = (data[i + 2] >> 4) & 15
            sr_idx = (data[i + 2] >> 2) & 3
            mode = (data[i + 3] >> 6) & 3
            if (
                version != 1  # reserved
                and layer != 0  # reserved
                and bitrate_idx not in (0, 15)  # free-form / invalid
                and sr_idx != 3  # reserved
            ):
                sr = _MPEG_SR[_VERSION_BITS[version]][sr_idx]
                channels = 1 if mode == 3 else 2
                return sr, channels
        i += 1
    raise ValueError("no valid MPEG audio frame header found")


def parse_ogg_info(data: bytes) -> Tuple[int, int]:
    """(sample_rate, channels) from an Ogg Vorbis identification header.

    Reads the first Ogg page ("OggS", RFC 3533) and parses the Vorbis
    identification packet (packet type 0x01 + "vorbis"): channels is the
    byte at packet offset 11, sample rate the LE uint32 at offset 12.
    Raises ``ValueError`` for non-Vorbis Ogg streams (e.g. Opus) — only
    Vorbis is wired through the SDL backend here.
    """
    if data[:4] != b"OggS" or len(data) < 28:
        raise ValueError("not an Ogg stream")
    n_segs = data[26]
    payload = 27 + n_segs
    pkt = data[payload : payload + 16]
    if pkt[:7] == b"\x01vorbis" and len(pkt) >= 16:
        channels = pkt[11]
        sr = struct.unpack("<I", pkt[12:16])[0]
        if channels == 0 or sr == 0:
            raise ValueError("corrupt Vorbis identification header")
        return sr, channels
    codec = pkt[:8].rstrip(b"\x00")
    raise ValueError(
        f"Ogg stream is not Vorbis (first packet {codec!r}); only Ogg "
        "Vorbis is supported through the SDL_mixer backend"
    )


def _load_via_sdl(path: str, sr: int, channels: int) -> Tuple[np.ndarray, int]:
    """Decode ``path`` with SDL_mixer at its native (sr, channels) spec.

    Returns (waveform (channels, time) float32 in [-1, 1], sr) with the
    same int16 → 1/32768 scaling convention as ``load_wav``.
    """
    try:
        os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
        import pygame  # noqa: F811
        import pygame.sndarray
    except ImportError as exc:
        raise ImportError(
            f"decoding {path!r} needs the optional SDL_mixer backend "
            "(python package 'pygame'); WAV and FLAC decode natively "
            "without it. Install pygame or convert the file to WAV/FLAC."
        ) from exc

    if pygame.mixer.get_init() != (sr, -16, channels):
        pygame.mixer.quit()
        pygame.mixer.init(frequency=sr, size=-16, channels=channels)
    sound = pygame.mixer.Sound(path)
    arr = pygame.sndarray.array(sound)  # (T,) mono or (T, C) int16
    if arr.ndim == 1:
        arr = arr[:, None]
    x = np.ascontiguousarray(arr.T.astype(np.float32) / 32768.0)
    return x, sr


def load_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Load an mp3 → (waveform (channels, time) float32 in [-1, 1], sr)."""
    with open(path, "rb") as f:
        head = f.read(65536)
    sr, channels = parse_mp3_info(head)
    return _load_via_sdl(path, sr, channels)


def load_ogg(path: str) -> Tuple[np.ndarray, int]:
    """Load an Ogg Vorbis file → ((channels, time) float32 in [-1, 1], sr)."""
    with open(path, "rb") as f:
        head = f.read(4096)
    sr, channels = parse_ogg_info(head)
    return _load_via_sdl(path, sr, channels)
