"""ctypes bindings for the native audio loader.

Counterpart of ``conette_tpu/native/loader.py``: RIFF/WAVE PCM decode,
channel mean and the polyphase sinc resample of ``ops/resample.py`` in C++
(``audio_loader.cpp`` beside this file). The source keeps the C ABI, the
compiler flags and the filter bank's math of the JAX package's
``native/audio_loader.cpp``, and runs only each phase's band of non-zero
taps, from a bank built once for each pair of rates and shared by the
threads (:func:`resample_taps` counts them). The ctypes calls release the
GIL, so :func:`load_batch` decodes a corpus, and :func:`resample_batch`
resamples arrays, on a pool of ``WORKERS`` threads.

On first use the source is compiled with the host's ``g++`` and the flags of
``native/Makefile`` into ``build/conette_torch/`` at the repository root.
The library's file name carries a hash of the source, the flags and the
target that ``-march=native`` resolves to on this host (as ``g++ -Q
--help=target`` reports it), so an edited source, or a build directory
carried to another machine, builds anew. The compiler writes to a temporary
file that is then renamed into place, so processes that build at once never
load a half-written library. A build that fails raises with the compiler's
output: nothing falls back to numpy.

The library is built with ``-ffast-math``, whose start-up code sets
flush-to-zero on the thread that loads it (threads started later inherit
it); :func:`library` loads it on a thread of its own, so that no caller's
floats change.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import math
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np

from conette_torch.kernels._build import BUILD_DIR
from conette_torch.utils.profiling import current, span

SOURCE = Path(__file__).resolve().with_name("audio_loader.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17")
WORKERS = 8  # threads of a batch's pool

pylog = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class CompilerNotFound(RuntimeError):
    """``g++`` is not on PATH, so the library cannot be built here."""


def _run_cxx(args: list[str], what: str) -> subprocess.CompletedProcess:
    try:
        proc = subprocess.run([CXX, *args], capture_output=True, text=True)
    except FileNotFoundError as err:
        raise CompilerNotFound(f"the native audio loader needs {CXX} on PATH to {what}") from err
    if proc.returncode:
        raise RuntimeError(f"{CXX} failed to {what}:\n{proc.stderr}")
    return proc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_run_cxx(["-march=native", "-Q", "--help=target"], "report its target").stdout.encode())
    return BUILD_DIR / f"libconette_audio-{h.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        _run_cxx([*CXX_FLAGS, "-o", str(tmp_out), str(SOURCE)], f"build {SOURCE.name}")
        os.replace(tmp_out, out)


def library() -> ctypes.CDLL:
    """The loaded library, built first if its source, flags or target changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                build(path)
            # on a thread of its own: loading sets flush-to-zero on the loader
            with ThreadPoolExecutor(max_workers=1) as one:
                lib = one.submit(ctypes.CDLL, str(path)).result()
            i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.conette_wav_info.argtypes = [ctypes.c_char_p, i32p, i32p, i64p]
            lib.conette_wav_info.restype = ctypes.c_int
            lib.conette_load_resample_mono.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, f32p, ctypes.c_int64, i64p]
            lib.conette_load_resample_mono.restype = ctypes.c_int
            lib.conette_resample.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f32p, ctypes.c_int64, i64p]
            lib.conette_resample.restype = ctypes.c_int
            lib.conette_resample_taps.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p]
            lib.conette_resample_taps.restype = ctypes.c_int
            _lib = lib
        return _lib


def is_available() -> bool:
    """True once the library is loaded (built first where needed); False,
    with the reason logged, where ``g++`` is missing. A build that fails
    raises, as :func:`library` does: a broken source is never reported as
    an absent compiler."""
    try:
        library()
    except CompilerNotFound as err:
        pylog.warning(f"native audio loader unavailable: {err}")
        return False
    return True


_ERROR_MESSAGES = {
    -1: "cannot open file",
    -2: "not a RIFF/WAVE file",
    -3: "unsupported WAV encoding",
    -4: "invalid argument/buffer",
    -5: "internal decoder error",
}


def _raise(fn: str, path: str, rc: int) -> None:
    reason = _ERROR_MESSAGES.get(rc, f"error code {rc}")
    raise OSError(f"{fn}({path!r}): {reason}")


def is_riff(path: str) -> bool:
    """Whether the file starts as a RIFF container (the native decoder's)."""
    with open(path, "rb") as f:
        return f.read(4) == b"RIFF"


def wav_info(path: str) -> tuple[int, int, int]:
    """(sample_rate, channels, num_frames) from a WAV header."""
    sr, ch, n = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = library().conette_wav_info(path.encode(), sr, ch, n)
    if rc != 0:
        _raise("conette_wav_info", path, rc)
    return sr.value, ch.value, n.value


def load_resample_mono(path: str, target_sr: int = 0) -> np.ndarray:
    """Decode → channel mean → resample to ``target_sr`` (0: keep the file's
    rate); (time,) float32. Containers other than RIFF (FLAC, mp3, Ogg)
    decode through ``utils/audio_io.py`` and resample natively, so every
    file takes the mean before the resample, as the WAV route does."""
    return _load_resample_mono(path, target_sr)[0]


def _load_resample_mono(path: str, target_sr: int) -> tuple[np.ndarray, int]:
    """:func:`load_resample_mono` and the file's sample rate."""
    if not is_riff(path):
        from conette_torch.utils.audio_io import load_audio

        try:
            wav, sr = load_audio(path)
        except ValueError as err:  # the native route's OSError for unreadable audio
            raise OSError(str(err)) from err
        mono = wav.mean(axis=0).astype(np.float32)
        if target_sr <= 0 or sr == target_sr:
            return mono, sr
        return resample(mono, sr, target_sr), sr
    sr, _, frames = wav_info(path)
    tsr = target_sr if target_sr > 0 else sr
    capacity = int(math.ceil(frames * tsr / sr)) + 16
    out = np.empty((capacity,), np.float32)
    out_len = ctypes.c_int64()
    rc = library().conette_load_resample_mono(
        path.encode(), ctypes.c_int32(target_sr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(capacity), out_len,
    )
    if rc != 0:
        _raise("conette_load_resample_mono", path, rc)
    return out[: out_len.value], sr


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample a mono (time,) signal in native code; (time',) float32."""
    x = np.ascontiguousarray(x, np.float32)
    capacity = int(math.ceil(len(x) * target_sr / orig_sr)) + 16
    out = np.empty((capacity,), np.float32)
    out_len = ctypes.c_int64()
    rc = library().conette_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(x)),
        ctypes.c_int32(orig_sr), ctypes.c_int32(target_sr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(capacity), out_len,
    )
    if rc != 0:
        raise OSError(f"conette_resample failed ({rc})")
    return out[: out_len.value]


@functools.cache
def resample_taps(orig_sr: int, target_sr: int) -> tuple[int, int]:
    """(band taps, bank taps): the taps that each output sample of a resample
    from ``orig_sr`` to ``target_sr`` runs, and those of each phase of the
    dense bank; (0, 0) where the rates are equal (no resample). A constant
    of the pair, kept after its first query."""
    band, bank = ctypes.c_int32(), ctypes.c_int32()
    rc = library().conette_resample_taps(orig_sr, target_sr, band, bank)
    if rc != 0:
        raise OSError(f"conette_resample_taps failed ({rc})")
    return band.value, bank.value


def taps_attrs(orig_sr: int, target_sr: int) -> dict[str, int]:
    """:func:`resample_taps` as span attributes ``band_taps`` and
    ``bank_taps``, both 0 where no resample runs (``target_sr`` 0 or
    ``orig_sr``)."""
    band, bank = resample_taps(orig_sr, target_sr) if 0 < target_sr != orig_sr else (0, 0)
    return {"band_taps": band, "bank_taps": bank}


def load_batch(paths: Sequence[str], target_sr: int, workers: int = WORKERS) -> list[np.ndarray]:
    """:func:`load_resample_mono` of every path on a pool of threads, in order.
    A span ``native_load`` on the calling thread holds a span ``load_file``
    for each file, on the thread that loads it, with the ``band_taps`` and
    ``bank_taps`` of its resample (:func:`resample_taps`)."""
    with span("native_load", files=len(paths), workers=workers):
        library()  # build once, before the threads need it
        parent = current()

        def load(path: str) -> np.ndarray:
            with span("load_file", parent=parent) as s:
                mono, sr = _load_resample_mono(path, target_sr)
                s.set(**taps_attrs(sr, target_sr))
                return mono

        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(load, paths))


def resample_batch(clips: Sequence[np.ndarray], rates: Sequence[int], target_sr: int) -> list[np.ndarray]:
    """Each (channels, time) float32 clip's channel mean, resampled from its
    rate to ``target_sr`` (:func:`resample`), on a pool of threads, in
    order; (time',) float32 each."""
    if any(sr != target_sr for sr in rates):
        library()  # build once, before the threads need it

    def one(clip: np.ndarray, sr: int) -> np.ndarray:
        mono = clip[0] if len(clip) == 1 else clip.mean(axis=0, dtype=np.float32)
        return mono if sr == target_sr else resample(mono, sr, target_sr)

    with ThreadPoolExecutor(max_workers=max(1, min(WORKERS, len(clips)))) as pool:
        return list(pool.map(one, clips, rates))
