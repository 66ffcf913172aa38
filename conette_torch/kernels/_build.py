"""Build the port's CUDA kernels once and bind them with ctypes.

On first use, ``conette_torch/csrc/*.cu`` are compiled for Hopper
(``sm_90a``) by ``nvcc``, one process per source, all started together,
and linked into one shared library under ``build/conette_torch/`` at the
repository root. Its file name carries a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so an edited source or header
triggers a rebuild. Each C entry point returns the
``cudaError_t`` of its launch; :func:`check` raises on a non-zero code.

Nothing here touches CUDA when the module is imported: the library is
built and loaded by the first kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "conette_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libconette_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel, link, and return the library path.
    ``ptxas -v`` (registers, shared memory, spills) goes to ``<lib>.log``."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, log) for s, p, log in zip(sources(), procs, logs) if p.returncode]
        if failed:
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(f"--- {s.name}\n{log}" for s, log in failed)
            )
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc(), "-shared", *map(str, objs), "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                build()
            lib = ctypes.CDLL(str(path))
            lib.conette_cuda_error_string.argtypes = [ctypes.c_int]
            lib.conette_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


@functools.cache
def entry(name: str, n_ptrs: int, n_ints: int, n_floats: int = 1) -> ctypes._CFuncPtr:
    """A C entry point ``(ptr × n_ptrs, int × n_ints, float × n_floats,
    stream)`` returning an ``int`` error code, with its ``argtypes`` set:
    every pointer and the stream as ``c_void_p``, so no 64-bit address is
    cut to 32 bits."""
    fn = getattr(library(), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs
        + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().conette_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` with a 32-byte aligned start (the WMMA loads need it)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 32:
        raise ValueError(f"{name} must start on a 32-byte boundary")
