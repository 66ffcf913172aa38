"""Misc run utilities (counterpart of ``conette_tpu/utils/misc.py``, the
reference's ``src/conette/utils/misc.py:25-240``)."""

from __future__ import annotations

import logging
import os
import random
import subprocess
import zipfile
from typing import Iterable

import numpy as np

pylog = logging.getLogger(__name__)


def reset_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (twin of
    ``reset_seed``). The training draws take explicit generators; this
    covers whatever does not."""
    import torch

    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def get_current_git_hash(cwd: str | None = None, default: str = "unknown") -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, cwd=cwd, timeout=10,
        )
        return out.stdout.strip() if out.returncode == 0 else default
    except Exception:
        return default


def save_code_to_zip(
    out_fpath: str,
    root: str | None = None,
    extensions: Iterable[str] = (".py", ".yaml", ".cpp", ".toml"),
) -> str:
    """Snapshot the package source into a zip next to the run artifacts
    (twin of ``save_code_to_zip``)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extensions = tuple(extensions)
    with zipfile.ZipFile(out_fpath, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fname in filenames:
                if fname.endswith(extensions):
                    fpath = os.path.join(dirpath, fname)
                    zf.write(fpath, os.path.relpath(fpath, root))
    return out_fpath


# ``enable_compilation_cache`` (a persistent cache of JAX's compiled
# programs) has no counterpart here: PyTorch compiles nothing ahead of a
# call, and the CUDA kernels are built once into ``build/conette_torch/``
# by ``conette_torch.kernels._build``. Nor has ``hard_exit``: its CLIs end
# as any Python program does.
