"""Process queries of the training path, for one process.

Counterpart of the part of ``conette_tpu/parallel/distributed.py`` that
``conette-train`` calls on one card: ``is_main_process``, ``rank_tag`` and
``gather_to_host0``. They read ``torch.distributed`` where a process group
has been initialised. Initialising one (``initialize``) and training over
several processes wait for the port's multi-GPU work (ROADMAP Queue 1
item 9); ``train/main.py`` raises before it gets there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return _rank() == 0


def rank_tag() -> str:
    """Log-prefix rank tag (``RANK0``)."""
    return f"RANK{_rank()}"


def gather_to_host0(x: Any) -> np.ndarray | None:
    """The full value of ``x`` as a numpy array on the main process, None on
    the others. One process holds all of it."""
    if world_size() > 1:
        raise NotImplementedError(
            "gathering over several processes comes with multi-GPU training "
            "(ROADMAP Queue 1 item 9)")
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
