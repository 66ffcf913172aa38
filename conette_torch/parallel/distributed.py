"""Process groups of the training and serving paths.

Counterpart of ``conette_tpu/parallel/distributed.py``: ``initialize``
wires ``torch.distributed`` from the launcher's variables (SLURM's when
present, else torchrun's), one process per card; ``is_main_process`` and
``rank_tag`` stand in for the reference's rank-0 checks; ``gather_to_host0``
brings a value whose rows are split over the processes to rank 0, where
scoring runs.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for the
CPU, unless ``backend=`` names one. A failing ``nccl`` raises: nothing
switches to ``gloo`` on its own.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

pylog = logging.getLogger(__name__)

DEFAULT_PORT = 29500  # torchrun's default MASTER_PORT


def _first_host(nodelist: str) -> str:
    """The first host of a SLURM node list: ``gpu[03-05,07],cpu1`` → ``gpu03``."""
    head = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist)
    if head is None:
        raise ValueError(f"cannot read SLURM_JOB_NODELIST={nodelist!r}")
    prefix, ranges = head.groups()
    return prefix + (re.split(r"[-,]", ranges)[0] if ranges else "")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    use_scheduler_env: bool = True,
    *,
    local_rank: int | None = None,
    device: torch.device | str | None = None,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> None:
    """Join the process group of a launch of several processes.

    The coordinates that are not passed come from SLURM (``SLURM_NTASKS``,
    ``SLURM_PROCID``, ``SLURM_LOCALID``, the first host of
    ``SLURM_JOB_NODELIST``) unless ``use_scheduler_env`` is False (the
    ``trainer/plugins: lightning`` local environment), else from torchrun
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). A world of one process is a no-op unless ``backend``
    asks for a group. On ``cuda`` the process's card is set from its local
    rank first.

    :param coordinator_address: ``host:port`` of rank 0's store.
    :param device: the device the group's tensors live on (default
        ``cuda``); it picks the backend.
    :param timeout_s: the group's collective timeout (torch's default when
        None).
    """

    def sched(key: str, fallback_key: str, default: str) -> str:
        if use_scheduler_env and key in os.environ:
            return os.environ[key]
        return os.environ.get(fallback_key, default)

    if num_processes is None:
        num_processes = int(sched("SLURM_NTASKS", "WORLD_SIZE", "1"))
    if num_processes <= 1 and backend is None:
        return
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} processes is already "
                f"initialised; asked for {num_processes}")
        return
    if process_id is None:
        process_id = int(sched("SLURM_PROCID", "RANK", "0"))
    if local_rank is None:
        local_rank = int(sched("SLURM_LOCALID", "LOCAL_RANK", "0"))
    if coordinator_address is None:
        host = os.environ.get("MASTER_ADDR")
        if host is None and use_scheduler_env and "SLURM_JOB_NODELIST" in os.environ:
            host = _first_host(os.environ["SLURM_JOB_NODELIST"])
        if host is None:
            if num_processes > 1:
                raise ValueError(
                    f"a launch of {num_processes} processes needs rank 0's address: set "
                    "MASTER_ADDR and MASTER_PORT (torchrun does), SLURM_JOB_NODELIST, or "
                    "pass coordinator_address")
            host = "localhost"
        coordinator_address = f"{host}:{os.environ.get('MASTER_PORT', DEFAULT_PORT)}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs: dict[str, Any] = {}
    if timeout_s is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kwargs,
    )
    pylog.info(f"torch.distributed initialised: rank {process_id}/{num_processes}, "
               f"local rank {local_rank}, backend {backend}")


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return _rank() == 0


def rank_tag() -> str:
    """Log-prefix rank tag (``RANK0``)."""
    return f"RANK{_rank()}"


def collective_device(group: Any = None) -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under ``nccl``, the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The rows of every process of ``group``, concatenated along axis 0 in
    rank order; every process passes a tensor of the same shape. The result
    lies where ``x`` lies."""
    if dist.get_world_size(group) == 1:
        return x
    src = x.detach().to(collective_device(group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor where ``x`` lies; ``x``
    is left as it is)."""
    dev = collective_device(group)
    out = x.detach().to(dev, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(x.device)


def broadcast_from_main(obj: Any) -> Any:
    """Rank 0's ``obj`` on every process (any picklable value)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_to_host0(x: Any, replicated: bool = False) -> np.ndarray | None:
    """The full value of ``x`` as a numpy array on rank 0, None on the
    others.

    :param x: this process's rows of a value split over the processes
        (axis 0), gathered in rank order; or, with ``replicated``, a value
        every process holds whole, which rank 0 reads as it is."""
    if world_size() == 1:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if replicated:
        if not is_main_process():
            return None
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    full = all_gather_rows(t)
    return full.cpu().numpy() if is_main_process() else None
