"""Device mesh and placements.

Counterpart of ``conette_tpu/parallel/mesh.py``. One process drives one
card, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the world's ranks with two dims: ``data`` splits the batch rows (the
gradients are reduced over it) and ``model`` splits the decoder's widest
matrices (the Megatron column → row pair on ``linear1``/``linear2``).

A :class:`Sharding` holds ``torch.distributed.tensor`` placements, one a
mesh dim (``Shard(d)`` or ``Replicate()``), as a ``DTensor`` carries them.
The train step and the serving function hold plain tensors, this process's
part, and slice and gather by these placements themselves
(:func:`local_part`, :func:`full_value`), so the model's functional code
stays as it is on one card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from conette_torch.models.decoder import FeedForwardSplit
from conette_torch.parallel.distributed import all_gather_rows, all_reduce
from conette_torch.weights import map_tree, map_tree_with_path

Params = Any

# the leaves the ``model`` dim splits: linear1/pwconv1 by their output
# columns, linear2/pwconv2 by their input rows (weights are (in, out))
MODEL_SPLIT = (("linear1/weight", 1), ("linear2/weight", 0), ("pwconv1/weight", 1),
               ("pwconv2/weight", 0))


@dataclass(frozen=True)
class Sharding:
    """Where a value's blocks lie: one placement a mesh dim, in the mesh's
    dim order (``data``, ``model``)."""

    placements: tuple


class Axis(NamedTuple):
    """One mesh dim as this process sees it."""

    group: Any  # its process group
    rank: int  # this process's coordinate along it
    size: int


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> DeviceMesh:
    """A ``(n_devices // model_parallel, model_parallel)`` mesh over ranks
    ``0 .. n_devices - 1``, dims ``("data", "model")``; rank ``r`` sits at
    ``(r // model_parallel, r % model_parallel)``. The process group must be
    initialised (``distributed.initialize``) and hold ``n_devices``
    processes; its backend picks the device type (``nccl`` → ``cuda``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "conette_torch.parallel.distributed.initialize first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by model_parallel={model_parallel}")
    if n_devices != world:
        raise ValueError(f"the mesh spans every process: n_devices={n_devices}, world {world}")
    grid = torch.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def axis(mesh: DeviceMesh, name: str) -> Axis:
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Leading batch axis split over ``data``, whole on ``model``."""
    return Sharding((Shard(0), Replicate()))


def batch_specs(tree: Any, mesh: DeviceMesh) -> Any:
    return map_tree(lambda _: batch_sharding(mesh), tree)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding((Replicate(), Replicate()))


def param_sharding(params: Params, mesh: DeviceMesh) -> Params:
    """Replicate everything except the widest decoder matrices, which split
    their output (``linear1``, ``pwconv1``) or input (``linear2``,
    ``pwconv2``) features over ``model`` when it has more than one rank."""
    return map_tree_with_path(lambda name, leaf: leaf_sharding(name, leaf, mesh), params)


def leaf_sharding(name: str, leaf: Any, mesh: DeviceMesh) -> Sharding:
    """:func:`param_sharding` of one leaf, by its ``named_leaves`` name."""
    if axis(mesh, "model").size > 1 and getattr(leaf, "ndim", 0) == 2:
        for key, dim in MODEL_SPLIT:
            if key in name:
                return Sharding((Replicate(), Shard(dim)))
    return replicated(mesh)


def _block(n: int, ax: Axis, what: str) -> slice:
    if n % ax.size:
        raise ValueError(f"{what}: {n} not divisible by {ax.size}")
    size = n // ax.size
    return slice(ax.rank * size, (ax.rank + 1) * size)


def local_part(x: torch.Tensor, sharding: Sharding, mesh: DeviceMesh) -> torch.Tensor:
    """This process's block of the whole value ``x`` (a view)."""
    for name, p in zip(mesh.mesh_dim_names, sharding.placements):
        if isinstance(p, Shard):
            idx = [slice(None)] * x.ndim
            idx[p.dim] = _block(x.shape[p.dim], axis(mesh, name), f"dim {p.dim} over {name}")
            x = x[tuple(idx)]
    return x


def full_value(x: torch.Tensor, sharding: Sharding, mesh: DeviceMesh) -> torch.Tensor:
    """The whole value from every process's block ``x`` (a collective over
    each mesh dim that splits it; every process of that dim must call it)."""
    for name, p in reversed(list(zip(mesh.mesh_dim_names, sharding.placements))):
        if isinstance(p, Shard):
            moved = x.movedim(p.dim, 0)
            x = all_gather_rows(moved, axis(mesh, name).group).movedim(0, p.dim)
    return x


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This process's rows of a global batch (every leaf's axis 0 split over
    ``data``)."""
    return map_tree(lambda x: local_part(x, batch_sharding(mesh), mesh), batch)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _SumOverGroup(torch.autograd.Function):
    """The sum over the group forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def feed_forward_split(mesh: DeviceMesh) -> FeedForwardSplit:
    """This process's part of the decoder's feed-forward blocks split over
    ``model`` (``decoder.feed_forward``)."""
    model = axis(mesh, "model")
    return FeedForwardSplit(model.rank, model.size,
                            functools.partial(copy_to_group, group=model.group),
                            functools.partial(sum_over_group, group=model.group))


def copy_to_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` as it is, where every process of ``group`` uses it for its own
    block of a split computation: its gradient is the sum of theirs."""
    return _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of every ``group`` process's partial ``x``, where each then
    computes the same thing from it: the gradient reaches each partial as
    it is."""
    return _SumOverGroup.apply(x, group)
