"""The train and eval steps.

Counterpart of ``conette_tpu/train/step.py``. A training step is the loss
(mixup → teacher forcing → label-smoothed CE), its backward pass, the
global-norm clip of ``optax.clip_by_global_norm``, the gradient
accumulation of ``optax.MultiSteps`` and the optimizer's step, all queued
on the parameters' device: the step reads nothing back to the host, and
its metrics are device tensors that the caller reads when it logs.

``make_sharded_train_step`` runs the same step over a ``("data", "model")``
mesh (``parallel/mesh.py``), one process per card: each process computes
its rows' share of the loss (``objective.training_loss(mesh=)``), the
gradients are summed over ``data``, and ``model`` splits the decoder's
feed-forward blocks, whose weights each process holds a block of.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from conette_torch.models.conette import ConetteConfig
from conette_torch.train.objective import training_loss, validation_loss
from conette_torch.weights import named_leaves

Params = Any


@dataclass
class TrainState:
    """The parameter tree (leaves with ``requires_grad``), the optimizer
    over its leaves (the counterpart of the optax state) and the count of
    steps taken (micro-batches, as the JAX state counts them)."""

    params: Params
    opt_state: torch.optim.Optimizer
    step: int = 0
    acc_grads: list[torch.Tensor] | None = field(default=None, repr=False)
    mini_step: int = 0


def init_train_state(params: Params, optimizer: torch.optim.Optimizer) -> TrainState:
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over all tensors, as ``optax.global_norm``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm_fn: Callable = global_norm) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm reaches ``max_norm``, as ``optax.clip_by_global_norm`` (no epsilon
    in the divisor, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    norm = norm_fn(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def make_train_step(
    cfg: ConetteConfig,
    *,
    use_mixup: bool = True,
    grad_clip_norm: float | None = None,
    accumulate_grad_batches: int = 1,
    loss_fn: Callable | None = None,
) -> Callable:
    """Returns ``train_step(state, batch, gen) -> (state, metrics)``.

    :param grad_clip_norm: clip the (accumulated) gradient's global norm.
    :param accumulate_grad_batches: k > 1 updates the parameters every k
        calls, on the mean of the k gradients (``optax.MultiSteps``): the
        optimizer, its schedule and its moments see k micro-batches as one
        step; the calls in between leave the parameters as they are.
    :param loss_fn: ``(params, batch, gen) -> loss`` in place of
        :func:`training_loss` (the tests drive a fixed mixup through it).
    metrics: ``train/loss`` and ``train/grad_norm`` (the micro-batch
        gradient's global norm, before clipping) as 0-d device tensors.
    """
    if loss_fn is None:
        def loss_fn(params, batch, gen):
            return training_loss(params, cfg, batch, gen, use_mixup=use_mixup)
    return _make_step(loss_fn, grad_clip_norm, accumulate_grad_batches)


def _make_step(
    loss_fn: Callable,
    grad_clip_norm: float | None,
    accumulate_grad_batches: int,
    reduce: Callable | None = None,
    norm: Callable = global_norm,
) -> Callable:
    """The step of :func:`make_train_step`; ``reduce(loss, grads) -> (loss,
    grads)`` combines the processes' shares, ``norm`` is the global norm."""
    k = int(accumulate_grad_batches or 1)

    def train_step(state: TrainState, batch: dict, gen: torch.Generator):
        leaves = [t for _, t in named_leaves(state.params)]
        loss = loss_fn(state.params, batch, gen)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
        loss = loss.detach()
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        gnorm = norm(grads)
        if k > 1:
            if state.acc_grads is None:
                state.acc_grads = [torch.zeros_like(g) for g in grads]
            # acc + (g - acc) / (n + 1): the running mean of optax.MultiSteps
            delta = torch._foreach_sub(grads, state.acc_grads)
            torch._foreach_div_(delta, float(state.mini_step + 1))
            torch._foreach_add_(state.acc_grads, delta)
            state.mini_step += 1
            state.step += 1
            if state.mini_step < k:
                return state, {"train/loss": loss, "train/grad_norm": gnorm}
            grads, state.acc_grads, state.mini_step = state.acc_grads, None, 0
        else:
            state.step += 1
        if grad_clip_norm:
            clip_by_global_norm_(grads, float(grad_clip_norm), norm)
        for t, g in zip(leaves, grads):
            # laid out as its parameter, as the fused optimizers take it
            # (autograd.grad gives a conv weight's gradient permuted)
            t.grad = g if g.stride() == t.stride() else torch.empty_like(t).copy_(g)
        state.opt_state.step()
        for t in leaves:
            t.grad = None
        return state, {"train/loss": loss, "train/grad_norm": gnorm}

    return train_step


def make_sharded_train_step(
    cfg: ConetteConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Any,
    state: TrainState,
    example_batch: dict,
    *,
    use_mixup: bool = True,
    grad_clip_norm: float | None = None,
    accumulate_grad_batches: int = 1,
) -> tuple[TrainState, Callable]:
    """The train step over ``mesh``. Returns ``(placed_state, train_step)``.

    ``state`` holds the whole parameters (every process the same). Placing
    it keeps each process's block of the leaves that ``param_sharding``
    splits over ``model``, in place, so ``optimizer`` (built over ``state``'s
    leaves) goes on stepping them, and its moments with them. ``train_step``
    takes this process's rows of the global batch (``shard_batch``), its
    block of ``data``, and a generator in the same state on every process;
    ``example_batch`` is such a batch, and every process must hold as many
    rows as the others. The loss shares and gradients are summed over
    ``data`` before the clip and the update, and the global norm counts a
    split leaf's squares over ``model`` once. ``train/loss`` is the global
    batch's loss on every process.
    """
    from conette_torch.parallel.distributed import all_gather_rows, all_reduce
    from conette_torch.parallel.mesh import axis, local_part, param_sharding

    if optimizer is not state.opt_state:
        raise ValueError("optimizer must be the state's own (init_train_state(params, optimizer))")
    data, model = axis(mesh, "data"), axis(mesh, "model")
    rows = {k: v.shape[0] for k, v in example_batch.items()}
    if len(set(rows.values())) != 1:
        raise ValueError(f"the batch's leaves hold different row counts: {rows}")
    counts = all_gather_rows(torch.tensor([next(iter(rows.values()))]), data.group)
    if len(set(counts.tolist())) != 1:
        raise ValueError(f"the processes of 'data' hold different row counts: {counts.tolist()}")

    placements = param_sharding(state.params, mesh)
    split = []
    for (_, t), (_, p) in zip(named_leaves(state.params), named_leaves(placements)):
        block = local_part(t.detach(), p, mesh)
        split.append(block.shape != t.shape)
        if split[-1]:
            moments = state.opt_state.state.get(t, {})
            for key, m in moments.items():
                if isinstance(m, torch.Tensor) and m.shape == t.shape:
                    moments[key] = local_part(m, p, mesh).clone()
            t.data = block.clone()

    def reduce(loss, grads):
        if data.size == 1:
            return loss, grads
        flat = all_reduce(torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads]),
                          data.group)
        sizes = [1] + [g.numel() for g in grads]
        parts = flat.split(sizes)
        return parts[0].reshape(()), [p.view_as(g) for p, g in zip(parts[1:], grads)]

    def norm(grads):
        if model.size == 1:
            return global_norm(grads)
        whole = global_norm([g for g, s in zip(grads, split) if not s]).square()
        blocks = global_norm([g for g, s in zip(grads, split) if s]).square()
        return torch.sqrt(whole + all_reduce(blocks, model.group))

    def loss_fn(params, batch, gen):
        return training_loss(params, cfg, batch, gen, use_mixup=use_mixup, mesh=mesh)

    return state, _make_step(loss_fn, grad_clip_norm, accumulate_grad_batches, reduce, norm)


def gather_opt_state(optimizer: torch.optim.Optimizer, mesh: Any) -> Any:
    """What a checkpoint stores of ``optimizer`` in the one-process layout:
    ``optimizer`` itself where nothing is split, else its state flattened
    as ``checkpoint.flatten_opt_state`` does, with the moments of the split
    leaves gathered whole (a collective over ``model``)."""
    from conette_torch.parallel.mesh import axis, full_value, leaf_sharding
    from conette_torch.train.checkpoint import flatten_opt_state

    if mesh is None or axis(mesh, "model").size == 1:
        return optimizer
    flat = flatten_opt_state(optimizer)
    for group in optimizer.param_groups:
        for name, t in zip(group["param_names"], group["params"]):
            sharding = leaf_sharding(name, t, mesh)
            for key, v in optimizer.state.get(t, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == t.shape:
                    flat[f"state/{name}/{key}"] = full_value(v, sharding, mesh).cpu().numpy()
    return flat


def gather_params(params: Params, mesh: Any) -> Params:
    """The whole parameter tree from each process's blocks (a collective
    over ``model``), in the one-process layout."""
    from conette_torch.parallel.mesh import full_value, leaf_sharding
    from conette_torch.weights import map_tree_with_path

    if mesh is None:
        return params
    return map_tree_with_path(
        lambda name, t: full_value(t.detach(), leaf_sharding(name, t, mesh), mesh), params)


def make_eval_step(cfg: ConetteConfig) -> Callable:
    """Returns ``eval_step(params, batch) -> {"val/loss": 0-d tensor}``."""

    @torch.no_grad()
    def eval_step(params: Params, batch: dict) -> dict:
        return {"val/loss": validation_loss(params, cfg, batch)}

    return eval_step
