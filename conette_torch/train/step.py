"""The train and eval steps.

Counterpart of ``conette_tpu/train/step.py``. A training step is the loss
(mixup → teacher forcing → label-smoothed CE), its backward pass, the
global-norm clip of ``optax.clip_by_global_norm``, the gradient
accumulation of ``optax.MultiSteps`` and the optimizer's step, all queued
on the parameters' device: the step reads nothing back to the host, and
its metrics are device tensors that the caller reads when it logs.

``make_sharded_train_step`` (data and model parallel over several cards)
is not ported yet.
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


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm reaches ``max_norm``, as ``optax.clip_by_global_norm`` (no epsilon
    in the divisor, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    norm = global_norm(grads)
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
    k = int(accumulate_grad_batches or 1)
    if loss_fn is None:
        def loss_fn(params, batch, gen):
            return training_loss(params, cfg, batch, gen, use_mixup=use_mixup)

    def train_step(state: TrainState, batch: dict, gen: torch.Generator):
        leaves = [t for _, t in named_leaves(state.params)]
        loss = loss_fn(state.params, batch, gen)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
        gnorm = global_norm(grads)
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
                return state, {"train/loss": loss.detach(), "train/grad_norm": gnorm}
            grads, state.acc_grads, state.mini_step = state.acc_grads, None, 0
        else:
            state.step += 1
        if grad_clip_norm:
            clip_by_global_norm_(grads, float(grad_clip_norm))
        for t, g in zip(leaves, grads):
            t.grad = g
        state.opt_state.step()
        for t in leaves:
            t.grad = None
        return state, {"train/loss": loss.detach(), "train/grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ConetteConfig) -> Callable:
    """Returns ``eval_step(params, batch) -> {"val/loss": 0-d tensor}``."""

    @torch.no_grad()
    def eval_step(params: Params, batch: dict) -> dict:
        return {"val/loss": validation_loss(params, cfg, batch)}

    return eval_step
