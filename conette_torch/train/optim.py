"""Optimizers and learning-rate schedules over the port's parameter tree.

Counterpart of ``conette_tpu/train/optim.py`` (the reference's optimizer
factory, ``optim/optimizers.py:17-81``, and schedules,
``optim/schedulers.py:19-125``). The optimizer is a ``torch.optim``
optimizer over the tree's leaf tensors (``weights.named_leaves`` order):

- ``use_custom_wd`` splits the leaves into two parameter groups, ndim >= 2
  with weight decay and the rest (biases, norms) without it, as
  ``optax.adamw(mask=decay_mask(params))`` does;
- the learning rate is set by the host once an epoch in every group's
  ``lr`` (:func:`set_lr`), from a schedule of the epoch (:func:`get_schedule`,
  plain Python) or from :class:`ReduceLROnPlateau`'s factor.

torch's AdamW decays the weights before its Adam update; optax adds
``wd·p`` to the update. The two agree to f32 rounding.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from conette_torch.weights import map_tree, named_leaves

Params = Any

PLATEAU_NAMES = ("reduce_lr_on_plateau", "reducelronplateau")


def decay_mask(params: Params) -> Params:
    """True for parameters that receive weight decay: ndim >= 2 (biases and
    norm scales do not)."""
    return map_tree(lambda p: p.ndim >= 2, params)


def param_groups(params: Params, weight_decay: float, use_custom_wd: bool = True) -> list[dict]:
    """The optimizer's parameter groups: with ``use_custom_wd`` the decayed
    leaves (ndim >= 2) and the others at weight decay 0, else one group;
    each names its leaves (``param_names``) as ``params.npz`` does."""
    leaves = named_leaves(params)
    if not use_custom_wd:
        return [_group(leaves, weight_decay)]
    decay = dict(named_leaves(decay_mask(params)))
    return [
        _group([(k, t) for k, t in leaves if decay[k]], weight_decay),
        _group([(k, t) for k, t in leaves if not decay[k]], 0.0),
    ]


def _group(leaves: list, weight_decay: float) -> dict:
    # ``param_names`` keys the optimizer's state by the tree's names
    return {"params": [t for _, t in leaves], "param_names": [k for k, _ in leaves],
            "weight_decay": weight_decay}


# ---------------------------------------------------------------- schedules
def cos_decay_schedule(base_lr: float, n_steps: int) -> Callable[[int], float]:
    """lr(step) = base · 0.5 · (1 + cos(π · min(step, n-1) / n)): the
    reference's ``CosDecayRule`` clamps the step at ``n_steps - 1``."""
    n = max(n_steps, 1)
    return lambda step: base_lr * 0.5 * (1.0 + math.cos(math.pi * min(step, n - 1) / n))


def trf_schedule(d_model: int, warmup_steps: int = 4000) -> Callable[[int], float]:
    """Noam/Transformer schedule."""

    def fn(step: int) -> float:
        s = max(float(step), 1.0)
        return d_model ** (-0.5) * min(s ** (-0.5), s * warmup_steps ** (-1.5))

    return fn


def multistep_schedule(base_lr: float, milestones: list[int], gamma: float = 0.1) -> Callable:
    return lambda step: base_lr * math.prod(gamma if step >= m else 1.0 for m in milestones)


def swalr_schedule(
    base_lr: float,
    swa_lr: float = 0.05,
    anneal_epochs: int = 20,
    anneal_strategy: str = "linear",
) -> Callable:
    """torch ``SWALR``: anneal from the optimizer lr to ``swa_lr`` over
    ``anneal_epochs`` steps ("linear" or "cos"), constant after."""

    def fn(step: int) -> float:
        frac = min(max(step / max(anneal_epochs, 1), 0.0), 1.0)
        if anneal_strategy == "cos":
            return swa_lr + (base_lr - swa_lr) * 0.5 * (1.0 + math.cos(math.pi * frac))
        return base_lr + (swa_lr - base_lr) * frac

    return fn


def cyclic_cos_decay_schedule(
    base_lr: float,
    init_decay_epochs: int,
    min_decay_lr: float,
    restart_interval: int | None = None,
    restart_interval_multiplier: float | None = None,
    restart_lr: float | None = None,
    warmup_epochs: int | None = None,
    warmup_start_lr: float | None = None,
) -> Callable:
    """``CyclicCosineDecayLR`` (vendored by the reference): an optional
    cosine warmup, an initial cosine decay to ``min_decay_lr``, then
    optional fixed or geometrically growing cosine restart cycles."""
    if init_decay_epochs < 1:
        raise ValueError(f"init_decay_epochs must be >= 1, got {init_decay_epochs}")
    if warmup_epochs is not None and warmup_start_lr is None:
        raise ValueError("warmup_start_lr must be set when warmup_epochs is set")
    warm = int(warmup_epochs or 0)

    def cos_calc(t: float, period: float, lr_hi: float) -> float:
        return min_decay_lr + (lr_hi - min_decay_lr) * 0.5 * (1.0 + math.cos(math.pi * t / period))

    def fn(step: int) -> float:
        step = float(step)
        t0 = step - warm
        if t0 < 0:
            return base_lr + (warmup_start_lr - base_lr) * 0.5 * (
                1.0 + math.cos(math.pi * step / max(warm, 1)))
        t1 = t0 - init_decay_epochs
        if t1 < 0:
            return cos_calc(min(max(t0, 0), init_decay_epochs), init_decay_epochs, base_lr)
        lr_hi = base_lr if restart_lr is None else restart_lr
        if restart_interval is None:
            return min_decay_lr
        if restart_interval_multiplier is None:
            return cos_calc(t1 % restart_interval, restart_interval, lr_hi)
        m = restart_interval_multiplier
        n = math.floor(math.log(max(1.0 - (1.0 - m) * t1 / restart_interval, 1e-12)) / math.log(m))
        done = restart_interval * (1.0 - m**n) / (1.0 - m)
        return cos_calc(t1 - done, restart_interval * m**n, lr_hi)

    return fn


def get_schedule(
    name: str,
    base_lr: float,
    n_steps: int,
    d_model: int = 256,
    milestones: list[int] | None = None,
    **kwargs: Any,
) -> Callable[[int], float]:
    """Schedule factory: a function of the epoch giving the learning rate.
    ``reduce_lr_on_plateau`` is stateful and built as
    :class:`ReduceLROnPlateau` instead."""
    name = str(name).lower()
    if name in ("cos_decay", "cosdecayrule"):
        return cos_decay_schedule(base_lr, n_steps)
    if name in ("trf", "trfrule", "transformer_scheduler"):
        return trf_schedule(d_model, kwargs.get("warmup_steps", 4000))
    if name in ("multistep", "multisteplr"):
        return multistep_schedule(base_lr, milestones or [n_steps // 2], kwargs.get("gamma", 0.1))
    if name == "swalr":
        return swalr_schedule(
            base_lr,
            swa_lr=kwargs.get("swa_lr", 0.05),
            anneal_epochs=kwargs.get("anneal_epochs", 20),
            anneal_strategy=kwargs.get("anneal_strategy", "linear"),
        )
    if name in ("cyclic_cos_decay", "cycliccosinedecaylr"):
        return cyclic_cos_decay_schedule(
            base_lr,
            init_decay_epochs=kwargs.get("init_decay_epochs", max(n_steps // 2, 1)),
            min_decay_lr=kwargs.get("min_decay_lr", base_lr * 0.01),
            restart_interval=kwargs.get("restart_interval"),
            restart_interval_multiplier=kwargs.get("restart_interval_multiplier"),
            restart_lr=kwargs.get("restart_lr"),
            warmup_epochs=kwargs.get("warmup_epochs"),
            warmup_start_lr=kwargs.get("warmup_start_lr"),
        )
    if name in ("none", "null"):
        return lambda step: base_lr
    raise ValueError(
        f"Unknown scheduler {name!r}. (expected one of ('cos_decay', 'trf', "
        "'multistep', 'swalr', 'cyclic_cos_decay', 'reduce_lr_on_plateau', "
        "'none'))"
    )


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch ``ReduceLROnPlateau``'s rule) as a
    multiplicative factor on the base lr: call ``step(metric)`` once per
    validation and set the lr to ``base_lr * factor``."""

    def __init__(
        self,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr_factor: float = 0.0,
        cooldown: int = 0,
    ) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"Invalid {mode=}")
        self.mode = mode
        self.reduce_factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr_factor = min_lr_factor
        self.cooldown = cooldown
        self.factor = 1.0
        self.best: float | None = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.factor = max(self.factor * self.reduce_factor, self.min_lr_factor)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
        return self.factor


def get_optimizer(
    params: Params,
    optim_name: str = "AdamW",
    lr: float = 5e-4,
    weight_decay: float = 2.0,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    use_custom_wd: bool = True,
    sched_name: str = "cos_decay",
    sched_n_steps: int = 400,
    sched_kwargs: dict[str, Any] | None = None,
) -> tuple[torch.optim.Optimizer, Callable[[int], float] | None]:
    """The optimizer over ``params``' leaves and its schedule of the epoch
    (None for ``reduce_lr_on_plateau``, whose lr the caller sets from
    :class:`ReduceLROnPlateau`). The optimizer starts at the schedule's
    epoch-0 lr.

    AdamW and Adam run fused on the card (one kernel for all leaves) and as
    ``foreach`` on the CPU; SGD has momentum 0.9 and decays the weights of
    the decay group, as ``optax.chain(add_decayed_weights, sgd)``."""
    plateau = str(sched_name).lower() in PLATEAU_NAMES
    schedule = None if plateau else get_schedule(sched_name, lr, sched_n_steps, **(sched_kwargs or {}))
    lr0 = lr if schedule is None else schedule(0)
    name_l = optim_name.lower()
    groups = param_groups(params, weight_decay if name_l != "adam" else 0.0, use_custom_wd)
    cuda = all(t.is_cuda for g in groups for t in g["params"])
    if name_l == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=tuple(betas), eps=eps, fused=cuda or None)
    elif name_l == "adam":
        opt = torch.optim.Adam(groups, lr=lr0, betas=tuple(betas), eps=eps, fused=cuda or None)
    elif name_l == "sgd":
        opt = torch.optim.SGD(groups, lr=lr0, momentum=0.9)
    else:
        raise ValueError(f"Unknown optimizer {optim_name!r}. (expected AdamW, Adam or SGD)")
    return opt, schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's learning rate (a host value; the next
    ``optimizer.step()`` uses it)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


# ---------------------------------------------------------------- EMA / SWA
def _map2(fn: Callable, a: Params, b: Params) -> Params:
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


@torch.no_grad()
def ema_update(ema_params: Params, params: Params, decay: float = 0.999) -> Params:
    """Exponential moving average of the weights: a new tree."""
    return _map2(lambda e, p: decay * e + (1.0 - decay) * p, ema_params, params)


@torch.no_grad()
def swa_update(swa_params: Params, params: Params, n_averaged: int) -> Params:
    """Stochastic weight averaging: the running mean over ``n_averaged + 1``
    snapshots, as a new tree."""
    return _map2(lambda s, p: s + (p - s) / float(n_averaged + 1), swa_params, params)


def snapshot(params: Params) -> Params:
    """A detached copy of the tree (the optimizer updates its leaves in
    place, so an average must start from a copy)."""
    return map_tree(lambda t: t.detach().clone(), params)
