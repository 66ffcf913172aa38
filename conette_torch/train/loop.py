"""The fit loop of ``conette-train``: phase 4/6.

Counterpart of ``conette_tpu/train/loop.py`` (the reference's
``trainer.fit`` pass and its per-epoch callbacks: checkpointing, SWA/EMA,
the NaN early stop). Batches come from a background thread
(``data/prefetch.py``) that also stages them in pinned memory, so that
the copy to the card does not wait on the host; the step's metrics stay
on the device and are read only at a logging step and by the end-of-epoch
NaN guard. The learning rate is set by the host once an epoch.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from conette_torch.train.optim import ema_update, set_lr, snapshot, swa_update

pylog = logging.getLogger(__name__)


class FitResult(NamedTuple):
    state: Any  # TrainState
    swa_params: Any
    ema_params: Any
    global_step: int
    fit_duration: float
    # host seconds the loop spent waiting for its next batch, and the
    # seconds of each epoch's training pass, and of the whole epoch
    # (validation and checkpoint included)
    batch_wait_s: float = 0.0
    epoch_train_s: tuple = ()
    epoch_s: tuple = ()


def pinned_batches(batches: Iterator[dict], pin: bool) -> Iterator[dict]:
    """Each batch's arrays as CPU tensors, in pinned memory when ``pin``
    (run in the prefetch thread, so the main thread copies them to the card
    without a host wait)."""
    for b in batches:
        out = {}
        for k, v in b.items():
            if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
                t = torch.from_numpy(np.ascontiguousarray(v))
                out[k] = t.pin_memory() if pin else t
            else:
                out[k] = v
        yield out


def fit(
    *,
    state,
    gen: torch.Generator,
    dm,
    train_step: Callable,
    to_train_batch: Callable,
    eval_runner,
    ckpt,
    logger,
    tokenizer,
    model_cfg,
    lr_schedule: Callable[[int], float],
    plateau=None,
    base_lr: float = 5e-4,
    max_epochs: int = 400,
    max_steps: int = -1,
    lim_train: Optional[int] = None,
    val_every_n_epochs: int = 1,
    log_every_n_steps: int = 50,
    ema_decay: Optional[float] = None,
    swa_start: Optional[int] = None,
    pin_memory: bool = False,
    debug: bool = False,
    mesh: Any = None,
) -> FitResult:
    """Train for ``max_epochs`` (or ``max_steps``), validating and
    checkpointing each ``val_every_n_epochs``.

    :param mesh: the mesh of ``make_sharded_train_step`` when it trains
        ``state``: its parameters and moments are then this process's
        blocks, and every process gathers them whole (``step.gather_params``,
        ``step.gather_opt_state``) for validation and checkpoints, which run
        on rank 0; rank 0 hands the validation metrics to every process."""
    from conette_torch.data.prefetch import prefetch_iterator
    from conette_torch.parallel.distributed import broadcast_from_main, is_main_process
    from conette_torch.train.step import gather_opt_state, gather_params

    ema_params = snapshot(state.params) if ema_decay else None
    swa_params = None
    swa_n = 0
    global_step = 0
    last_train_loss = None
    wait_s = 0.0
    train_s, epoch_s = [], []
    fit_start = time.time()

    for epoch in range(max_epochs):
        if 0 <= max_steps <= global_step:
            break
        set_lr(state.opt_state, base_lr * plateau.factor if plateau is not None else lr_schedule(epoch))
        t_epoch = time.perf_counter()
        batches = prefetch_iterator(pinned_batches(dm.train_batches(epoch), pin_memory))
        i = 0
        while True:
            if (lim_train is not None and i >= lim_train) or 0 <= max_steps <= global_step:
                break
            t_wait = time.perf_counter()
            b = next(batches, None)
            wait_s += time.perf_counter() - t_wait
            if b is None:
                break
            state, metrics = train_step(state, to_train_batch(b, global_step), gen)
            global_step += 1
            if ema_decay:
                ema_params = ema_update(ema_params, state.params, float(ema_decay))
            # reading a metric waits for the card: only at a logging step
            if global_step % log_every_n_steps == 0 or i == 0:
                logger.log_metrics(
                    {k: float(v) for k, v in metrics.items()}
                    | {"epoch": epoch, "train/lr": float(state.opt_state.param_groups[0]["lr"])},
                    step=global_step,
                )
            last_train_loss = metrics["train/loss"]
            i += 1
        if debug:
            import gc

            pylog.debug(f"epoch {epoch}: gc_objects={len(gc.get_objects())}")
        # NaN guard (the reference's check_finite early stop); reading the
        # loss waits for the epoch's last step, so it ends the pass's time
        finite = last_train_loss is None or np.isfinite(float(last_train_loss))
        train_s.append(time.perf_counter() - t_epoch)
        if not finite:
            pylog.error(f"Non-finite train loss at epoch {epoch}; stopping early.")
            break

        # ---- SWA snapshot averaging from swa_start onwards
        if swa_start is not None and epoch >= swa_start:
            if swa_params is None:
                swa_params, swa_n = snapshot(state.params), 1
            else:
                swa_params = swa_update(swa_params, state.params, swa_n)
                swa_n += 1

        # ---- validation
        if dm.num_eval_loaders("val") > 0 and epoch % int(val_every_n_epochs) == 0:
            params = gather_params(state.params, mesh)
            val_metrics = broadcast_from_main(
                eval_runner.run_validation(params, epoch) if is_main_process() else None)
            logger.log_metrics(val_metrics | {"epoch": epoch}, step=global_step)
            if plateau is not None and ckpt.monitor in val_metrics:
                plateau.step(float(val_metrics[ckpt.monitor]))
            # checkpoint the averaged weights when SWA or EMA is on (SWA wins)
            ckpt_params = (
                gather_params(swa_params, mesh) if swa_params is not None
                else (gather_params(ema_params, mesh) if ema_decay else params)
            )
            opt_state = gather_opt_state(state.opt_state, mesh)
            if is_main_process():
                ckpt.step(
                    epoch, val_metrics,
                    ckpt_params,
                    opt_state=opt_state,
                    tokenizer=tokenizer,
                    extra_meta={
                        "global_step": global_step,
                        "model_cfg": {
                            k: (list(v) if isinstance(v, tuple) else v)
                            for k, v in model_cfg._asdict().items()
                        },
                    },
                )
        epoch_s.append(time.perf_counter() - t_epoch)
    return FitResult(state, swa_params, ema_params, global_step, time.time() - fit_start,
                     wait_s, tuple(train_s), tuple(epoch_s))
