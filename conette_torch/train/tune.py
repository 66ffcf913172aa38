"""Batch-size tuner (the reference's TUNE_MODE path,
``src/conette/train.py:435-455``; counterpart of
``conette_tpu/train/tune.py``): a doubling search for the largest batch size
whose training step runs without running out of card memory."""

from __future__ import annotations

import logging
from typing import Any, Callable

import torch

pylog = logging.getLogger(__name__)


def find_max_batch_size(
    make_batch: Callable[[int], dict[str, Any]],
    step_fn: Callable[[dict[str, Any]], Any],
    start: int = 32,
    max_bsize: int = 65536,
) -> int:
    """Doubles ``bsize`` from ``start`` until ``step_fn(make_batch(bsize))``
    raises ``torch.cuda.OutOfMemoryError`` or passes ``max_bsize``, and
    returns the last size that ran. Any other error propagates. The card's
    work is waited for after each try, so an out-of-memory error surfaces
    in it, and the allocator's cache is emptied between tries.

    :param make_batch: bsize → batch dict.
    :param step_fn: one training step.
    """
    best = 0
    bsize = start
    while bsize <= max_bsize:
        try:
            step_fn(make_batch(bsize))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            best = bsize
            pylog.info(f"bsize {bsize}: OK")
            bsize *= 2
        except torch.cuda.OutOfMemoryError:
            pylog.info(f"bsize {bsize}: out of memory, stopping the search")
            break
        finally:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    if best == 0:
        raise RuntimeError(f"even bsize={start} does not fit")
    return best


def tune_batch_size_for_model(cfg: Any, params: Any, t_frames: int = 31, **search: Any) -> int:
    """:func:`find_max_batch_size` for the CoNeTTE training step: the
    decoder's training loss and its backward pass, on the device of
    ``params``, at each size (``search``: ``start``, ``max_bsize``)."""
    from conette_torch.train.objective import training_loss
    from conette_torch.weights import map_tree, named_leaves

    dev = named_leaves(params)[0][1].device
    gen = torch.Generator(dev).manual_seed(0)

    def step(batch: dict[str, Any]) -> Any:
        with torch.enable_grad():
            tree = map_tree(lambda t: t.detach().requires_grad_(True), params)
            leaves = [t for _, t in named_leaves(tree)]
            return torch.autograd.grad(training_loss(tree, cfg, batch, gen), leaves)

    def make_batch(b: int) -> dict[str, Any]:  # drawn on the device: no host copy to wait for
        return {
            "audio": torch.randn((b, t_frames, cfg.proj_in), generator=gen, device=dev),
            "audio_lens": torch.full((b,), t_frames, dtype=torch.long, device=dev),
            "captions": torch.randint(4, cfg.vocab_size, (b, cfg.max_pred_size), generator=gen,
                                      device=dev),
        }

    return find_max_batch_size(make_batch, step, **search)

