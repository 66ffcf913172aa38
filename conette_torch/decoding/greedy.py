"""Greedy caption decoding over the static KV cache.

Counterpart of ``conette_tpu/decoding/greedy.py`` (reference
``nn/decoding/greedy.py:18-131``): min-length EOS masking and
forbid-repetition masking before selection, finished rows emit the pad
one-hot logits row, output logits (B, vocab, L).

The loop leaves as the JAX package's ``lax.while_loop`` does, once every
row has emitted EOS, through the step guard that the caller picks
(``decoding/guard.py``). The state (``cache``, ``tok``, ``finished``,
``mh``, and the outputs ``toks`` and ``logits_out``) is held in buffers
allocated before the first step, which each step writes in place; a step
ends by writing ``~finished.all()`` into a 0-dim bool flag, and step ``s``
is handed to the guard with the flag that step ``s - 1`` wrote. The
default guard runs every step and reads nothing back to the host, so the
loop can be captured in a CUDA graph; the captured programs' guard puts
each step under a graph *if* node, so a replay skips the steps after the
last row finishes.

A skipped step is exact: once a row has finished, every later step writes
``pad`` to its token and the pad row to its logits, which is what both
outputs were filled with; ``finished`` stays set, and the row's step
computation reaches no output. So once every row has finished, a step
changes neither output, and the fixed-step and the early-exit loops give
the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from conette_torch.decoding.guard import Guard, every_step
from conette_torch.models.decoder import (
    DecoderConfig,
    Params,
    decode_step,
    init_cross,
    init_self,
)

__all__ = ["GreedyResult", "greedy_search", "masked_logits", "one_hot_bool"]

NEG_INF = float("-inf")


class GreedyResult(NamedTuple):
    preds: torch.Tensor  # (B, max_pred_size) token ids (pad after eos)
    logits: torch.Tensor  # (B, vocab, max_pred_size)


def one_hot_bool(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool one-hot rows of ``ids``, checked by no host read."""
    return ids[..., None] == torch.arange(n, device=ids.device)


def masked_logits(
    logits: torch.Tensor,
    step: int,
    min_pred_size: int,
    eos_id: int,
    prev_multihot: torch.Tensor | None,
    forbid_rep_mask: torch.Tensor | None,
) -> torch.Tensor:
    """Apply the min-length EOS mask and the forbid-repetition mask."""
    if min_pred_size > 0 and step < min_pred_size:
        logits = logits.clone()
        logits[:, eos_id] = NEG_INF
    if forbid_rep_mask is not None and prev_multihot is not None:
        logits = logits.masked_fill(prev_multihot & forbid_rep_mask[None, :], NEG_INF)
    return logits


def greedy_search(
    params: Params,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    memory_key_padding_mask: torch.Tensor,
    bos_ids: torch.Tensor,
    *,
    min_pred_size: int = 0,
    max_pred_size: int = 20,
    forbid_rep_mask: torch.Tensor | None = None,
    guard: Guard = every_step,
) -> GreedyResult:
    """
    :param memory: (B, T_mem, d_model) projected frame embeddings.
    :param memory_key_padding_mask: (B, T_mem) True = PAD.
    :param bos_ids: (B,) per-example BOS ids (task-token conditioning).
    :param guard: runs each step or skips it, given the flag that the
        previous step left (``decoding/guard.py``); every step by default.
    """
    b = memory.shape[0]
    vocab = cfg.vocab_size
    dev = memory.device
    ctx = init_cross(params, cfg, memory, memory_key_padding_mask)
    cache = init_self(cfg, b, max_pred_size, memory.dtype, dev)

    pad_row = torch.where(torch.arange(vocab, device=dev) == cfg.pad_id, 0.0, NEG_INF)
    toks = torch.full((b, max_pred_size), cfg.pad_id, dtype=torch.int64, device=dev)
    logits_out = pad_row[None, :, None].repeat(b, 1, max_pred_size)

    tok = bos_ids.to(device=dev, dtype=torch.int64).clone()
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    mh = one_hot_bool(tok, vocab)
    flag = torch.ones((), dtype=torch.bool, device=dev)  # some row is unfinished
    pad_t = torch.full((), cfg.pad_id, dtype=torch.int64, device=dev)  # for where(..., out=)

    def step_body(step: int) -> None:
        raw = decode_step(params, cfg, cache, ctx, tok, step)
        logits = masked_logits(raw, step, min_pred_size, cfg.eos_id, mh, forbid_rep_mask)
        next_tok = logits.argmax(dim=-1)
        logits_out[:, :, step] = torch.where(finished[:, None], pad_row[None, :], logits)
        torch.where(finished, pad_t, next_tok, out=tok)
        toks[:, step] = tok
        finished.logical_or_(next_tok == cfg.eos_id)
        mh.logical_or_(one_hot_bool(tok, vocab))
        torch.any(~finished, out=flag)

    for step in range(max_pred_size):
        guard(flag, functools.partial(step_body, step))
    return GreedyResult(preds=toks, logits=logits_out)
