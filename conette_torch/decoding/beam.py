"""Batched beam search over the static KV cache.

Counterpart of ``conette_tpu/decoding/beam.py`` with its exact semantics
(reference ``nn/decoding/beam.py:23-269``):

- per-example BOS ids (task-token conditioning);
- scores are *sum* log-probs during the search, final ranking by average
  log-prob;
- min-length EOS masking, forbid-repetition masking and the optional
  per-clip ``eos_bias_schedule`` are applied to the logits before the
  log-softmax;
- at the first step only beam 0 competes;
- a beam that emits EOS at step i retires with avg = sum / (i + 1), the
  live beams continue and the selection width shrinks with them; at the
  last step every live beam retires;
- ``NEG = -1e30`` stands for minus infinity.

Ties: the reference keeps the lowest flat index first (parent-major, then
token id). ``torch.topk`` leaves its tie order unspecified, so the top-k is
taken from a stable descending sort, which keeps exactly that order. The
final best hypothesis is the first maximum in finish order.

The state is a fixed (B·beam) batch: retired beams are score-masked so
they sort last, "top-k over live beams only" is the rank test
``rank < n_alive``, and the KV cache follows the parents by an index
gather (``models/decoder.py::reorder_cache``).

The loop leaves as the JAX package's ``lax.while_loop`` does, once no beam
is alive, through the step guard that the caller picks
(``decoding/guard.py``). The state is held in buffers allocated before the
first step (JAX's ``_State`` carry: ``preds``, ``mh``, ``sum_lprobs``,
``alive``, ``fin_preds``, ``fin_avg``, ``fin_count``, ``tok`` and the KV
cache), and each step writes its new values into them in place and ends by
writing ``alive.any()`` into a 0-dim bool flag; step ``s`` is handed to
the guard with the flag that step ``s - 1`` wrote. The default guard runs
every step and reads nothing back to the host, so the search can be
captured in a CUDA graph; the captured programs' guard puts each step under
a graph *if* node, so a replay skips the steps after the last beam retires.

A skipped step is exact: with no beam alive, every candidate score is
``NEG``, so ``valid`` is false for every rank, nothing finishes, and
``fin_preds``, ``fin_avg`` and ``fin_count`` keep their values; the state
that would still move (``preds``, the cache, the tokens) reaches no output.
So the fixed-step and the early-exit loops give the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from conette_torch.decoding.greedy import masked_logits, one_hot_bool
from conette_torch.decoding.guard import Guard, every_step
from conette_torch.models.decoder import (
    DecoderConfig,
    Params,
    decode_step,
    init_cross,
    init_self,
    reorder_cache,
)

NEG = -1.0e30


class BeamResult(NamedTuple):
    best_preds: torch.Tensor  # (B, max_pred_size) best hypothesis (pad-filled)
    best_avg_lprobs: torch.Tensor  # (B,)
    global_preds: torch.Tensor  # (B, beam, max_pred_size)
    global_avg_lprobs: torch.Tensor  # (B, beam)


def top_k_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis; equal values keep ascending index
    order (``lax.top_k``'s order), which ``torch.topk`` does not promise."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_search(
    params: Params,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    memory_key_padding_mask: torch.Tensor,
    bos_ids: torch.Tensor,
    *,
    beam_size: int = 3,
    min_pred_size: int = 0,
    max_pred_size: int = 20,
    forbid_rep_mask: torch.Tensor | None = None,
    eos_bias_schedule: torch.Tensor | None = None,
    guard: Guard = every_step,
) -> BeamResult:
    """
    :param memory: (B, T_mem, d_model) projected frame embeddings.
    :param memory_key_padding_mask: (B, T_mem) True = PAD.
    :param bos_ids: (B,) per-example BOS token ids.
    :param eos_bias_schedule: optional (B, max_pred_size) f32 bias added to
        the EOS logit of every beam of clip ``b`` at step ``s``; the
        min-length mask still wins.
    :param guard: runs each step or skips it, given the flag that the
        previous step left (``decoding/guard.py``); every step by default.
    """
    b = memory.shape[0]
    k = beam_size
    vocab = cfg.vocab_size
    dev = memory.device
    pad, eos = cfg.pad_id, cfg.eos_id

    ctx = init_cross(params, cfg, memory, memory_key_padding_mask)
    cache = init_self(cfg, b * k, max_pred_size, memory.dtype, dev)

    tok = bos_ids.to(device=dev, dtype=torch.int64).repeat_interleave(k)
    preds = torch.full((b, k, max_pred_size), pad, dtype=torch.int64, device=dev)
    sum_lprobs = torch.full((b, k), NEG, device=dev)
    sum_lprobs[:, 0] = 0.0  # only beam 0 competes at the first step
    alive = torch.ones((b, k), dtype=torch.bool, device=dev)
    mh = one_hot_bool(tok, vocab).reshape(b, k, vocab)
    fin_preds = torch.full((b, k, max_pred_size), pad, dtype=torch.int64, device=dev)
    fin_avg = torch.zeros((b, k), device=dev)
    fin_count = torch.zeros((b,), dtype=torch.int64, device=dev)
    rank = torch.arange(k, device=dev)[None, :]
    # pad and NEG as tensors, for the in-place where(..., out=) below
    pad_t = torch.full((), pad, dtype=torch.int64, device=dev)
    neg_t = torch.full((), NEG, device=dev)

    flag = torch.ones((), dtype=torch.bool, device=dev)  # some beam is alive

    def step_body(step: int) -> None:
        raw = decode_step(params, cfg, cache, ctx, tok, step)
        logits = masked_logits(
            raw, step, min_pred_size, eos, mh.reshape(b * k, vocab), forbid_rep_mask
        ).reshape(b, k, vocab)
        if eos_bias_schedule is not None:
            logits = logits.clone()
            logits[:, :, eos] += eos_bias_schedule[:, step].to(logits)[:, None]

        lprobs = torch.log_softmax(torch.clamp_min(logits, NEG), dim=-1)
        cand = torch.where(alive[:, :, None], sum_lprobs[:, :, None] + lprobs, NEG)
        n_alive = alive.sum(dim=1)
        scores, flat_idx = top_k_lowest_index(cand.reshape(b, k * vocab), k)
        parent = flat_idx // vocab  # (B, k) beam index within the clip
        token = flat_idx % vocab
        valid = rank < n_alive[:, None]  # only live beams yield winners

        emitted = torch.where(valid, token, pad_t, out=tok.view(b, k))  # the next step's input
        preds.copy_(preds.gather(1, parent[:, :, None].expand(-1, -1, max_pred_size)))
        preds[:, :, step] = emitted
        torch.logical_or(mh.gather(1, parent[:, :, None].expand(-1, -1, vocab)),
                         one_hot_bool(emitted, vocab), out=mh)

        finishing = valid & ((token == eos) | (step == max_pred_size - 1))
        # retire finishing winners into slots fin_count .. (in score-rank order)
        slot = fin_count[:, None] + torch.cumsum(finishing.long(), dim=1) - 1
        onehot = finishing[:, :, None] & (slot[:, :, None] == rank[:, None, :])  # (B, w, s)
        filled = onehot.any(dim=1)  # (B, s)
        winner = onehot.long().argmax(dim=1)  # (B, s): the winner landing in slot s
        avg = scores / float(step + 1)
        torch.where(filled, avg.gather(1, winner), fin_avg, out=fin_avg)
        torch.where(
            filled[:, :, None],
            preds.gather(1, winner[:, :, None].expand(-1, -1, max_pred_size)),
            fin_preds,
            out=fin_preds,
        )
        fin_count.add_(finishing.sum(dim=1))

        torch.logical_and(valid, ~finishing, out=alive)
        torch.where(alive, scores, neg_t, out=sum_lprobs)
        torch._foreach_copy_(cache, reorder_cache(cache, parent))
        torch.any(alive, out=flag)

    for step in range(max_pred_size):
        guard(flag, functools.partial(step_body, step))

    best = fin_avg.argmax(dim=1)  # first maximum on ties
    best_preds = fin_preds.gather(1, best[:, None, None].expand(-1, 1, max_pred_size))[:, 0]
    best_avg = fin_avg.gather(1, best[:, None])[:, 0]
    return BeamResult(best_preds, best_avg, fin_preds, fin_avg)
