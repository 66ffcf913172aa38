"""Training objective: embedding-space mixup + label-smoothed CE.

Counterpart of ``conette_tpu/train/objective.py`` (the reference training
step, ``pl_modules/conette.py:187-231``):

- asymmetric mixup: λ ~ Beta(α, α) folded into [0.5, 1], pairing by a
  random permutation with no fixed point (``randperm_diff``), applied to
  both the audio frame embeddings and the input token embeddings, while
  the targets stay unmixed; a mixed clip's length is the larger of the
  pair's;
- CE with ``ignore_index=pad`` and label smoothing (torch semantics: mean
  over non-pad targets, the smoothed target ε/K).

Every draw takes an explicit ``torch.Generator``; it lives on the device of
the tensors it draws for.
"""

from __future__ import annotations

from typing import Any

import torch

from conette_torch.models.conette import (
    ConetteConfig,
    embed_tokens,
    encode_audio,
    forward_forcing,
)
from conette_torch.models.layers import RowDraws

Params = dict[str, Any]


def sample_lambda(
    gen: torch.Generator, alpha: float, asymmetric: bool = True
) -> torch.Tensor:
    """λ ~ Beta(α, α) as a 0-d f32 tensor on ``gen``'s device; asymmetric
    folds it to [0.5, 1] by max(λ, 1-λ). At α == 0: asymmetric → 1.0,
    symmetric → a fair coin in {0, 1} (the reference's edge cases)."""
    device = gen.device
    if alpha == 0.0:
        if asymmetric:
            return torch.ones((), device=device)
        return (torch.rand((), generator=gen, device=device) < 0.5).float()
    pair = torch.full((2,), float(alpha), device=device)
    lbd = torch._sample_dirichlet(pair, generator=gen)[0]  # Beta(α, α)
    if asymmetric:
        lbd = torch.maximum(lbd, 1.0 - lbd)
    return lbd


def randperm_diff(gen: torch.Generator, n: int) -> torch.Tensor:
    """A random permutation with no fixed point for n > 1: each element is
    paired with its successor in a random cycle order."""
    perm = torch.randperm(n, generator=gen, device=gen.device)
    inv = torch.argsort(perm)
    return perm[(inv + 1) % n]


def _log_probs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    if logits.shape[1] != targets.shape[1]:
        logits = logits.transpose(1, 2)  # (B, vocab, L) → (B, L, vocab)
    return torch.log_softmax(logits.float(), dim=-1)


def label_smoothed_ce(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pad_id: int,
    label_smoothing: float = 0.0,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """torch ``CrossEntropyLoss(ignore_index=pad, label_smoothing=ε)``:
    mean over non-pad positions of CE against the ε-smoothed target.

    :param logits: (B, vocab, L) (reference layout) or (B, L, vocab).
    :param targets: (B, L) token ids.
    :param count: the divisor in place of these targets' non-pad count
        (a sharded step divides its rows' sum by the global batch's count).
    """
    lp = _log_probs(logits, targets)
    nll = -lp.gather(-1, targets[..., None])[..., 0]
    smooth = -lp.mean(dim=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    mask = targets != pad_id
    if count is None:
        count = mask.sum()
    return torch.where(mask, loss, 0.0).sum() / count.clamp_min(1)


def per_caption_ce(
    logits: torch.Tensor, targets: torch.Tensor, pad_id: int
) -> torch.Tensor:
    """Per-example mean CE over non-pad tokens (the validation loss)."""
    lp = _log_probs(logits, targets)
    nll = -lp.gather(-1, targets[..., None])[..., 0]
    mask = targets != pad_id
    return torch.where(mask, nll, 0.0).sum(dim=1) / mask.sum(dim=1).clamp_min(1)


def training_loss(
    params: Params,
    cfg: ConetteConfig,
    batch: dict[str, torch.Tensor],
    gen: torch.Generator | None,
    *,
    use_mixup: bool = True,
    mixup_override: tuple[Any, torch.Tensor] | None = None,
    mesh: Any = None,
) -> torch.Tensor:
    """One training-step loss on a batch with keys ``audio`` (B, T, 768),
    ``audio_lens`` (B,), ``captions`` (B, L) (first column already the task
    token).

    :param gen: the step's generator (mixup pairing and λ, dropout).
    :param mixup_override: (λ, perm) in place of the drawn mixup
        randomness, so that two implementations can be driven with the same
        mixing.
    :param mesh: a ``("data", "model")`` device mesh (``parallel/mesh.py``)
        whose ``data`` dim splits the global batch: ``batch`` holds this
        process's block of rows, and the result is its share of the global
        loss, the sum of its rows' token losses over the global batch's
        token count, so that the shares sum over ``data`` to the
        one-process loss and their gradients to its gradient. Every draw
        (pairing, λ, dropout) is made at the global batch's shape and this
        process's rows are kept (``RowDraws``), and mixup pairs rows over
        the whole batch, whose rows are first gathered over ``data``: a
        row's result does not depend on how the batch is split. The
        ``model`` dim splits the decoder's feed-forward blocks."""
    audio = batch["audio"]
    audio_lens = batch["audio_lens"]
    captions = batch["captions"]
    b = captions.shape[0]
    draws, ff_split = gen, None
    if mesh is not None:
        from conette_torch.parallel.mesh import axis, feed_forward_split

        data, ff_split = axis(mesh, "data"), feed_forward_split(mesh)
        rows = slice(data.rank * b, (data.rank + 1) * b)
        b *= data.size
        draws = RowDraws(gen, rows.start, b)

    caps_in = captions[:, :-1]
    caps_out = captions[:, 1:]
    caps_in_pad_mask = caps_in == cfg.pad_id
    caps_emb = embed_tokens(params, caps_in, dtype=audio.dtype, pad_id=cfg.pad_id)

    if use_mixup:
        if mixup_override is not None:
            lbd, idx = mixup_override
            idx = torch.as_tensor(idx, device=audio.device)
        else:
            idx = randperm_diff(gen, b)
            lbd = sample_lambda(gen, cfg.mixup_alpha, asymmetric=True)
        if mesh is None:
            other_audio, other_lens, other_emb = audio[idx], audio_lens[idx], caps_emb[idx]
        else:
            from conette_torch.parallel.distributed import all_gather_rows

            partner = idx[rows]
            other_audio = all_gather_rows(audio, data.group)[partner]
            other_lens = all_gather_rows(audio_lens, data.group)[partner]
            other_emb = embed_tokens(params, all_gather_rows(caps_in, data.group)[partner],
                                     dtype=audio.dtype, pad_id=cfg.pad_id)
        audio = audio * lbd + other_audio * (1.0 - lbd)
        audio_lens = torch.maximum(audio_lens, other_lens)
        caps_emb = caps_emb * lbd + other_emb * (1.0 - lbd)

    memory, memory_pad = encode_audio(
        params, cfg, audio, audio_lens, deterministic=False, gen=draws
    )
    logits = forward_forcing(
        params, cfg, memory, memory_pad, caps_emb,
        caps_in_pad_mask=caps_in_pad_mask, deterministic=False, gen=draws,
        caps_in_embedded=True, ff_split=ff_split,
    )
    count = None
    if mesh is not None:
        from conette_torch.parallel.distributed import all_reduce

        count = all_reduce((caps_out != cfg.pad_id).sum(), data.group)
    return label_smoothed_ce(logits, caps_out, cfg.pad_id, cfg.label_smoothing, count)


def per_ref_losses(
    params: Params,
    cfg: ConetteConfig,
    batch: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(clip, reference) teacher-forced CE over ``mult_captions``
    (B, R, L) → (losses (B, R), valid (B, R)). A reference row is valid when
    it holds a token past column 0: the batch stamps the task token into
    column 0 of every row, also of the all-pad rows that pad a clip with
    fewer references than the batch's largest count."""
    memory, memory_pad = encode_audio(params, cfg, batch["audio"], batch["audio_lens"])
    mult = batch["mult_captions"]
    b, r, length = mult.shape
    # all references at once: each clip's memory repeated for its R rows
    caps = mult.reshape(b * r, length)
    caps_in, caps_out = caps[:, :-1], caps[:, 1:]
    logits = forward_forcing(
        params, cfg, memory.repeat_interleave(r, dim=0),
        memory_pad.repeat_interleave(r, dim=0), caps_in,
        caps_in_pad_mask=caps_in == cfg.pad_id,
    )
    losses = per_caption_ce(logits, caps_out, cfg.pad_id).reshape(b, r)
    valid = (mult[:, :, 1:] != cfg.pad_id).any(dim=2)
    return losses, valid


def validation_loss(
    params: Params,
    cfg: ConetteConfig,
    batch: dict[str, torch.Tensor],
) -> torch.Tensor:
    """Mean per-caption forced loss over all valid references."""
    losses, valid = per_ref_losses(params, cfg, batch)
    return torch.where(valid, losses, 0.0).sum() / valid.sum().clamp_min(1)
