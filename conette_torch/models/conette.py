"""CoNeTTE model assembly: projection + task-conditioned caption decoder.

Counterpart of ``conette_tpu/models/conette.py`` (reference ``CoNeTTEPLM``):
the model takes 768-d frame embeddings, projects them 768→256 with
Dropout+Linear+ReLU+Dropout (the dropouts act only in training), and
decodes with the transformer decoder, by teacher forcing in training
(:func:`forward_forcing`) and by beam or greedy search at inference;
``<bos_{task}>`` special tokens are appended to the vocabulary per task;
the forbid-repetition mask marks every non-stopword vocabulary entry.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from conette_torch.decoding.beam import BeamResult, beam_search
from conette_torch.decoding.greedy import GreedyResult, greedy_search
from conette_torch.models.decoder import (
    DecoderConfig,
    FeedForwardSplit,
    Params,
    decoder_forward,
    decoder_init,
)
from conette_torch.models.layers import RowDraws, cast, dropout, linear, linear_init
from conette_torch.tokenization import AACTokenizer
from conette_torch.utils.stopwords import ENGLISH_STOPWORDS

DEFAULT_TASK_NAMES = (
    "clotho",
    "audiocaps",
    "macs",
    "wavcaps_audioset_sl",
    "wavcaps_bbc_sound_effects",
    "wavcaps_freesound",
    "wavcaps_soundbible",
)


class ConetteConfig(NamedTuple):
    """Model/decode hyperparameters (reference ``huggingface/config.py``)."""

    vocab_size: int
    task_mode: str = "ds_src"
    task_names: tuple[str, ...] = DEFAULT_TASK_NAMES
    label_smoothing: float = 0.2
    mixup_alpha: float = 0.4
    proj_in: int = 768
    proj_dropout_p: float = 0.5
    min_pred_size: int = 3
    max_pred_size: int = 20
    beam_size: int = 3
    nhead: int = 8
    d_model: int = 256
    num_decoder_layers: int = 6
    decoder_dropout_p: float = 0.2
    dim_feedforward: int = 2048
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0

    def decoder_config(self) -> DecoderConfig:
        return DecoderConfig(
            vocab_size=self.vocab_size,
            d_model=self.d_model,
            nhead=self.nhead,
            num_layers=self.num_decoder_layers,
            dim_feedforward=self.dim_feedforward,
            dropout_p=self.decoder_dropout_p,
            bos_id=self.bos_id,
            eos_id=self.eos_id,
            pad_id=self.pad_id,
        )


def add_task_tokens(
    tokenizer: AACTokenizer,
    task_names: Sequence[str] = DEFAULT_TASK_NAMES,
    task_mode: str = "ds_src",
) -> dict[str, int]:
    """Append ``<bos_{task}>`` tokens; returns task name → token id."""
    mapping: dict[str, int] = {}
    if task_mode == "none":
        return mapping
    for name in task_names:
        token = f"<bos_{name}>"
        if tokenizer.has(token):
            mapping[name] = tokenizer.token_to_id(token)
        else:
            mapping[name] = tokenizer.add_special_token(token)
    return mapping


def build_forbid_rep_mask(
    tokenizer: AACTokenizer, mode: str = "content_words"
) -> np.ndarray | None:
    """(vocab,) bool — True = the token may not repeat."""
    if mode == "none":
        return None
    vocab_size = tokenizer.get_vocab_size()
    if mode == "all":
        return np.ones((vocab_size,), bool)
    if mode == "content_words":
        mask = np.ones((vocab_size,), bool)
        for word in ENGLISH_STOPWORDS:
            if tokenizer.has(word):
                mask[tokenizer.token_to_id(word)] = False
        return mask
    raise ValueError(
        f"Invalid forbid_rep mode {mode!r}. "
        "(expected one of ('none', 'all', 'content_words'))"
    )


def conette_init(gen: torch.Generator, cfg: ConetteConfig) -> Params:
    """Random projection + decoder parameter tree, on the CPU."""
    return {
        "projection": linear_init(gen, cfg.proj_in, cfg.d_model, init="torch"),
        "decoder": decoder_init(gen, cfg.decoder_config()),
    }


def encode_audio(
    params: Params,
    cfg: ConetteConfig,
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    *,
    deterministic: bool = True,
    gen: torch.Generator | RowDraws | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project (B, T, 768) frame embeddings → (B, T, d_model) memory and a
    (B, T) pad mask (True = PAD). In training (``deterministic=False``)
    dropout at ``cfg.proj_dropout_p`` acts before and after the projection,
    drawn from ``gen``."""
    x = dropout(gen, audio, cfg.proj_dropout_p, deterministic)
    x = torch.relu(linear(params["projection"], x))
    x = dropout(gen, x, cfg.proj_dropout_p, deterministic)
    t = x.shape[1]
    pad_mask = torch.arange(t, device=x.device)[None, :] >= audio_lens.to(x.device)[:, None]
    return x, pad_mask


def tasks_to_bos_ids(
    cfg: ConetteConfig,
    task_token_ids: dict[str, int],
    datasets: Sequence[str],
    sources: Sequence[str | None] | None = None,
) -> np.ndarray:
    """Map per-example dataset(+source) strings to ``<bos_task>`` ids."""
    n = len(datasets)
    if cfg.task_mode == "none":
        return np.full((n,), cfg.bos_id, np.int32)
    if cfg.task_mode == "ds":
        names = list(datasets)
    elif cfg.task_mode == "ds_src":
        if sources is None:
            sources = [None] * n
        names = [
            ds if src is None else f"{ds}_{src}".lower()
            for ds, src in zip(datasets, sources)
        ]
    else:
        raise ValueError(f"Invalid task mode {cfg.task_mode!r}.")
    return np.asarray([task_token_ids[name] for name in names], np.int32)


def forward_forcing(
    params: Params,
    cfg: ConetteConfig,
    memory: torch.Tensor,
    memory_pad_mask: torch.Tensor,
    caps_in: torch.Tensor,
    *,
    caps_in_pad_mask: torch.Tensor | None = None,
    deterministic: bool = True,
    gen: torch.Generator | RowDraws | None = None,
    caps_in_embedded: bool = False,
    ff_split: FeedForwardSplit | None = None,
) -> torch.Tensor:
    """Teacher forcing → (B, vocab, L) logits (the reference's layout).
    ``ff_split``: the decoder's feed-forward split (``decoder.feed_forward``)."""
    if caps_in_pad_mask is None and not caps_in_embedded:
        caps_in_pad_mask = caps_in == cfg.pad_id
    logits = decoder_forward(
        params["decoder"],
        cfg.decoder_config(),
        memory,
        caps_in,
        memory_key_padding_mask=memory_pad_mask,
        caps_in_pad_mask=caps_in_pad_mask,
        deterministic=deterministic,
        gen=gen,
        caps_in_embedded=caps_in_embedded,
        ff_split=ff_split,
    )
    return logits.transpose(1, 2)


def embed_tokens(
    params: Params,
    ids: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    pad_id: int | None = None,
) -> torch.Tensor:
    """Token embedding lookup (before the sqrt(d_model) scale), for the
    mixup training path.

    :param pad_id: when given, the PAD row passes no gradient back, as in
        ``nn.Embedding(padding_idx=pad)``. Under mixup ``emb[pad]`` leaks
        into the live positions of the mixing partner, so without this the
        PAD row would move in training.
    """
    weight = params["decoder"]["emb"]["weight"]
    if pad_id is not None:
        is_pad = torch.arange(weight.shape[0], device=weight.device)[:, None] == pad_id
        weight = torch.where(is_pad, weight.detach(), weight)
    return cast(weight, dtype)[ids]


def forward_generate(
    params: Params,
    cfg: ConetteConfig,
    memory: torch.Tensor,
    memory_pad_mask: torch.Tensor,
    bos_ids: torch.Tensor,
    *,
    beam_size: int | None = None,
    min_pred_size: int | None = None,
    max_pred_size: int | None = None,
    forbid_rep_mask: torch.Tensor | None = None,
    eos_bias_schedule: torch.Tensor | None = None,
) -> BeamResult:
    return beam_search(
        params["decoder"],
        cfg.decoder_config(),
        memory,
        memory_pad_mask,
        bos_ids,
        beam_size=beam_size if beam_size is not None else cfg.beam_size,
        min_pred_size=min_pred_size if min_pred_size is not None else cfg.min_pred_size,
        max_pred_size=max_pred_size if max_pred_size is not None else cfg.max_pred_size,
        forbid_rep_mask=forbid_rep_mask,
        eos_bias_schedule=eos_bias_schedule,
    )


def forward_greedy(
    params: Params,
    cfg: ConetteConfig,
    memory: torch.Tensor,
    memory_pad_mask: torch.Tensor,
    bos_ids: torch.Tensor,
    *,
    min_pred_size: int | None = None,
    max_pred_size: int | None = None,
    forbid_rep_mask: torch.Tensor | None = None,
) -> GreedyResult:
    return greedy_search(
        params["decoder"],
        cfg.decoder_config(),
        memory,
        memory_pad_mask,
        bos_ids,
        min_pred_size=min_pred_size if min_pred_size is not None else cfg.min_pred_size,
        max_pred_size=max_pred_size if max_pred_size is not None else cfg.max_pred_size,
        forbid_rep_mask=forbid_rep_mask,
    )
