"""Task-conditioned transformer caption decoder with a static KV cache.

Counterpart of ``conette_tpu/models/decoder.py``: Embedding(vocab, d_model,
padding_idx=pad) scaled by sqrt(d_model) + sinusoidal positions → post-norm
decoder layers (torch ``TransformerDecoderLayer(norm_first=False)``
semantics, GELU, eps 1e-5) → Linear(d_model, vocab), batch-first.

Incremental decoding keeps a physical per-row self-attention cache: one
(rows, 2, H, L_max, dh) tensor per layer holding K and V, written in place
at ``step``. Beam search reorders it by parent with one index gather per
layer (:func:`reorder_cache`). The JAX package's "ancestry" map and its
dense one-hot reorder matmul were formulations for the TPU; at f32 they
give the same result as this gather. Cross-attention K/V are computed once
per clip (:class:`CrossContext`) and shared by the clip's beams.

A step reads nothing back to the host and copies nothing from it: the
sinusoidal table lives on the device (:func:`position_table`, built once
a key) and ``step`` is a Python int, so a decode loop can be captured in a
CUDA graph.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from conette_torch.models.layers import (
    Params,
    RowDraws,
    cast,
    dropout,
    embedding,
    embedding_init,
    f32,
    gelu,
    layer_norm,
    linear,
    linear_init,
    xavier_uniform,
)
from conette_torch.weights import device_constant

LN_EPS = 1e-5
NEG_INF = -1e30


class DecoderConfig(NamedTuple):
    vocab_size: int
    d_model: int = 256
    nhead: int = 8
    num_layers: int = 6
    dim_feedforward: int = 2048
    dropout_p: float = 0.2
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0
    max_len: int = 5000  # positional table size (reference maxlen=5000)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Sin/cos positional table (sin on even dims, cos on odd dims)."""
    den = np.exp(-np.arange(0, d_model, 2, dtype=np.float64) * math.log(10000.0) / d_model)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    table = np.zeros((max_len, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * den)
    table[:, 1::2] = np.cos(pos * den)
    return table.astype(np.float32)


@functools.lru_cache(maxsize=8)
def position_table(device: torch.device, d_model: int, max_len: int) -> torch.Tensor:
    """:func:`sinusoidal_positions` as an f32 (max_len, d_model) tensor on
    ``device``, uploaded once for each key; a decode step reads its row."""
    return device_constant(sinusoidal_positions(max_len, d_model), device)


# --------------------------------------------------------------------- init
def attention_init(gen: torch.Generator, d_model: int) -> Params:
    """torch MultiheadAttention init: xavier-uniform packed in-projection,
    zero in-projection bias, default out-projection init with zero bias."""
    wq, wk, wv = xavier_uniform(gen, (d_model, 3 * d_model)).split(d_model, dim=1)
    out = linear_init(gen, d_model, d_model, init="torch")
    out["bias"] = torch.zeros(d_model)
    zeros = torch.zeros(d_model)
    return {
        "q": {"weight": wq.contiguous(), "bias": zeros.clone()},
        "k": {"weight": wk.contiguous(), "bias": zeros.clone()},
        "v": {"weight": wv.contiguous(), "bias": zeros.clone()},
        "out": out,
    }


def decoder_init(gen: torch.Generator, cfg: DecoderConfig) -> Params:
    def norm() -> Params:
        return {"weight": torch.ones(cfg.d_model), "bias": torch.zeros(cfg.d_model)}

    return {
        "emb": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.pad_id),
        "classifier": linear_init(gen, cfg.d_model, cfg.vocab_size, init="torch"),
        "layers": [
            {
                "self_attn": attention_init(gen, cfg.d_model),
                "cross_attn": attention_init(gen, cfg.d_model),
                "linear1": linear_init(gen, cfg.d_model, cfg.dim_feedforward, init="torch"),
                "linear2": linear_init(gen, cfg.dim_feedforward, cfg.d_model, init="torch"),
                "norm1": norm(),
                "norm2": norm(),
                "norm3": norm(),
            }
            for _ in range(cfg.num_layers)
        ],
    }


# ---------------------------------------------------------------- attention
def _split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, nhead, d // nhead).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _softmax_f32(scores: torch.Tensor) -> torch.Tensor:
    return torch.softmax(f32(scores), dim=-1)


def attention(
    params: Params,
    q_in: torch.Tensor,
    kv_in: torch.Tensor,
    nhead: int,
    *,
    mask: torch.Tensor | None = None,
    key_padding_mask: torch.Tensor | None = None,
    dropout_p: float = 0.0,
    deterministic: bool = True,
    gen: torch.Generator | RowDraws | None = None,
) -> torch.Tensor:
    """Multi-head attention. ``mask`` (Lq, Lk) bool, True = blocked;
    ``key_padding_mask`` (B, Lk) bool, True = PAD. In training
    (``deterministic=False``) the attention probabilities take dropout at
    ``dropout_p``, drawn from ``gen``."""
    dh = q_in.shape[-1] // nhead
    q = _split_heads(linear(params["q"], q_in), nhead)
    k = _split_heads(linear(params["k"], kv_in), nhead)
    v = _split_heads(linear(params["v"], kv_in), nhead)
    scores = torch.matmul(f32(q), f32(k).transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        scores = scores.masked_fill(mask[None, None], NEG_INF)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    w = cast(_softmax_f32(scores), q.dtype)
    w = dropout(gen, w, dropout_p, deterministic)
    out = cast(torch.matmul(f32(w), f32(v)), q_in.dtype)
    return linear(params["out"], _merge_heads(out))


# ------------------------------------------------------------- full forward
class FeedForwardSplit(NamedTuple):
    """A feed-forward block split over ``size`` processes (Megatron's column
    → row pair), as this process sees it: ``copy`` is the identity whose
    gradient is summed over the processes, ``sum`` the processes' sum
    whose gradient passes through (``parallel/mesh.py::feed_forward_split``
    builds them over a mesh's ``model`` dim)."""

    rank: int
    size: int
    copy: Callable[[torch.Tensor], torch.Tensor]
    sum: Callable[[torch.Tensor], torch.Tensor]


def feed_forward(
    layer: Params,
    x: torch.Tensor,
    p: float,
    deterministic: bool,
    gen: torch.Generator | RowDraws | None,
    split: FeedForwardSplit | None = None,
) -> torch.Tensor:
    """``linear2(dropout(gelu(linear1(x))))``.

    :param split: where the block is split over processes: ``layer`` then
        holds this process's columns of ``linear1/weight`` and rows of
        ``linear2/weight`` and both biases whole. Each process computes its
        block of the hidden layer, takes that block of the whole layer's
        dropout draw, and the partial outputs are summed (``split.sum``);
        ``x`` and ``linear1``'s bias enter through ``split.copy``, so the
        replicated leaves get the whole gradient on every process."""
    if split is None or split.size == 1:
        hidden = dropout(gen, gelu(linear(layer["linear1"], x)), p, deterministic)
        return linear(layer["linear2"], hidden)
    width = layer["linear1"]["weight"].shape[1]
    bias1 = split.copy(layer["linear1"]["bias"])[split.rank * width:(split.rank + 1) * width]
    hidden = gelu(linear({"weight": layer["linear1"]["weight"], "bias": bias1}, split.copy(x)))
    hidden = dropout(gen, hidden, p, deterministic, cols=(split.rank, split.size))
    partial = torch.matmul(f32(hidden), f32(cast(layer["linear2"]["weight"], hidden.dtype)))
    return cast(split.sum(partial) + f32(layer["linear2"]["bias"]), x.dtype)


def decoder_forward(
    params: Params,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    caps_in: torch.Tensor,
    *,
    memory_key_padding_mask: torch.Tensor | None = None,
    caps_in_pad_mask: torch.Tensor | None = None,
    causal: bool = True,
    deterministic: bool = True,
    gen: torch.Generator | RowDraws | None = None,
    caps_in_embedded: bool = False,
    ff_split: FeedForwardSplit | None = None,
) -> torch.Tensor:
    """Teacher-forcing forward over a whole caption (the training pass).

    :param memory: (B, T_mem, D) projected frame embeddings.
    :param caps_in: (B, L) token ids, or (B, L, D) embeddings when
        ``caps_in_embedded`` (the mixup path).
    :param deterministic: False in training: dropout at ``cfg.dropout_p``
        on the scaled embeddings and, in each layer, on the self- and
        cross-attention probabilities and outputs, the hidden layer of the
        feed-forward block and its output, each draw from ``gen``.
    :param ff_split: the split of the feed-forward blocks over processes
        (:func:`feed_forward`), or None for whole layers.
    :returns: (B, L, vocab) f32 logits.
    """
    x = caps_in if caps_in_embedded else embedding(params["emb"], caps_in, dtype=memory.dtype)
    length = x.shape[1]
    x = x * math.sqrt(cfg.d_model)
    pos = position_table(x.device, cfg.d_model, cfg.max_len)[:length]
    x = dropout(gen, x + cast(pos, x.dtype)[None], cfg.dropout_p, deterministic)
    p = cfg.dropout_p

    sq_mask = None
    if causal:
        sq_mask = torch.ones((length, length), dtype=torch.bool, device=x.device).triu(1)
    for layer in params["layers"]:
        sa = attention(layer["self_attn"], x, x, cfg.nhead, mask=sq_mask,
                       key_padding_mask=caps_in_pad_mask, dropout_p=p,
                       deterministic=deterministic, gen=gen)
        x = layer_norm(layer["norm1"], x + dropout(gen, sa, p, deterministic), LN_EPS)
        ca = attention(layer["cross_attn"], x, memory, cfg.nhead,
                       key_padding_mask=memory_key_padding_mask, dropout_p=p,
                       deterministic=deterministic, gen=gen)
        x = layer_norm(layer["norm2"], x + dropout(gen, ca, p, deterministic), LN_EPS)
        ff = feed_forward(layer, x, p, deterministic, gen, ff_split)
        x = layer_norm(layer["norm3"], x + dropout(gen, ff, p, deterministic), LN_EPS)
    return f32(linear(params["classifier"], x))


# ------------------------------------------------------------- cached decode
class CrossContext(NamedTuple):
    """Loop-invariant cross-attention state, stored per clip: the beams of
    one clip share its K/V."""

    cross_k: torch.Tensor  # (num_layers, B, H, T_mem, dh)
    cross_v: torch.Tensor  # (num_layers, B, H, T_mem, dh)
    memory_pad: torch.Tensor  # (B, T_mem) True = PAD


def init_cross(
    params: Params,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    memory_key_padding_mask: torch.Tensor,
) -> CrossContext:
    """Precompute per-clip cross-attention K/V from projected memory."""
    ks, vs = [], []
    for layer in params["layers"]:
        ca = layer["cross_attn"]
        ks.append(_split_heads(linear(ca["k"], memory), cfg.nhead))
        vs.append(_split_heads(linear(ca["v"], memory), cfg.nhead))
    return CrossContext(torch.stack(ks), torch.stack(vs), memory_key_padding_mask)


def init_self(
    cfg: DecoderConfig, rows: int, max_steps: int, dtype: torch.dtype, device
) -> list[torch.Tensor]:
    """Zeroed self-attention caches: per layer one (rows, 2, H, L, dh)
    tensor, index 0 of axis 1 holding K and index 1 holding V."""
    dh = cfg.d_model // cfg.nhead
    return [
        torch.zeros((rows, 2, cfg.nhead, max_steps, dh), dtype=dtype, device=device)
        for _ in range(cfg.num_layers)
    ]


def init_cache(
    params: Params,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    memory_key_padding_mask: torch.Tensor,
    max_steps: int,
) -> tuple[list[torch.Tensor], CrossContext]:
    """``(init_self(...), init_cross(...))`` at the memory's batch, dtype
    and device."""
    ctx = init_cross(params, cfg, memory, memory_key_padding_mask)
    cache = init_self(cfg, memory.shape[0], max_steps, memory.dtype, memory.device)
    return cache, ctx


def reorder_cache(cache: list[torch.Tensor], parent: torch.Tensor) -> list[torch.Tensor]:
    """Gather the rows by per-clip beam parents.

    :param parent: (B, beam) parent beam within each clip; rows are laid out
        clip-major (all beams of clip 0 first).
    """
    b, k = parent.shape
    flat = (parent + torch.arange(b, device=parent.device)[:, None] * k).reshape(-1)
    return [buf.index_select(0, flat) for buf in cache]


def decode_step(
    params: Params,
    cfg: DecoderConfig,
    cache: list[torch.Tensor],
    ctx: CrossContext,
    token_ids: torch.Tensor,
    step: int,
) -> torch.Tensor:
    """One incremental decode step; writes position ``step`` of ``cache``
    in place.

    :param token_ids: (B·beam,) current input tokens in clip-major order;
        ``ctx`` is at clip batch B, ``beam = len(token_ids) // B``.
    :returns: (B·beam, vocab) f32 logits for the next token.
    """
    b = token_ids.shape[0]
    b_ctx = ctx.memory_pad.shape[0]
    if b % b_ctx:
        raise ValueError(
            f"token batch {b} is not a multiple of the cross-context clip batch {b_ctx}"
        )
    beams = b // b_ctx
    dh = cfg.d_model // cfg.nhead
    max_steps = cache[0].shape[3]
    dtype = ctx.cross_k.dtype

    x = embedding(params["emb"], token_ids, dtype=dtype) * math.sqrt(cfg.d_model)
    pos = position_table(x.device, cfg.d_model, cfg.max_len)[step]
    x = (x + cast(pos, dtype))[:, None, :]  # (B, 1, D)
    invalid = torch.arange(max_steps, device=x.device) > step  # (L,)

    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        qkv = linear(
            {
                "weight": torch.cat([sa["q"]["weight"], sa["k"]["weight"], sa["v"]["weight"]], 1),
                "bias": torch.cat([sa["q"]["bias"], sa["k"]["bias"], sa["v"]["bias"]]),
            },
            x,
        )
        q, k_new, v_new = (_split_heads(t, cfg.nhead) for t in qkv.split(cfg.d_model, dim=-1))
        buf = cache[i]
        buf[:, 0, :, step] = k_new[:, :, 0]
        buf[:, 1, :, step] = v_new[:, :, 0]
        scores = torch.matmul(f32(q), f32(buf[:, 0]).transpose(-1, -2)) / math.sqrt(dh)
        w = cast(_softmax_f32(scores.masked_fill(invalid, NEG_INF)), q.dtype)
        sa_out = cast(torch.matmul(f32(w), f32(buf[:, 1])), x.dtype)
        x = layer_norm(layer["norm1"], x + linear(sa["out"], _merge_heads(sa_out)), LN_EPS)

        ca = layer["cross_attn"]
        qc = _split_heads(linear(ca["q"], x), cfg.nhead)  # (B·beam, H, 1, dh)
        qb = qc[:, :, 0, :].reshape(b_ctx, beams, cfg.nhead, dh)
        scores = torch.einsum("bkhd,bhmd->bkhm", f32(qb), f32(ctx.cross_k[i])) / math.sqrt(dh)
        scores = scores.masked_fill(ctx.memory_pad[:, None, None, :], NEG_INF)
        w = cast(_softmax_f32(scores), qc.dtype)
        ca_out = torch.einsum("bkhm,bhmd->bkhd", f32(w), f32(ctx.cross_v[i]))
        ca_out = cast(ca_out.reshape(b, cfg.nhead, 1, dh), x.dtype)
        x = layer_norm(layer["norm2"], x + linear(ca["out"], _merge_heads(ca_out)), LN_EPS)

        ff = linear(layer["linear2"], gelu(linear(layer["linear1"], x)))
        x = layer_norm(layer["norm3"], x + ff, LN_EPS)

    return f32(linear(params["classifier"], x[:, 0, :]))


def count_params(params: Any) -> int:
    """The number of scalars in a parameter tree of tensors or arrays."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(params.shape))
