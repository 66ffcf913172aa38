"""BERTScore with multiple references — gated model wrapper.

Twin of the reference's ``BERTScoreMRefs`` (aac-metrics, wired in
``src/conette/metrics/classes/all_metrics.py:75-77``; its outputs are the
published ``bert_score.precision/recall/f1`` columns): greedy token-level
cosine matching between candidate and reference contextual embeddings —

* precision = mean over candidate tokens of the max cosine similarity to
  any reference token; recall = the transpose; f1 = harmonic mean;
* scored against every reference, reduced with ``max`` (per metric);
* corpus value = mean over sentences;
* no IDF weighting, no baseline rescaling (aac-metrics defaults).

The encoder (reference default: roberta-large via torchmetrics) needs a
one-time download; configuration:

* ``CONETTE_BERTSCORE_MODEL`` — HF model name/path (default
  ``roberta-large``);
* ``embed_fn`` — injectable ``callable(list[str]) -> list[np.ndarray
  (n_tokens_i, d)]`` for tests / custom encoders.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Sequence

import numpy as np

pylog = logging.getLogger(__name__)

_DEFAULT_MODEL = "roberta-large"
_CACHE: dict[str, Any] = {}

#: callable(list[str]) -> per-sentence token-embedding arrays (n_i, d)
EmbedFn = Callable[[Sequence[str]], list[np.ndarray]]


def _load_embedder() -> EmbedFn | None:
    if "embed" in _CACHE:
        return _CACHE["embed"]
    name = os.environ.get("CONETTE_BERTSCORE_MODEL", _DEFAULT_MODEL)
    embed: EmbedFn | None = None
    try:
        import torch
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(name)
        model = AutoModel.from_pretrained(name).eval()

        def embed(sentences: Sequence[str]) -> list[np.ndarray]:
            out: list[np.ndarray] = []
            with torch.no_grad():
                for i in range(0, len(sentences), 32):
                    batch = list(sentences[i : i + 32])
                    enc = tokenizer(
                        batch, padding=True, truncation=True, return_tensors="pt"
                    )
                    hidden = model(**enc).last_hidden_state.float().cpu().numpy()
                    mask = enc["attention_mask"].cpu().numpy().astype(bool)
                    out.extend(h[m] for h, m in zip(hidden, mask))
            return out

    except Exception as err:
        pylog.warning(f"BERTScore unavailable (model load failed: {err})")
    _CACHE["embed"] = embed
    return embed


def is_available() -> bool:
    return _load_embedder() is not None


def _pair_scores(cand: np.ndarray, ref: np.ndarray) -> tuple[float, float, float]:
    if len(cand) == 0 or len(ref) == 0:
        return 0.0, 0.0, 0.0
    c = cand / np.maximum(np.linalg.norm(cand, axis=-1, keepdims=True), 1e-9)
    r = ref / np.maximum(np.linalg.norm(ref, axis=-1, keepdims=True), 1e-9)
    sim = c @ r.T
    p = float(sim.max(axis=1).mean())
    rec = float(sim.max(axis=0).mean())
    f1 = 2 * p * rec / max(p + rec, 1e-12)
    return p, rec, f1


def bert_score(
    candidates: Sequence[str],
    mult_references: Sequence[Sequence[str]],
    *,
    embed_fn: EmbedFn | None = None,
) -> dict[str, object]:
    """→ flat dict: corpus ``bert_score.{precision,recall,f1}`` + per-
    sentence ``*_sents`` lists (reference CSV column names)."""
    embed = embed_fn or _load_embedder()
    if embed is None:
        raise RuntimeError(
            "BERTScore requires a transformer encoder; set "
            "CONETTE_BERTSCORE_MODEL to a local model path."
        )
    cand_embs = embed(list(candidates))
    flat_refs = [r for refs in mult_references for r in refs]
    ref_embs = embed(flat_refs)

    ps: list[float] = []
    rs: list[float] = []
    f1s: list[float] = []
    offset = 0
    for cand_emb, refs in zip(cand_embs, mult_references):
        scores = [
            _pair_scores(cand_emb, ref_embs[offset + j]) for j in range(len(refs))
        ]
        offset += len(refs)
        # per-metric max over refs (aac-metrics reduction="max")
        ps.append(max(s[0] for s in scores))
        rs.append(max(s[1] for s in scores))
        f1s.append(max(s[2] for s in scores))

    def mean(xs: list[float]) -> float:
        return sum(xs) / max(len(xs), 1)

    return {
        "bert_score.precision": mean(ps),
        "bert_score.recall": mean(rs),
        "bert_score.f1": mean(f1s),
        "bert_score.precision_sents": ps,
        "bert_score.recall_sents": rs,
        "bert_score.f1_sents": f1s,
    }
