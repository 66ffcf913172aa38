"""Diversity, text-stats and new-words metrics — reference-exact.

Twins of the reference custom metrics, matching their key names, their
(corpus, per-sentence) output split and their numeric conventions so the
published ``scores_*.yaml`` / ``outputs_*.csv`` columns reproduce to
machine precision (validated in ``tests/test_reference_parity.py``):

- ``diversity`` ≙ ``src/conette/metrics/functional/diversity.py:53-120``:
  per-sentence n-gram diversity = unique/total n-grams; per-clip ref value
  = mean over that clip's refs; corpus ``sents_div{n}.ratio`` = mean of
  per-clip ratios (ratio 0 where the ref value is 0); ``corpus_div{n}``
  over the pooled candidate corpus, with the reference corpus value
  averaged over ``max_n_refs`` random one-ref-per-clip subsamples drawn
  from a ``torch.Generator().manual_seed(123)`` randint stream
  (diversity.py:122-141).
- ``text_stats`` ≙ ``metrics/functional/text_stats.py:17-120``: sentence
  lengths (ref = mean over refs), frequency-weighted ``vocab_coverage``,
  ``vocab_len.mrefs_avg`` over the same kind of seeded subsample,
  ``empty_sents``; note the reference's per-sentence key is the
  underscored ``sent_len_cands`` (its CSV column quirk).
- ``new_words`` ≙ ``metrics/functional/new_words.py:16-42``: per sentence
  the count of UNIQUE candidate tokens outside the train vocab; corpus =
  mean over sentences (not the union size).
- ``vocab_size`` ≙ ``metrics/functional/diversity.py:17-50``: diversity at
  n=1 with ``sents_div1``/``corpus_div1`` renamed to ``*_vocab``.

All functions accept either raw strings (tokenized with ``tokenizer``,
default whitespace split — the reference default) or pre-tokenized lists.
Scalars are python floats computed in float64.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Sequence

import numpy as np

pylog = logging.getLogger(__name__)

_REF_SEED = 123


def _tokenize_all(
    candidates: Sequence,
    mult_references: Sequence[Sequence] | None,
    tokenizer: Callable[[str], list[str]],
) -> tuple[list[list[str]], list[list[list[str]]]]:
    def tok(x):
        return list(x) if isinstance(x, (list, tuple)) else tokenizer(x)

    tok_cands = [tok(c) for c in candidates]
    tok_mrefs = (
        [[tok(r) for r in refs] for refs in mult_references]
        if mult_references is not None
        else []
    )
    return tok_cands, tok_mrefs


def _subsample_indexes(
    n_refs_list: Sequence[int], n_sweeps: int, seed: int | None
) -> list[list[int]]:
    """One-ref-per-clip index draws. Replicates the reference's
    ``torch.randint(0, len(refs), (), generator=g)`` stream with
    ``g = torch.Generator().manual_seed(seed)`` (diversity.py:122-131,
    text_stats.py:68-80) — bit-exact when torch is importable; a numpy
    fallback keeps the statistics (but not the stream) otherwise."""
    try:
        import torch

        g = torch.Generator().manual_seed(_REF_SEED if seed is None else seed)
        return [
            [int(torch.randint(0, n, (), generator=g).item()) for n in n_refs_list]
            for _ in range(n_sweeps)
        ]
    except ImportError:  # pragma: no cover - torch is baked into this env
        pylog.warning("torch unavailable: ref-subsample stream is not bit-exact")
        rng = np.random.default_rng(seed)
        return [
            [int(rng.integers(0, n)) for n in n_refs_list] for _ in range(n_sweeps)
        ]


def _ngram_list(tokens: Sequence[str], n: int) -> list[tuple]:
    return [tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


def _sent_diversities(
    sent: Sequence[str], n_max: int, cumulative: bool, use_ngram_count: bool
) -> np.ndarray:
    out = np.zeros((n_max,), np.float64)
    if len(sent) == 0:
        return out
    deno = np.zeros((n_max,), np.float64)
    uniq = np.zeros((n_max,), np.float64)
    for n in range(1, min(n_max, len(sent)) + 1):
        ngs = _ngram_list(sent, n)
        deno[n - 1] = len(ngs) if use_ngram_count else len(sent)
        uniq[n - 1] = len(set(ngs))
    if cumulative:
        uniq, deno = uniq.cumsum(), deno.cumsum()
        return uniq / np.maximum(deno, 1.0) / np.arange(1, n_max + 1)
    return uniq / np.maximum(deno, 1.0)


def _corpus_diversities(
    sents: Sequence[Sequence[str]], n_max: int, cumulative: bool, use_ngram_count: bool
) -> np.ndarray:
    deno = np.zeros((n_max,), np.float64)
    uniq_sets: list[set] = [set() for _ in range(n_max)]
    for sent in sents:
        for n in range(1, min(n_max, len(sent)) + 1):
            ngs = _ngram_list(sent, n)
            deno[n - 1] += len(ngs) if use_ngram_count else len(sent)
            uniq_sets[n - 1] |= set(ngs)
    uniq = np.asarray([len(s) for s in uniq_sets], np.float64)
    if cumulative:
        uniq, deno = uniq.cumsum(), deno.cumsum()
        return uniq / np.maximum(deno, 1.0) / np.arange(1, n_max + 1)
    return uniq / np.maximum(deno, 1.0)


def diversity(
    candidates: Sequence,
    mult_references: Sequence[Sequence],
    n_max: int = 1,
    cumulative: bool = False,
    use_ngram_count: bool = True,
    seed: int | None = _REF_SEED,
    tokenizer: Callable[[str], list[str]] = str.split,
) -> tuple[dict[str, float], dict[str, list[float]]]:
    """→ (corpus_scores, per_sentence_scores), reference key names."""
    tok_cands, tok_mrefs = _tokenize_all(candidates, mult_references, tokenizer)
    if len(tok_mrefs) <= 0:
        raise ValueError(f"Invalid number of references. (found {len(tok_mrefs)})")

    sents_cands = np.stack(
        [_sent_diversities(c, n_max, cumulative, use_ngram_count) for c in tok_cands]
    )
    sents_mrefs = np.stack(
        [
            np.mean(
                [_sent_diversities(r, n_max, cumulative, use_ngram_count) for r in refs],
                axis=0,
            )
            if refs
            else np.zeros((n_max,), np.float64)
            for refs in tok_mrefs
        ]
    )
    sents_ratios = np.where(sents_mrefs != 0.0, sents_cands / np.where(sents_mrefs != 0.0, sents_mrefs, 1.0), 0.0)

    corpus_cands = _corpus_diversities(tok_cands, n_max, cumulative, use_ngram_count)
    n_sweeps = max(len(refs) for refs in tok_mrefs)
    draws = _subsample_indexes([len(refs) for refs in tok_mrefs], n_sweeps, seed)
    corpus_mrefs = np.mean(
        [
            _corpus_diversities(
                [refs[i] for i, refs in zip(idxs, tok_mrefs)],
                n_max,
                cumulative,
                use_ngram_count,
            )
            for idxs in draws
        ],
        axis=0,
    )
    corpus_ratio = np.where(corpus_mrefs != 0.0, corpus_cands / np.where(corpus_mrefs != 0.0, corpus_mrefs, 1.0), 0.0)

    corpus: dict[str, float] = {}
    sents: dict[str, list[float]] = {}
    for n in range(1, n_max + 1):
        corpus |= {
            f"sents_div{n}.cands": float(sents_cands[:, n - 1].mean()),
            f"sents_div{n}.mrefs": float(sents_mrefs[:, n - 1].mean()),
            f"sents_div{n}.ratio": float(sents_ratios[:, n - 1].mean()),
            f"corpus_div{n}.cands": float(corpus_cands[n - 1]),
            f"corpus_div{n}.mrefs": float(corpus_mrefs[n - 1]),
            f"corpus_div{n}.ratio": float(corpus_ratio[n - 1]),
        }
        sents |= {
            f"sents_div{n}.cands": sents_cands[:, n - 1].tolist(),
            f"sents_div{n}.mrefs": sents_mrefs[:, n - 1].tolist(),
            f"sents_div{n}.ratio": sents_ratios[:, n - 1].tolist(),
        }
    return corpus, sents


def vocab_size(
    candidates: Sequence,
    mult_references: Sequence[Sequence],
    seed: int | None = _REF_SEED,
    tokenizer: Callable[[str], list[str]] = str.split,
) -> tuple[dict[str, float], dict[str, list[float]]]:
    """Diversity at n=1 under ``*_vocab`` key names
    (reference diversity.py:17-50)."""
    corpus, sents = diversity(
        candidates, mult_references, n_max=1, seed=seed, tokenizer=tokenizer
    )
    ren = lambda k: k.replace("sents_div1.", "sents_vocab.").replace(
        "corpus_div1.", "corpus_vocab."
    )
    return {ren(k): v for k, v in corpus.items()}, {
        ren(k): v for k, v in sents.items()
    }


def text_stats(
    candidates: Sequence,
    mult_references: Sequence[Sequence],
    seed: int | None = _REF_SEED,
    tokenizer: Callable[[str], list[str]] = str.split,
) -> tuple[dict[str, float], dict[str, list[float]]]:
    """Sentence-length and vocab statistics, reference key names."""
    tok_cands, tok_mrefs = _tokenize_all(candidates, mult_references, tokenizer)
    if len(tok_mrefs) <= 0:
        raise ValueError(f"Invalid number of references. (found {len(tok_mrefs)})")

    len_cands = np.asarray([len(c) for c in tok_cands], np.float64)
    len_mrefs = np.asarray(
        [sum(map(len, refs)) / len(refs) for refs in tok_mrefs], np.float64
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        len_ratios = len_cands / len_mrefs

    cands_counter: dict[str, int] = {}
    for c in tok_cands:
        for t in c:
            cands_counter[t] = cands_counter.get(t, 0) + 1
    mrefs_counter: dict[str, int] = {}
    for refs in tok_mrefs:
        for r in refs:
            for t in r:
                mrefs_counter[t] = mrefs_counter.get(t, 0) + 1

    total_mrefs_tokens = max(sum(mrefs_counter.values()), 1)
    vocab_coverage = sum(
        mrefs_counter.get(t, 0) / total_mrefs_tokens for t in cands_counter
    )
    vocab_in_ref_len = float(sum(1 for t in cands_counter if t in mrefs_counter))

    n_sweeps = max(len(refs) for refs in tok_mrefs)
    draws = _subsample_indexes([len(refs) for refs in tok_mrefs], n_sweeps, seed)
    vocab_lens = [
        float(
            len({t for i, refs in zip(idxs, tok_mrefs) for t in refs[i]})
        )
        for idxs in draws
    ]
    vocab_len_mrefs_avg = float(np.mean(vocab_lens))

    empty = np.asarray([1.0 if len(c) == 0 else 0.0 for c in tok_cands], np.float64)
    n_cands_vocab = len(cands_counter)

    with np.errstate(divide="ignore", invalid="ignore"):
        corpus = {
            "sent_len.cands": float(len_cands.mean()),
            "sent_len.mrefs": float(len_mrefs.mean()),
            "sent_len.ratio": float(len_ratios.mean()),
            "vocab_len.cands": float(n_cands_vocab),
            "vocab_len.mrefs_full": float(len(mrefs_counter)),
            # unguarded divisions, like the reference's torch tensors
            # (text_stats.py:58-88): 0-denominators yield inf/nan
            "vocab_len.ratio_full": float(
                np.float64(n_cands_vocab) / np.float64(len(mrefs_counter))
            ),
            "vocab_len.mrefs_avg": vocab_len_mrefs_avg,
            "vocab_len.ratio_avg": float(
                np.float64(n_cands_vocab) / np.float64(vocab_len_mrefs_avg)
            ),
            "vocab_coverage": float(vocab_coverage),
            "vocab_in_ref_len": vocab_in_ref_len,
            "vocab_in_ref_ratio": float(
                np.float64(vocab_in_ref_len) / np.float64(n_cands_vocab)
            ),
            "empty_sents": float(empty.mean()),
            "sent_len.cands.min": float(len_cands.min()),
            "sent_len.cands.max": float(len_cands.max()),
        }
    sents = {
        # reference per-sentence CSV quirk: underscored "sent_len_cands"
        "sent_len_cands": len_cands.tolist(),
        "sent_len.mrefs": len_mrefs.tolist(),
        "sent_len.ratio": len_ratios.tolist(),
        "empty_sents": empty.tolist(),
    }
    return corpus, sents


def new_words(
    candidates: Sequence,
    mult_references: Sequence[Sequence] | None = None,
    *,
    train_vocab: Iterable[str] = (),
    tokenizer: Callable[[str], list[str]] = str.split,
) -> tuple[dict[str, float], dict[str, list[float]]]:
    """Unique candidate tokens outside the train vocab; corpus = mean of
    per-sentence counts (reference new_words.py:16-42). ``mult_references``
    exists for reference signature parity and is unused (the reference
    ignores it too, new_words.py:24-26); ``train_vocab`` is keyword-only so
    a legacy positional call cannot silently bind it there."""
    tok_cands, _ = _tokenize_all(candidates, None, tokenizer)
    vocab = set(train_vocab)
    counts = [float(len(set(c) - vocab)) for c in tok_cands]
    mean = float(np.mean(counts)) if counts else 0.0
    return {"new_words": mean}, {"new_words": counts}
