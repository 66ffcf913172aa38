"""Offline parity harness against the reference's published outputs.

Counterpart of ``conette_tpu/parity.py``, a copy of its code (pure Python;
its lazy imports read the port's ``tokenization/`` and
``metrics/functional/``). The reference ships per-clip eval artifacts for
the released checkpoint (``results/detailed_outputs/outputs_{clotho_eval,
audiocaps_test}.csv`` and ``scores_*.yaml``): decoded token ids, candidate
strings, references, per-sentence and corpus scores. They allow two
offline proofs that need no model weights:

1. **Metric-stack parity**: the published ``cands``/``mrefs`` through the
   pure-Python BLEU1-4 / ROUGE-L / CIDEr-D reproduce the published corpus
   scores and per-sentence columns.
2. **Detokenizer parity**: the checkpoint's id → token map rebuilt from the
   (preds, cands) pairs, and ``AACTokenizer.decode_batch`` with the
   post-normalizers reproduces every candidate string.

The artifacts are read from ``DEFAULT_OUTPUTS_DIR`` (the reference
checkout's ``results/detailed_outputs``) or ``CONETTE_REFERENCE_OUTPUTS``;
they are produced by the reference's ``callbacks/aac_evaluator.py:466-497``.
"""

from __future__ import annotations

import ast
import csv
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

PAD_ID, BOS_ID, EOS_ID, UNK_ID = 0, 1, 2, 3

DEFAULT_OUTPUTS_DIR = os.path.join(os.sep, "root", "reference", "results", "detailed_outputs")

#: dataset key -> (outputs csv, scores yaml, row count)
DATASETS = {
    "clotho_eval": ("outputs_clotho_eval.csv", "scores_clotho_eval.yaml", 1045),
    "audiocaps_test": ("outputs_audiocaps_test.csv", "scores_audiocaps_test.yaml", 912),
}

#: corpus metrics computable fully offline (no Java jars / SBERT weights)
OFFLINE_CORPUS_METRICS = (
    "bleu_1", "bleu_2", "bleu_3", "bleu_4", "rouge_l", "cider_d",
    # diversity family (n=1..3; corpus mrefs uses the seeded subsample
    # stream, reproduced bit-exactly via torch.Generator(123))
    *(
        f"{fam}{n}.{part}"
        for n in (1, 2, 3)
        for fam in ("sents_div", "corpus_div")
        for part in ("cands", "mrefs", "ratio")
    ),
    # text-stats family
    "sent_len.cands", "sent_len.mrefs", "sent_len.ratio",
    "sent_len.cands.min", "sent_len.cands.max",
    "vocab_len.cands", "vocab_len.mrefs_full", "vocab_len.ratio_full",
    "vocab_len.mrefs_avg", "vocab_len.ratio_avg",
    "vocab_coverage", "vocab_in_ref_len", "vocab_in_ref_ratio",
    "empty_sents",
    # new-words (train vocab == the reconstructed released-ckpt vocab)
    "new_words",
)

#: per-sentence metrics validated against the published CSV columns
#: (name here == CSV column suffix; note the reference's underscored
#: ``sent_len_cands`` quirk)
OFFLINE_SENT_METRICS = (
    "cider_d", "rouge_l",
    "bleu_1", "bleu_2", "bleu_3", "bleu_4",
    *(
        f"sents_div{n}.{part}"
        for n in (1, 2, 3)
        for part in ("cands", "mrefs", "ratio")
    ),
    "sent_len_cands", "sent_len.mrefs", "sent_len.ratio",
    "empty_sents", "new_words",
)


def outputs_dir() -> str:
    """Fixture directory; override with ``CONETTE_REFERENCE_OUTPUTS``."""
    return os.environ.get("CONETTE_REFERENCE_OUTPUTS", DEFAULT_OUTPUTS_DIR)


def available() -> bool:
    d = outputs_dir()
    return all(os.path.isfile(os.path.join(d, f)) for f, _, _ in DATASETS.values())


@dataclass
class ReferenceRow:
    """One clip of the released checkpoint's eval output."""

    fname: str
    preds: list[int]  # best-beam token ids (no BOS; EOS then PAD tail)
    cands: str  # best-beam decoded candidate
    mpreds: list[list[int]]  # all beams token ids
    mcands: list[str]  # all beams decoded
    mrefs: list[str]  # ground-truth references
    lprobs: float
    sent_scores: dict[str, float] = field(default_factory=dict)


def load_rows(dataset: str, dirpath: str | None = None) -> list[ReferenceRow]:
    csv_name, _, _ = DATASETS[dataset]
    path = os.path.join(dirpath or outputs_dir(), csv_name)
    rows: list[ReferenceRow] = []
    prefix = "best_fense.cands."
    with open(path, newline="") as file:
        for raw in csv.DictReader(file):
            sent_scores = {
                k.removeprefix(prefix): float(v)
                for k, v in raw.items()
                if k.startswith(prefix) and _is_float(v)
            }
            rows.append(
                ReferenceRow(
                    fname=raw["fname"],
                    preds=[int(t) for t in ast.literal_eval(raw["preds"])],
                    cands=raw["cands"],
                    mpreds=[
                        [int(t) for t in beam]
                        for beam in ast.literal_eval(raw["mpreds"])
                    ],
                    mcands=list(ast.literal_eval(raw["mcands"])),
                    mrefs=list(ast.literal_eval(raw["mrefs"])),
                    lprobs=float(raw["lprobs"]),
                    sent_scores=sent_scores,
                )
            )
    return rows


def load_corpus_scores(dataset: str, dirpath: str | None = None) -> dict[str, float]:
    """Published corpus scores, keyed by short metric name (bleu_1, cider_d, …)."""
    import yaml

    _, yaml_name, _ = DATASETS[dataset]
    path = os.path.join(dirpath or outputs_dir(), yaml_name)
    with open(path) as file:
        raw: Mapping[str, Any] = yaml.safe_load(file)
    out: dict[str, float] = {}
    for key, value in raw.items():
        # keys look like "clotho_eval/best_fense.cands.sents_div1.cands":
        # strip "{corpus}/best_fense.cands." and keep the full metric name
        short = key.split("/", 1)[-1].removeprefix("best_fense.cands.")
        if isinstance(value, (int, float)):
            out[short] = float(value)
    return out


def iter_pred_cand_pairs(
    rows: Sequence[ReferenceRow],
) -> Iterator[tuple[list[int], str]]:
    """All (token ids, decoded string) pairs: best beam + every beam."""
    for row in rows:
        yield row.preds, row.cands
        for preds, cand in zip(row.mpreds, row.mcands):
            yield preds, cand


def reconstruct_id_map(
    rows: Sequence[ReferenceRow],
) -> tuple[dict[int, str], list[tuple[int, str, str]]]:
    """Rebuild the released checkpoint's id->token map from (preds, cands)
    pairs. `preds` holds content-token ids aligned 1:1 with the whitespace
    words of `cands`, followed by EOS then PAD (verified: zero length
    mismatches over both datasets). Returns (idmap, conflicts)."""
    idmap: dict[int, str] = {
        PAD_ID: "<pad>",
        BOS_ID: "<bos>",
        EOS_ID: "<eos>",
        UNK_ID: "<unk>",
    }
    conflicts: list[tuple[int, str, str]] = []
    for preds, cand in iter_pred_cand_pairs(rows):
        words = cand.split()
        core = [t for t in preds if t not in (PAD_ID, EOS_ID)]
        if len(core) != len(words):
            raise ValueError(
                f"preds/cands length mismatch: {len(core)} ids vs "
                f"{len(words)} words for {cand!r}"
            )
        for token_id, word in zip(core, words):
            seen = idmap.get(token_id)
            if seen is not None and seen != word:
                conflicts.append((token_id, seen, word))
            idmap[token_id] = word
    return idmap, conflicts


def tokenizer_from_id_map(idmap: Mapping[int, str]):
    """Build an AACTokenizer whose vocab is the reconstructed id map (sparse
    ids are fine: decode only walks `itos`)."""
    from conette_torch.tokenization.aac_tokenizer import AACTokenizer

    state = {
        "_type_": "txt",
        "_version_": AACTokenizer.VERSION,
        "tokenizer": {
            "hparams": {
                "level": "word",
                "lowercase": True,
                "punctuation_mode": "remove",
                "normalize": True,
                "backend": "regex",
            },
            "normalize": True,
            "added_special_tokens": [],
            "max_sentence_size": 20,
            "min_sentence_size": 1,
            "n_sentences_fit": 1,
            "itos": dict(idmap),
            "stoi": {tok: i for i, tok in idmap.items()},
            "vocab": {tok: 1 for tok in idmap.values()},
        },
    }
    return AACTokenizer.from_txt_state(state)


def compute_offline_corpus_scores(
    rows: Sequence[ReferenceRow],
) -> tuple[dict[str, float], dict[str, list[float]]]:
    """The FULL offline scorecard over the published cands/mrefs: corpus +
    per-sentence BLEU1-4 / ROUGE-L / CIDEr-D, the diversity family (n=1..3
    incl. the seeded corpus-mrefs subsample), text stats, and new-words
    against the reconstructed released-checkpoint vocab. The published
    numbers were computed on PTB-tokenized text; the candidates/references
    in the CSVs are already normalized (lowercase, punctuation-free), where
    PTB tokenization == whitespace split."""
    from conette_torch.metrics.functional.bleu import bleu
    from conette_torch.metrics.functional.cider_d import cider_d
    from conette_torch.metrics.functional.diversity import (
        diversity,
        new_words,
        text_stats,
    )
    from conette_torch.metrics.functional.rouge_l import rouge_l

    cands = [row.cands.split() for row in rows]
    mrefs = [[ref.split() for ref in row.mrefs] for row in rows]

    bl = bleu(cands, mrefs)
    corpus: dict[str, float] = {
        k: v for k, v in bl.items() if not k.endswith("_sents")
    }
    sents: dict[str, list[float]] = {
        k.removesuffix("_sents"): list(v)
        for k, v in bl.items()
        if k.endswith("_sents")
    }
    rl = rouge_l(cands, mrefs)
    cd = cider_d(cands, mrefs)
    corpus["rouge_l"] = rl["rouge_l"]
    corpus["cider_d"] = cd["cider_d"]
    sents["rouge_l"] = list(rl["rouge_l_sents"])
    sents["cider_d"] = list(cd["cider_d_sents"])

    div_c, div_s = diversity(cands, mrefs, n_max=3)
    ts_c, ts_s = text_stats(cands, mrefs)
    corpus |= div_c | ts_c
    sents |= div_s | ts_s

    # the train vocab is not shipped, but the reconstructed released-ckpt
    # vocab is a faithful stand-in: every emitted word has a token id, so
    # new_words must be 0.0 — which is exactly the published value
    idmap, _ = reconstruct_id_map(rows)
    nw_c, nw_s = new_words(cands, train_vocab=set(idmap.values()))
    corpus |= nw_c
    sents |= nw_s
    return corpus, sents


def _is_float(value: str) -> bool:
    try:
        float(value)
        return True
    except (TypeError, ValueError):
        return False
