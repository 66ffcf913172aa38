"""Validation-epoch metrics + test-corpus evaluation.

Twins of the reference callbacks:
- ``Validator`` ≙ ``AACValidator`` (``callbacks/aac_validator.py:18-228``):
  collects candidates/references over a val epoch, computes CIDEr-D,
  diversity and text stats (+FENSE when available and monitored) at epoch
  end;
- ``Evaluator`` ≙ ``AACEvaluator`` (``callbacks/aac_evaluator.py:33-525``):
  accumulates all test-batch outputs on host, derives the
  ``{dataset}_{subset}`` corpus name, re-tokenizes with the metric
  tokenizer, runs ``AllMetrics``, writes per-sentence CSV outputs and the
  optional DCASE task6a submission, and prints one random qualitative
  example.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Any, Sequence

from conette_torch.metrics import AllMetrics
from conette_torch.metrics.functional.cider_d import cider_d
from conette_torch.metrics.functional.diversity import diversity, text_stats
from conette_torch.metrics.functional import fense as fense_mod
from conette_torch.utils.dcase import export_outputs_csv, export_to_dcase_task6a_csv

pylog = logging.getLogger(__name__)


def make_metric_tokenizer():
    """Metric-time tokenizer (twin of the reference's PTB test tokenizer,
    ``tokenizers/ptb.py:14-51``): prefers the Java PTB backend when its jar
    is available, else the normalizing regex backend — both lowercase,
    strip punctuation and split contractions the PTB way on caption text."""
    from conette_torch.tokenization.word_tokenizers import (
        RegexWordTokenizer,
        word_tokenizer_factory,
    )
    from conette_torch.tokenization.normalizers import get_pre_encoding_normalizers

    try:
        wt = word_tokenizer_factory(backend="ptb")
    except Exception:
        wt = RegexWordTokenizer()
    normalizers = get_pre_encoding_normalizers(lowercase=True, punctuation_mode="remove")

    def tokenize(sentences):
        out = list(sentences)
        for n in normalizers:
            out = n.normalize_batch(out)
        return wt.tokenize_batch(out)

    return tokenize


class Validator:
    def __init__(self, monitors: Sequence[str] = ("val/cider_d",)) -> None:
        self.monitors = list(monitors)
        self.reset()

    def reset(self) -> None:
        self._cands: list[str] = []
        self._mrefs: list[list[str]] = []

    def add_batch(self, cands: Sequence[str], mrefs: Sequence[Sequence[str]]) -> None:
        self._cands.extend(cands)
        self._mrefs.extend([list(r) for r in mrefs])

    def compute(self) -> dict[str, float]:
        if not self._cands:
            return {}
        cand_toks = [c.split() for c in self._cands]
        ref_toks = [[r.split() for r in refs] for refs in self._mrefs]
        scores: dict[str, float] = {}
        scores["val/cider_d"] = cider_d(cand_toks, ref_toks)["cider_d"]
        div_corpus, _ = diversity(cand_toks, ref_toks, n_max=1)
        ts_corpus, _ = text_stats(cand_toks, ref_toks)
        scores |= {f"val/{k}": v for k, v in div_corpus.items()}
        scores |= {f"val/{k}": v for k, v in ts_corpus.items()}
        if any("fense" in m for m in self.monitors) and fense_mod.is_available():
            try:
                scores["val/fense"] = fense_mod.fense(self._cands, self._mrefs)["fense"]
            except Exception as err:
                pylog.warning(f"val FENSE failed: {err}")
        return scores


class Evaluator:
    # corpora the reference skips scoring for (aac_evaluator.py:79-84)
    SKIP_CORPORA = ("audiocaps_train", "clotho_test", "clotho_analysis")

    def __init__(
        self,
        out_dir: str,
        model_name: str = "model",
        metrics: AllMetrics | None = None,
        export_dcase: bool = True,
        score: bool = True,
        seed: int = 1234,
    ) -> None:
        """``score=False`` turns this into the reference's PREDICT-epoch
        exporter (aac_evaluator.py:106-128): outputs CSVs are written with
        no metric columns for every corpus — caption-less prediction
        corpora (clotho_test DCASE submissions) have nothing to score."""
        self.out_dir = out_dir
        self.model_name = model_name
        self.metrics = metrics or (
            AllMetrics(use_java=True, use_fense=True) if score else None
        )
        self.export_dcase = export_dcase
        self.score = score
        self._rng = random.Random(seed)
        os.makedirs(out_dir, exist_ok=True)
        self.reset()

    def reset(self) -> None:
        self._rows: list[dict[str, Any]] = []

    def set_model_name(self, name: str) -> None:
        self.model_name = name

    def add_batch(
        self,
        cands: Sequence[str],
        mrefs: Sequence[Sequence[str]],
        *,
        fnames: Sequence[str] | None = None,
        dataset: str = "unknown",
        subset: str = "test",
        lprobs: Sequence[float] | None = None,
        preds: Any = None,
        mpreds: Any = None,
        mlprobs: Any = None,
        mcands: Sequence[Sequence[str]] | None = None,
        losses: Sequence[Sequence[float]] | None = None,
    ) -> None:
        """``preds``/``mpreds``/``mlprobs``/``mcands``/``losses`` are the
        reference's extra per-clip columns (token ids of the best beam /
        all beams, all-beam avg lprobs, all-beam decodes, per-reference
        forced losses — the ``outputs_*.csv`` schema the published
        detailed_outputs use); optional for callers that only score."""

        def opt(seq, i):
            if seq is None:
                return None
            v = seq[i]
            return v.tolist() if hasattr(v, "tolist") else v

        for i, (cand, refs) in enumerate(zip(cands, mrefs)):
            self._rows.append(
                {
                    "fname": fnames[i] if fnames is not None else str(len(self._rows)),
                    "candidate": cand,
                    "references": list(refs),
                    "dataset": dataset,
                    "subset": subset,
                    "lprob": float(lprobs[i]) if lprobs is not None else None,
                    "preds": opt(preds, i),
                    "mpreds": opt(mpreds, i),
                    "mlprobs": opt(mlprobs, i),
                    "mcands": list(mcands[i]) if mcands is not None else None,
                    "losses": opt(losses, i),
                }
            )

    def compute_and_export(self) -> dict[str, dict[str, float]]:
        """→ {corpus_name: corpus_scores}; writes CSV artifacts per corpus."""
        by_corpus: dict[str, list[dict]] = {}
        for row in self._rows:
            name = f"{row['dataset']}_{row['subset']}"
            by_corpus.setdefault(name, []).append(row)

        all_scores: dict[str, dict[str, float]] = {}
        for corpus_name, rows in by_corpus.items():
            cands = [r["candidate"] for r in rows]
            mrefs = [r["references"] for r in rows]

            if self.score and corpus_name not in self.SKIP_CORPORA:
                corpus_scores, sent_scores = self.metrics(cands, mrefs)
                all_scores[corpus_name] = corpus_scores
                # one random qualitative example (aac_evaluator.py:407-464)
                ex = self._rng.choice(rows)
                pylog.info(
                    f"[{corpus_name}] example — cand: {ex['candidate']!r} "
                    f"refs: {ex['references'][:2]!r}"
                )
            else:
                corpus_scores, sent_scores = {}, {}
                pylog.info(f"Skipping scoring for corpus {corpus_name}")

            # reference outputs_*.csv schema (aac_evaluator.py:466-497 /
            # the published detailed_outputs): token/beam/loss columns
            # first, then "{model}.cands.{metric}" per-sentence scores —
            # so a run's own artifacts round-trip through the same parity
            # tooling that validates the published ones
            csv_rows = []
            for i, row in enumerate(rows):
                out_row = {
                    "losses": row["losses"],
                    "preds": row["preds"],
                    "lprobs": row["lprob"],
                    "mpreds": row["mpreds"],
                    "mlprobs": row["mlprobs"],
                    "cands": row["candidate"],
                    "mcands": row["mcands"],
                    "mrefs": row["references"],
                    "fname": row["fname"],
                    "index": i,
                    "dataset": row["dataset"],
                    "subset": row["subset"],
                }
                for k, vals in sent_scores.items():
                    out_row[f"{self.model_name}.cands.{k}"] = vals[i]
                csv_rows.append(out_row)
            export_outputs_csv(
                os.path.join(
                    self.out_dir, f"{self.model_name}_outputs_{corpus_name}.csv"
                ),
                csv_rows,
            )
            if self.export_dcase:
                export_to_dcase_task6a_csv(
                    os.path.join(
                        self.out_dir,
                        f"submission_output_{self.model_name}_{corpus_name}.csv",
                    ),
                    [r["fname"] for r in rows],
                    cands,
                )
        return all_scores
