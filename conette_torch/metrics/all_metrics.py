"""AllMetrics — corpus scoring orchestrator.

Twin of the reference ``AllMetrics``
(``src/conette/metrics/classes/all_metrics.py:29-178``): BLEU1-4, ROUGE-L,
CIDEr-D, METEOR (Java, gated), SPICE (Java, gated), SPIDEr, FENSE
(SBERT + echecker, gated), BERTScore (gated), SPIDEr-FL (post-hoc,
``spider × (1 − 0.9·fer)``), diversity, text stats and new-words — all
under the reference's key names (the published CSV/yaml column set) —
computing everything available in the environment and reporting what was
skipped.
"""

from __future__ import annotations

import logging
from typing import Callable, Sequence

from conette_torch.metrics.functional.bleu import bleu
from conette_torch.metrics.functional.cider_d import cider_d
from conette_torch.metrics.functional.diversity import diversity, new_words, text_stats
from conette_torch.metrics.functional import bert_score as bert_score_mod
from conette_torch.metrics.functional import fense as fense_mod
from conette_torch.metrics.functional import java_metrics
from conette_torch.metrics.functional.rouge_l import rouge_l

pylog = logging.getLogger(__name__)

Tokenizer = Callable[[Sequence[str]], list[list[str]]]


def _default_tokenizer(sentences: Sequence[str]) -> list[list[str]]:
    return [s.split() for s in sentences]


class AllMetrics:
    def __init__(
        self,
        tokenizer: Tokenizer | None = None,
        train_vocab: Sequence[str] | None = None,
        use_java: bool = True,
        use_fense: bool = True,
        use_bert_score: bool = True,
        max_bleu_n: int = 4,
    ) -> None:
        self.tokenizer = tokenizer or _default_tokenizer
        self.train_vocab = list(train_vocab) if train_vocab is not None else None
        self.use_java = use_java
        self.use_fense = use_fense
        self.use_bert_score = use_bert_score
        self.max_bleu_n = max_bleu_n

    def __call__(
        self,
        candidates: Sequence[str],
        mult_references: Sequence[Sequence[str]],
    ) -> tuple[dict[str, float], dict[str, list]]:
        """→ (corpus_scores, per_sentence_scores)."""
        cand_toks = self.tokenizer(list(candidates))
        ref_toks = [self.tokenizer(list(refs)) for refs in mult_references]

        corpus: dict[str, float] = {}
        sents: dict[str, list] = {}
        skipped: list[str] = []

        bl = bleu(cand_toks, ref_toks, self.max_bleu_n)
        corpus |= {k: v for k, v in bl.items() if not k.endswith("_sents")}
        sents |= {
            k.removesuffix("_sents"): list(v)
            for k, v in bl.items()
            if k.endswith("_sents")
        }

        r = rouge_l(cand_toks, ref_toks)
        corpus["rouge_l"] = r["rouge_l"]
        sents["rouge_l"] = r["rouge_l_sents"]

        c = cider_d(cand_toks, ref_toks)
        corpus["cider_d"] = c["cider_d"]
        sents["cider_d"] = c["cider_d_sents"]

        if self.use_java and java_metrics.meteor_available():
            try:
                m = java_metrics.meteor(list(candidates), mult_references)
                corpus["meteor"] = m["meteor"]
                sents["meteor"] = m["meteor_sents"]
            except Exception as err:
                pylog.warning(f"METEOR failed: {err}")
                skipped.append("meteor")
        else:
            skipped.append("meteor")

        if self.use_java and java_metrics.spice_available():
            try:
                s = java_metrics.spice(list(candidates), mult_references)
                corpus["spice"] = s["spice"]
                sents["spice"] = s["spice_sents"]
            except Exception as err:
                pylog.warning(f"SPICE failed: {err}")
                skipped.append("spice")
        else:
            skipped.append("spice")

        if "spice" in corpus:
            corpus["spider"] = (corpus["cider_d"] + corpus["spice"]) / 2.0
            sents["spider"] = [
                (cd + sp) / 2.0 for cd, sp in zip(sents["cider_d"], sents["spice"])
            ]
        else:
            skipped.append("spider")

        if self.use_fense and fense_mod.is_available():
            try:
                f = fense_mod.fense(list(candidates), mult_references)
                for k, v in f.items():
                    if k.endswith("_sents"):
                        sents[k.removesuffix("_sents")] = list(v)
                    else:
                        corpus[k] = v
            except Exception as err:
                pylog.warning(f"FENSE failed: {err}")
                skipped.append("fense")
        else:
            skipped.append("fense")

        if self.use_bert_score and bert_score_mod.is_available():
            try:
                bs = bert_score_mod.bert_score(list(candidates), mult_references)
                for k, v in bs.items():
                    if k.endswith("_sents"):
                        sents[k.removesuffix("_sents")] = list(v)
                    else:
                        corpus[k] = v
            except Exception as err:
                pylog.warning(f"BERTScore failed: {err}")
                skipped.append("bert_score")
        else:
            skipped.append("bert_score")

        # SPIDEr-FL post-hoc (reference all_metrics.py:155-171 /
        # _spider_fl_from_outputs): spider × (1 − 0.9·fer), corpus = mean
        if "spider" in sents and "fer" in sents:
            spider_fl = fense_mod.apply_fluency_penalty(
                sents["spider"], sents["fer"]
            )
            sents["spider_fl"] = spider_fl
            corpus["spider_fl"] = sum(spider_fl) / max(len(spider_fl), 1)
        else:
            skipped.append("spider_fl")

        # reference key names throughout (sents_div{n}.*, corpus_div{n}.*,
        # sent_len.*, vocab_len.*, new_words — all_metrics.py:78-90 wiring:
        # Diversity(n_max=3), TextStats, NewWords(train_vocab))
        div_c, div_s = diversity(cand_toks, ref_toks, n_max=3)
        ts_c, ts_s = text_stats(cand_toks, ref_toks)
        corpus |= div_c | ts_c
        sents |= div_s | ts_s
        if self.train_vocab is not None:
            nw_c, nw_s = new_words(cand_toks, train_vocab=self.train_vocab)
            corpus |= nw_c
            sents |= nw_s

        if skipped:
            pylog.info(f"Skipped unavailable metrics: {skipped}")
        corpus = {k: float(v) for k, v in corpus.items()}
        return corpus, sents
