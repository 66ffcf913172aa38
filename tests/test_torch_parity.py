"""The port's ``parity.py`` (a copy under the copy rule) against
conette_tpu's on a run's own evaluator CSV, as
``tests/test_own_outputs_roundtrip.py`` holds the JAX module: the CSV that
the port's ``Evaluator`` writes, read by both modules, gives equal rows, id
maps, decoded candidates and offline scores. No published reference output
is read."""

import dataclasses
import os
import shutil

import pytest

from conette_tpu import parity as jax_parity
from conette_torch import parity
from conette_torch.metrics import AllMetrics
from conette_torch.tokenization import AACTokenizer
from conette_torch.train.evaluation import Evaluator
from test_own_outputs_roundtrip import ALT_BEAMS, CANDS, MREFS


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    tok = AACTokenizer()
    tok.fit(CANDS + ALT_BEAMS + [r for refs in MREFS for r in refs])
    assert tok.token_to_id("<pad>") == parity.PAD_ID and tok.token_to_id("<eos>") == parity.EOS_ID

    def ids_of(sentences, pad_to=12):
        enc = tok.encode_batch(sentences, add_bos_eos=False, out_type="int")
        return [list(ids) + [parity.EOS_ID] + [parity.PAD_ID] * (pad_to - len(ids) - 1) for ids in enc]

    preds, alt = ids_of(CANDS), ids_of(ALT_BEAMS)
    mlprobs = [[-0.5 - i * 0.1, -0.9 - i * 0.1] for i in range(len(CANDS))]
    ev = Evaluator(out, model_name="best_fense",
                   metrics=AllMetrics(use_java=False, use_fense=False, use_bert_score=False))
    ev.add_batch(CANDS, MREFS, fnames=[f"clip_{i}.wav" for i in range(len(CANDS))],
                 dataset="clotho", subset="eval", lprobs=[r[0] for r in mlprobs], preds=preds,
                 mpreds=[[p, a] for p, a in zip(preds, alt)], mlprobs=mlprobs,
                 mcands=[[c, a] for c, a in zip(CANDS, ALT_BEAMS)],
                 losses=[[2.0 + i, 2.5 + i] for i in range(len(CANDS))])
    ev.compute_and_export()
    shutil.copy(os.path.join(out, "best_fense_outputs_clotho_eval.csv"),
                os.path.join(out, "outputs_clotho_eval.csv"))
    return out


def test_rows_round_trip_as_in_jax(out_dir):
    rows = parity.load_rows("clotho_eval", dirpath=out_dir)
    want = jax_parity.load_rows("clotho_eval", dirpath=out_dir)
    assert [dataclasses.asdict(r) for r in rows] == [dataclasses.asdict(r) for r in want]
    assert [r.cands for r in rows] == CANDS and [r.mrefs for r in rows] == MREFS


def test_id_map_and_decoding_as_in_jax(out_dir):
    rows = parity.load_rows("clotho_eval", dirpath=out_dir)
    idmap, conflicts = parity.reconstruct_id_map(rows)
    assert (idmap, conflicts) == jax_parity.reconstruct_id_map(
        jax_parity.load_rows("clotho_eval", dirpath=out_dir))
    assert conflicts == []
    tok = parity.tokenizer_from_id_map(idmap)
    assert tok.decode_batch([r.preds for r in rows]) == CANDS


def test_offline_scores_as_in_jax(out_dir):
    rows = parity.load_rows("clotho_eval", dirpath=out_dir)
    corpus, sents = parity.compute_offline_corpus_scores(rows)
    want_corpus, want_sents = jax_parity.compute_offline_corpus_scores(
        jax_parity.load_rows("clotho_eval", dirpath=out_dir))
    assert {"bleu_1", "bleu_4", "rouge_l", "cider_d"} <= corpus.keys()
    assert corpus == want_corpus
    assert {k: list(v) for k, v in sents.items()} == {k: list(v) for k, v in want_sents.items()}
    for i, row in enumerate(rows):  # the CSV's own per-sentence scores, recomputed
        assert row.sent_scores["cider_d"] == pytest.approx(sents["cider_d"][i], abs=1e-6)


def test_default_outputs_dir_is_the_jax_modules():
    assert parity.DEFAULT_OUTPUTS_DIR == jax_parity.DEFAULT_OUTPUTS_DIR
