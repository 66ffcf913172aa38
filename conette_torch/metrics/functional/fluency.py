"""Fluency-error checker (the FENSE "echecker") — gated model wrapper.

Twin of the disfluency classifier the reference uses inside FENSE /
SPIDEr-FL (via aac-metrics; the published artifacts carry its outputs as
the ``fer.*`` columns of ``outputs_*.csv`` / ``scores_*.yaml``). The
checker is a BERT encoder + linear head over the [CLS] token emitting six
sigmoid probabilities, one per error type plus an overall ``error`` head:

    (add_tail, repeat_event, repeat_adv, remove_conj, remove_verb, error)

A sentence is flagged disfluent when ``error_prob > 0.9`` (the published
``fer`` column is exactly ``float(error_prob > 0.9)`` — verified offline
in ``tests/test_reference_parity.py``), and FENSE multiplies the SBERT
similarity by ``(1 - 0.9)`` for flagged sentences.

The model weights ("echecker_clotho_audiocaps_base") need a one-time
download; on egress-less hosts ``echecker_available()`` is False and
callers fall back (with a loud warning — ``fense`` without the penalty is
just ``sbert_sim``). Configuration:

* ``CONETTE_ECHECKER_MODEL`` — path to either a fense-style ``.ckpt``
  (torch state dict, optionally wrapped in a dict with ``state_dict`` /
  ``model_type`` / ``num_classes`` keys) or a HF
  ``AutoModelForSequenceClassification`` directory with 6 labels;
* ``CONETTE_ECHECKER_TOKENIZER`` — optional tokenizer override (defaults
  to the model's ``model_type`` / directory).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Sequence

import numpy as np

pylog = logging.getLogger(__name__)

ERROR_NAMES = (
    "add_tail",
    "repeat_event",
    "repeat_adv",
    "remove_conj",
    "remove_verb",
    "error",
)

#: error_prob > threshold => sentence is disfluent (fer = 1.0)
ERROR_THRESHOLD = 0.9

#: callable(list[str]) -> {f"{name}_prob": np.ndarray} for name in ERROR_NAMES
FluencyFn = Callable[[Sequence[str]], dict[str, np.ndarray]]

_CACHE: dict[str, Any] = {}


def _load_fense_ckpt(path: str) -> Any:
    """Build encoder+head from a fense-style torch checkpoint."""
    import torch
    from transformers import AutoModel

    raw = torch.load(path, map_location="cpu", weights_only=False)
    state = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    model_type = (
        raw.get("model_type", "bert-base-uncased")
        if isinstance(raw, dict)
        else "bert-base-uncased"
    )
    encoder = AutoModel.from_pretrained(model_type)
    hidden = encoder.config.hidden_size
    clf = torch.nn.Linear(hidden, len(ERROR_NAMES))
    enc_state = {
        k.removeprefix("encoder."): v
        for k, v in state.items()
        if k.startswith("encoder.")
    }
    clf_state = {
        k.removeprefix("clf."): v for k, v in state.items() if k.startswith("clf.")
    }
    encoder.load_state_dict(enc_state)
    clf.load_state_dict(clf_state)
    encoder.eval()
    clf.eval()
    return model_type, encoder, clf


class Echecker:
    """BERT [CLS] classifier → per-error-type sigmoid probabilities."""

    def __init__(self, model_path: str, tokenizer_name: str | None = None) -> None:
        import torch
        from transformers import (
            AutoModelForSequenceClassification,
            AutoTokenizer,
        )

        self._torch = torch
        if os.path.isfile(model_path):
            model_type, self.encoder, self.clf = _load_fense_ckpt(model_path)
            self.seq_clf = None
            tok_src = tokenizer_name or model_type
        else:
            self.seq_clf = AutoModelForSequenceClassification.from_pretrained(
                model_path
            ).eval()
            self.encoder = self.clf = None
            tok_src = tokenizer_name or model_path
        self.tokenizer = AutoTokenizer.from_pretrained(tok_src)

    def __call__(
        self, sentences: Sequence[str], batch_size: int = 32
    ) -> dict[str, np.ndarray]:
        torch = self._torch
        logits_all: list[np.ndarray] = []
        with torch.no_grad():
            for i in range(0, len(sentences), batch_size):
                batch = list(sentences[i : i + batch_size])
                enc = self.tokenizer(
                    batch, padding=True, truncation=True, return_tensors="pt"
                )
                if self.seq_clf is not None:
                    logits = self.seq_clf(**enc).logits
                else:
                    hidden = self.encoder(**enc)[0][:, 0, :]
                    logits = self.clf(hidden)
                logits_all.append(logits.float().cpu().numpy())
        probs = 1.0 / (1.0 + np.exp(-np.concatenate(logits_all, axis=0)))
        return {
            f"{name}_prob": probs[:, j] for j, name in enumerate(ERROR_NAMES)
        }


def load_echecker() -> Echecker | None:
    """Env-gated singleton; None when no model is staged/loadable."""
    if "echecker" in _CACHE:
        return _CACHE["echecker"]
    path = os.environ.get("CONETTE_ECHECKER_MODEL")
    checker = None
    if path:
        try:
            checker = Echecker(path, os.environ.get("CONETTE_ECHECKER_TOKENIZER"))
        except Exception as err:
            pylog.warning(f"echecker unavailable (load failed: {err})")
    _CACHE["echecker"] = checker
    return checker


def echecker_available() -> bool:
    return load_echecker() is not None


def fluency_outputs(
    probs: dict[str, np.ndarray], threshold: float = ERROR_THRESHOLD
) -> tuple[dict[str, float], dict[str, list[float]]]:
    """probs → (corpus, per-sentence) under the reference's ``fer.*`` key
    names: per-type mean probabilities plus the binary ``fer`` flag."""
    fer = (np.asarray(probs["error_prob"]) > threshold).astype(np.float64)
    corpus: dict[str, float] = {}
    sents: dict[str, list[float]] = {}
    for name in ERROR_NAMES:
        key = f"fer.{name}_prob"
        vals = np.asarray(probs[f"{name}_prob"], np.float64)
        corpus[key] = float(vals.mean())
        sents[key] = vals.tolist()
    corpus["fer"] = float(fer.mean())
    sents["fer"] = fer.tolist()
    return corpus, sents
