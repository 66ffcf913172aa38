"""AudioSet class-index ↔ display-name mapping.

The reference downloads ``class_labels_indices.csv`` on first use
(``src/conette/transforms/audioset_mapping.py:28-107``). Hosts without
network access are common, so the mapping is resolved from (in order): an explicit path,
a ``class_labels_indices.csv``/``audioset_names.json`` file in the
checkpoint directory, the ``CONETTE_AUDIOSET_CSV`` env var, or a generic
``class_{idx}`` fallback.
"""

from __future__ import annotations

import csv
import json
import logging
import os

import numpy as np

pylog = logging.getLogger(__name__)

NUM_CLASSES = 527


def load_audioset_names(search_dirs: list[str] | None = None) -> list[str]:
    candidates: list[str] = []
    for d in search_dirs or []:
        candidates.append(os.path.join(d, "class_labels_indices.csv"))
        candidates.append(os.path.join(d, "audioset_names.json"))
    env = os.environ.get("CONETTE_AUDIOSET_CSV")
    if env:
        candidates.append(env)
    for path in candidates:
        if not os.path.isfile(path):
            continue
        try:
            if path.endswith(".json"):
                with open(path) as f:
                    names = json.load(f)
            else:
                with open(path) as f:
                    rows = list(csv.DictReader(f))
                names = [""] * NUM_CLASSES
                for row in rows:
                    names[int(row["index"])] = row["display_name"]
            if len(names) == NUM_CLASSES:
                return list(names)
            pylog.warning(f"Ignoring {path}: {len(names)} names != {NUM_CLASSES}")
        except Exception as err:
            pylog.warning(f"Could not parse AudioSet names from {path}: {err}")
    return [f"class_{i}" for i in range(NUM_CLASSES)]


def probs_to_names(
    probs: np.ndarray, threshold: float, idx_to_name: list[str]
) -> list[list[str]]:
    """Per-example tag names where prob > threshold, sorted by descending
    probability (reference ``probs_to_names`` contract)."""
    probs = np.asarray(probs)
    out: list[list[str]] = []
    for row in probs:
        idxs = np.where(row > threshold)[0]
        idxs = idxs[np.argsort(-row[idxs], kind="stable")]
        out.append([idx_to_name[int(i)] for i in idxs])
    return out
