"""DCASE task-6a submission CSV exporters
(twin of ``src/conette/utils/dcase.py:17-61``)."""

from __future__ import annotations

import csv
from typing import Sequence


def export_to_dcase_task6a_csv(
    fpath: str,
    fnames: Sequence[str],
    candidates: Sequence[str],
) -> None:
    """Writes the task6a submission format: file_name,caption_predicted."""
    if len(fnames) != len(candidates):
        raise ValueError(f"{len(fnames)=} != {len(candidates)=}")
    with open(fpath, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["file_name", "caption_predicted"])
        writer.writeheader()
        for fname, cand in zip(fnames, candidates):
            writer.writerow({"file_name": fname, "caption_predicted": cand})


def export_outputs_csv(
    fpath: str,
    rows: Sequence[dict],
    fieldnames: Sequence[str] | None = None,
) -> None:
    """Per-sentence outputs CSV (twin of the ``AACEvaluator`` CSV artifact,
    ``callbacks/aac_evaluator.py:466-497``)."""
    if not rows:
        return
    if fieldnames is None:
        fieldnames = list(rows[0].keys())
    with open(fpath, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(rows)
