"""Run-artifact logger.

Twin of the reference ``CustomTensorboardLogger``
(``src/conette/utils/custom_logger.py:21-153``) + ``StatsSaver``
(``callbacks/stats_saver.py:31-361``): accumulates hparams and metrics in
memory and flushes once at run end to ``hparams.yaml`` / ``metrics.yaml``
/ ``endfile.txt``, plus a step-level ``scalars.jsonl`` stream (the
TB-event-file replacement — host-agnostic, greppable, no TB dependency).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

pylog = logging.getLogger(__name__)


class RunLogger:
    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.hparams: dict[str, Any] = {}
        self.metrics: dict[str, Any] = {}
        self._scalars_path = os.path.join(log_dir, "scalars.jsonl")
        self._scalars_file = open(self._scalars_path, "a")
        self._start = time.time()

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self.hparams.update(params)

    def log_metrics(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        """Step-level scalars stream + last-value accumulation."""
        clean = {k: _to_py(v) for k, v in metrics.items()}
        self.metrics.update(clean)
        rec = {"step": step, "time": round(time.time() - self._start, 3)} | clean
        self._scalars_file.write(json.dumps(rec) + "\n")
        self._scalars_file.flush()

    def update_files(self) -> None:
        import yaml

        with open(os.path.join(self.log_dir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(_sanitize(self.hparams), f)
        with open(os.path.join(self.log_dir, "metrics.yaml"), "w") as f:
            yaml.safe_dump(_sanitize(self.metrics), f)

    def finalize(self, status: str = "success") -> None:
        self.update_files()
        self._scalars_file.close()
        with open(os.path.join(self.log_dir, "endfile.txt"), "w") as f:
            f.write(f"{status}\n")


def _to_py(v: Any) -> Any:
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:
            return str(v)
    return v


def _sanitize(d: Mapping[str, Any]) -> dict:
    out = {}
    for k, v in d.items():
        v = _to_py(v)
        if isinstance(v, (str, int, float, bool, type(None))):
            out[str(k)] = v
        elif isinstance(v, Mapping):
            out[str(k)] = _sanitize(v)
        elif isinstance(v, (list, tuple)):
            out[str(k)] = [_to_py(x) for x in v]
        else:
            out[str(k)] = str(v)
    return out
