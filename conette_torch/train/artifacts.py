"""End-of-run artifacts: phase 6/6 of ``conette-train``.

Counterpart of ``conette_torch/train/artifacts.py`` (the reference's
``StatsSaver`` and teardown, ``src/conette/train.py:501-523``): the
tokenizer and vocabulary CSV, parameter count, csums, durations, and the
sweep ``out_crit`` return value.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np

pylog = logging.getLogger(__name__)


def save_vocab_csv(tokenizer, fpath: str) -> None:
    import csv

    with open(fpath, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["token", "id", "count"])
        for token, count in tokenizer.get_vocab().items():
            writer.writerow([token, tokenizer.token_to_id(token), count])


def finalize_run(
    *,
    cfg: Any,
    run_dir: str,
    logger,
    tokenizer,
    params,
    ckpt,
    monitor: str,
    t_start: float,
) -> float:
    """Write tokenizer/vocab artifacts, final hyperparams/metrics, and
    return the sweep output criterion (reference train.py:515-521)."""
    from conette_torch.utils.csum import csum_module
    from conette_torch.weights import named_leaves

    tokenizer.save_file(os.path.join(run_dir, "tokenizer.json"))
    save_vocab_csv(tokenizer, os.path.join(run_dir, "vocab.csv"))
    logger.log_hyperparams(
        {
            "end_csum": csum_module(params),
            "n_params": int(sum(np.prod(p.shape) for _, p in named_leaves(params))),
            "total_duration_s": round(time.time() - t_start, 1),
            "best_monitor": ckpt.best_score,
            "best_ckpt": ckpt.best_dir,
        }
    )
    logger.finalize()
    # sweep output criterion (reference train.py:515-521): return the
    # logged metric named by out_crit, or out_default when absent/unset
    out_crit = cfg.get("out_crit")
    out_default = float(cfg.get("out_default", -1.0))
    if out_crit is not None:
        out = float(logger.metrics.get(str(out_crit), out_default))
        pylog.info(f"Training is finished with {out_crit}={out}.")
    else:
        out = out_default
    pylog.info(
        f"Done: best {monitor}={ckpt.best_score} "
        f"({time.time() - t_start:.0f}s, run dir {run_dir})"
    )
    return out
