"""Run setup: phase 1/6 of ``conette-train``.

Counterpart of ``conette_tpu/train/run_setup.py`` (the reference's
``setup_run``, ``src/conette/train.py:58-146``): logging, seed, run-dir
naming from the CLI overrides (the get_tag/get_subtag idiom), the
``RunLogger`` and the code snapshot. ``debug=true`` turns on
``torch.autograd.set_detect_anomaly``, the reference's own
``detect_anomaly`` (the JAX package's ``jax_debug_nans``). One process
only: a launch over several (``WORLD_SIZE`` or ``SLURM_NTASKS`` > 1) raises
until multi-GPU training is ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Any, NamedTuple

pylog = logging.getLogger(__name__)


def _sanitize_tag(s: str) -> str:
    return (
        s.replace("/", "_").replace("=", "_")
        .replace("[", "").replace("]", "").replace(" ", "")
    )


def run_tag(cfg: Any, argv: list[str]) -> str:
    """Run-dir tag — twin of the reference's get_tag/get_subtag hydra
    resolvers (utils/hydra.py:47-126): explicit ``tagk`` keys (possibly
    dotted) join their config values (NOTAG when all empty); otherwise the
    tag derives from the CLI overrides (the sweep-override auto-detection
    of get_subtag_fn, adapted to the flat CLI); ``pretag``/``posttag``
    affixes; sanitized and capped at 80 chars."""
    tagk = cfg.get("tagk") or []
    if isinstance(tagk, str) and tagk != "auto":
        tagk = [tagk]
    if tagk and tagk != "auto":
        vals = [cfg.get_path(str(k)) for k in tagk]
        tag = (
            "-".join(
                _sanitize_tag(str(v)) for v in vals if v not in (None, "")
            )
            or "NOTAG"
        )
    else:
        tag = "-".join(
            _sanitize_tag(a)
            for a in argv
            if not a.startswith(("log_root", "run_name", "dm.hdf_root"))
        )
    pretag = _sanitize_tag(str(cfg.get("pretag", "") or ""))
    posttag = _sanitize_tag(str(cfg.get("posttag", "") or ""))
    if pretag and not pretag.endswith("-"):
        pretag += "-"
    if posttag and not posttag.startswith("-"):
        posttag = "-" + posttag
    return f"{pretag}{tag}{posttag}"[:80]


class RunSetup(NamedTuple):
    run_dir: str
    logger: Any  # RunLogger
    seed: int
    t_start: float


def setup_run(cfg: Any, argv: list[str]) -> RunSetup:
    """Logging → seed → run dir → artifact logger, in the reference's
    phase-1 order."""
    import torch

    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        if int(os.environ.get(var, "1") or 1) > 1:
            raise NotImplementedError(
                f"{var}={os.environ[var]}: conette_torch trains in one process on one "
                "card; multi-process training waits for ROADMAP Queue 1 item 9")

    from conette_torch.utils.log_utils import setup_job_logging

    setup_job_logging(verbose=int(cfg.get("verbose", 1)))

    if cfg.get("debug"):
        torch.autograd.set_detect_anomaly(True)

    seed = int(cfg.get("seed", 1234))
    tag = run_tag(cfg, argv)
    stamp = datetime.datetime.fromtimestamp(time.time()).strftime("%Y.%m.%d-%H.%M.%S")
    run_name = cfg.get("run_name") or (
        f"{cfg.get('job', 'train')}-" + stamp + (f"-{tag}" if tag else "")
    )
    run_dir = os.path.join(cfg.get("log_root", "logs"), run_name)
    os.makedirs(run_dir, exist_ok=True)
    # re-attach with the run-dir file handler (logs/outputs.log twin)
    setup_job_logging(run_dir=run_dir, verbose=int(cfg.get("verbose", 1)))

    from conette_torch.utils.misc import (
        get_current_git_hash,
        reset_seed,
        save_code_to_zip,
    )
    from conette_torch.utils.run_logger import RunLogger

    reset_seed(seed)
    logger = RunLogger(run_dir)
    logger.log_hyperparams(
        {"cfg": dict(cfg), "seed": seed, "git_hash": get_current_git_hash()}
    )
    try:
        save_code_to_zip(os.path.join(run_dir, "code.zip"))
    except Exception as err:
        pylog.warning(f"code snapshot failed: {err}")
    return RunSetup(run_dir, logger, seed, time.time())
