"""Console + run-dir logging setup.

Twin of the reference's job-logging stack: the colorlog console formatter
and per-run ``logs/outputs.log`` file handler configured by
``conf/hydra/job_logging/custom.yaml`` (reference
``src/conf/hydra/job_logging/custom.yaml``, ``utils/log_utils.py:17-104``,
and the rank-tagged formatter in ``train.py:70-84``). The YAML here is the
single source for the format string / filename so the config surface stays
hydra-shaped.
"""

from __future__ import annotations

import logging
import os
import sys

import yaml

_COLORS = {
    "DEBUG": "\033[35m",  # purple
    "INFO": "\033[32m",  # green
    "WARNING": "\033[33m",  # yellow
    "ERROR": "\033[31m",  # red
    "CRITICAL": "\033[31m",  # red
}
_RESET = "\033[0m"


class ColorFormatter(logging.Formatter):
    """ANSI-colored levelname (colorlog.ColoredFormatter twin)."""

    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelname, "")
        orig = record.levelname
        record.levelname = f"{color}{orig}{_RESET}"
        try:
            return super().format(record)
        finally:
            record.levelname = orig


def load_job_logging_cfg(conf_dir: str | None = None) -> dict:
    if conf_dir is None:
        conf_dir = os.path.join(os.path.dirname(__file__), "..", "conf")
    fpath = os.path.join(conf_dir, "hydra", "job_logging", "custom.yaml")
    if not os.path.isfile(fpath):
        return {}
    with open(fpath) as f:
        return yaml.safe_load(f) or {}


def setup_job_logging(
    run_dir: str | None = None,
    rank_tag: str | None = None,
    verbose: int = 1,
) -> None:
    """Configure the root logger: colored console (+ optional rank tag for
    multi-host runs) and, when ``run_dir`` is given, a plain-text file
    handler at ``{run_dir}/{file}`` (default ``logs/outputs.log``)."""
    cfg = load_job_logging_cfg()
    fmt = cfg.get("format", "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")
    if rank_tag:
        fmt = fmt.replace("%(levelname)s", f"%(levelname)s][{rank_tag}", 1)
    level = logging.DEBUG if verbose >= 2 else getattr(
        logging, str(cfg.get("level", "INFO")).upper(), logging.INFO
    )

    root = logging.getLogger()
    root.setLevel(level)
    # replace any prior basicConfig handlers (idempotent across calls)
    for h in [h for h in root.handlers if getattr(h, "_conette_job", False)]:
        root.removeHandler(h)

    console = logging.StreamHandler(sys.stdout)
    use_color = bool(cfg.get("colorlog", True)) and sys.stdout.isatty()
    console.setFormatter((ColorFormatter if use_color else logging.Formatter)(fmt))
    console._conette_job = True  # type: ignore[attr-defined]
    root.addHandler(console)

    if run_dir is not None:
        log_fpath = os.path.join(run_dir, cfg.get("file", "logs/outputs.log"))
        os.makedirs(os.path.dirname(log_fpath), exist_ok=True)
        fileh = logging.FileHandler(log_fpath)
        fileh.setFormatter(logging.Formatter(fmt))
        fileh._conette_job = True  # type: ignore[attr-defined]
        root.addHandler(fileh)
