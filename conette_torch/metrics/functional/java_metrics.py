"""METEOR / SPICE — Java-subprocess metrics (gated).

The reference spawns the coco-caption Java jars downloaded by
``conette-prepare`` (``src/conette/prepare.py:567-576``,
``metrics/classes/all_metrics.py:106-131``). These stay host-side
subprocess tools here too; on hosts without Java or the jars they are
unavailable and ``AllMetrics`` skips them (reporting which metrics were
skipped), since the TPU compute path never depends on them.

Jar locations resolve from ``CONETTE_METEOR_JAR`` / ``CONETTE_SPICE_JAR``
env vars or ``~/.cache/conette_torch/aac-metrics/``.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

pylog = logging.getLogger(__name__)

DEFAULT_CACHE = os.path.expanduser("~/.cache/conette_torch/aac-metrics")


def _find_jar(env_var: str, default_name: str) -> str | None:
    path = os.environ.get(env_var)
    if path and os.path.isfile(path):
        return path
    cand = os.path.join(DEFAULT_CACHE, default_name)
    return cand if os.path.isfile(cand) else None


def java_available() -> bool:
    return shutil.which("java") is not None


def meteor_available() -> bool:
    return java_available() and _find_jar("CONETTE_METEOR_JAR", "meteor-1.5.jar") is not None


def spice_available() -> bool:
    return java_available() and _find_jar("CONETTE_SPICE_JAR", "spice-1.0.jar") is not None


def meteor(
    candidates: Sequence[str], mult_references: Sequence[Sequence[str]]
) -> dict[str, object]:
    """METEOR 1.5 via the official jar (stdin line protocol of the
    coco-caption wrapper)."""
    jar = _find_jar("CONETTE_METEOR_JAR", "meteor-1.5.jar")
    if jar is None or not java_available():
        raise RuntimeError(
            "METEOR requires java + meteor-1.5.jar (set CONETTE_METEOR_JAR)."
        )
    cmd = ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en", "-norm"]
    proc = subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True
    )
    assert proc.stdin is not None and proc.stdout is not None
    eval_lines = []
    for cand, refs in zip(candidates, mult_references):
        stat_line = f"SCORE ||| {' ||| '.join(refs)} ||| {cand}"
        proc.stdin.write(stat_line + "\n")
        proc.stdin.flush()
        eval_lines.append(proc.stdout.readline().strip())
    proc.stdin.write("EVAL ||| " + " ||| ".join(eval_lines) + "\n")
    proc.stdin.flush()
    sents = [float(proc.stdout.readline().strip()) for _ in candidates]
    corpus = float(proc.stdout.readline().strip())
    proc.stdin.close()
    proc.wait()
    return {"meteor": corpus, "meteor_sents": sents}


def spice(
    candidates: Sequence[str], mult_references: Sequence[Sequence[str]]
) -> dict[str, object]:
    """SPICE via the official jar (JSON file protocol)."""
    import json

    jar = _find_jar("CONETTE_SPICE_JAR", "spice-1.0.jar")
    if jar is None or not java_available():
        raise RuntimeError(
            "SPICE requires java + spice-1.0.jar (set CONETTE_SPICE_JAR)."
        )
    with tempfile.TemporaryDirectory() as tmp:
        in_file = os.path.join(tmp, "input.json")
        out_file = os.path.join(tmp, "output.json")
        payload = [
            {"image_id": i, "test": cand, "refs": list(refs)}
            for i, (cand, refs) in enumerate(zip(candidates, mult_references))
        ]
        with open(in_file, "w") as f:
            json.dump(payload, f)
        subprocess.run(
            [
                "java", "-jar", "-Xmx8G", jar, in_file,
                "-cache", os.path.join(DEFAULT_CACHE, "spice_cache"),
                "-out", out_file, "-subset", "-silent",
            ],
            check=True,
            cwd=os.path.dirname(jar),
        )
        with open(out_file) as f:
            results = json.load(f)
    sents = [float(r["scores"]["All"]["f"]) for r in results]
    corpus = sum(sents) / max(len(sents), 1)
    return {"spice": corpus, "spice_sents": sents}
