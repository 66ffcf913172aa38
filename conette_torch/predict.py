"""Caption audio files from the command line.

Run as ``python -m conette_torch.predict --audio a.wav b.wav --model_path DIR``.
The flags are those of ``conette_tpu.predict`` (``--audio``, ``--task``,
``--model_name``, ``--model_path``, ``--device``, ``--token``, ``--seed``,
``--csv_export``, ``--beam_size``, ``--dtype``, ``--verbose``), with the same
CSV columns (audio, task, candidate). ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys
from typing import Optional

from conette_torch import DEFAULT_MODEL_NAME, get_sample_path

pylog = logging.getLogger(__name__)


def get_predict_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Generate audio captions with a CoNeTTE model (PyTorch/CUDA build)."
    )
    parser.add_argument("--audio", type=str, nargs="+", default=None,
                        help="Audio file paths to caption (default: a generated sample).")
    parser.add_argument("--task", type=str, nargs="+", default=None,
                        help="Task token(s); defaults to the model's default task.")
    parser.add_argument("--model_name", type=str, default=DEFAULT_MODEL_NAME)
    parser.add_argument("--model_path", type=str, default=None, help="Local model directory.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device; 'cpu' runs without a card.")
    parser.add_argument("--token", type=str, default=None,
                        help="Accepted for parity; models load from local directories.")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--csv_export", type=str, default=None)
    parser.add_argument("--beam_size", type=int, default=None)
    parser.add_argument(
        "--dtype", type=str, default="float32", choices=("float32", "bfloat16"),
        help="Encoder compute dtype. bfloat16 on a CUDA device runs the "
        "encoder through the hand-written block and seam kernels.",
    )
    parser.add_argument("--verbose", type=int, default=1)
    return parser.parse_args(argv)


def main_predict(argv: Optional[list[str]] = None) -> int:
    args = get_predict_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 2 else logging.INFO,
        format="%(message)s",
        stream=sys.stdout,
    )
    import torch

    from conette_torch.huggingface.model import CoNeTTEModel

    audio = args.audio if args.audio is not None else [get_sample_path()]
    path = args.model_path if args.model_path is not None else args.model_name
    model = CoNeTTEModel.from_pretrained(
        path,
        device=args.device,
        verbose=args.verbose,
        seed=args.seed,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
    )

    tasks = args.task
    if tasks is None:
        tasks = [model.default_task] * len(audio)
    if len(tasks) == 1:
        tasks = tasks * len(audio)
    if len(tasks) != len(audio):
        raise ValueError(
            f"--task count ({len(tasks)}) must be 1 or match --audio count ({len(audio)})"
        )

    cands = model(audio, task=tasks, beam_size=args.beam_size)["cands"]
    rows = []
    for fpath, task, cand in zip(audio, tasks, cands):
        if args.verbose >= 1:
            print(f'File "{fpath}" with task "{task}": "{cand}"')
        rows.append({"audio": fpath, "task": task, "candidate": cand})

    if args.csv_export is not None:
        with open(args.csv_export, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["audio", "task", "candidate"])
            writer.writeheader()
            writer.writerows(rows)
        if args.verbose >= 1:
            print(f"Exported {len(rows)} captions to {args.csv_export}")
    return 0


if __name__ == "__main__":
    sys.exit(main_predict())
