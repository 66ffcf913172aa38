"""Checkpointing: monitored top-k snapshots, a ``best`` link, resume.

Counterpart of ``conette_tpu/train/checkpoint.py`` (the reference's
``CustomModelCheckpoint``, ``ResumeCallback`` and one-file serialisation):
a checkpoint is a directory with ``params.npz`` (the JAX package's flat
names and layout, ``huggingface/convert.py::save_params_npz``),
``meta.json``, ``tokenizer.json`` and, where an optimizer is given,
``opt_state.npz``. A checkpoint directory of either package loads in the
other; the optimizer state is each package's own (here the ``torch.optim``
state of each parameter, keyed by its name).

The ``orbax`` backend of the JAX package has no counterpart.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from conette_torch.huggingface.convert import (
    flatten_pytree,
    load_params_npz,
    unflatten_pytree,
)
from conette_torch.tokenization import AACTokenizer
from conette_torch.weights import save_tree, to_torch

pylog = logging.getLogger(__name__)


def save_checkpoint(
    ckpt_dir: str,
    params: Any,
    *,
    opt_state: torch.optim.Optimizer | None = None,
    step: int = 0,
    meta: dict | None = None,
    tokenizer: AACTokenizer | None = None,
    backend: str = "npz",
) -> str:
    """Write ``params`` (a tree of tensors or arrays), the optimizer's state,
    ``meta.json`` (``{"step": step} | meta``) and the tokenizer into
    ``ckpt_dir``."""
    if backend != "npz":
        raise NotImplementedError(
            f"checkpoint backend {backend!r}: conette_torch writes npz only "
            "(the JAX package's orbax backend has no counterpart here)")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_tree(os.path.join(ckpt_dir, "params.npz"), params)
    if opt_state is not None:
        np.savez(os.path.join(ckpt_dir, "opt_state.npz"), **_opt_state_flat(opt_state))
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump({"step": step} | (meta or {}), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_file(os.path.join(ckpt_dir, "tokenizer.json"))
    return ckpt_dir


def load_checkpoint(
    ckpt_dir: str, ign_weights: str | None = None
) -> dict[str, Any]:
    """→ {"params" (a tree of CPU tensors), "meta", "tokenizer"?,
    "opt_state_flat"?}. ``ign_weights`` is a regex of parameter paths to
    drop (warm-start filter)."""
    out: dict[str, Any] = {}
    npz_path = os.path.join(ckpt_dir, "params.npz")
    if not os.path.isfile(npz_path):
        if os.path.isdir(os.path.join(ckpt_dir, "orbax")):
            raise NotImplementedError(
                f"{ckpt_dir} holds an orbax checkpoint of the JAX package, "
                "which conette_torch does not read; save it with backend='npz'")
        raise FileNotFoundError(f"no params.npz under {ckpt_dir}")
    params = load_params_npz(npz_path)
    if ign_weights:
        pat = re.compile(ign_weights)
        flat = flatten_pytree(params)
        kept = {k: v for k, v in flat.items() if not pat.search(k)}
        dropped = sorted(set(flat) - set(kept))
        if dropped:
            pylog.info(f"Ignoring {len(dropped)} weights matching {ign_weights!r}")
        params = unflatten_pytree(kept)
    out["params"] = to_torch(params)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        out["meta"] = json.load(f)
    tok_file = os.path.join(ckpt_dir, "tokenizer.json")
    if os.path.isfile(tok_file):
        out["tokenizer"] = AACTokenizer.from_file(tok_file)
    opt_file = os.path.join(ckpt_dir, "opt_state.npz")
    if os.path.isfile(opt_file):
        with np.load(opt_file) as data:
            out["opt_state_flat"] = {k: data[k] for k in data.files}
    return out


class CheckpointManager:
    """Top-k monitored checkpointing with a ``best`` link."""

    def __init__(
        self,
        root: str,
        monitor: str = "val/fense",
        mode: str = "max",
        top_k: int = 1,
        save_after_epoch: int = 0,
    ) -> None:
        if mode not in ("max", "min"):
            raise ValueError(f"Invalid {mode=}")
        self.root = root
        self.monitor = monitor
        self.mode = mode
        self.top_k = top_k
        self.save_after_epoch = save_after_epoch
        self._saved: list[tuple[float, str]] = []  # (score, dir)
        os.makedirs(root, exist_ok=True)

    @property
    def best_score(self) -> float | None:
        if not self._saved:
            return None
        return max(s for s, _ in self._saved) if self.mode == "max" else min(
            s for s, _ in self._saved
        )

    @property
    def best_dir(self) -> str | None:
        if not self._saved:
            return None
        key = (max if self.mode == "max" else min)
        return key(self._saved, key=lambda x: x[0])[1]

    def _is_improvement(self, score: float) -> bool:
        if len(self._saved) < self.top_k:
            return True
        worst = min(self._saved, key=lambda x: x[0] if self.mode == "max" else -x[0])
        return score > worst[0] if self.mode == "max" else score < worst[0]

    def step(
        self,
        epoch: int,
        metrics: dict[str, float],
        params: Any,
        *,
        opt_state: Any = None,
        tokenizer: AACTokenizer | None = None,
        extra_meta: dict | None = None,
    ) -> str | None:
        """Maybe snapshot after a validation epoch; returns the dir saved."""
        if epoch < self.save_after_epoch or self.monitor not in metrics:
            return None
        score = float(metrics[self.monitor])
        if not self._is_improvement(score):
            return None
        # hydra-safe filename separators (custom_ckpt.py:40-41)
        safe_mon = self.monitor.replace("/", "_")
        name = f"epoch_{epoch:03d}-{safe_mon}_{score:.4f}"
        ckpt_dir = os.path.join(self.root, name)
        save_checkpoint(
            ckpt_dir, params, opt_state=opt_state,
            step=epoch, tokenizer=tokenizer,
            meta={"monitor": self.monitor, "score": score, "epoch": epoch}
            | (extra_meta or {}),
        )
        self._saved.append((score, ckpt_dir))
        # evict beyond top_k
        ordered = sorted(self._saved, key=lambda x: x[0], reverse=self.mode == "max")
        for score_i, dir_i in ordered[self.top_k :]:
            shutil.rmtree(dir_i, ignore_errors=True)
        self._saved = ordered[: self.top_k]
        self._update_best_link()
        return ckpt_dir

    def _update_best_link(self) -> None:
        best = self.best_dir
        if best is None:
            return
        link = os.path.join(self.root, "best")
        try:
            if os.path.islink(link) or os.path.exists(link):
                if os.path.islink(link):
                    os.unlink(link)
                else:
                    shutil.rmtree(link)
            os.symlink(os.path.basename(best), link)
        except OSError:  # filesystems without symlinks: copy
            shutil.copytree(best, link, dirs_exist_ok=True)


def _opt_state_flat(optimizer: torch.optim.Optimizer) -> dict[str, np.ndarray]:
    """The optimizer's per-parameter state keyed ``state/<param name>/<key>``
    (its groups' ``param_names``, as ``train/optim.py`` builds them) and each
    group's numeric hyperparameters keyed ``group/<i>/<key>``."""
    flat: dict[str, np.ndarray] = {}
    for i, group in enumerate(optimizer.param_groups):
        for key, value in group.items():
            if isinstance(value, (int, float, bool)):
                flat[f"group/{i}/{key}"] = np.asarray(value)
        for name, t in zip(group["param_names"], group["params"]):
            for key, value in optimizer.state.get(t, {}).items():
                flat[f"state/{name}/{key}"] = (
                    value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value))
    return flat


def restore_opt_state(
    opt_state_flat: dict[str, Any], optimizer: torch.optim.Optimizer
) -> torch.optim.Optimizer:
    """Load a flattened ``opt_state.npz`` payload into ``optimizer``, built
    with the same configuration over the same parameter names: resume with
    momentum. A payload of another configuration raises ``ValueError``."""
    names = [n for g in optimizer.param_groups for n in g["param_names"]]
    want = {k for k in _opt_state_flat(optimizer) if k.startswith("group/")}
    missing = sorted(want - set(opt_state_flat))
    extra = sorted(k for k in opt_state_flat if k not in want
                   and not (k.startswith("state/") and k.split("/", 1)[1].rsplit("/", 1)[0] in names))
    if missing or extra:
        raise ValueError(
            f"opt_state mismatch: missing={missing[:5]} extra={extra[:5]} "
            "(optimizer config changed since the checkpoint was written?)"
        )
    for i, group in enumerate(optimizer.param_groups):
        for key in list(group):
            if f"group/{i}/{key}" in opt_state_flat:
                group[key] = type(group[key])(opt_state_flat[f"group/{i}/{key}"].item())
        for name, t in zip(group["param_names"], group["params"]):
            prefix = f"state/{name}/"
            state = {}
            for k, v in opt_state_flat.items():
                if k.startswith(prefix):
                    key = k[len(prefix):]
                    # torch keeps Adam's ``step`` on the CPU unless the
                    # step is fused or capturable
                    on_cpu = key == "step" and not (group.get("fused") or group.get("capturable"))
                    state[key] = torch.as_tensor(np.asarray(v), device="cpu" if on_cpu else t.device)
            if state:
                optimizer.state[t] = state
    return optimizer
