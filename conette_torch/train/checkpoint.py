"""Checkpointing: monitored top-k snapshots, a ``best`` link, resume.

Counterpart of ``conette_tpu/train/checkpoint.py`` (the reference's
``CustomModelCheckpoint``, ``ResumeCallback`` and one-file serialisation):
a checkpoint is a directory with ``params.npz`` (the JAX package's flat
names and layout, ``huggingface/convert.py::save_params_npz``),
``meta.json``, ``tokenizer.json`` and, where an optimizer is given,
``opt_state.npz``. A checkpoint directory of either package loads in the
other; the optimizer state is each package's own (here the ``torch.optim``
state of each parameter, keyed by its name).

``backend="orbax"`` (the name the JAX package's callers pass for its
sharded, multi-host orbax tree) writes the parameter tree in its place with
``torch.distributed.checkpoint`` under ``dcp/``: each process writes its
own blocks of a tree split over a mesh's ``model`` dim, one of them each
replicated leaf, and ``load_checkpoint`` reads it back whole, in the
one-process layout. The tree's Python values (the PANN zoo's strides,
kinds and flags) go beside it in ``dcp/values.json``, so the reader
unpickles nothing. The port cannot read a JAX ``orbax/`` tree
(tensorstore), and says so.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import warnings
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from conette_torch.huggingface.convert import (
    flatten_pytree,
    load_params_npz,
    unflatten_pytree,
)
from conette_torch.parallel.distributed import is_main_process
from conette_torch.tokenization import AACTokenizer
from conette_torch.weights import named_leaves, save_tree, to_torch

pylog = logging.getLogger(__name__)


def save_checkpoint(
    ckpt_dir: str,
    params: Any,
    *,
    opt_state: torch.optim.Optimizer | Mapping[str, np.ndarray] | None = None,
    step: int = 0,
    meta: dict | None = None,
    tokenizer: AACTokenizer | None = None,
    backend: str = "npz",
    mesh: Any = None,
) -> str:
    """Write ``params`` (a tree of tensors or arrays), the optimizer's state
    (an optimizer, or its state as :func:`flatten_opt_state` lays it out),
    ``meta.json`` (``{"step": step} | meta``) and the tokenizer into
    ``ckpt_dir``.

    ``backend="npz"`` writes ``params.npz``; ``"orbax"`` writes ``dcp/``
    (module docstring), a collective of every process of the group. With
    ``mesh``, ``params`` holds this process's blocks as the sharded train
    step leaves them (``parallel/mesh.py::leaf_sharding``), and an optimizer
    is gathered to the one-process layout (``step.gather_opt_state``, a
    collective); the main process writes the files beside the tree."""
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r} (npz or orbax)")
    if mesh is not None and backend == "npz":
        raise ValueError("a tree split over a mesh is written with backend='orbax'; "
                         "for params.npz gather it first (step.gather_params)")
    os.makedirs(ckpt_dir, exist_ok=True)
    if backend == "orbax":
        _save_dcp_tree(os.path.join(ckpt_dir, "dcp"), params, mesh)
    else:
        save_tree(os.path.join(ckpt_dir, "params.npz"), params)
    if isinstance(opt_state, torch.optim.Optimizer) and mesh is not None:
        from conette_torch.train.step import gather_opt_state

        opt_state = gather_opt_state(opt_state, mesh)
    if is_main_process():
        if opt_state is not None:
            if isinstance(opt_state, torch.optim.Optimizer):
                opt_state = flatten_opt_state(opt_state)
            np.savez(os.path.join(ckpt_dir, "opt_state.npz"), **opt_state)
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump({"step": step} | (meta or {}), f, indent=2)
        if tokenizer is not None:
            tokenizer.save_file(os.path.join(ckpt_dir, "tokenizer.json"))
    if backend == "orbax" and dist.is_initialized():
        dist.barrier()  # every process returns once the whole checkpoint is written
    return ckpt_dir


def _save_dcp_tree(path: str, params: Any, mesh: Any = None) -> None:
    """``params`` with ``torch.distributed.checkpoint`` under ``path``: its
    tensor leaves by ``named_leaves`` name (as ``DTensor``s of ``mesh`` with
    ``leaf_sharding``'s placements where a mesh is given), its Python values
    in ``values.json``. Every process of the group calls it."""
    import torch.distributed.checkpoint as dcp

    tensors, values = {}, {}
    for name, leaf in named_leaves(params):
        if isinstance(leaf, (bool, int, str)):
            values[name] = leaf
            continue
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        if mesh is not None:
            from torch.distributed.tensor import DTensor

            from conette_torch.parallel.mesh import leaf_sharding

            t = DTensor.from_local(t, mesh, leaf_sharding(name, t, mesh).placements,
                                   run_check=False)
        tensors[name] = t
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        dcp.save(tensors, checkpoint_id=path, no_dist=not dist.is_initialized())
    if is_main_process():
        with open(os.path.join(path, "values.json"), "w") as f:
            json.dump({"order": [n for n, _ in named_leaves(params)], "values": values}, f)


def _load_dcp_tree(path: str) -> Any:
    """The tree :func:`_save_dcp_tree` wrote, whole, as numpy leaves
    (Python values as they were), read by this process alone."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    with open(os.path.join(path, "values.json")) as f:
        saved = json.load(f)
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if not all(isinstance(m, TensorStorageMetadata) for m in stored.values()):
        raise ValueError(f"{path} holds non-tensor entries, which this reader does not unpickle")
    tensors = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in stored.items()}
    with warnings.catch_warnings():  # that no_dist reads in one process, which it says anyway
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        dcp.load(tensors, checkpoint_id=path, no_dist=True)
    return unflatten_pytree({name: saved["values"][name] if name in saved["values"]
                             else tensors[name].numpy() for name in saved["order"]})


def load_checkpoint(
    ckpt_dir: str, ign_weights: str | None = None
) -> dict[str, Any]:
    """→ {"params" (a tree of CPU tensors, in the one-process layout),
    "meta", "tokenizer"?, "opt_state_flat"?}, the parameters from
    ``params.npz``, else from ``dcp/``. ``ign_weights`` is a regex of
    parameter paths to drop (warm-start filter)."""
    out: dict[str, Any] = {}
    npz_path = os.path.join(ckpt_dir, "params.npz")
    dcp_path = os.path.join(ckpt_dir, "dcp")
    if os.path.isfile(npz_path):
        params = load_params_npz(npz_path)
    elif os.path.isdir(dcp_path):
        params = _load_dcp_tree(dcp_path)
    elif os.path.isdir(os.path.join(ckpt_dir, "orbax")):
        raise NotImplementedError(
            f"{ckpt_dir} holds an orbax checkpoint of the JAX package, "
            "which conette_torch does not read; save it with backend='npz'")
    else:
        raise FileNotFoundError(f"no params.npz or dcp/ under {ckpt_dir}")
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


def flatten_opt_state(optimizer: torch.optim.Optimizer) -> dict[str, np.ndarray]:
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
    want = {k for k in flatten_opt_state(optimizer) if k.startswith("group/")}
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
