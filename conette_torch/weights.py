"""The weight bridge: numpy parameter pytrees ↔ the port's tensor trees.

Both packages keep their weights as the same nested dict/list tree
(``{"encoder": convnext params, "model": conette params}`` in
``params.npz``), with the same layouts: ``(in, out)`` linear weights, HWIO
conv weights. ``conette_tpu`` holds numpy/JAX arrays in it, the port holds
tensors. This module maps one to the other leaf by leaf without touching
the bits, so a ``params.npz`` written by either package loads unchanged in
the other, and ``to_numpy(to_torch(tree))`` equals ``tree`` bit for bit.

The PANN zoo's trees also hold Python values that steer the forward (a
stride, a layer kind, a flag). Those stay Python values both ways: a bool,
int or str leaf, or a 0-d bool, integer or string array (what
``params.npz`` makes of one), is never a tensor, so the forward branches on
it without reading the device.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from conette_torch.huggingface.convert import load_params_npz, save_params_npz

__all__ = ["map_tree", "to_torch", "to_numpy", "load_tree", "save_tree", "device_constant",
           "named_leaves"]


def device_constant(array: np.ndarray, device: torch.device, dtype: torch.dtype | None = None
                    ) -> torch.Tensor:
    """``array`` as an f32 tensor on ``device``, rounded to ``dtype`` first
    where given, for a cache of device constants: built as a real tensor
    outside inference mode even while ``torch.export`` traces with fake
    tensors, so eager calls, CUDA graph capture and export (which keeps
    it as a constant of the program) can all share it."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily(), torch.inference_mode(False):
        t = torch.from_numpy(array).to(device, dtype or torch.float32)
        return t.float()


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


#: leaves kept as Python values, and the 0-d array kinds read back as them
_STATIC_TYPES = (bool, int, str)
_STATIC_KINDS = "biuU"


def map_tree_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """Apply ``fn(name, leaf)`` to every leaf, ``name`` as :func:`named_leaves`
    gives it."""
    if isinstance(tree, Mapping):
        return {k: map_tree_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def to_torch(tree: Any, device: torch.device | str = "cpu") -> Any:
    """numpy (or array-like) leaves → tensors on ``device``, dtype kept;
    steering values → Python values."""

    def leaf(a: Any) -> Any:
        if isinstance(a, torch.Tensor):
            return a.to(device)
        if isinstance(a, _STATIC_TYPES):
            return a
        a = np.asarray(a)
        if a.ndim == 0 and a.dtype.kind in _STATIC_KINDS:
            return a.item()
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)

    return map_tree(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """Tensor leaves → numpy arrays on the host, dtype kept; Python bool,
    int and str leaves kept as they are."""

    def leaf(t: Any) -> Any:
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy().copy()
        if isinstance(t, _STATIC_TYPES):
            return t
        return np.asarray(t)

    return map_tree(leaf, tree)


def load_tree(path: str, device: torch.device | str = "cpu") -> Any:
    """Read a ``params.npz`` (either package's) as a tensor tree."""
    return to_torch(load_params_npz(path), device)


def save_tree(path: str, tree: Any) -> None:
    """Write a tensor tree as a ``params.npz`` both packages read."""
    save_params_npz(path, to_numpy(tree))


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(name, leaf)`` of every leaf in ``flatten_pytree``'s order and with
    its names (``"decoder/layers/0/norm1/weight"``), as ``params.npz`` keys
    them."""
    if isinstance(tree, Mapping):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]
