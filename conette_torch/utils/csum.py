"""Deterministic checksums of arbitrary values / parameter trees.

Counterpart of ``conette_tpu/utils/csum.py`` (the reference's
reproducibility self-checks, ``src/conette/utils/csum.py:33-90``): a stable
integer digest of nested values and model parameters. A tensor is hashed
as the numpy array it holds (its ``str(dtype)`` and bytes), and a tree's
leaves are named and ordered as JAX's ``tree_leaves_with_path`` names and
orders them, so the same values give the JAX package's number and a run's
logged csums compare across the two packages.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Mapping

import numpy as np
import torch


def _update(h: "hashlib._Hash", value: Any) -> None:
    if value is None:
        h.update(b"\x00none")
    elif isinstance(value, (bool, int)):
        h.update(b"\x01int" + struct.pack("<q", int(value)))
    elif isinstance(value, float):
        h.update(b"\x02flt" + struct.pack("<d", value))
    elif isinstance(value, str):
        h.update(b"\x03str" + value.encode())
    elif isinstance(value, bytes):
        h.update(b"\x04byt" + value)
    elif isinstance(value, Mapping):
        h.update(b"\x05map")
        for k in sorted(value.keys(), key=str):
            _update(h, str(k))
            _update(h, value[k])
    elif isinstance(value, (list, tuple)):
        h.update(b"\x06seq" + struct.pack("<q", len(value)))
        for v in value:
            _update(h, v)
    elif hasattr(value, "shape"):  # ndarray / tensor
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        h.update(b"\x07arr" + str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    else:
        h.update(b"\x08obj" + repr(value).encode())


def csum_any(value: Any) -> int:
    """Stable integer checksum of a nested value."""
    h = hashlib.blake2b(digest_size=8)
    _update(h, value)
    return int.from_bytes(h.digest(), "little")


def _leaves_with_path(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """JAX's ``tree_leaves_with_path`` with ``keystr`` names: dict keys in
    sorted order as ``['key']``, list items as ``[i]``."""
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree) for kv in _leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def csum_module(params: Any, with_names: bool = True) -> int:
    """Checksum of a parameter tree (reference ``csum_module`` twin)."""
    leaves = _leaves_with_path(params)
    if with_names:
        return csum_any(leaves)
    return csum_any([v for _, v in leaves])
