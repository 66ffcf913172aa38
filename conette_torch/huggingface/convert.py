"""Parameter persistence: nested dict/list pytrees ↔ flat ``params.npz``.

The same on-disk format as ``conette_tpu``'s ``huggingface/convert.py``
(``flatten_pytree`` … ``load_params_npz``): keys are ``/``-joined paths,
list indices are digit keys. Converting a torch checkpoint of the reference
comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = ["flatten_pytree", "unflatten_pytree", "save_params_npz", "load_params_npz"]


def flatten_pytree(params: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_pytree(flat: Mapping[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params_npz(path: str, params: Any) -> None:
    np.savez(path, **flatten_pytree(params))


def load_params_npz(path: str) -> Any:
    with np.load(path, allow_pickle=False) as data:
        return unflatten_pytree({k: data[k] for k in data.files})
