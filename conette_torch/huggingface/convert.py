"""Checkpoint conversion: reference torch state dict → numpy parameter trees.

Copy of ``conette_tpu/huggingface/convert.py`` (the port imports nothing of
the JAX package), so both packages build the same tree from one checkpoint.
It differs in one place: its unpickler admits no torch global (see
``_RemapUnpickler``). Handles:

- the ``preprocessor.encoder.*`` ConvNeXt weights: torch OIHW conv kernels →
  HWIO, torch (out, in) linears → (in, out), ``gamma`` → ``scale_layer``
  legacy rename (reference pre-hook, ``nn/encoders/convnext.py:76-102``),
  BN running stats, skipping the fixed STFT/mel buffers (we rebuild them);
- the ``model.*`` CoNeTTE weights: projection (``projection.2`` inside the
  reference's Sequential, ``pl_modules/common.py:59-78``), decoder embedding,
  per-layer packed MHA in-proj → split q/k/v, FF linears, norms, classifier;
- the ``_extra_state_`` uint8 tensor: pickled tokenizer state
  (``huggingface/model.py:165-183``), unpickled with a module-remapping
  Unpickler so reference class paths resolve onto ``conette_torch``'s
  tokenizer without the reference package.

The tree is the ``params.npz`` layout (``flatten_pytree`` …
``load_params_npz``): keys are ``/``-joined paths, list indices are digit
keys.
"""

from __future__ import annotations

import io
import logging
import pickle
import re
from typing import Any, Mapping

import numpy as np

pylog = logging.getLogger(__name__)

Params = dict[str, Any]


# --------------------------------------------------------------- unpickling
class _RemapUnpickler(pickle.Unpickler):
    """Resolves reference-package class paths onto this package's twins so
    the checkpoint's pickled tokenizer state loads standalone.

    Untrusted-input hardening: everything outside the remap table resolves
    only through an explicit allowlist of data-shaped classes; any other
    global (os.system, subprocess, numpy ufuncs, …) raises UnpicklingError
    instead of executing reduce payloads. A tokenizer state is strings and
    ints, so no ``torch`` global is allowed: ``torch.storage._load_from_bytes``
    runs ``torch.load(..., weights_only=False)`` on bytes the file supplies,
    which would run any pickle hidden in them."""

    _MODULE_MAP = {
        "conette.tokenization.aac_tokenizer": "conette_torch.tokenization.aac_tokenizer",
        "conette.tokenization.normalizers": "conette_torch.tokenization.normalizers",
    }

    #: non-conette globals a reference tokenizer-state pickle may contain —
    #: pure data containers only, nothing with side effects on construction
    _ALLOWED = {
        ("builtins", "set"),
        ("builtins", "frozenset"),
        ("builtins", "complex"),
        ("builtins", "bytearray"),
        ("builtins", "slice"),
        ("builtins", "range"),
        ("collections", "OrderedDict"),
        ("collections", "Counter"),
    }

    def find_class(self, module: str, name: str) -> Any:
        module = self._MODULE_MAP.get(module, module)
        if module.startswith("conette."):
            # unsupported reference internals (word tokenizers, torch refs):
            # return a permissive stub that records its state
            return _StatefulStub
        if module.startswith("conette_torch.tokenization."):
            return super().find_class(module, name)
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"Blocked unpickling of {module}.{name} from checkpoint "
            "_extra_state_ (not in the conette tokenizer-state allowlist)."
        )


class _StatefulStub:
    """Absorbs arbitrary pickled objects (setstate-only)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state: Any) -> None:
        self.state = state


def loads_remapped(data: bytes) -> Any:
    return _RemapUnpickler(io.BytesIO(data)).load()


# ------------------------------------------------------------- name mapping
def _conv_w(x: np.ndarray) -> np.ndarray:
    """torch Conv2d OIHW → HWIO."""
    return np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0)))


def _lin_w(x: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) → (in, out)."""
    return np.ascontiguousarray(x.T)


def convert_convnext(
    state: Mapping[str, np.ndarray], prefix: str = "preprocessor.encoder."
) -> Params:
    """Build the ConvNeXt parameter pytree from a reference-layout state
    dict (numpy values)."""
    g = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    # legacy rename (convnext.py:76-102)
    g = {k.replace(".gamma", ".scale_layer"): v for k, v in g.items()}

    def has(k: str) -> bool:
        return k in g

    params: Params = {
        "bn0": {
            "weight": g["bn0.weight"],
            "bias": g["bn0.bias"],
            "running_mean": g["bn0.running_mean"],
            "running_var": g["bn0.running_var"],
        },
        "stem": {
            "conv": {
                "weight": _conv_w(g["downsample_layers.0.0.weight"]),
                "bias": g["downsample_layers.0.0.bias"],
            },
            "norm": {
                "weight": g["downsample_layers.0.1.weight"],
                "bias": g["downsample_layers.0.1.bias"],
            },
        },
        "downsample": [],
        "stages": [],
        "norm": {"weight": g["norm.weight"], "bias": g["norm.bias"]},
        "head_audioset": {
            "weight": _lin_w(g["head_audioset.weight"]),
            "bias": g["head_audioset.bias"],
        },
    }
    for i in range(1, 4):
        params["downsample"].append(
            {
                "norm": {
                    "weight": g[f"downsample_layers.{i}.0.weight"],
                    "bias": g[f"downsample_layers.{i}.0.bias"],
                },
                "conv": {
                    "weight": _conv_w(g[f"downsample_layers.{i}.1.weight"]),
                    "bias": g[f"downsample_layers.{i}.1.bias"],
                },
            }
        )
    for i in range(4):
        stage = []
        j = 0
        while has(f"stages.{i}.{j}.dwconv.weight"):
            p = f"stages.{i}.{j}."
            stage.append(
                {
                    "dwconv": {
                        "weight": _conv_w(g[p + "dwconv.weight"]),
                        "bias": g[p + "dwconv.bias"],
                    },
                    "norm": {
                        "weight": g[p + "norm.weight"],
                        "bias": g[p + "norm.bias"],
                    },
                    "pwconv1": {
                        "weight": _lin_w(g[p + "pwconv1.weight"]),
                        "bias": g[p + "pwconv1.bias"],
                    },
                    "pwconv2": {
                        "weight": _lin_w(g[p + "pwconv2.weight"]),
                        "bias": g[p + "pwconv2.bias"],
                    },
                    "scale": g[p + "scale_layer"],
                }
            )
            j += 1
        params["stages"].append(stage)
    return params


def convert_conette(
    state: Mapping[str, np.ndarray], prefix: str = "model."
) -> Params:
    """Build the projection+decoder pytree from a reference-layout state
    dict. The reference projection is ``Sequential(Dropout, Identity,
    Linear, ReLU, Transpose, Dropout)`` so the Linear lives at index 2."""
    g = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    proj_key = next(
        (k for k in g if re.fullmatch(r"projection\.\d+\.weight", k)), None
    )
    if proj_key is None:
        raise KeyError("projection linear weight not found in state dict")
    proj_idx = proj_key.split(".")[1]

    d = "decoder."
    params: Params = {
        "projection": {
            "weight": _lin_w(g[f"projection.{proj_idx}.weight"]),
            "bias": g[f"projection.{proj_idx}.bias"],
        },
        "decoder": {
            "emb": {"weight": g[d + "emb_layer.weight"]},
            "layers": [],
            "classifier": {
                "weight": _lin_w(g[d + "classifier.weight"]),
                "bias": g[d + "classifier.bias"],
            },
        },
    }
    i = 0
    while d + f"layers.{i}.linear1.weight" in g:
        p = d + f"layers.{i}."

        def attn(tname: str) -> Params:
            w = g[p + tname + ".in_proj_weight"]
            b = g[p + tname + ".in_proj_bias"]
            dm = w.shape[1]
            wq, wk, wv = w[:dm], w[dm : 2 * dm], w[2 * dm :]
            bq, bk, bv = b[:dm], b[dm : 2 * dm], b[2 * dm :]
            return {
                "q": {"weight": _lin_w(wq), "bias": bq},
                "k": {"weight": _lin_w(wk), "bias": bk},
                "v": {"weight": _lin_w(wv), "bias": bv},
                "out": {
                    "weight": _lin_w(g[p + tname + ".out_proj.weight"]),
                    "bias": g[p + tname + ".out_proj.bias"],
                },
            }

        params["decoder"]["layers"].append(
            {
                "self_attn": attn("self_attn"),
                "cross_attn": attn("multihead_attn"),
                "linear1": {
                    "weight": _lin_w(g[p + "linear1.weight"]),
                    "bias": g[p + "linear1.bias"],
                },
                "linear2": {
                    "weight": _lin_w(g[p + "linear2.weight"]),
                    "bias": g[p + "linear2.bias"],
                },
                "norm1": {"weight": g[p + "norm1.weight"], "bias": g[p + "norm1.bias"]},
                "norm2": {"weight": g[p + "norm2.weight"], "bias": g[p + "norm2.bias"]},
                "norm3": {"weight": g[p + "norm3.weight"], "bias": g[p + "norm3.bias"]},
            }
        )
        i += 1
    return params


def extract_extra_state(state: Mapping[str, np.ndarray]) -> dict[str, Any] | None:
    """Unpickle the ``_extra_state_`` uint8 tensor into a plain dict
    (parity: ``huggingface/model.py:126-163``)."""
    key = next((k for k in state if k.endswith("_extra_state_")), None)
    if key is None:
        return None
    raw = np.asarray(state[key], dtype=np.uint8).tobytes()
    try:
        return loads_remapped(raw)
    except Exception as err:
        pylog.warning(f"Could not unpickle _extra_state_: {err}")
        return None


def convert_torch_checkpoint(
    state: Mapping[str, Any],
) -> tuple[Params, Params, dict[str, Any] | None]:
    """Full conversion: torch tensors/numpy state dict →
    (convnext_params, conette_params, extra_state)."""
    np_state: dict[str, np.ndarray] = {}
    for k, v in state.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        np_state[k] = np.asarray(v)
    encoder = convert_convnext(np_state)
    model = convert_conette(np_state)
    extra = extract_extra_state(np_state)
    return encoder, model, extra


# ---------------------------------------------------------- our persistence
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
