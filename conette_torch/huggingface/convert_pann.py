"""PANN checkpoint conversion: torch state dicts → numpy parameter trees.

Copy of ``conette_tpu/huggingface/convert_pann.py`` (the port imports
nothing of the JAX package), so that both packages build the same tree from
one checkpoint, for the architectures that ``models/pann.py`` runs: the Cnn
family (Cnn10, Cnn14 and its frontend and embedding variants,
Cnn14_DecisionLevelAtt). The architectures of ``models/pann_zoo.py``
(ResNet*, Wavegram*, MobileNet*, Cnn6, LeeNet*, DaiNet19, Res1dNet*,
Cnn14_DecisionLevelMax/Avg) raise ``NotImplementedError`` before any
conversion until the zoo is ported (ROADMAP Queue 1).

Layout rules (those of ``convert.py``'s ConvNeXt converter):
- torch Conv2d OIHW → HWIO; bias-free PANN convs get a zero bias
  (mathematically identical);
- torch Linear (out, in) → (in, out);
- BatchNorm {weight, bias, running_mean, running_var} copied verbatim
  (``num_batches_tracked`` skipped);
- the STFT/mel buffers (``spectrogram_extractor.*``, ``logmel_extractor.*``)
  and SpecAugment state are skipped: the frontend rebuilds them;
- the Cnn14_DecisionLevelAtt ``att_block.att/cla`` Conv1d k1 weights map to
  the linear attention head ((out,in,1) → squeeze → transpose);
  ``att_block.bn_att`` is skipped (declared but unused in the reference
  forward, models.py:121-166).

Every converted tensor is checked against the shape of the tree that
``models/pann.py::build_pann_model`` builds for the architecture, so that a
naming or layout drift fails loudly.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Mapping

import numpy as np

from conette_torch.models.pann import ZOO_ONLY_NAMES, build_pann_model

pylog = logging.getLogger(__name__)

Params = dict[str, Any]

#: torch keys safely skipped during conversion
_SKIP_PATTERNS = re.compile(
    r"(spectrogram_extractor\.|logmel_extractor\.|spec_augmenter\.|"
    r"num_batches_tracked$|att_block\.bn_att\.)"
)


def _conv2d_w(x: np.ndarray) -> np.ndarray:
    """torch OIHW → HWIO."""
    return np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0)))


def _lin_w(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def _bn(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {
        "weight": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
        "running_mean": np.asarray(sd[f"{prefix}.running_mean"]),
        "running_var": np.asarray(sd[f"{prefix}.running_var"]),
    }


def _conv2d(sd: Mapping[str, np.ndarray], key: str) -> Params:
    w = _conv2d_w(np.asarray(sd[f"{key}.weight"]))
    bias = sd.get(f"{key}.bias")
    return {
        "weight": w,
        "bias": np.asarray(bias) if bias is not None else np.zeros(w.shape[-1], np.float32),
    }


def _linear(sd: Mapping[str, np.ndarray], key: str) -> Params:
    return {
        "weight": _lin_w(np.asarray(sd[f"{key}.weight"])),
        "bias": np.asarray(sd[f"{key}.bias"]),
    }


def _conv_block(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    """PANN ConvBlock (two bias-free 3x3 convs + BNs, models.py:32-82)."""
    return {
        "conv1": _conv2d(sd, f"{prefix}.conv1"),
        "bn1": _bn(sd, f"{prefix}.bn1"),
        "conv2": _conv2d(sd, f"{prefix}.conv2"),
        "bn2": _bn(sd, f"{prefix}.bn2"),
    }


# ------------------------------------------------------------------ Cnn family
def _convert_cnn(sd: Mapping[str, np.ndarray], n_blocks: int, att_head: bool) -> Params:
    params: Params = {
        "bn0": _bn(sd, "bn0"),
        "blocks": [_conv_block(sd, f"conv_block{i + 1}") for i in range(n_blocks)],
        "fc1": _linear(sd, "fc1"),
    }
    if att_head:
        # AttBlock Conv1d k1 → linear head (weight (out,in,1))
        att_w = np.asarray(sd["att_block.att.weight"])[:, :, 0]
        cla_w = np.asarray(sd["att_block.cla.weight"])[:, :, 0]
        params["att"] = {
            "att": {"weight": _lin_w(att_w), "bias": np.asarray(sd["att_block.att.bias"])},
            "cla": {"weight": _lin_w(cla_w), "bias": np.asarray(sd["att_block.cla.bias"])},
        }
    else:
        params["fc_audioset"] = _linear(sd, "fc_audioset")
    return params


# --------------------------------------------------------------------- entry
_CONVERTERS = {
    "cnn10": lambda sd: _convert_cnn(sd, 4, att_head=False),
    "cnn14": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_16k": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_8k": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_mel32": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_mel128": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_no_specaug": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_no_dropout": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_mixup_time_domain": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_decisionlevelatt": lambda sd: _convert_cnn(sd, 6, att_head=True),
    # emb variants share Cnn14's state-dict layout; only fc1/fc_audioset
    # dims differ (models.py:1315-1660) — the shape check pins them
    "cnn14_emb512": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_emb128": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_emb32": lambda sd: _convert_cnn(sd, 6, att_head=False),
}


def convert_pann(state_dict: Mapping[str, Any], architecture: str) -> Params:
    """Convert a PANN torch ``state_dict`` (already ``.numpy()``-ified or
    torch tensors) into the matching numpy parameter tree.

    :param architecture: registry architecture name (case-insensitive),
        e.g. ``"Cnn14"``, ``"Cnn14_DecisionLevelAtt"``.
    """
    arch = architecture.lower()
    if arch in ZOO_ONLY_NAMES:
        raise NotImplementedError(
            f"{architecture!r} is a models/pann_zoo.py architecture, which "
            "conette_torch has not ported yet (ROADMAP Queue 1); convertible: "
            f"{sorted(_CONVERTERS)}")
    if arch not in _CONVERTERS:
        raise ValueError(
            f"No PANN converter for {architecture!r} "
            f"(supported: {sorted(_CONVERTERS)})"
        )
    sd = {
        k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
        for k, v in state_dict.items()
        if not _SKIP_PATTERNS.search(k)
    }
    params = _CONVERTERS[arch](sd)
    _check_shapes(params, arch)
    return params


def _check_shapes(params: Params, arch: str) -> None:
    """Compare converted leaf shapes against a freshly-initialized pytree of
    the same architecture — catches key-mapping drift."""
    ref, _ = build_pann_model(arch)

    def shapes(tree: Any, path: str = "") -> dict[str, tuple]:
        out: dict[str, tuple] = {}
        if isinstance(tree, dict):
            for k, v in tree.items():
                out |= shapes(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                out |= shapes(v, f"{path}/{i}")
        elif hasattr(tree, "shape"):
            out[path] = tuple(tree.shape)
        return out

    got, want = shapes(params), shapes(ref)
    mismatched = {
        k: (got.get(k), want.get(k))
        for k in got.keys() | want.keys()
        if got.get(k) != want.get(k)
    }
    if mismatched:
        sample = dict(list(sorted(mismatched.items()))[:8])
        raise ValueError(
            f"PANN conversion shape mismatch for {arch!r} "
            f"({len(mismatched)} leaves): {sample}"
        )


def load_registry_pann(name: str, ckpt_dir: str | None = None) -> Params:
    """Load and convert a ``PANN_REGISTRY`` checkpoint into the numpy tree
    (reference ``pann_utils/hub.py::build_pann_model(pretrained=True)``)."""
    import torch

    from conette_torch.models.registries import PANN_REGISTRY, resolve_checkpoint

    if name not in PANN_REGISTRY:
        raise KeyError(f"Unknown PANN checkpoint {name!r} (known: {list(PANN_REGISTRY)})")
    entry = PANN_REGISTRY[name]
    fpath = resolve_checkpoint(entry, ckpt_dir)
    state = torch.load(fpath, map_location="cpu", weights_only=True)
    if entry.state_dict_key and entry.state_dict_key in state:
        state = state[entry.state_dict_key]
    return convert_pann(state, entry.architecture)
