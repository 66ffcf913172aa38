"""PANN checkpoint conversion: torch state dicts → numpy parameter trees.

Copy of ``conette_tpu/huggingface/convert_pann.py`` (the port imports
nothing of the JAX package), so that both packages build the same tree from
one checkpoint. It covers every architecture of the reference's
``PANN_REGISTRY`` (``nn/ckpt.py:38-113``: Cnn10, Cnn14,
Cnn14_DecisionLevelAtt, Cnn6, ResNet22, ResNet38, ResNet54, Wavegram_Cnn14,
Wavegram_Logmel_Cnn14), the extra registry entries (Cnn14_16k, MobileNetV1,
MobileNetV2) and every other name of ``models/pann.py::PANN_ZOO_NAMES``.

Layout rules (those of ``convert.py``'s ConvNeXt converter):
- torch Conv2d OIHW → HWIO; bias-free PANN convs get a zero bias
  (mathematically identical);
- torch Conv1d (out, in, k) → WIO (k, in, out);
- torch Linear (out, in) → (in, out);
- BatchNorm {weight, bias, running_mean, running_var} copied verbatim
  (``num_batches_tracked`` skipped);
- the STFT/mel buffers (``spectrogram_extractor.*``, ``logmel_extractor.*``)
  and SpecAugment state are skipped: the frontend rebuilds them;
- the Cnn14_DecisionLevelAtt ``att_block.att/cla`` Conv1d k1 weights map to
  the linear attention head ((out,in,1) → squeeze → transpose);
  ``att_block.bn_att`` is skipped (declared but unused in the reference
  forward, models.py:121-166);
- the trees' Python values that steer the forward (``"stride"``,
  ``"kind"``, ``"use_res"``, ``"expand"``, ``"double"``, ``"bottleneck"``)
  are set from the architecture, as ``models/pann_zoo.py``'s inits set them.

Every converted tensor is checked against the shape of the tree that
``models/pann.py::build_pann_model`` builds for the architecture, so that a
naming or layout drift fails loudly.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Mapping

import numpy as np

from conette_torch.models.pann import build_pann_model

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


def _conv1d_w(x: np.ndarray) -> np.ndarray:
    """torch (out, in, k) → WIO (k, in, out)."""
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


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


def _conv1d(sd: Mapping[str, np.ndarray], key: str) -> Params:
    return {"weight": _conv1d_w(np.asarray(sd[f"{key}.weight"]))}


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


def _conv_block5x5(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {
        "conv1": _conv2d(sd, f"{prefix}.conv1"),
        "bn1": _bn(sd, f"{prefix}.bn1"),
    }


def _pre_wav_block(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {
        "conv1": _conv1d(sd, f"{prefix}.conv1"),
        "bn1": _bn(sd, f"{prefix}.bn1"),
        "conv2": _conv1d(sd, f"{prefix}.conv2"),
        "bn2": _bn(sd, f"{prefix}.bn2"),
    }


# ------------------------------------------------------------------ Cnn family
def _convert_cnn(sd: Mapping[str, np.ndarray], n_blocks: int,
                 att_head: bool, block5x5: bool = False) -> Params:
    make = _conv_block5x5 if block5x5 else _conv_block
    params: Params = {
        "bn0": _bn(sd, "bn0"),
        "blocks": [make(sd, f"conv_block{i + 1}") for i in range(n_blocks)],
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


# ----------------------------------------------------------------- ResNet 2d
def _resnet_block(sd: Mapping[str, np.ndarray], prefix: str, stride: int,
                  bottleneck: bool) -> Params:
    p: Params = {
        "conv1": _conv2d(sd, f"{prefix}.conv1"),
        "bn1": _bn(sd, f"{prefix}.bn1"),
        "conv2": _conv2d(sd, f"{prefix}.conv2"),
        "bn2": _bn(sd, f"{prefix}.bn2"),
        "stride": stride,
    }
    if bottleneck:
        p["conv3"] = _conv2d(sd, f"{prefix}.conv3")
        p["bn3"] = _bn(sd, f"{prefix}.bn3")
    # downsample Sequential: stride==1 → (conv, bn) at indices 0,1;
    # stride==2 → (AvgPool, conv, bn) at 1,2 (models.py:915-937)
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample"] = {
            "conv": _conv2d(sd, f"{prefix}.downsample.0"),
            "bn": _bn(sd, f"{prefix}.downsample.1"),
        }
    elif f"{prefix}.downsample.1.weight" in sd:
        p["downsample"] = {
            "conv": _conv2d(sd, f"{prefix}.downsample.1"),
            "bn": _bn(sd, f"{prefix}.downsample.2"),
        }
    return p


def _convert_resnet(sd: Mapping[str, np.ndarray], depths: tuple[int, ...],
                    bottleneck: bool) -> Params:
    params: Params = {
        "bn0": _bn(sd, "bn0"),
        "conv_block1": _conv_block(sd, "conv_block1"),
        "layers": [],
        # all three ResNets end with conv_block_after1 after the 2x2
        # avg-pool (models.py:1046/1148/1262)
        "conv_block_after1": _conv_block(sd, "conv_block_after1"),
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
    }
    strides = (1, 2, 2, 2)
    for li, (blocks, stride) in enumerate(zip(depths, strides), start=1):
        stage = []
        for bi in range(blocks):
            stage.append(
                _resnet_block(
                    sd, f"resnet.layer{li}.{bi}", stride if bi == 0 else 1,
                    bottleneck,
                )
            )
        params["layers"].append(stage)
    if bottleneck:
        params["bottleneck"] = True
    return params


# ------------------------------------------------------------------ Wavegram
def _convert_wavegram(sd: Mapping[str, np.ndarray], logmel: bool) -> Params:
    channels = (
        [(1, 64), (128, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048)]
        if logmel
        else [(64, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048)]
    )
    params: Params = {
        "pre_conv0": _conv1d(sd, "pre_conv0"),
        "pre_bn0": _bn(sd, "pre_bn0"),
        "pre_block1": _pre_wav_block(sd, "pre_block1"),
        "pre_block2": _pre_wav_block(sd, "pre_block2"),
        "pre_block3": _pre_wav_block(sd, "pre_block3"),
        "pre_block4": _conv_block(sd, "pre_block4"),
        "bn0": _bn(sd, "bn0"),
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
    }
    if logmel:
        params["blocks"] = [
            _conv_block(sd, f"conv_block{i + 1}") for i in range(6)
        ]
    else:
        params["conv_block1"] = _conv_block(sd, "conv_block1")
        params["blocks"] = [
            _conv_block(sd, f"conv_block{i + 2}") for i in range(5)
        ]
    return params


# ----------------------------------------------------------- raw-wave models
_LEENET11_CH = [(1, 64), (64, 64), (64, 64), (64, 128), (128, 128), (128, 128),
                (128, 128), (128, 128), (128, 256)]
_LEENET24_CH = [(1, 64), (64, 96), (96, 128), (128, 128), (128, 256),
                (256, 256), (256, 512), (512, 512), (512, 1024)]


def _convert_leenet(sd: Mapping[str, np.ndarray], double: bool) -> Params:
    """LeeNet11 (single-conv blocks, models.py:2051-2113) / LeeNet24
    (double-conv LeeNetConvBlock2, models.py:2157-2230)."""
    blocks: list[Params] = []
    for i in range(9):
        base = f"conv_block{i + 1}"
        block: Params = {"conv1": _conv1d(sd, f"{base}.conv1"),
                         "bn1": _bn(sd, f"{base}.bn1")}
        if double:
            block["conv2"] = _conv1d(sd, f"{base}.conv2")
            block["bn2"] = _bn(sd, f"{base}.bn2")
        blocks.append(block)
    return {
        "blocks": blocks,
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
        "double": double,
    }


def _convert_dainet(sd: Mapping[str, np.ndarray]) -> Params:
    """DaiNet19 (models.py:2315-2383): conv0 k80 s4 + 4 DaiNetResBlocks.
    Every torch block declares a downsample conv+BN, but it is only used
    when channels change (models.py:2295-2299) — blocks with in==out skip
    it here to mirror ``dainet_init``."""
    channels = [(64, 64), (64, 128), (128, 256), (256, 512)]
    blocks: list[Params] = []
    for i, (in_ch, out_ch) in enumerate(channels):
        base = f"conv_block{i + 1}"
        block: Params = {}
        for j in range(1, 5):
            block[f"conv{j}"] = _conv1d(sd, f"{base}.conv{j}")
            block[f"bn{j}"] = _bn(sd, f"{base}.bn{j}")
        if in_ch != out_ch:
            block["downsample"] = _conv1d(sd, f"{base}.downsample")
            block["bn_downsample"] = _bn(sd, f"{base}.bn_downsample")
        blocks.append(block)
    return {
        "conv0": _conv1d(sd, "conv0"),
        "bn0": _bn(sd, "bn0"),
        "blocks": blocks,
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
    }


def _convert_res1dnet(sd: Mapping[str, np.ndarray],
                      depths: tuple[int, ...]) -> Params:
    """Res1dNet31/51 (models.py:2576-2700): conv0 k11 s5 p5 + 7 stages of
    _ResnetBasicBlockWav1d. downsample Sequential indexing follows
    _ResNetWav1d._make_layer (models.py:2510-2528): stride==1 → (conv, bn)
    at 0,1; stride!=1 → (AvgPool, conv, bn) at 1,2."""
    params: Params = {
        "conv0": _conv1d(sd, "conv0"),
        "bn0": _bn(sd, "bn0"),
        "layers": [],
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
    }
    strides = (1, 4, 4, 4, 4, 4, 4)
    for li, (blocks, stride) in enumerate(zip(depths, strides), start=1):
        stage = []
        for bi in range(blocks):
            base = f"resnet.layer{li}.{bi}"
            block: Params = {
                "conv1": _conv1d(sd, f"{base}.conv1"),
                "bn1": _bn(sd, f"{base}.bn1"),
                "conv2": _conv1d(sd, f"{base}.conv2"),
                "bn2": _bn(sd, f"{base}.bn2"),
                "stride": stride if bi == 0 else 1,
            }
            if f"{base}.downsample.0.weight" in sd:
                block["downsample"] = {
                    "conv": _conv1d(sd, f"{base}.downsample.0"),
                    "bn": _bn(sd, f"{base}.downsample.1"),
                }
            elif f"{base}.downsample.1.weight" in sd:
                block["downsample"] = {
                    "conv": _conv1d(sd, f"{base}.downsample.1"),
                    "bn": _bn(sd, f"{base}.downsample.2"),
                }
            stage.append(block)
        params["layers"].append(stage)
    return params


# ---------------------------------------------------------------- MobileNets
def _convert_mobilenetv1(sd: Mapping[str, np.ndarray]) -> Params:
    spec = [  # (kind, pool_stride) mirroring mobilenetv1_init
        ("bn", 2), ("dw", 1), ("dw", 2), ("dw", 1), ("dw", 2), ("dw", 1),
        ("dw", 2), ("dw", 1), ("dw", 1), ("dw", 1), ("dw", 1), ("dw", 1),
        ("dw", 2), ("dw", 1),
    ]
    params: Params = {"bn0": _bn(sd, "bn0"), "features": []}
    for i, (kind, stride) in enumerate(spec):
        base = f"features.{i}"
        if kind == "bn":
            # conv_bn Sequential: 0=conv, 1=AvgPool, 2=BN (models.py:1717-1727)
            params["features"].append({
                "kind": "bn", "stride": stride,
                "conv": _conv2d(sd, f"{base}.0"),
                "bn": _bn(sd, f"{base}.2"),
            })
        else:
            # conv_dw Sequential: 0=dwconv, 2=BN, 4=pwconv, 5=BN
            params["features"].append({
                "kind": "dw", "stride": stride,
                "dwconv": _conv2d(sd, f"{base}.0"),
                "bn1": _bn(sd, f"{base}.2"),
                "pwconv": _conv2d(sd, f"{base}.4"),
                "bn2": _bn(sd, f"{base}.5"),
            })
    params["fc1"] = _linear(sd, "fc1")
    params["fc_audioset"] = _linear(sd, "fc_audioset")
    return params


def _convert_mobilenetv2(sd: Mapping[str, np.ndarray]) -> Params:
    from conette_torch.models.pann_zoo import _MBV2_SETTING

    params: Params = {
        "bn0": _bn(sd, "bn0"),
        # stem conv_bn Sequential: 0=conv, 1=AvgPool, 2=BN
        "stem_conv": _conv2d(sd, "features.0.0"),
        "stem_bn": _bn(sd, "features.0.2"),
        "blocks": [],
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
    }
    inp, idx = 32, 1
    for t, c, n, s in _MBV2_SETTING:
        for i in range(n):
            base = f"features.{idx}.conv"
            stride = s if i == 0 else 1
            block: Params = {
                "stride": stride, "use_res": stride == 1 and inp == c, "expand": t,
            }
            if t == 1:
                # Sequential: 0=dwconv, 1=AvgPool, 2=BN, 4=pwconv, 5=BN
                block["dwconv"] = _conv2d(sd, f"{base}.0")
                block["dw_bn"] = _bn(sd, f"{base}.2")
                block["project_conv"] = _conv2d(sd, f"{base}.4")
                block["project_bn"] = _bn(sd, f"{base}.5")
            else:
                # Sequential: 0=expand conv, 1=BN, 3=dwconv, 4=AvgPool,
                # 5=BN, 7=pwconv, 8=BN (models.py:1826-1848)
                block["expand_conv"] = _conv2d(sd, f"{base}.0")
                block["expand_bn"] = _bn(sd, f"{base}.1")
                block["dwconv"] = _conv2d(sd, f"{base}.3")
                block["dw_bn"] = _bn(sd, f"{base}.5")
                block["project_conv"] = _conv2d(sd, f"{base}.7")
                block["project_bn"] = _bn(sd, f"{base}.8")
            params["blocks"].append(block)
            inp = c
            idx += 1
    params["head_conv"] = _conv2d(sd, f"features.{idx}.0")
    params["head_bn"] = _bn(sd, f"features.{idx}.1")
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
    "cnn14_decisionlevelmax": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_decisionlevelavg": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_decisionlevelatt": lambda sd: _convert_cnn(sd, 6, att_head=True),
    "cnn6": lambda sd: _convert_cnn(sd, 4, att_head=False, block5x5=True),
    # emb variants share Cnn14's state-dict layout; only fc1/fc_audioset
    # dims differ (models.py:1315-1660) — the shape check pins them
    "cnn14_emb512": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_emb128": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "cnn14_emb32": lambda sd: _convert_cnn(sd, 6, att_head=False),
    "leenet11": lambda sd: _convert_leenet(sd, double=False),
    "leenet24": lambda sd: _convert_leenet(sd, double=True),
    "dainet19": _convert_dainet,
    "res1dnet31": lambda sd: _convert_res1dnet(sd, (2, 2, 2, 2, 2, 2, 2)),
    "res1dnet51": lambda sd: _convert_res1dnet(sd, (2, 3, 4, 6, 4, 3, 2)),
    "resnet22": lambda sd: _convert_resnet(sd, (2, 2, 2, 2), bottleneck=False),
    "resnet38": lambda sd: _convert_resnet(sd, (3, 4, 6, 3), bottleneck=False),
    "resnet54": lambda sd: _convert_resnet(sd, (3, 4, 6, 3), bottleneck=True),
    "wavegram_cnn14": lambda sd: _convert_wavegram(sd, logmel=False),
    "wavegram_logmel_cnn14": lambda sd: _convert_wavegram(sd, logmel=True),
    # identical layout to wavegram_logmel_cnn14; bn0 is 128-mel
    # (models.py:2988-3131) and is copied verbatim
    "wavegram_logmel128_cnn14": lambda sd: _convert_wavegram(sd, logmel=True),
    "mobilenetv1": _convert_mobilenetv1,
    "mobilenetv2": _convert_mobilenetv2,
}


def convert_pann(state_dict: Mapping[str, Any], architecture: str) -> Params:
    """Convert a PANN torch ``state_dict`` (already ``.numpy()``-ified or
    torch tensors) into the matching numpy parameter tree.

    :param architecture: registry architecture name (case-insensitive),
        e.g. ``"Cnn14"``, ``"ResNet38"``, ``"Wavegram_Logmel_Cnn14"``.
    """
    arch = architecture.lower()
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
