"""Inputs and comparisons shared by the port's tests and the on-card smoke
run at the repo's root (which imports this file from its directory):
PANN trees with drawn batch norms and zero conv biases, the reference's
state dict of a PANN tree, and the decode's scripted caption lengths and
same-bits check. Not a test module: it imports neither JAX nor
conette_tpu, so the card runs it.
"""

from __future__ import annotations

import numpy as np

# caption lengths (EOS included) drawn as the JAX bench draws them from the
# released checkpoint's Clotho lengths (bench.py, not imported: it imports
# JAX), forced by an EOS bias from step length - 1
LEN_MEAN, LEN_STD, LEN_MIN, LEN_MAX = 11.6, 2.6, 5, 18
LEN_SEED = 7
EOS_FORCE = 1.0e4


def same_bits(a, b) -> bool:
    import torch

    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(bits), b.view(bits)))


def target_lengths(n: int) -> np.ndarray:
    rng = np.random.default_rng(LEN_SEED)
    return np.clip(np.round(rng.normal(LEN_MEAN, LEN_STD, n)), LEN_MIN, LEN_MAX).astype(np.int32)


def eos_schedule(lengths: np.ndarray, max_pred: int) -> np.ndarray:
    """An EOS bias from step ``length - 1`` on, so that every beam of a clip
    ends after exactly ``length`` tokens."""
    steps = np.arange(max_pred)[None, :]
    return np.where(steps >= lengths[:, None] - 1, EOS_FORCE, 0.0).astype(np.float32)


def outputs_same_bits(a, b) -> bool:
    """Whether two programs' outputs (float and integer tensors) have the
    same bits."""
    import torch

    return all(same_bits(x, y) if x.is_floating_point() else bool(torch.equal(x, y))
               for x, y in zip(a, b))


def random_batch_norms(tree, rng: np.random.Generator):
    """A numpy PANN tree with every batch norm drawn from ``rng`` (weight
    and running variance in [0.5, 1.5), bias and running mean N(0, 0.1));
    other leaves as they are."""
    if isinstance(tree, dict):
        if "running_var" in tree:
            n = len(tree["weight"])
            return {"weight": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "running_mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "running_var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        return {k: random_batch_norms(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [random_batch_norms(v, rng) for v in tree]
    return tree


def without_conv_biases(tree):
    """A numpy PANN tree with every 2-D conv's bias zero, as the converter
    makes it from the reference's bias-free convs."""
    if isinstance(tree, dict):
        if np.ndim(tree.get("weight")) == 4:
            return dict(tree, bias=np.zeros_like(tree["bias"]))
        return {k: without_conv_biases(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [without_conv_biases(v) for v in tree]
    return tree


def reference_pann_state(tree) -> dict:
    """The reference's torch state dict of a numpy PANN tree (the inverse
    of ``convert_pann``, for every name of ``PANN_ZOO_NAMES``): 2-D conv
    biases dropped (the reference's convs have none), with the BN counters
    and a frontend buffer that the converter skips."""
    sd = {"spectrogram_extractor.stft.conv_real.weight": np.zeros((513, 1, 1024), np.float32)}

    def put(prefix: str, p) -> None:
        if "running_var" in p:  # BatchNorm
            sd.update({f"{prefix}.{k}": np.asarray(v) for k, v in p.items()})
            sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
        elif "weight" in p and "bias" in p and np.ndim(p["weight"]) == 2:  # Linear
            sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["weight"]).T)
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        elif "weight" in p:  # HWIO conv2d → OIHW, WIO conv1d → (out, in, k)
            w = np.asarray(p["weight"])
            sd[f"{prefix}.weight"] = np.ascontiguousarray(
                w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.transpose(2, 1, 0))
        else:  # a block: its convs and BNs by name, a ResNet downsample by index
            for k, v in p.items():
                if k == "downsample" and "conv" in v:
                    i = int(p["stride"] != 1)  # (AvgPool,) conv, BN
                    put(f"{prefix}.downsample.{i}", v["conv"])
                    put(f"{prefix}.downsample.{i + 1}", v["bn"])
                elif isinstance(v, dict):
                    put(f"{prefix}.{k}", v)

    if "features" in tree:  # MobileNetV1: conv_bn (0, 2), conv_dw (0, 2, 4, 5)
        for i, f in enumerate(tree["features"]):
            names = (("conv", 0), ("bn", 2)) if f["kind"] == "bn" else (
                ("dwconv", 0), ("bn1", 2), ("pwconv", 4), ("bn2", 5))
            for k, j in names:
                put(f"features.{i}.{j}", f[k])
        tree = {k: tree[k] for k in ("bn0", "fc1", "fc_audioset")}
    elif "stem_conv" in tree:  # MobileNetV2
        put("features.0.0", tree["stem_conv"])
        put("features.0.2", tree["stem_bn"])
        for i, b in enumerate(tree["blocks"], 1):
            idx = ((("dwconv", 0), ("dw_bn", 2), ("project_conv", 4), ("project_bn", 5))
                   if b["expand"] == 1 else
                   (("expand_conv", 0), ("expand_bn", 1), ("dwconv", 3), ("dw_bn", 5),
                    ("project_conv", 7), ("project_bn", 8)))
            for k, j in idx:
                put(f"features.{i}.conv.{j}", b[k])
        put(f"features.{len(tree['blocks']) + 1}.0", tree["head_conv"])
        put(f"features.{len(tree['blocks']) + 1}.1", tree["head_bn"])
        tree = {k: tree[k] for k in ("bn0", "fc1", "fc_audioset")}
    # Wavegram_Cnn14 keeps the log-mel branch's conv_block1, so its blocks
    # are conv_block2..6
    first = 2 if "blocks" in tree and "conv_block1" in tree else 1
    for k, v in tree.items():
        if k == "blocks":
            for i, b in enumerate(v):
                put(f"conv_block{i + first}", b)
        elif k == "layers":
            for li, stage in enumerate(v, 1):
                for bi, b in enumerate(stage):
                    put(f"resnet.layer{li}.{bi}", b)
        elif k == "att":  # AttBlock's Conv1d k1 heads
            for h in ("att", "cla"):
                sd[f"att_block.{h}.weight"] = np.ascontiguousarray(np.asarray(v[h]["weight"]).T)[:, :, None]
                sd[f"att_block.{h}.bias"] = np.asarray(v[h]["bias"])
        elif isinstance(v, dict):
            put(k, v)
    return sd
