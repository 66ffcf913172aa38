"""Pretrained-checkpoint registries.

Counterpart of ``conette_tpu/models/registries.py`` (reference
``src/conette/nn/ckpt.py:8-113``): named entries with source URL, checksum
and architecture, so that callers fetch a checkpoint on a connected host
(:func:`download_checkpoint`) or point ``CONETTE_CKPT_DIR`` at files staged
beforehand (:func:`resolve_checkpoint`). ``cnext_bl_75`` is the production
ConvNeXt encoder. The entries and both functions are the JAX package's;
:func:`load_registry_encoder` converts through the port's
``huggingface/convert.py`` and returns the numpy tree, which
``weights.to_torch`` moves to a device.
"""

from __future__ import annotations

import logging
import os
from typing import Any, NamedTuple

pylog = logging.getLogger(__name__)

DEFAULT_CKPT_DIR = os.path.expanduser("~/.cache/conette_torch/checkpoints")


class RegistryEntry(NamedTuple):
    name: str
    architecture: str
    url: str
    fname: str
    hash_value: str | None = None
    hash_type: str = "md5"
    state_dict_key: str | None = "model"


CNEXT_REGISTRY: dict[str, RegistryEntry] = {
    "cnext_nobl": RegistryEntry(
        name="cnext_nobl",
        architecture="ConvNeXt-Tiny",
        url="https://zenodo.org/record/8020843/files/convnext_tiny_465mAP_BL_AC_70kit.pth?download=1",
        fname="convnext_tiny_465mAP_BL_AC_70kit.pth",
    ),
    "cnext_bl_70": RegistryEntry(
        name="cnext_bl_70",
        architecture="ConvNeXt-Tiny",
        url="https://zenodo.org/record/8020843/files/convnext_tiny_471mAP_BL_AC_70kit.pth?download=1",
        fname="convnext_tiny_471mAP_BL_AC_70kit.pth",
    ),
    # production encoder for CoNeTTE (nn/ckpt.py: cnext_bl_75)
    "cnext_bl_75": RegistryEntry(
        name="cnext_bl_75",
        architecture="ConvNeXt-Tiny",
        url="https://zenodo.org/record/8020843/files/convnext_tiny_471mAP_BL_AC_75kit.pth?download=1",
        fname="convnext_tiny_471mAP_BL_AC_75kit.pth",
    ),
}

# The reference's PANN_REGISTRY ships exactly 9 checkpoints with md5s
# (nn/ckpt.py:38-113); MobileNetV1/V2 and Cnn14_16k are extra public PANN
# Zenodo files kept for zoo coverage (hashes unknown here → None).
PANN_REGISTRY: dict[str, RegistryEntry] = {
    name: RegistryEntry(
        name=name,
        architecture=arch,
        url=f"https://zenodo.org/record/3987831/files/{fname}?download=1",
        fname=fname,
        hash_value=md5,
    )
    for name, arch, fname, md5 in [
        ("Cnn10", "Cnn10", "Cnn10_mAP=0.380.pth",
         "bfb1f1f9968938fa8ef4012b8471f5f6"),
        ("Cnn14", "Cnn14", "Cnn14_mAP=0.431.pth",
         "541141fa2ee191a88f24a3219fff024e"),
        ("Cnn14_16k", "Cnn14_16k", "Cnn14_16k_mAP=0.438.pth", None),
        ("Cnn14_DecisionLevelAtt", "Cnn14_DecisionLevelAtt",
         "Cnn14_DecisionLevelAtt_mAP=0.425.pth",
         "c8281ca2b9967244b91d557aa941e8ca"),
        ("Cnn6", "Cnn6", "Cnn6_mAP=0.343.pth",
         "e25e26b84585b14c7754c91e48efc9be"),
        ("MobileNetV1", "MobileNetV1", "MobileNetV1_mAP=0.389.pth", None),
        ("MobileNetV2", "MobileNetV2", "MobileNetV2_mAP=0.383.pth", None),
        ("ResNet22", "ResNet22", "ResNet22_mAP=0.430.pth",
         "cf36d413096793c4e15dc752a3abd599"),
        ("ResNet38", "ResNet38", "ResNet38_mAP=0.434.pth",
         "bf12f36aaabac4e0855e22d3c3239c1b"),
        ("ResNet54", "ResNet54", "ResNet54_mAP=0.429.pth",
         "4f1f1406d37a29e2379916885e18c5f3"),
        ("Wavegram_Cnn14", "Wavegram_Cnn14", "Wavegram_Cnn14_mAP=0.389.pth",
         "1e3506ab640371e0b5a417b15fd66d21"),
        ("Wavegram_Logmel_Cnn14", "Wavegram_Logmel_Cnn14",
         "Wavegram_Logmel_Cnn14_mAP=0.439.pth",
         "17fa9ab65af3c0eb5ffbc5f65552c4e1"),
    ]
}


def resolve_checkpoint(entry: RegistryEntry, ckpt_dir: str | None = None) -> str:
    """Local path of a registry checkpoint; raises with instructions when the
    file is absent (no implicit downloads on egress-less hosts)."""
    ckpt_dir = ckpt_dir or os.environ.get("CONETTE_CKPT_DIR", DEFAULT_CKPT_DIR)
    fpath = os.path.join(ckpt_dir, entry.fname)
    if os.path.isfile(fpath):
        return fpath
    raise FileNotFoundError(
        f"Checkpoint {entry.name!r} not found at {fpath!r}. Download "
        f"{entry.url} to {ckpt_dir} (or set CONETTE_CKPT_DIR)."
    )


def load_registry_encoder(name: str, ckpt_dir: str | None = None) -> Any:
    """Load and convert a registry ConvNeXt checkpoint into the numpy tree."""
    if name not in CNEXT_REGISTRY:
        raise KeyError(f"Unknown encoder {name!r} (known: {list(CNEXT_REGISTRY)})")
    fpath = resolve_checkpoint(CNEXT_REGISTRY[name], ckpt_dir)
    import torch

    from conette_torch.huggingface.convert import convert_convnext

    state = torch.load(fpath, map_location="cpu", weights_only=True)
    entry = CNEXT_REGISTRY[name]
    if entry.state_dict_key and entry.state_dict_key in state:
        state = state[entry.state_dict_key]
    state = {k: v.numpy() for k, v in state.items() if hasattr(v, "numpy")}
    return convert_convnext(state, prefix="")


def download_checkpoint(
    entry: RegistryEntry, ckpt_dir: str | None = None, force: bool = False
) -> str:
    """Fetch a registry checkpoint to the cache with md5 verification
    (twin of torchoutil ``RegistryHub.download_file``; the reference
    downloads lazily on first use, ``nn/ckpt.py`` + ``prepare.py:66-136``).
    Connected hosts only — egress-less hosts stage files instead
    (``resolve_checkpoint``)."""
    import hashlib
    import urllib.request

    ckpt_dir = ckpt_dir or os.environ.get("CONETTE_CKPT_DIR", DEFAULT_CKPT_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)
    fpath = os.path.join(ckpt_dir, entry.fname)
    if os.path.isfile(fpath) and not force:
        return fpath
    tmp = fpath + ".part"
    pylog.info(f"Downloading {entry.name} from {entry.url}")
    try:
        with urllib.request.urlopen(entry.url, timeout=60) as resp, open(tmp, "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except OSError as err:
        if os.path.isfile(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"Download of {entry.name!r} failed ({err}); on egress-less "
            f"hosts stage {entry.fname} under {ckpt_dir} manually."
        ) from err
    if entry.hash_value:
        digest = hashlib.new(entry.hash_type)
        with open(tmp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        if digest.hexdigest() != entry.hash_value:
            os.unlink(tmp)
            raise ValueError(
                f"Checksum mismatch for {entry.name!r}: got "
                f"{digest.hexdigest()}, expected {entry.hash_value}"
            )
    os.replace(tmp, fpath)
    return fpath
