"""``build_pann_model`` and the checkpoint conversion of the port's PANN
zoo against conette_tpu's, and ``load_registry_pann`` for the registry's
zoo entries: ResNet22/38/54, MobileNetV1/V2 and Cnn6 here, the waveform
models in ``test_torch_pann_zoo_convert_wave.py``, the Cnn14 variants and
the decision-level heads in ``test_torch_pann_zoo_convert_cnn14.py``
(Cnn10 and Cnn14_DecisionLevelAtt: ``test_torch_pann.py``). Each file holds
its architectures' three checks, which share JAX's compiled inits.

- ``build_pann_model``: the tree's leaves have JAX's shapes and dtypes, its
  steering values (strides, layer kinds, flags) and its batch norms'
  constant inits (the residual branches' last BN weight is zero) are
  JAX's, and so is the frame embedding width.
- ``convert_pann``: full-width random state dicts in the reference's
  layout (the conversion's shape check builds the full model), from the
  generators of ``tests/test_convert_pann.py`` for the eleven
  architectures it covers and the ones below for the rest; every converted
  tree equals JAX's bit for bit. It also goes back through
  ``torch_fixtures.reference_pann_state``, the converter's inverse with which
  the card run stages its registry checkpoints, and must convert to itself.
- ``load_registry_pann``: a generated state dict saved under the entry's
  file name in ``CONETTE_CKPT_DIR`` loads to JAX's conversion of it.
"""

import jax
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.convert_pann import convert_pann as jax_convert_pann
from conette_tpu.models import pann as jax_pann
from conette_torch.huggingface import convert_pann
from conette_torch.huggingface.convert import flatten_pytree
from conette_torch.models import pann
from conette_torch.models.registries import PANN_REGISTRY
from conette_torch.weights import to_numpy
from test_convert_pann import (
    _GENERATORS,
    _bn_sd,
    _conv1d_sd,
    _cnn14_sd,
    _linear_sd,
    _pre_wav_block_sd,
    _wavegram_sd,
)
from torch_fixtures import reference_pann_state


def _cnn14_variant_sd(rng, n_mels=64, emb=None):
    sd = _cnn14_sd(rng)
    sd |= _bn_sd("bn0", n_mels, rng)
    if emb is not None:  # Cnn14_emb*: fc1 2048 → emb, fc_audioset emb → 527
        sd |= _linear_sd("fc1", 2048, emb, rng) | _linear_sd("fc_audioset", emb, 527, rng)
    return sd


def _leenet_sd(rng, double):
    spec = ([(1, 64), (64, 96), (96, 128), (128, 128), (128, 256), (256, 256), (256, 512),
             (512, 512), (512, 1024)] if double else
            [(1, 64), (64, 64), (64, 64), (64, 128), (128, 128), (128, 128), (128, 128),
             (128, 128), (128, 256)])
    sd = {}
    for bi, (i, o) in enumerate(spec, 1):
        sd |= _conv1d_sd(f"conv_block{bi}.conv1", i, o, 3, rng) | _bn_sd(f"conv_block{bi}.bn1", o, rng)
        if double:
            sd |= _conv1d_sd(f"conv_block{bi}.conv2", o, o, 3, rng)
            sd |= _bn_sd(f"conv_block{bi}.bn2", o, rng)
    emb, fc1 = spec[-1][1], 1024 if double else 512
    return sd | _linear_sd("fc1", emb, fc1, rng) | _linear_sd("fc_audioset", fc1, 527, rng)


def _dainet_sd(rng):
    sd = _conv1d_sd("conv0", 1, 64, 80, rng) | _bn_sd("bn0", 64, rng)
    for bi, (i, o) in enumerate([(64, 64), (64, 128), (128, 256), (256, 512)], 1):
        ch = i
        for j in range(1, 5):
            sd |= _conv1d_sd(f"conv_block{bi}.conv{j}", ch, o, 3, rng)
            sd |= _bn_sd(f"conv_block{bi}.bn{j}", o, rng)
            ch = o
        # every reference block declares its downsample; DaiNet uses it only
        # where the channels change, and the converter skips it elsewhere
        sd |= _conv1d_sd(f"conv_block{bi}.downsample", i, o, 1, rng)
        sd |= _bn_sd(f"conv_block{bi}.bn_downsample", o, rng)
    return sd | _linear_sd("fc1", 512, 512, rng) | _linear_sd("fc_audioset", 512, 527, rng)


def _res1dnet_sd(rng, depths):
    sd = _conv1d_sd("conv0", 1, 64, 11, rng) | _bn_sd("bn0", 64, rng)
    inplanes = 64
    for li, (planes, stride, blocks) in enumerate(
            zip((64, 128, 256, 512, 1024, 1024, 2048), (1, 4, 4, 4, 4, 4, 4), depths), 1):
        for bi in range(blocks):
            p = f"resnet.layer{li}.{bi}"
            sd |= _conv1d_sd(f"{p}.conv1", inplanes, planes, 3, rng) | _bn_sd(f"{p}.bn1", planes, rng)
            sd |= _conv1d_sd(f"{p}.conv2", planes, planes, 3, rng) | _bn_sd(f"{p}.bn2", planes, rng)
            s = stride if bi == 0 else 1
            if s != 1 or inplanes != planes:  # (AvgPool,) conv, BN
                j = int(s != 1)
                sd |= _conv1d_sd(f"{p}.downsample.{j}", inplanes, planes, 1, rng)
                sd |= _bn_sd(f"{p}.downsample.{j + 1}", planes, rng)
            inplanes = planes
    return sd | _linear_sd("fc1", 2048, 2048, rng) | _linear_sd("fc_audioset", 2048, 527, rng)


def _wavegram_logmel128_sd(rng):
    sd = _wavegram_sd(rng, True)
    for k in [k for k in sd if k.startswith("pre_block3.")]:
        del sd[k]
    return sd | _pre_wav_block_sd("pre_block3", 128, 256, rng) | _bn_sd("bn0", 128, rng)


GENERATORS = {
    **{k: v for k, v in _GENERATORS.items() if k not in ("cnn10", "cnn14_decisionlevelatt")},
    **{name: _cnn14_sd for name in ("cnn14_16k", "cnn14_8k", "cnn14_no_specaug", "cnn14_no_dropout",
                                    "cnn14_mixup_time_domain", "cnn14_decisionlevelmax",
                                    "cnn14_decisionlevelavg")},
    "cnn14_mel32": lambda rng: _cnn14_variant_sd(rng, n_mels=32),
    "cnn14_mel128": lambda rng: _cnn14_variant_sd(rng, n_mels=128),
    "cnn14_emb512": lambda rng: _cnn14_variant_sd(rng, emb=512),
    "cnn14_emb128": lambda rng: _cnn14_variant_sd(rng, emb=128),
    "cnn14_emb32": lambda rng: _cnn14_variant_sd(rng, emb=32),
    "leenet11": lambda rng: _leenet_sd(rng, False),
    "leenet24": lambda rng: _leenet_sd(rng, True),
    "dainet19": _dainet_sd,
    "res1dnet31": lambda rng: _res1dnet_sd(rng, (2, 2, 2, 2, 2, 2, 2)),
    "res1dnet51": lambda rng: _res1dnet_sd(rng, (2, 3, 4, 6, 4, 3, 2)),
    "wavegram_logmel128_cnn14": _wavegram_logmel128_sd,
}


def assert_trees_equal(got, want):
    got, want = flatten_pytree(got), flatten_pytree(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


STEERING = ("stride", "kind", "use_res", "expand", "double", "bottleneck")


def check_structure(name: str) -> None:
    got, width = pann.build_pann_model(name, torch.Generator().manual_seed(0))
    want, jax_width = jax_pann.build_pann_model(name, jax.random.PRNGKey(0))
    assert width == jax_width
    g, w = flatten_pytree(to_numpy(got)), flatten_pytree(want)
    assert {k: (v.shape, v.dtype) for k, v in g.items()} == {k: (v.shape, v.dtype) for k, v in w.items()}
    for k, v in w.items():
        if k.endswith(STEERING) or k.rsplit("/", 1)[0] + "/running_var" in w:
            assert g[k].tobytes() == v.tobytes(), k


def check_conversion(arch: str) -> None:
    sd = GENERATORS[arch](np.random.default_rng(len(arch)))
    want = jax_convert_pann(sd, arch)
    got = convert_pann.convert_pann({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, arch)
    assert_trees_equal(got, want)
    assert_trees_equal(convert_pann.convert_pann(reference_pann_state(got), arch), got)


def check_registry(name: str, ckpt_dir, monkeypatch) -> None:
    entry = PANN_REGISTRY[name]
    sd = GENERATORS[entry.architecture.lower()](np.random.default_rng(7))
    path = ckpt_dir / entry.fname
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    monkeypatch.setenv("CONETTE_CKPT_DIR", str(ckpt_dir))
    loaded = convert_pann.load_registry_pann(name)
    path.unlink()  # up to 420 MB: not left for the temporary directories' cleanup
    assert_trees_equal(loaded, jax_convert_pann(sd, entry.architecture))


ARCHS = ["cnn6", "mobilenetv1", "mobilenetv2", "resnet22", "resnet38", "resnet54"]


@pytest.mark.parametrize("name", ARCHS)
def test_build_pann_model_gives_jax_s_structure(name):
    check_structure(name)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_pann_matches_jax(arch):
    check_conversion(arch)


@pytest.mark.parametrize("name", ["Cnn6", "MobileNetV1", "MobileNetV2", "ResNet22", "ResNet38",
                                  "ResNet54"])
def test_load_registry_pann_loads_the_zoo_entries(tmp_path, monkeypatch, name):
    check_registry(name, tmp_path, monkeypatch)
