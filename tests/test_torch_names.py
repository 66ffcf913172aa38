"""The port holds a counterpart of every top-level name of conette_tpu, file
for file, apart from those it leaves out on purpose; and the names it
gained last against conette_tpu on the CPU: ``apply_pann_model``'s
``deterministic=`` keyword, ``wavegram_logmel128_cnn14_apply`` and the
native loader's ``is_available``."""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import random_batch_norms
from conette_tpu.models import pann as jax_pann
from conette_tpu.models import pann_zoo as jax_zoo
from conette_torch.models import pann, pann_zoo
from conette_torch.native import loader
from conette_torch.weights import to_numpy, to_torch
from test_torch_pann_zoo import _wave, assert_outputs_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (file, name): left out on purpose (ROADMAP "Copy rule" and Queue 1)
LEFT_OUT = {
    ("decoding/beam.py", "KV_REORDER"), ("decoding/beam.py", "REORDER_L_CHUNKS"),
    ("models/decoder.py", "DecodeCache"), ("models/decoder.py", "init_self_grouped"),
    ("huggingface/config.py", "pylog"), ("train/loop.py", "set_injected_lr"),
    ("utils/misc.py", "enable_compilation_cache"), ("utils/misc.py", "hard_exit"),
}


def _top_level_names(package: str) -> dict[str, set[str]]:
    root = os.path.join(REPO, package)
    out = {}
    for d, _, files in os.walk(root):
        rel_dir = os.path.relpath(d, root)
        if rel_dir.split(os.sep)[0] == "conf" or rel_dir == os.path.join("ops", "pallas"):
            continue  # the config tree (byte-equal copy) and the TPU kernels (csrc/)
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f)) as fh:
                tree = ast.parse(fh.read())
            names = set()
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    names.add(node.name)
                elif isinstance(node, ast.Assign):
                    names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
                elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                    names.add(node.target.id)
            out[os.path.normpath(os.path.join(rel_dir, f))] = {n for n in names if not n.startswith("_")}
    return out


def test_every_top_level_name_has_a_counterpart():
    jax_names, port_names = _top_level_names("conette_tpu"), _top_level_names("conette_torch")
    missing = {(f, n) for f, names in jax_names.items() for n in names - port_names.get(f, set())}
    assert missing == LEFT_OUT


@pytest.mark.parametrize("deterministic", [True, False])
def test_apply_pann_model_takes_deterministic(deterministic):
    tree = random_batch_norms(to_numpy(pann.build_pann_model("cnn6", torch.Generator().manual_seed(6))[0]),
                              np.random.default_rng(6))
    wav, lens = _wave()
    args = (torch.from_numpy(wav), torch.from_numpy(lens))
    if not deterministic:  # the PANN training mode is not ported
        with pytest.raises(NotImplementedError, match="item 6"):
            pann.apply_pann_model("cnn6", to_torch(tree), *args, deterministic=False)
        return
    want = jax_pann.apply_pann_model("cnn6", tree, wav, lens, deterministic=True)
    got = pann.apply_pann_model("cnn6", to_torch(tree), *args, deterministic=True)
    assert_outputs_close(got, want)


def test_wavegram_logmel128_cnn14_apply_matches_jax():
    tree = random_batch_norms(
        jax.tree.map(np.asarray, jax_zoo.wavegram_logmel128_cnn14_init(jax.random.PRNGKey(3))),
        np.random.default_rng(3))
    wav, lens = _wave()
    want = jax_zoo.wavegram_logmel128_cnn14_apply(tree, wav, lens)
    got = pann_zoo.wavegram_logmel128_cnn14_apply(to_torch(tree), torch.from_numpy(wav),
                                                  torch.from_numpy(lens))
    assert_outputs_close(got, want)


def test_native_is_available_builds_or_names_a_missing_compiler(monkeypatch):
    assert loader.is_available()
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "CXX", "g++-not-installed")
    assert not loader.is_available()
    # a compiler that fails is not an absent one: it raises
    monkeypatch.setattr(loader, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        loader.is_available()
