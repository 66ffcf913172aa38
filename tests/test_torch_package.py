"""conette_torch as a package: import isolation from JAX, device defaults,
the weight bridge and the copied tokenizer, held against conette_tpu."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.convert import load_params_npz as jax_load_npz
from conette_tpu.huggingface.convert import save_params_npz as jax_save_npz
from conette_tpu.models.conette import ConetteConfig, conette_init
from conette_tpu.models.convnext import convnext_init
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
from conette_torch.huggingface.config import CoNeTTEConfig
from conette_torch.huggingface.convert import flatten_pytree
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.tokenization import AACTokenizer
from conette_torch.weights import load_tree, save_tree, to_numpy, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_conette_tpu():
    code = (
        "import sys\n"
        "import conette_torch, conette_torch.huggingface.model, conette_torch.predict\n"
        "import conette_torch.kernels.convnext_block, conette_torch.kernels.logmel\n"
        "import conette_torch.serving, conette_torch.huggingface.convert\n"
        "import conette_torch.utils.flac, conette_torch.utils.lossy\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'conette_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoNeTTEModel(CoNeTTEConfig())


@pytest.fixture(scope="module")
def jax_tree():
    enc = convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    model = conette_init(
        jax.random.PRNGKey(1),
        ConetteConfig(vocab_size=50, proj_in=128, d_model=32, nhead=2,
                      num_decoder_layers=2, dim_feedforward=64),
    )
    return jax.tree.map(np.asarray, {"encoder": enc, "model": model})


def _assert_bit_equal(a, b):
    fa, fb = flatten_pytree(a), flatten_pytree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def test_weight_bridge_round_trip_is_bit_exact(jax_tree):
    tree = jax_tree
    bridged = to_torch(tree)
    assert isinstance(bridged["encoder"]["stages"][0][0]["pwconv1"]["weight"], torch.Tensor)
    assert bridged["encoder"]["stages"][0][0]["pwconv1"]["weight"].shape == (16, 64)
    _assert_bit_equal(to_numpy(bridged), tree)


def test_params_npz_is_shared_by_both_packages(jax_tree, tmp_path):
    tree = jax_tree
    jax_save_npz(str(tmp_path / "jax.npz"), tree)
    _assert_bit_equal(to_numpy(load_tree(str(tmp_path / "jax.npz"))), tree)
    save_tree(str(tmp_path / "port.npz"), to_torch(tree))
    _assert_bit_equal(jax_load_npz(str(tmp_path / "port.npz")), tree)


CORPUS = [
    "A bird sings, loudly!",
    "an engine hums near a road",
    "People talk and a dog barks.",
    "rain falls on a tin roof while thunder rumbles",
]


def test_tokenizer_copy_matches_conette_tpu():
    jt, pt = JaxTokenizer(), AACTokenizer()
    jt.fit(CORPUS)
    pt.fit(CORPUS)
    for t in (jt, pt):
        t.add_special_token("<bos_clotho>")
    assert jt.get_vocab() == pt.get_vocab()
    sents = CORPUS + ["a cat meows at an unknown zebra"]
    unk = jt.unk_token
    for s in sents:
        np.testing.assert_array_equal(
            jt.encode_single(s, default=unk), pt.encode_single(s, default=unk)
        )
    ids = jt.encode_batch(sents, default=unk, padding="batch")
    np.testing.assert_array_equal(ids, pt.encode_batch(sents, default=unk, padding="batch"))
    assert jt.decode_batch(ids) == pt.decode_batch(ids)
    # txt states cross over in both directions, as config.json carries them
    assert AACTokenizer.from_txt_state(jt.get_txt_state()).get_vocab() == jt.get_vocab()
    assert JaxTokenizer.from_txt_state(pt.get_txt_state()).get_vocab() == pt.get_vocab()
    # equal but for ``_target_``, the class path each package writes
    pt_state, jt_state = pt.get_txt_state(), jt.get_txt_state()
    assert pt_state.pop("_target_").startswith("conette_torch.")
    jt_state.pop("_target_")
    assert pt_state == jt_state
