"""The port's PANN zoo (``models/pann_zoo.py`` through
``models/pann.py::apply_pann_model``) against conette_tpu's, on the CPU,
and the weight bridge's handling of the zoo trees' Python steering values
(strides, layer kinds, flags).

Each architecture runs at full width (the port's ``build_pann_model``
tree, every batch norm randomised and conv biases kept random, so that no
residual branch adds zero) on two clips of 1.5 s at 32 kHz, the second cut
to 3/5 for ``frame_embs_lens``: long enough that Res1dNet's /20480
reduction keeps 2 frames and the decision-level heads pad their framewise
output. Both packages get the same numpy tree and waveform.

Tolerances: at f32, every output key within 1e-6 of the larger of 1 and
the key's largest value (``ENC_ATOL``, scaled because the same operations
summed in another order round in proportion to the values: Cnn6's frame
embeddings reach 2.7), and ``embedding`` within 2e-6 of it: relu(fc1) of
the pooled frames is a 2048-term f32 sum, which Res1dNet51 rounds 1.25e-6
apart. At bf16 every activation is rounded to 8 bits of mantissa at each
layer in both packages, and the sums are ordered differently, so a value
can land one bf16 ulp apart and carry it forward: within 2e-2 of the key's
largest value, the envelope the JAX package sets for its own bf16 kernels
(``tests/test_pallas_convnext_block.py:82``; 6.7e-3 measured at worst).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.convert import save_params_npz as jax_save_npz
from conette_tpu.models import pann as jax_pann
from conette_tpu.models.conette import ConetteConfig, conette_init
from conette_tpu.models.convnext import convnext_init
from conette_torch.huggingface.convert import flatten_pytree, save_params_npz
from conette_torch.models import pann, pann_zoo
from conette_torch.weights import load_tree, named_leaves, to_numpy, to_torch
from torch_fixtures import random_batch_norms

ZOO_NAMES = sorted({
    "cnn6", "cnn14_decisionlevelavg", "cnn14_decisionlevelmax", "dainet19", "leenet11",
    "leenet24", "mobilenetv1", "mobilenetv2", "res1dnet31", "res1dnet51", "resnet22", "resnet38",
    "resnet54", "wavegram_cnn14", "wavegram_logmel128_cnn14", "wavegram_logmel_cnn14",
})
ENC_ATOL = 1e-6
EMB_ATOL = 2e-6
BF16_REL = 2e-2
SAMPLES = 48_000


def zoo_tree(name: str) -> dict:
    """The port's full-width tree of ``name`` as numpy, its batch norms
    drawn from a seed."""
    tree = to_numpy(pann.build_pann_model(name, torch.Generator().manual_seed(len(name)))[0])
    return random_batch_norms(tree, np.random.default_rng(len(name)))


def _wave(b: int = 2) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(SAMPLES)
    return ((0.1 * rng.standard_normal((b, SAMPLES))).astype(np.float32),
            np.array([SAMPLES, SAMPLES * 3 // 5][:b]))


def assert_outputs_close(got: dict, want: dict, rel: float | None = None) -> None:
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k]).astype(np.float32) if want[k].dtype != np.int32 else np.asarray(want[k])
        g = got[k].float().numpy() if got[k].is_floating_point() else got[k].numpy()
        assert g.shape == w.shape, k
        scale = float(np.abs(w).max())
        atol = rel * scale if rel is not None else (
            (EMB_ATOL if k == "embedding" else ENC_ATOL) * max(1.0, scale))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_apply_pann_model_matches_jax(name):
    tree = zoo_tree(name)
    wav, lens = _wave()
    want = jax_pann.apply_pann_model(name, tree, wav, lens)
    got = pann.apply_pann_model(name, to_torch(tree), torch.from_numpy(wav), torch.from_numpy(lens))
    assert_outputs_close(got, want)
    if "framewise_output" in want:
        assert want["framewise_output"].shape[1] == SAMPLES // 320 + 1


@pytest.mark.parametrize("name", ["resnet38", "res1dnet31"])  # one 2-D, one 1-D
def test_apply_pann_model_bf16_matches_jax(name):
    tree = zoo_tree(name)
    wav, lens = _wave()
    want = jax_pann.apply_pann_model(name, tree, wav, lens, compute_dtype=jnp.bfloat16)
    got = pann.apply_pann_model(name, to_torch(tree), torch.from_numpy(wav), torch.from_numpy(lens),
                                compute_dtype=torch.bfloat16)
    assert_outputs_close(got, want, rel=BF16_REL)


def test_apply_pann_model_rejects_unknown_names():
    with pytest.raises(ValueError, match="Unknown PANN model"):
        pann.build_pann_model("resnet18")
    with pytest.raises(ValueError, match="Unknown PANN model"):
        pann.apply_pann_model("resnet18", {}, torch.zeros(1, 3200))
    with pytest.raises(ValueError, match="pooling"):
        pann_zoo.cnn14_decisionlevel_apply({}, torch.zeros(1, 3200), pooling="median")


@pytest.mark.parametrize("k", [2, 3, 4])
def test_1d_pools_match_jax(k):
    from conette_tpu.models import pann_zoo as jax_zoo

    x = np.random.default_rng(k).standard_normal((2, 11, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    for port, ref in ((pann_zoo._max_pool1d, jax_zoo._max_pool1d),
                      (pann_zoo._max_pool1d_pad, jax_zoo._max_pool1d_pad),
                      (pann_zoo._avg_pool1d, jax_zoo._avg_pool1d)):
        np.testing.assert_allclose(port(xt, k).numpy(), np.asarray(ref(x, k)), rtol=0, atol=1e-7)
    np.testing.assert_allclose(pann_zoo._avg_pool(torch.from_numpy(x[..., None]), 2).numpy(),
                               np.asarray(jax_zoo._avg_pool(jnp.asarray(x[..., None]), 2)), atol=1e-7)


STEERING = ("stride", "kind", "use_res", "expand", "double", "bottleneck")


@pytest.mark.parametrize("name", ["mobilenetv1", "mobilenetv2"])
def test_steering_values_round_trip_through_params_npz(tmp_path, name):
    """A MobileNet tree (layer kinds as strings, strides as ints, flags as
    bools) through either package's ``params.npz`` and back: its steering
    values are Python values again, never tensors, and it gives the outputs
    of the tree it was saved from."""
    tree = to_torch(zoo_tree(name))
    save_params_npz(str(tmp_path / "port.npz"), to_numpy(tree))
    jax_save_npz(str(tmp_path / "jax.npz"), zoo_tree(name))
    wav = torch.from_numpy(_wave(1)[0][:, :16_000])
    want = pann.apply_pann_model(name, tree, wav)
    before = dict(named_leaves(tree))
    for path in ("port.npz", "jax.npz"):
        loaded = load_tree(str(tmp_path / path))
        leaves = dict(named_leaves(loaded))
        assert leaves.keys() == before.keys()
        for k, v in leaves.items():
            if k.endswith(STEERING):
                assert type(v) is type(before[k]) and v == before[k], k
            else:
                assert isinstance(v, torch.Tensor) and torch.equal(v, before[k]), k
        got = pann.apply_pann_model(name, loaded, wav)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_weight_bridge_leaves_array_trees_as_they_were():
    """The trees that hold no steering value (ConvNeXt, CoNeTTE, the Cnn
    family) bridge to a tensor at every leaf, and back bit for bit, as
    before the zoo."""
    trees = [
        convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128)),
        conette_init(jax.random.PRNGKey(1), ConetteConfig(vocab_size=50, proj_in=128, d_model=32,
                                                          nhead=2, num_decoder_layers=2,
                                                          dim_feedforward=64)),
        *(jax_pann.pann_init(jax.random.PRNGKey(2), (8, 16, 32, 64), att_head=att)
          for att in (False, True)),
    ]
    for tree in trees:
        tree = jax.tree.map(np.asarray, tree)
        bridged = to_torch(tree)
        assert all(isinstance(v, torch.Tensor) for _, v in named_leaves(bridged))
        back, want = flatten_pytree(to_numpy(bridged)), flatten_pytree(tree)
        assert back.keys() == want.keys()
        assert all(back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes() for k, v in want.items())
