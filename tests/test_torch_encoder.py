"""The port's ConvNeXt encoder (``convnext_apply``) against conette_tpu at
float32 on the CPU: frame embeddings, their lengths and the clip head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models.convnext import convnext_apply as jax_apply
from conette_tpu.models.convnext import convnext_init as jax_init
from conette_tpu.models.convnext import frame_reduction_factor as jax_reduction
from conette_torch.models.convnext import convnext_apply, frame_reduction_factor
from conette_torch.weights import to_torch


@pytest.fixture(scope="module")
def params():
    p = jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128)
    ))
    rng = np.random.default_rng(0)
    for stage in p["stages"]:  # layer scales large enough for the blocks to matter
        for block in stage:
            block["scale"] = (rng.standard_normal(block["scale"].shape) * 0.1).astype(np.float32)
    p["bn0"]["running_mean"] = (rng.standard_normal(224) * 3 - 20).astype(np.float32)
    p["bn0"]["running_var"] = (np.abs(rng.standard_normal(224)) * 50 + 10).astype(np.float32)
    return p


@pytest.mark.parametrize("n_samples", [32000 + 77, 24000])
def test_convnext_apply_matches_jax(params, n_samples):
    rng = np.random.default_rng(n_samples)
    wav = (rng.standard_normal((3, n_samples)) * 0.1).astype(np.float32)
    want = jax_apply(params, jnp.asarray(wav), None)
    n_out = want["frame_embs"].shape[-1]
    red = n_samples // n_out
    # half-way lengths exercise the half-to-even rounding of frame_embs_lens
    lens = np.array([n_samples, int(red * 2.5), int(red * 0.5)], np.int32)
    want = jax_apply(params, jnp.asarray(wav), jnp.asarray(lens))
    got = convnext_apply(to_torch(params), torch.from_numpy(wav), torch.from_numpy(lens))
    fe_w, fe_g = np.asarray(want["frame_embs"]), got["frame_embs"].numpy()
    assert fe_g.shape == fe_w.shape and fe_g.dtype == np.float32
    assert np.abs(fe_w - fe_g).max() / np.abs(fe_w).max() < 1e-4
    np.testing.assert_array_equal(got["frame_embs_lens"].numpy(), np.asarray(want["frame_embs_lens"]))
    np.testing.assert_allclose(
        got["clipwise_output"].numpy(), np.asarray(want["clipwise_output"]), atol=1e-5
    )
    assert frame_reduction_factor(n_samples) == jax_reduction(n_samples)


def test_convnext_apply_on_logmel_input(params):
    rng = np.random.default_rng(5)
    mel = (rng.standard_normal((2, 101, 224)) * 5 - 20).astype(np.float32)
    want = jax_apply(params, jnp.asarray(mel), None, waveform_input=False)
    got = convnext_apply(to_torch(params), torch.from_numpy(mel), waveform_input=False)
    np.testing.assert_allclose(
        got["frame_embs"].numpy(), np.asarray(want["frame_embs"]), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(got["frame_embs_lens"].numpy(), np.asarray(want["frame_embs_lens"]))
