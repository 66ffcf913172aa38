"""conette_torch layers and frontend against conette_tpu at float32 on the
CPU, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models import layers as jl
from conette_tpu.ops.frontend import logmel_spectrogram as jax_logmel
from conette_tpu.ops.resample import resample as jax_resample
from conette_tpu.ops.resample import resample_numpy as jax_resample_numpy
from conette_tpu.ops.stft import power_spectrogram as jax_power
from conette_torch.models import layers as tl
from conette_torch.ops.frontend import logmel_spectrogram
from conette_torch.ops.resample import resample_kernel, resample_numpy, resampled_length
from conette_torch.ops.stft import power_spectrogram
from conette_torch.weights import to_torch

RNG = np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("n_samples", [16000, 16000 + 123, 9601])
def test_logmel_matches_jax(n_samples):
    x = (RNG.standard_normal((2, n_samples)) * 0.1).astype(np.float32)
    want = np.asarray(jax_logmel(jnp.asarray(x)))
    got = logmel_spectrogram(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    pw = np.asarray(jax_power(jnp.asarray(x)))
    np.testing.assert_allclose(power_spectrogram(_t(x)).numpy(), pw, rtol=1e-4, atol=1e-5 * pw.max())


@pytest.mark.parametrize("orig", [44100, 48000, 16000])
def test_resample_numpy_matches_jax(orig):
    x = (RNG.standard_normal((2, orig // 3 + 17)) * 0.1).astype(np.float32)
    got = resample_numpy(x, orig, 32000)
    np.testing.assert_array_equal(got, jax_resample_numpy(x, orig, 32000))
    assert got.shape[-1] == resampled_length(x.shape[-1], orig, 32000)
    # the host resampler agrees with the device one the JAX bench uses
    np.testing.assert_allclose(
        got, np.asarray(jax_resample(jnp.asarray(x), orig, 32000)), atol=1e-5
    )
    assert resample_kernel(orig, 32000)[1] > 0


def test_layers_match_jax():
    x = RNG.standard_normal((2, 5, 6, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    lin = jax.tree.map(np.asarray, jl.linear_init(key, 8, 12))
    np.testing.assert_allclose(
        tl.linear(to_torch(lin), _t(x)).numpy(),
        np.asarray(jl.linear(lin, jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )
    ln = {"weight": RNG.standard_normal(8).astype(np.float32),
          "bias": RNG.standard_normal(8).astype(np.float32)}
    np.testing.assert_allclose(
        tl.layer_norm(to_torch(ln), _t(x), eps=1e-6).numpy(),
        np.asarray(jl.layer_norm(ln, jnp.asarray(x), eps=1e-6)), rtol=1e-5, atol=1e-5,
    )
    bn = {k: np.abs(RNG.standard_normal(8)).astype(np.float32) + 0.1
          for k in ("weight", "bias", "running_mean", "running_var")}
    np.testing.assert_allclose(
        tl.batch_norm_inference(to_torch(bn), _t(x)).numpy(),
        np.asarray(jl.batch_norm_inference(bn, jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )
    for kernel, stride, pad, groups in [
        ((7, 7), (1, 1), ((3, 3), (3, 3)), 8),
        ((2, 2), (2, 2), ((0, 0), (0, 0)), 1),
        ((4, 4), (4, 4), ((4, 4), (0, 0)), 1),
    ]:
        conv = jax.tree.map(np.asarray, jl.conv2d_init(key, 8, 8, kernel, groups=groups, init="torch"))
        np.testing.assert_allclose(
            tl.conv2d(to_torch(conv), _t(x), stride=stride, padding=pad, groups=groups).numpy(),
            np.asarray(jl.conv2d(conv, jnp.asarray(x), stride=stride, padding=pad, groups=groups)),
            rtol=1e-5, atol=1e-6,
        )
    np.testing.assert_allclose(
        tl.gelu(_t(x)).numpy(), np.asarray(jl.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6
    )
    emb = {"weight": RNG.standard_normal((10, 4)).astype(np.float32)}
    ids = np.array([[0, 3, 9], [2, 2, 1]])
    np.testing.assert_array_equal(
        tl.embedding(to_torch(emb), torch.from_numpy(ids)).numpy(),
        np.asarray(jl.embedding(emb, jnp.asarray(ids))),
    )


def test_bf16_linear_rounds_like_jax():
    """bf16 operands, f32 accumulation, one rounding to bf16 at the end:
    equal to JAX up to one bf16 ulp from summation order."""
    x = RNG.standard_normal((4, 64)).astype(np.float32)
    lin = jax.tree.map(np.asarray, jl.linear_init(jax.random.PRNGKey(5), 64, 32))
    want = np.asarray(jl.linear(lin, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tl.linear(to_torch(lin), _t(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
