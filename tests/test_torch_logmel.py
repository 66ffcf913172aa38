"""The log-mel kernel's plain version and the fused-frontend route against
conette_tpu, on the CPU.

``logmel_reference`` is held against the JAX package's Pallas log-mel
kernel run in interpret mode (``fused_logmel(..., interpret=True)``):
- f32 compute: the JAX envelope of its kernel, atol 2e-3 dB, rtol 1e-4
  (``tests/test_pallas_logmel.py:21``);
- bf16 compute: both round frames, basis, power and filterbank at the same
  points and differ only by f32 summation order, which can flip one bf16
  rounding of a power bin (2^-8 relative, about 0.017 dB on the mel bins
  that hold it): atol 0.05 dB, times the largest |scale| with the affine.
The kernel itself is held against ``logmel_reference`` on the card by
``tests/test_torch_kernels_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models.convnext import convnext_apply as jax_convnext_apply
from conette_tpu.models.convnext import convnext_init as jax_convnext_init
from conette_tpu.ops.pallas.logmel import fused_logmel as pallas_logmel
from conette_torch.kernels.logmel import fused_logmel, logmel_reference
from conette_torch.models.convnext import convnext_apply
from conette_torch.ops.frontend import LogMelConfig
from conette_torch.weights import to_torch

F32_TOL = dict(atol=2e-3, rtol=1e-4)
BF16_ATOL = 0.05

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def waveform(rng, b, s, silent_tail=True):
    """Noise and a chirp; the last clip ends in silence, so the frames that
    straddle its end and the -100 dB floor are covered."""
    t = np.arange(s) / 32000
    x = 0.05 * rng.standard_normal((b, s)) + 0.3 * np.sin(2 * np.pi * 440 * t * (1 + t))
    if silent_tail:
        x[-1, s - s // 4:] = 0.0
    return x.astype(np.float32)


def affine(rng):
    return (rng.uniform(0.5, 2.0, 224).astype(np.float32),
            rng.standard_normal(224).astype(np.float32))


@pytest.mark.parametrize("b,s", [(1, 32_000), (2, 22_400)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_affine", [False, True])
def test_reference_matches_pallas_kernel(b, s, dtype, with_affine):
    rng = np.random.default_rng(s + b)
    x = waveform(rng, b, s)
    torch_dtype, jax_dtype = DTYPES[dtype]
    scale = shift = None
    if with_affine:
        scale, shift = affine(rng)
    want = np.asarray(pallas_logmel(
        jnp.asarray(x), bn_scale=None if scale is None else jnp.asarray(scale),
        bn_shift=None if shift is None else jnp.asarray(shift),
        interpret=True, compute_dtype=jax_dtype,
    ))
    got = logmel_reference(
        torch.from_numpy(x), bn_scale=None if scale is None else torch.from_numpy(scale),
        bn_shift=None if shift is None else torch.from_numpy(shift), compute_dtype=torch_dtype,
    ).numpy()
    assert got.shape == want.shape == (b, 1 + s // 320, 224)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        gain = 1.0 if scale is None else float(np.abs(scale).max())
        assert np.abs(got - want).max() <= BF16_ATOL * gain


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silence_sits_on_the_floor(dtype):
    x = np.zeros((1, 16_000), np.float32)
    torch_dtype, jax_dtype = DTYPES[dtype]
    got = logmel_reference(torch.from_numpy(x), compute_dtype=torch_dtype).numpy()
    want = np.asarray(pallas_logmel(jnp.asarray(x), interpret=True, compute_dtype=jax_dtype))
    np.testing.assert_allclose(got, -100.0, atol=1e-4)
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(waveform(rng, 2, 9_600))
    scale, shift = (torch.from_numpy(a) for a in affine(rng))
    n = fused_logmel.launches
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            fused_logmel(x, bn_scale=scale, bn_shift=shift, compute_dtype=dtype),
            logmel_reference(x, bn_scale=scale, bn_shift=shift, compute_dtype=dtype),
        )
    assert fused_logmel.launches == n
    with pytest.raises(ValueError, match="top_db"):
        fused_logmel(x, LogMelConfig(top_db=80.0))
    with pytest.raises(TypeError, match="compute_dtype"):
        fused_logmel(x, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="together"):
        fused_logmel(x, bn_scale=scale)
    with pytest.raises(RuntimeError):  # reflect padding needs more than n_fft // 2 samples
        fused_logmel(x[:, :400])


@pytest.fixture(scope="module")
def encoder():
    """A narrow JAX encoder with a non-trivial bn0 and layer scales, as
    numpy, and its torch twin."""
    enc = jax.tree.map(np.asarray, jax_convnext_init(
        jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128)))
    rng = np.random.default_rng(0)
    enc["bn0"] = {
        "weight": rng.uniform(0.5, 1.5, 224).astype(np.float32),
        "bias": (0.3 * rng.standard_normal(224)).astype(np.float32),
        "running_mean": (-40 + 5 * rng.standard_normal(224)).astype(np.float32),
        "running_var": rng.uniform(50, 200, 224).astype(np.float32),
    }
    for stage in enc["stages"]:
        for block in stage:
            block["scale"] = (0.1 * rng.standard_normal(block["scale"].shape)).astype(np.float32)
    return enc, to_torch(enc)


def rel_err(want, got):
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-6))


def test_fused_frontend_encoder_matches_jax(encoder):
    """``use_fused_frontend=True`` in both packages: JAX runs its Pallas
    kernel in interpret mode with bn0 folded, the port runs
    ``logmel_reference`` with the same folding (f32 compute). The kernels'
    f32 envelope in dB carries through the f32 encoder: relative 1e-4."""
    enc_np, enc_t = encoder
    rng = np.random.default_rng(1)
    x = waveform(rng, 2, 22_400)
    lens = np.array([22_400, 16_000])
    want = jax_convnext_apply(jax.tree.map(jnp.asarray, enc_np), jnp.asarray(x),
                              jnp.asarray(lens), use_fused_frontend=True)
    got = convnext_apply(enc_t, torch.from_numpy(x), torch.from_numpy(lens),
                         use_fused_frontend=True)
    assert rel_err(np.asarray(want["frame_embs"]), got["frame_embs"].numpy()) < 1e-4
    assert rel_err(np.asarray(want["clipwise_output"]), got["clipwise_output"].numpy()) < 1e-4
    np.testing.assert_array_equal(got["frame_embs_lens"].numpy(), np.asarray(want["frame_embs_lens"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_route_is_unfused_on_cpu(encoder, dtype):
    """``use_fused_frontend=None`` resolves to the plain frontend for a CPU
    waveform at either compute type: bit-equal to ``False``. At bf16 the
    fused route rounds the power and so gives other numbers, which shows
    the comparison can tell the two apart."""
    _, enc_t = encoder
    x = torch.from_numpy(waveform(np.random.default_rng(2), 2, 16_000))
    n = fused_logmel.launches
    default = convnext_apply(enc_t, x, compute_dtype=dtype)
    plain = convnext_apply(enc_t, x, compute_dtype=dtype, use_fused_frontend=False)
    assert torch.equal(default["frame_embs"], plain["frame_embs"])
    assert torch.equal(default["clipwise_output"], plain["clipwise_output"])
    if dtype == torch.bfloat16:
        fused = convnext_apply(enc_t, x, compute_dtype=dtype, use_fused_frontend=True)
        assert not torch.equal(default["frame_embs"], fused["frame_embs"])
    assert fused_logmel.launches == n
