"""The block and seam kernels' plain versions against conette_tpu.

On the CPU: the plain versions equal the JAX XLA path at float32, and sit
within the JAX package's own bf16 envelope (max relative error < 0.02,
``tests/test_pallas_convnext_block.py:82``, ``tests/test_pallas_downsample.py:57``)
of the Pallas kernels run in interpret mode. The wrappers take the plain
version for CPU tensors. The kernels themselves are held against these
plain versions on the card by ``tests/test_torch_kernels_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models.convnext import convnext_block as jax_block
from conette_tpu.models.layers import conv2d as jax_conv2d
from conette_tpu.models.layers import layer_norm as jax_layer_norm
from conette_tpu.ops.pallas.convnext_block import fused_convnext_block as pallas_block
from conette_tpu.ops.pallas.convnext_block import pad_fc
from conette_tpu.ops.pallas.downsample import fused_downsample_padded as pallas_seam
from conette_torch.kernels.convnext_block import convnext_block_reference, fused_convnext_block
from conette_torch.kernels.downsample import downsample_reference, fused_downsample

EPS = 1e-6


def rel_err(want, got):
    w = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32)
    return float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-6))


def make_block(rng, c):
    """Block params as numpy, with non-trivial LN affine, biases and a
    layer scale drawn as N(0, 0.1) so the MLP shows in the output."""
    return {
        "dwconv": {"weight": rng.standard_normal((7, 7, 1, c)).astype(np.float32) * 0.1,
                   "bias": rng.standard_normal(c).astype(np.float32) * 0.1},
        "norm": {"weight": 1 + 0.1 * rng.standard_normal(c).astype(np.float32),
                 "bias": 0.1 * rng.standard_normal(c).astype(np.float32)},
        "pwconv1": {"weight": rng.standard_normal((c, 4 * c)).astype(np.float32) * 0.05,
                    "bias": rng.standard_normal(4 * c).astype(np.float32) * 0.05},
        "pwconv2": {"weight": rng.standard_normal((4 * c, c)).astype(np.float32) * 0.05,
                    "bias": rng.standard_normal(c).astype(np.float32) * 0.05},
        "scale": rng.standard_normal(c).astype(np.float32) * 0.1,
    }


def block_tuple(p, conv=lambda a: a):
    return tuple(conv(a) for a in (
        p["dwconv"]["weight"], p["dwconv"]["bias"], p["norm"]["weight"], p["norm"]["bias"],
        p["pwconv1"]["weight"], p["pwconv1"]["bias"], p["pwconv2"]["weight"],
        p["pwconv2"]["bias"], p["scale"],
    ))


def make_seam(rng, c):
    return (
        1 + 0.1 * rng.standard_normal(c).astype(np.float32),
        0.05 * rng.standard_normal(c).astype(np.float32),
        rng.standard_normal((2, 2, c, 2 * c)).astype(np.float32) * 0.05,
        rng.standard_normal(2 * c).astype(np.float32) * 0.05,
    )


def _t(a, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device, dtype)


@pytest.mark.parametrize("shape", [(2, 9, 7, 16), (1, 12, 8, 32)])
def test_block_reference_matches_jax_f32(shape):
    rng = np.random.default_rng(sum(shape))
    p = make_block(rng, shape[-1])
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    want = np.asarray(jax_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = convnext_block_reference(_t(x), *block_tuple(p, _t), eps=EPS).numpy()
    assert rel_err(want, got) < 1e-5


def test_block_reference_matches_pallas_bf16():
    rng = np.random.default_rng(96)
    c = 96
    p = make_block(rng, c)
    x = (rng.standard_normal((1, 10, 7, c)) * 0.5).astype(np.float32)
    want = pallas_block(
        jnp.asarray(x, jnp.bfloat16), *block_tuple(p, jnp.asarray), eps=EPS, interpret=True
    )
    got = convnext_block_reference(_t(x, torch.bfloat16), *block_tuple(p, _t), eps=EPS)
    assert got.dtype == torch.bfloat16
    assert rel_err(want, got.float()) < 0.02


@pytest.mark.parametrize("shape", [(2, 7, 8, 16), (1, 6, 4, 32)])
def test_seam_reference_matches_jax_f32(shape):
    rng = np.random.default_rng(sum(shape))
    ln_w, ln_b, w, b = make_seam(rng, shape[-1])
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    want = np.asarray(jax_conv2d(
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        jax_layer_norm({"weight": jnp.asarray(ln_w), "bias": jnp.asarray(ln_b)},
                       jnp.asarray(x), eps=EPS),
        stride=(2, 2),
    ))
    got = downsample_reference(_t(x), _t(ln_w), _t(ln_b), _t(w), _t(b), eps=EPS).numpy()
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 2 * shape[3])
    assert rel_err(want, got) < 1e-5


def test_seam_reference_matches_pallas_bf16():
    rng = np.random.default_rng(7)
    t, f, c = 9, 8, 96  # odd T floors
    ln_w, ln_b, w, b = make_seam(rng, c)
    x = (rng.standard_normal((1, t, f, c)) * 0.5).astype(np.float32)
    want = pallas_seam(
        pad_fc(jnp.asarray(x, jnp.bfloat16)), f, c, jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(w), jnp.asarray(b), eps=EPS, interpret=True,
    )[:, :, : f // 2, : 2 * c]
    got = downsample_reference(
        _t(x, torch.bfloat16), _t(ln_w), _t(ln_b), _t(w), _t(b), eps=EPS
    )
    assert got.shape == tuple(want.shape)
    assert rel_err(want, got.float()) < 0.02


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    p = make_block(rng, 16)
    x = _t(rng.standard_normal((1, 5, 6, 16)), torch.bfloat16)
    n_block, n_seam = fused_convnext_block.launches, fused_downsample.launches
    args = block_tuple(p, _t)
    assert torch.equal(fused_convnext_block(x, *args, eps=EPS),
                       convnext_block_reference(x, *args, eps=EPS))
    seam = tuple(_t(a) for a in make_seam(rng, 16))
    assert torch.equal(fused_downsample(x, *seam, eps=EPS), downsample_reference(x, *seam, eps=EPS))
    assert (fused_convnext_block.launches, fused_downsample.launches) == (n_block, n_seam)
    with pytest.raises(ValueError, match="even F"):
        fused_downsample(_t(rng.standard_normal((1, 4, 7, 16))), *seam)
