"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at the main path's stage and seam shapes (bf16, batch 2), and
the block kernel at two ragged shapes.

A CUDA kernel has no CPU mode, so these tests skip without an sm_90
device. This file imports neither JAX nor conette_tpu, so it also runs
where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_kernels_card.py``.
The envelope is the JAX package's own for its kernels: max relative error
< 0.02 (``tests/test_pallas_convnext_block.py:82``).
"""

import numpy as np
import pytest
import torch

from conette_torch.kernels.convnext_block import (
    block_plan,
    convnext_block_reference,
    fused_convnext_block,
    launch_block,
    pack_block_weights,
    prepare_block_operands,
    work_size,
)
from conette_torch.kernels.downsample import downsample_reference, fused_downsample
from conette_torch.kernels.logmel import fused_logmel, logmel_reference
from conette_torch.models.convnext import convnext_apply

EPS = 1e-6
# (T, F, C) of each stage's blocks and seam input for a 10 s clip
STAGES = [(252, 56, 96), (126, 28, 192), (63, 14, 384), (31, 7, 768)]


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (H100); the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, scale, device, dtype=torch.float32, shift=0.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device, dtype)


def rel_err(want, got):
    return float((want.float() - got.float()).abs().max() / want.float().abs().max().clamp_min(1e-6))


# each stage at batch 2 (stages 3 and 4 split the hidden layer over CTAs),
# stage 4 of a 1 s clip at batch 8 (168 pixels: a ragged last tile, split
# 44 ways) and stage 1 at batch 1
BLOCK_SHAPES = [(2, t, f, c) for t, f, c in STAGES] + [(8, 3, 7, 768), (1, 252, 56, 96)]


@pytest.mark.parametrize("b,t,f,c", BLOCK_SHAPES)
def test_block_kernel_matches_plain_on_card(h100, b, t, f, c):
    rng = np.random.default_rng(c + b)
    args = (
        _randn(rng, (7, 7, 1, c), 0.1, h100), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c,), 0.1, h100, shift=1.0), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c, 4 * c), 0.05, h100), _randn(rng, (4 * c,), 0.05, h100),
        _randn(rng, (4 * c, c), 0.05, h100), _randn(rng, (c,), 0.05, h100),
        _randn(rng, (c,), 0.1, h100),  # layer scale N(0, 0.1)
    )
    x = _randn(rng, (b, t, f, c), 0.5, h100, torch.bfloat16)
    n = fused_convnext_block.launches
    got = fused_convnext_block(x, *args, eps=EPS)
    again = fused_convnext_block(x, *args, eps=EPS)
    torch.cuda.synchronize()
    assert fused_convnext_block.launches == n + 2
    assert rel_err(convnext_block_reference(x, *args, eps=EPS), got) < 0.02
    # the split's partial sums are added in a fixed order: the same bits
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("c", [96, 192, 384, 768])
def test_block_pack_kernel_writes_the_plain_layout(h100, c):
    """The launch's pack kernel writes W1 and W2 in ``pack_block_weights``
    order, then the depthwise weights and the layer scale, all as bf16
    rounded like ``Tensor.to(torch.bfloat16)``, bit for bit."""
    rng = np.random.default_rng(c)
    args = [_randn(rng, shape, 0.1, h100) for shape in
            ((7, 7, 1, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,), (c,))]
    x = _randn(rng, (1, 7, 7, c), 0.5, h100, torch.bfloat16)
    ops = prepare_block_operands(*args)
    work = torch.empty(work_size(c), dtype=torch.bfloat16, device=h100)
    launch_block(x, ops, block_plan(49, c), EPS, work=work)
    torch.cuda.synchronize()
    bf16 = torch.bfloat16
    want = torch.cat([pack_block_weights(args[4], args[6]), args[0].reshape(-1).to(bf16),
                      args[8].to(bf16)])
    assert torch.equal(work.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("t,f,c", STAGES[:3])
def test_seam_kernel_matches_plain_on_card(h100, t, f, c):
    rng = np.random.default_rng(c)
    seam = (
        _randn(rng, (c,), 0.1, h100, shift=1.0), _randn(rng, (c,), 0.05, h100),
        _randn(rng, (2, 2, c, 2 * c), 0.05, h100), _randn(rng, (2 * c,), 0.05, h100),
    )
    x = _randn(rng, (2, t, f, c), 0.5, h100, torch.bfloat16)
    n = fused_downsample.launches
    got = fused_downsample(x, *seam, eps=EPS)
    torch.cuda.synchronize()
    assert fused_downsample.launches == n + 1
    want = downsample_reference(x, *seam, eps=EPS)
    assert got.shape == want.shape == (2, t // 2, f // 2, 2 * c)
    assert rel_err(want, got) < 0.02


def _waveform(rng, b, s, h100):
    """Noise and a tone, with a silent tail in the last clip so the frames
    that straddle its end and the -100 dB floor are both covered."""
    t = np.arange(s) / 32000
    x = 0.05 * rng.standard_normal((b, s)) + 0.3 * np.sin(2 * np.pi * 440 * t * (1 + t))
    x[-1, s - s // 4:] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(h100)


# f32: the JAX envelope of its kernel (tests/test_pallas_logmel.py:21).
# bf16: kernel and plain version round at the same points and differ by f32
# summation order, which can flip one bf16 rounding of a power bin, about
# 0.017 dB on the mel bins that hold it; 0.05 dB (times the affine scale).
@pytest.mark.parametrize("shape", [(2, 320_000), (2, 22_400)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine", [False, True])
def test_logmel_kernel_matches_plain_on_card(h100, shape, dtype, affine):
    rng = np.random.default_rng(shape[1])
    x = _waveform(rng, *shape, h100)
    scale = shift = None
    if affine:
        scale = _randn(rng, (224,), 0.3, h100, shift=1.0)
        shift = _randn(rng, (224,), 1.0, h100)
    n = fused_logmel.launches
    got = fused_logmel(x, bn_scale=scale, bn_shift=shift, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert fused_logmel.launches == n + 1
    want = logmel_reference(x, bn_scale=scale, bn_shift=shift, compute_dtype=dtype)
    assert got.shape == want.shape == (shape[0], 1 + shape[1] // 320, 224)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-4)
    else:
        gain = 1.0 if scale is None else float(scale.abs().max())
        assert float((got - want).abs().max()) <= 0.05 * gain
    if not affine:  # the silent frames of the last clip sit on the -100 dB floor
        floor = torch.full_like(got[-1, -5:], -100.0)
        torch.testing.assert_close(got[-1, -5:], floor, atol=1e-4, rtol=0)


def test_bf16_card_route_keeps_the_frontend_kernel(h100):
    """Nothing turns the log-mel kernel off for a CUDA waveform at bf16."""
    x = torch.zeros((1, 32_000), device=h100)
    with pytest.raises(ValueError, match="always takes the log-mel kernel"):
        convnext_apply({}, x, compute_dtype=torch.bfloat16, use_fused_frontend=False)


def test_kernels_reject_what_they_do_not_take(h100):
    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=h100)
    w = torch.zeros(64, device=h100)
    with pytest.raises(ValueError, match="C in"):
        fused_convnext_block(x, torch.zeros((7, 7, 1, 64), device=h100), w, w, w,
                             torch.zeros((64, 256), device=h100), torch.zeros(256, device=h100),
                             torch.zeros((256, 64), device=h100), w, w)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_downsample(torch.zeros((1, 8, 8, 96), device=h100), torch.ones(96, device=h100),
                         torch.zeros(96, device=h100), torch.zeros((2, 2, 96, 192), device=h100),
                         torch.zeros(192, device=h100))
