"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at the main path's stage and seam shapes (bf16, batch 2).

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

from conette_torch.kernels.convnext_block import convnext_block_reference, fused_convnext_block
from conette_torch.kernels.downsample import downsample_reference, fused_downsample

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


@pytest.mark.parametrize("t,f,c", STAGES)
def test_block_kernel_matches_plain_on_card(h100, t, f, c):
    rng = np.random.default_rng(c)
    args = (
        _randn(rng, (7, 7, 1, c), 0.1, h100), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c,), 0.1, h100, shift=1.0), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c, 4 * c), 0.05, h100), _randn(rng, (4 * c,), 0.05, h100),
        _randn(rng, (4 * c, c), 0.05, h100), _randn(rng, (c,), 0.05, h100),
        _randn(rng, (c,), 0.1, h100),  # layer scale N(0, 0.1)
    )
    x = _randn(rng, (2, t, f, c), 0.5, h100, torch.bfloat16)
    n = fused_convnext_block.launches
    got = fused_convnext_block(x, *args, eps=EPS)
    torch.cuda.synchronize()
    assert fused_convnext_block.launches == n + 1
    assert rel_err(convnext_block_reference(x, *args, eps=EPS), got) < 0.02


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
