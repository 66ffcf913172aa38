"""The block kernel's host-side plan and weight layout, on the CPU.

``block_plan`` decides how a block call is cut (64-row tiles, the split of
the hidden layer over CTAs, the scratch for the partial sums) and
``pack_block_weights`` lays W1 and W2 out in the order the kernel's
shared-memory ring consumes them. Both are plain Python, so they are held
here to what the kernel (``conette_torch/csrc/convnext_block.cu``) assumes.
"""

import numpy as np
import pytest
import torch

from conette_torch.kernels.convnext_block import (
    CTAS_PER_SM,
    HIDDEN_CHUNK,
    SM_COUNT,
    SUPPORTED_C,
    TILE_ROWS,
    block_plan,
    pack_block_weights,
)

# (T, F, C) of each stage for a 10 s clip
STAGES = [(252, 56, 96), (126, 28, 192), (63, 14, 384), (31, 7, 768)]


@pytest.mark.parametrize("t,f,c", STAGES)
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_block_plan_fills_one_wave(batch, t, f, c):
    n_pix = batch * t * f
    plan = block_plan(n_pix, c)
    chunks = 4 * c // HIDDEN_CHUNK
    slots = SM_COUNT * CTAS_PER_SM[c]  # CTAs the card runs at once
    assert plan.tile_rows == TILE_ROWS
    assert plan.tiles == -(-n_pix // TILE_ROWS)
    assert 1 <= plan.splits <= chunks
    if 2 * plan.tiles > slots:
        assert plan.splits == 1
    else:  # the most splits that still run in one wave, where the chunks allow
        assert plan.tiles * plan.splits <= slots
        assert plan.tiles * (plan.splits + 1) > slots or plan.splits == chunks
    if plan.splits == 1:
        assert plan.scratch_shape is None
    else:
        assert plan.scratch_shape == (plan.splits, n_pix, c)


def test_block_plan_at_batch_8():
    """Stages 1-3 need no split (stage 3's 111 tiles already take 111 of the
    132 SMs); stage 4's 28 tiles split in 4; the 1 s corpus bucket's stage 4
    (3 x 7 pixels a clip, a ragged last tile) in 44."""
    assert [block_plan(8 * t * f, c).splits for t, f, c in STAGES] == [1, 1, 1, 4]
    assert 28 * 4 <= SM_COUNT < 28 * 5
    assert block_plan(8 * 3 * 7, 768).splits == 44
    assert block_plan(8 * 31 * 7, 768, n_sm=16).splits == 1


def _unpack(packed: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Undo pack_block_weights: back to W1 (C, H) and W2 (H, C)."""
    h = 4 * c
    n = h // HIDDEN_CHUNK
    chunks = packed.reshape(n, 2, HIDDEN_CHUNK * c)

    def untile(tiles, rows, cols):  # [k/16][n/8][k/8 % 2][n % 8][k % 8] -> (K, N)
        t = tiles.reshape(n, rows // 16, cols // 8, 2, 8, 8)  # (ch, kb, ng, kh, nr, kc)
        return t.permute(0, 1, 3, 5, 2, 4).reshape(n, rows, cols)

    w1 = untile(chunks[:, 0], c, HIDDEN_CHUNK).permute(1, 0, 2).reshape(c, h)
    w2 = untile(chunks[:, 1], HIDDEN_CHUNK, c).reshape(h, c)
    return w1, w2


@pytest.mark.parametrize("c", SUPPORTED_C)
def test_weight_packing_is_a_bijection(c):
    rng = np.random.default_rng(c)
    w1 = torch.from_numpy(rng.standard_normal((c, 4 * c)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((4 * c, c)).astype(np.float32))
    packed = pack_block_weights(w1, w2)
    assert packed.dtype == torch.bfloat16 and packed.shape == (2 * c * 4 * c,)
    assert packed.is_contiguous()
    u1, u2 = _unpack(packed, c)
    assert torch.equal(u1.view(torch.int16), w1.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(u2.view(torch.int16), w2.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("c", SUPPORTED_C)
def test_weight_packing_puts_each_element_where_the_kernel_reads_it(c):
    """Element (k, n) of a chunk's K x N operand sits at
    ((k/16 · N/8 + n/8) · 2 + k/8 % 2) · 64 + n % 8 · 8 + k % 8, the W1
    chunk (K = C, N = 64) first and the W2 chunk (K = 64, N = C) after it;
    a chunk is 128·C elements."""
    h = 4 * c
    w1 = torch.arange(c * h, dtype=torch.float32).reshape(c, h) % 251  # exact in bf16
    w2 = -(torch.arange(h * c, dtype=torch.float32).reshape(h, c) % 241)
    packed = pack_block_weights(w1, w2).float()
    rng = np.random.default_rng(0)

    def off(k, n, cols):
        return (((k // 16) * (cols // 8) + n // 8) * 2 + (k // 8) % 2) * 64 + (n % 8) * 8 + k % 8

    for _ in range(200):
        ch = int(rng.integers(h // HIDDEN_CHUNK))
        k, n = int(rng.integers(c)), int(rng.integers(HIDDEN_CHUNK))
        assert packed[ch * 128 * c + off(k, n, HIDDEN_CHUNK)] == w1[k, ch * HIDDEN_CHUNK + n]
        k2, n2 = int(rng.integers(HIDDEN_CHUNK)), int(rng.integers(c))
        assert packed[ch * 128 * c + 64 * c + off(k2, n2, c)] == w2[ch * HIDDEN_CHUNK + k2, n2]
