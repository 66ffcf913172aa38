"""The seam kernel's host-side plan and operand layouts, on the CPU.

``seam_plan`` decides how a seam call is cut (64-row tiles, slices of the
output columns) and ``pack_seam_weights`` lays W out in the order the
kernel's shared-memory ring consumes it. Both are plain Python, so they are
held here to what the kernel (``conette_torch/csrc/downsample.cu``) assumes.
A plain composition walks the kernel's own addressing (the patch-major K
order, the A buffers in ``a_off`` order, the ring's stages of packed W read
through wgmma's descriptor rule) in f32 and must give the plain version's
result. The build's library name is held to hash the headers too.
"""

import numpy as np
import pytest
import torch

from conette_torch.kernels import _build
from conette_torch.kernels.downsample import (
    SLICE_WIDTHS,
    SUPPORTED_C,
    TILE_ROWS,
    downsample_reference,
    pack_seam_weights,
    seam_plan,
    slice_counts,
)
from conette_torch.models.layers import layer_norm

SM_COUNT = 132
EPS = 1e-6


def _unpack(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Undo pack_seam_weights: back to (2, 2, C, 2C)."""
    k, n = 4 * c, 2 * c
    t = packed.reshape(k // 16, n // 8, 2, 8, 8)  # (kb, ng, kh, nr, kc)
    return t.permute(0, 2, 4, 1, 3).reshape(2, 2, c, n)


@pytest.mark.parametrize("c", SUPPORTED_C)
def test_seam_weight_packing_is_a_bijection(c):
    rng = np.random.default_rng(c)
    w = torch.from_numpy(rng.standard_normal((2, 2, c, 2 * c)).astype(np.float32))
    packed = pack_seam_weights(w)
    assert packed.dtype == torch.bfloat16 and packed.shape == (8 * c * c,)
    assert packed.is_contiguous()
    assert torch.equal(_unpack(packed, c).view(torch.int16), w.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("c", SUPPORTED_C)
def test_seam_weight_packing_puts_each_element_where_the_kernel_reads_it(c):
    """Element (k, n) of the (4C, 2C) matrix, k = (2i + j)·C + channel, sits at
    ((k/16 · 2C/8 + n/8) · 2 + k/8 % 2) · 64 + n % 8 · 8 + k % 8."""
    n_cols = 2 * c
    w = (torch.arange(8 * c * c, dtype=torch.float32) % 251).reshape(2, 2, c, n_cols)  # exact in bf16
    packed = pack_seam_weights(w).float()
    rng = np.random.default_rng(0)
    for _ in range(200):
        i, j, ch, n = (int(rng.integers(2)), int(rng.integers(2)), int(rng.integers(c)),
                       int(rng.integers(n_cols)))
        k = (2 * i + j) * c + ch
        off = (((k // 16) * (n_cols // 8) + n // 8) * 2 + (k // 8) % 2) * 64 + (n % 8) * 8 + k % 8
        assert packed[off] == w[i, j, ch, n]


# (B, T, F, C) of each seam input at batch 8: 10 s clips, then the 1 s
# corpus bucket (odd T at the first two seams), with (tiles, slices, ctas)
SEAM_PLANS = [
    ((8, 252, 56, 96), (441, 1, 132)),
    ((8, 126, 28, 192), (111, 2, 132)),
    ((8, 63, 14, 384), (28, 4, 112)),
    ((8, 27, 56, 96), (46, 2, 92)),
    ((8, 13, 28, 192), (11, 6, 66)),
    ((8, 6, 14, 384), (3, 12, 36)),
]


@pytest.mark.parametrize("shape,want", SEAM_PLANS)
def test_seam_plan_fills_one_wave(shape, want):
    b, t, f, c = shape
    n_out = b * (t // 2) * (f // 2)
    plan = seam_plan(n_out, c, SM_COUNT)
    assert (plan.tiles, plan.slices, plan.ctas) == want
    assert plan.tile_rows == TILE_ROWS and plan.tiles == -(-n_out // TILE_ROWS)
    assert plan.slice_width in SLICE_WIDTHS and plan.slices * plan.slice_width == 2 * c
    # one persistent CTA an SM, never more CTAs than work items
    assert plan.ctas == min(plan.tiles * plan.slices, SM_COUNT)
    counts = slice_counts(c)
    if plan.tiles * counts[0] > SM_COUNT:  # the tiles alone fill the card
        assert plan.slices == counts[0] == 2 * c // 192
    else:  # the most slices whose work items all run at once
        assert plan.tiles * plan.slices <= SM_COUNT
        more = [s for s in counts if s > plan.slices]
        assert not more or plan.tiles * more[0] > SM_COUNT


def test_seam_plan_slice_counts():
    assert slice_counts(96) == (1, 2, 3)
    assert slice_counts(192) == (2, 3, 4, 6)
    assert slice_counts(384) == (4, 6, 8, 12)
    assert seam_plan(8 * 126 * 28 // 4, 192, n_sm=16).slices == 2
    plan = seam_plan(8 * 31 * 7, 384, SM_COUNT, slices=12)
    assert (plan.slices, plan.slice_width, plan.ctas) == (12, 64, SM_COUNT)
    with pytest.raises(ValueError, match="slices"):
        seam_plan(100, 96, SM_COUNT, slices=4)


def _a_off(m: int, k: int, rows: int = TILE_ROWS) -> int:
    """csrc/hopper.cuh::a_off: element (m, k) of a 64-row A tile."""
    return ((((k >> 4) * (rows // 8) + (m >> 3)) * 2 + ((k >> 3) & 1)) * 8 + (m & 7)) * 8 + (k & 7)


def _read_k16(buf: torch.Tensor, base: int, rows: int) -> torch.Tensor:
    """What a wgmma descriptor without swizzle reads at element ``base``: a
    (rows, 16) K-major operand of 8×8 core matrices, the next 8 of K 64
    elements on (128 bytes), the next 8 rows 128 elements on (256 bytes)."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    return buf[base + (r // 8) * 128 + (k // 8) * 64 + (r % 8) * 8 + k % 8]


def _kernel_order_seam(x, ln_w, ln_b, conv_w, conv_b, slices):
    """The seam as the kernel walks it, in f32: for each 64-pixel tile and
    column slice, each patch position q's LayerNorm'd pixels laid out in an
    A buffer by a_off, and W's packed k16 steps brought into ring stages
    (KS steps each) from the slice's offset, multiplied step by step."""
    b, t, f, c = x.shape
    t2, f2 = t // 2, f // 2
    n_out, n_cols = b * t2 * f2, 2 * c
    ns = n_cols // slices
    ks = 4 if c == 384 else 2
    wpack = pack_seam_weights(conv_w, torch.float32)
    y = layer_norm({"weight": ln_w, "bias": ln_b}, x, eps=EPS)  # f32 in, f32 out
    out = torch.zeros((n_out, n_cols))
    for tile in range(-(-n_out // TILE_ROWS)):
        g = tile * TILE_ROWS + torch.arange(TILE_ROWS)
        valid = g < n_out
        gb, r = g // (t2 * f2), g % (t2 * f2)
        for s in range(slices):
            n0 = s * ns
            acc = torch.zeros((TILE_ROWS, ns))
            for q in range(4):
                i, j = q // 2, q % 2
                abuf = torch.zeros(TILE_ROWS * c)
                for m in range(TILE_ROWS):
                    if valid[m]:  # a pixel past the last one reads zeros
                        row = y[gb[m], 2 * (r[m] // f2) + i, 2 * (r[m] % f2) + j]
                        for k in range(0, c, 8):
                            abuf[_a_off(m, k):_a_off(m, k) + 8] = row[k:k + 8]
                for st in range(c // 16 // ks):
                    stage = torch.cat([  # one bulk copy a k16 step: 16·NS values from 16·n0 on
                        wpack[kb * 16 * n_cols + 16 * n0:kb * 16 * n_cols + 16 * (n0 + ns)]
                        for kb in range(q * c // 16 + st * ks, q * c // 16 + (st + 1) * ks)])
                    for kk in range(ks):
                        a = _read_k16(abuf, (st * ks + kk) * TILE_ROWS * 16, TILE_ROWS)
                        bt = _read_k16(stage, kk * ns * 16, ns)  # (NS, 16): B transposed
                        acc += a @ bt.T
            rows = g[valid]
            out[rows, n0:n0 + ns] = acc[valid] + conv_b[n0:n0 + ns]
    return out.reshape(b, t2, f2, n_cols)


# small shapes through both kernel orders: whole and ragged tiles, odd T,
# the fewest and the most slices of each C
@pytest.mark.parametrize("shape,slices", [
    ((2, 17, 16, 96), 3),      # 128 output pixels: two whole tiles; odd T
    ((3, 11, 14, 96), 1),      # 105: a ragged last tile; odd T
    ((1, 8, 6, 192), 2),       # 12: one ragged tile
    ((1, 5, 4, 192), 6),       # odd T, slices of 64
])
def test_kernel_order_composition_equals_the_plain_version(shape, slices):
    b, t, f, c = shape
    rng = np.random.default_rng(sum(shape) + slices)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ln_w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    ln_b = torch.from_numpy((0.05 * rng.standard_normal(c)).astype(np.float32))
    conv_w = torch.from_numpy((0.05 * rng.standard_normal((2, 2, c, 2 * c))).astype(np.float32))
    conv_b = torch.from_numpy((0.05 * rng.standard_normal(2 * c)).astype(np.float32))
    want = downsample_reference(x, ln_w, ln_b, conv_w, conv_b, eps=EPS)
    got = _kernel_order_seam(x, ln_w, ln_b, conv_w, conv_b, slices)
    assert got.shape == want.shape == (b, t // 2, f // 2, 2 * c)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """An edited header (csrc/*.cuh) names another library, so a build
    never loads one compiled against its old bytes."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path()
    assert _build.library_path() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path() != first
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build.library_path() == first
