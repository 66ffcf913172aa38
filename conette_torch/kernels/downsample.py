"""The fused downsample seam: CUDA kernel wrapper and its plain version.

``fused_downsample`` computes LayerNorm over C (f32 statistics) followed
by Conv2d(k=2, s=2) from C to 2C, with the hand-written Hopper kernel
``conette_torch/csrc/downsample.cu``; it replaces the TPU kernel
``conette_tpu/ops/pallas/downsample.py`` (``fused_downsample_padded``). An odd
T floors (the last row is dropped); F must be even. For a tensor on the
CPU it runs :func:`downsample_reference`; for a CUDA tensor it launches the
kernel or raises.

The design, in short (the source's head note has the whole of it): one
call launches a pack kernel (W cast to bf16 in ``wgmma``'s core-matrix
order) and the seam kernel, in which one persistent CTA an SM walks work
items of ``TILE_ROWS`` = 64 output pixels × one slice of the 2C output
columns. Warp-specialised roles pass each 2×2 patch position along: a
producer warp streams the item's W slice through a shared-memory ring of
``cp.async.bulk`` copies (kept resident where the ring holds it and the
CTA's items share a slice), two LayerNorm warpgroups copy the position's
input pixels into a shared-memory A buffer and normalise them in place
(never in device memory), and an MMA warpgroup multiplies on ``wgmma`` and
writes the item's rows by bulk copies. Two pieces of it live here, in
Python that the CPU tests reach:

- :func:`pack_seam_weights` states the packed order of W, so that a work
  item's columns of one k16 step are one contiguous copy. It is the plain
  version of the kernel's ``seam_pack_kernel``;
- :func:`seam_plan` cuts the output columns into slices (of 192 where the
  tiles fill the card, else as many as it holds) and sizes the persistent
  grid. K is never split, so two runs give the same bits.

The C entry point is ``conette_downsample(x, ln_w, ln_b, w, bias, work, out,
B, T, F, C, slices, ctas, device, eps, stream)``: 7 pointers, 7 ints, 1
float; it launches on ``device`` itself, so the wrapper switches no device.

On the card the wrapper calls the custom op ``conette_torch::downsample``
(:func:`downsample_op`), whose only implementation is CUDA's: the kernel
through :func:`launch_seam`. Its fake implementation gives the output's
shape, so ``torch.export`` and CUDA graph capture see one node a call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from conette_torch.kernels import _build
from conette_torch.kernels.convnext_block import SM_COUNT, sm_count
from conette_torch.models.layers import conv2d, layer_norm

SUPPORTED_C = (96, 192, 384)
TILE_ROWS = 64                      # output pixels a CTA
SLICE_WIDTHS = (192, 128, 96, 64)   # output columns a CTA: the kernel's wgmma widths


def downsample_reference(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LN over C, then the (2, 2, C, 2C) HWIO conv with stride 2 on the
    floored T, in plain PyTorch."""
    t = x.shape[1] - x.shape[1] % 2
    y = layer_norm({"weight": ln_weight, "bias": ln_bias}, x[:, :t], eps=eps)
    return conv2d({"weight": conv_weight, "bias": conv_bias}, y, stride=(2, 2))


class SeamPlan(NamedTuple):
    """How one seam call is cut: ``tiles`` tiles of ``tile_rows`` output
    pixels, each in ``slices`` slices of ``slice_width`` output columns, the
    tiles × slices work items shared by ``ctas`` persistent CTAs."""

    tile_rows: int
    tiles: int
    slices: int
    slice_width: int
    ctas: int


def slice_counts(c: int) -> tuple[int, ...]:
    """The slice counts the kernel takes at this C, fewest first."""
    return tuple(sorted({2 * c // w for w in SLICE_WIDTHS if 2 * c % w == 0}))


@functools.lru_cache(maxsize=256)
def seam_plan(n_out: int, c: int, n_sm: int = SM_COUNT, slices: int | None = None) -> SeamPlan:
    """Cut the 2C output columns into slices of 192 where the tiles fill the
    card, else into the most slices whose work items one CTA an SM still
    holds at once (or into ``slices``, where given: ``chip_smoke.py`` times
    the launch at the other counts where the tiles alone do not fill the
    card); one persistent CTA an SM, at most one a work item."""
    tiles = -(-n_out // TILE_ROWS)
    counts = slice_counts(c)
    if slices is None:
        slices = max((s for s in counts if tiles * s <= n_sm), default=counts[0])
    elif slices not in counts:
        raise ValueError(f"the seam kernel cuts 2C = {2 * c} columns into {counts} slices, not {slices}")
    return SeamPlan(TILE_ROWS, tiles, slices, 2 * c // slices, min(tiles * slices, n_sm))


def pack_seam_weights(conv_weight: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The (2, 2, C, 2C) conv weight as the (4C, 2C) matrix of K row
    ``(2i + j)·C + c``, flat in the kernel's order: 8×8 core matrices
    [k/16][n/8][k/8 % 2][n % 8][k % 8], cast to ``dtype`` in the same copy."""
    c = conv_weight.shape[2]
    k, n = 4 * c, 2 * c
    packed = torch.empty((k // 16, n // 8, 2, 8, 8), dtype=dtype, device=conv_weight.device)
    # row k = 16·kb + 8·kh + kc, column n = 8·ng + nr
    packed.copy_(conv_weight.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 3, 1, 4, 2))
    return packed.reshape(-1)


class SeamOperands(NamedTuple):
    """A seam's parameters as the kernel takes them: contiguous f32, in the
    C entry point's order (the launch casts and lays out W itself)."""

    ln_w: torch.Tensor    # (C)
    ln_b: torch.Tensor    # (C)
    w: torch.Tensor       # (2, 2, C, 2C)
    bias: torch.Tensor    # (2C)


def prepare_seam_operands(
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
) -> SeamOperands:
    """The parameters as contiguous f32 (no copy when they already are);
    raises on what the kernel does not take."""
    c = ln_weight.shape[-1]
    if c not in SUPPORTED_C:
        raise ValueError(f"the seam kernel takes C in {SUPPORTED_C}, got {c}")
    f32 = torch.float32
    device = ln_weight.device
    ops = []
    for name, v, shape in zip(SeamOperands._fields, (ln_weight, ln_bias, conv_weight, conv_bias),
                              ((c,), (c,), (2, 2, c, 2 * c), (2 * c,))):
        if v.dtype != f32 or not v.is_contiguous():
            v = v.to(f32).contiguous()
        if v.device != device or v.shape != shape or v.data_ptr() % 32:
            _build.require(v, name, f32, shape, device)  # raises, naming what is wrong
        ops.append(v)
    return SeamOperands(*ops)


def launch_seam(x: torch.Tensor, ops: SeamOperands, plan: SeamPlan, eps: float = 1e-6,
                work: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the seam on prepared operands: the pack kernel (W as bf16 in
    ``pack_seam_weights`` order, into ``work``) and the seam kernel. Adds
    one to ``fused_downsample.launches``. ``work`` (bf16, 8·C²) is
    allocated here unless given."""
    b, t, f, c = x.shape
    _build.require(x, "x", torch.bfloat16, (b, t, f, c), ops.w.device)
    n_out = b * (t // 2) * (f // 2)
    if (ops.ln_w.shape != (c,) or f % 2 or plan.tiles * plan.tile_rows < n_out
            or plan.slices * plan.slice_width != 2 * c):
        raise ValueError(f"operands or plan do not match x of shape {tuple(x.shape)}")
    # the output, and behind it the packed weights unless given
    n_o = n_out * 2 * c
    buf = torch.empty(n_o + (8 * c * c if work is None else 0), dtype=torch.bfloat16,
                      device=x.device)
    if work is None:
        work = buf[n_o:]  # 32-byte aligned: n_o is a multiple of 2·C
    else:
        _build.require(work, "work", torch.bfloat16, (8 * c * c,), x.device)
    out = buf[:n_o].view(b, t // 2, f // 2, 2 * c)
    code = _build.entry("conette_downsample", 7, 7)(
        x.data_ptr(), *(o.data_ptr() for o in ops), work.data_ptr(), out.data_ptr(),
        b, t, f, c, plan.slices, plan.ctas, x.device.index, eps, _build.stream_of(x),
    )
    _build.check(code, "conette_downsample")
    fused_downsample.launches += 1
    return out


@torch.library.custom_op("conette_torch::downsample", mutates_args=(), device_types="cuda")
def downsample_op(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """The seam kernel as a custom op on CUDA tensors (no other device)."""
    b, t, f, c = x.shape
    ops = prepare_seam_operands(ln_weight, ln_bias, conv_weight, conv_bias)
    return launch_seam(x, ops, seam_plan(b * (t // 2) * (f // 2), c, sm_count(x.device)), eps)


@downsample_op.register_fake
def _downsample_fake(x, ln_weight, ln_bias, conv_weight, conv_bias, eps):
    b, t, f, c = x.shape
    return x.new_empty((b, t // 2, f // 2, 2 * c))


def fused_downsample(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """(B, T, F, C) → (B, T // 2, F // 2, 2C). On the card ``x`` must be
    contiguous bf16 with C in ``SUPPORTED_C``, and the wrapper calls
    ``conette_torch::downsample``. Each launch adds one to
    ``fused_downsample.launches``; its pack launch is part of the call."""
    if x.dim() != 4 or x.shape[1] < 2:
        raise ValueError(f"expected (B, T >= 2, F, C) activations, got {tuple(x.shape)}")
    if x.shape[2] % 2:
        raise ValueError(f"the downsample seam needs an even F, got {x.shape[2]}")
    if x.device.type == "cpu":
        return downsample_reference(x, ln_weight, ln_bias, conv_weight, conv_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_downsample runs on cuda or cpu, got {x.device}")
    return torch.ops.conette_torch.downsample(x, ln_weight, ln_bias, conv_weight, conv_bias, eps)


fused_downsample.launches = 0
