"""The fused ConvNeXt block: CUDA kernel wrapper and its plain version.

``fused_convnext_block`` computes one whole block,
``x + scale ⊙ (W2·GELU(W1·LN(dwconv7×7(x) + b_dw) + b1) + b2)``, with the
hand-written Hopper kernel ``conette_torch/csrc/convnext_block.cu``; it
replaces the TPU kernel ``conette_tpu/ops/pallas/convnext_block.py``
(``fused_convnext_block_padded``). For a tensor on the CPU it runs
:func:`convnext_block_reference`, the same function in plain PyTorch; for a
CUDA tensor it launches the kernel or raises.

Every stage's bound is the tensor cores' (2·C·2H + 98·C operations a
pixel against 4·C bytes); what the kernel meets first is the 16·C² bytes
of W1 and W2 that each 64-pixel tile has to see, and the depthwise stencil
and the exact-erf GELU on the CUDA cores. The design, in short (the
source's head note has the whole of it): one call launches a pack kernel
(the bf16 casts and the weights' ring order), phase A's kernel (the
depthwise stencil and LayerNorm from 16-byte loads, over the whole card,
into a bf16 buffer of 64-row tiles, ``y``), the MLP kernel and, where the
hidden layer is split, a reduction. In the MLP kernel a CTA owns
``TILE_ROWS`` = 64 pixels: one bulk copy brings its Y tile into shared
memory; the weights stream through a shared-memory ring of
``cp.async.bulk`` copies that complete on mbarriers, issued by a producer
warp (at C = 768 by consumer thread 0); both products run on ``wgmma``
from shared memory, with the hidden layer in chunks of ``HIDDEN_CHUNK`` =
64, GELU(Hc) in shared memory and Z in registers. Two pieces of it live
here, in Python that the CPU tests reach:

- :func:`pack_block_weights` states the ring's order of W1 and W2 (for
  each hidden chunk the W1 chunk, then the W2 chunk, each as 8×8 core
  matrices), so that every ring stage is one contiguous copy. It is the
  plain version of the kernel's ``block_pack_kernel``, which writes that
  layout from the f32 weights in the same pass that rounds them to bf16,
  once a call, so the wrapper itself only checks and launches;
- :func:`block_plan` splits the hidden layer over S CTAs where the 64-row
  tiles leave the card idle (stage 4 at batch 8: S = 4), as far as one
  wave of CTAs allows. The CTAs write f32 partials to a scratch buffer
  allocated here, and a second launch sums them in a fixed order, so two
  runs give the same bits.

The C entry point is ``conette_convnext_block(x, dw_w, dw_b, ln_w, ln_b,
w1, w2, b1, b2, scale, work, y, out, partial, B, T, F, C, S, eps,
stream)``: 14 pointers, 5 ints, 1 float.

On the card the wrapper calls the custom op ``conette_torch::convnext_block``
(:func:`convnext_block_op`), whose only implementation is CUDA's: the
kernel through :func:`launch_block`. Its fake implementation gives the
output's shape, so ``torch.export`` and CUDA graph capture see one node a
call. A launch reads nothing on the host and runs on the current stream,
so a call can be captured.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from conette_torch.kernels import _build
from conette_torch.models.layers import conv2d, gelu, layer_norm, linear

SUPPORTED_C = (96, 192, 384, 768)
TILE_ROWS = 64       # pixels a CTA
HIDDEN_CHUNK = 64    # hidden units a chunk
SM_COUNT = 132       # streaming multiprocessors of an H100 SXM
# CTAs an SM keeps resident, by C (the kernel's Cfg<C>::MIN_CTAS: shared
# memory and registers allow 3, 2, 1, 1)
CTAS_PER_SM = {96: 3, 192: 2, 384: 1, 768: 1}


def work_size(c: int) -> int:
    """bf16 elements of a launch's ``work`` buffer: the packed W1 and W2
    (2·C·H), the depthwise weights (49·C) and the layer scale (C)."""
    return 2 * c * 4 * c + 50 * c


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class BlockPlan(NamedTuple):
    """How one block call is cut: ``tiles`` CTAs of ``tile_rows`` pixels,
    each repeated over ``splits`` parts of the hidden layer, and the f32
    scratch for the partial sums (``None`` when ``splits`` is 1)."""

    tile_rows: int
    tiles: int
    splits: int
    scratch_shape: tuple[int, int, int] | None


@functools.lru_cache(maxsize=256)
def block_plan(n_pix: int, c: int, n_sm: int = SM_COUNT) -> BlockPlan:
    """Split the hidden layer over as many CTAs as one wave of the card
    holds (``n_sm`` times the CTAs an SM keeps resident at this C), at most
    one hidden chunk a split: on the card a second wave costs more than the
    SMs that one wave leaves idle (``chip_smoke.py`` times the launch at
    other splits where the tiles do not fill the card)."""
    tiles = -(-n_pix // TILE_ROWS)
    chunks = 4 * c // HIDDEN_CHUNK
    splits = max(1, min(chunks, n_sm * CTAS_PER_SM[c] // tiles))
    return BlockPlan(TILE_ROWS, tiles, splits, (splits, n_pix, c) if splits > 1 else None)


def pack_block_weights(pw1_weight: torch.Tensor, pw2_weight: torch.Tensor) -> torch.Tensor:
    """W1 (C, H) and W2 (H, C) as one flat bf16 tensor in the kernel's ring
    order: for each chunk of ``HIDDEN_CHUNK`` hidden units, W1[:, chunk]
    (K = C) then W2[chunk, :] (K = 64), each as 8×8 core matrices ordered
    [k/16][n/8][k/8 % 2][n % 8][k % 8]. One cast-and-permute copy each."""
    c, h = pw1_weight.shape
    n = h // HIDDEN_CHUNK
    packed = torch.empty((n, 2, HIDDEN_CHUNK * c), dtype=torch.bfloat16, device=pw1_weight.device)
    # W1 row k = 16·kb + 8·kh + kc, column 64·ch + 8·ng + nr
    packed[:, 0].view(n, c // 16, 8, 2, 8, 8).copy_(
        pw1_weight.reshape(c // 16, 2, 8, n, 8, 8).permute(3, 0, 4, 1, 5, 2))
    # W2 row 64·ch + 16·kb + 8·kh + kc, column 8·ng + nr
    packed[:, 1].view(n, 4, c // 8, 2, 8, 8).copy_(
        pw2_weight.reshape(n, 4, 2, 8, c // 8, 8).permute(0, 1, 4, 2, 5, 3))
    return packed.reshape(-1)


class BlockOperands(NamedTuple):
    """A block's parameters as the kernel takes them: contiguous f32, in the
    C entry point's order (the launch casts and lays them out itself)."""

    dw: torch.Tensor       # (49, C)
    dw_b: torch.Tensor     # (C)
    ln_w: torch.Tensor     # (C)
    ln_b: torch.Tensor     # (C)
    w1: torch.Tensor       # (C, H)
    w2: torch.Tensor       # (H, C)
    b1: torch.Tensor       # (H)
    b2: torch.Tensor       # (C)
    scale: torch.Tensor    # (C)


def convnext_block_reference(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    pw1_weight: torch.Tensor,
    pw1_bias: torch.Tensor,
    pw2_weight: torch.Tensor,
    pw2_bias: torch.Tensor,
    layer_scale: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The block in plain PyTorch (NHWC; ``dw_weight`` (7, 7, 1, C) HWIO,
    ``pw1_weight`` (C, H), ``pw2_weight`` (H, C)); equal to the inference
    ``conette_tpu.models.convnext.convnext_block``."""
    return x + block_branch(x, dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight, pw1_bias,
                            pw2_weight, pw2_bias, layer_scale, eps)


def block_branch(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    pw1_weight: torch.Tensor,
    pw1_bias: torch.Tensor,
    pw2_weight: torch.Tensor,
    pw2_bias: torch.Tensor,
    layer_scale: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The block's residual branch, what :func:`convnext_block_reference`
    adds to ``x``: dwconv 7×7 → LN → W1 → GELU → W2 → layer scale."""
    c = x.shape[-1]
    y = conv2d(
        {"weight": dw_weight.reshape(7, 7, 1, c), "bias": dw_bias},
        x, padding=((3, 3), (3, 3)), groups=c,
    )
    y = layer_norm({"weight": ln_weight, "bias": ln_bias}, y, eps=eps)
    y = gelu(linear({"weight": pw1_weight, "bias": pw1_bias}, y))
    y = linear({"weight": pw2_weight, "bias": pw2_bias}, y)
    return y * layer_scale.to(y.dtype)


def prepare_block_operands(
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    pw1_weight: torch.Tensor,
    pw1_bias: torch.Tensor,
    pw2_weight: torch.Tensor,
    pw2_bias: torch.Tensor,
    layer_scale: torch.Tensor,
) -> BlockOperands:
    """The parameters as contiguous f32 (no copy when they already are);
    raises on what the kernel does not take."""
    c = ln_weight.shape[-1]
    if c not in SUPPORTED_C:
        raise ValueError(f"the block kernel takes C in {SUPPORTED_C}, got {c}")
    h = 4 * c
    if dw_weight.numel() != 49 * c or pw1_weight.shape != (c, h) or pw2_weight.shape != (h, c):
        raise ValueError(
            f"block weights do not match C={c}: dwconv {tuple(dw_weight.shape)}, "
            f"pwconv1 {tuple(pw1_weight.shape)}, pwconv2 {tuple(pw2_weight.shape)}"
        )
    f32 = torch.float32
    ops = BlockOperands(*(
        v if v.dtype == f32 and v.is_contiguous() else v.to(f32).contiguous()
        for v in (dw_weight.reshape(49, c), dw_bias, ln_weight, ln_bias, pw1_weight,
                  pw2_weight, pw1_bias, pw2_bias, layer_scale)
    ))
    # contiguous f32 by construction: what is left to check is where each
    # lies, its shape and its alignment
    device = ln_weight.device
    for name, v, shape in zip(BlockOperands._fields, ops,
                              ((49, c), (c,), (c,), (c,), (c, h), (h, c), (h,), (c,), (c,))):
        if v.device != device or v.shape != shape or v.data_ptr() % 32:
            _build.require(v, name, f32, shape, device)  # raises, naming what is wrong
    return ops


def launch_block(x: torch.Tensor, ops: BlockOperands, plan: BlockPlan, eps: float = 1e-6,
                 work: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the block on prepared operands: the pack kernel (bf16 casts
    and the ring layout, into ``work``), phase A's kernel
    (depthwise stencil and LayerNorm, into the tile buffer ``y``), the block
    kernel and, when ``plan.splits`` > 1, its reduction. Adds one to
    ``fused_convnext_block.launches``. ``work`` (bf16, ``work_size(C)``) is
    allocated here unless given; it then holds the packed weights
    (``pack_block_weights``), the bf16 depthwise weights and the layer
    scale."""
    b, t, f, c = x.shape
    _build.require(x, "x", torch.bfloat16, (b, t, f, c), ops.w1.device)
    if ops.ln_w.shape != (c,) or plan.tiles * plan.tile_rows < b * t * f:
        raise ValueError(f"operands or plan do not match x of shape {tuple(x.shape)}")
    # phase A's tiles, and behind them the prepared weights unless given
    n_y = plan.tiles * plan.tile_rows * c
    y = torch.empty(n_y + (work_size(c) if work is None else 0), dtype=torch.bfloat16,
                    device=x.device)
    if work is None:
        work = y[n_y:]  # 16-byte aligned: n_y is a multiple of 64·C
    else:
        _build.require(work, "work", torch.bfloat16, (work_size(c),), x.device)
    out = torch.empty_like(x)
    scratch = None
    if plan.scratch_shape is not None:
        scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        fn = _build.entry("conette_convnext_block", 14, 5)
        code = fn(
            x.data_ptr(), *(o.data_ptr() for o in ops), work.data_ptr(), y.data_ptr(),
            out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            b, t, f, c, plan.splits, eps, _build.stream_of(x),
        )
    _build.check(code, "conette_convnext_block")
    fused_convnext_block.launches += 1
    return out


@torch.library.custom_op("conette_torch::convnext_block", mutates_args=(), device_types="cuda")
def convnext_block_op(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    pw1_weight: torch.Tensor,
    pw1_bias: torch.Tensor,
    pw2_weight: torch.Tensor,
    pw2_bias: torch.Tensor,
    layer_scale: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """The block kernel as a custom op on CUDA tensors (no other device)."""
    b, t, f, c = x.shape
    ops = prepare_block_operands(dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight, pw1_bias,
                                 pw2_weight, pw2_bias, layer_scale)
    return launch_block(x, ops, block_plan(b * t * f, c, sm_count(x.device)), eps)


@convnext_block_op.register_fake
def _convnext_block_fake(x, dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight, pw1_bias,
                         pw2_weight, pw2_bias, layer_scale, eps):
    return torch.empty_like(x)


def fused_convnext_block(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    pw1_weight: torch.Tensor,
    pw1_bias: torch.Tensor,
    pw2_weight: torch.Tensor,
    pw2_bias: torch.Tensor,
    layer_scale: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """One ConvNeXt block on (B, T, F, C) NHWC activations.

    On the card ``x`` must be contiguous bf16 with C in ``SUPPORTED_C``;
    the parameters may be f32 or bf16 (weights are rounded to bf16 as the
    plain version rounds them). On the card it calls
    ``conette_torch::convnext_block``. Each launch adds one to
    ``fused_convnext_block.launches``; its pack, phase A and (for a split
    block) reduction launches are part of the same call.
    """
    args = (dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight, pw1_bias,
            pw2_weight, pw2_bias, layer_scale)
    if x.device.type == "cpu":
        return convnext_block_reference(x, *args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convnext_block runs on cuda or cpu, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"expected (B, T, F, C) activations, got {tuple(x.shape)}")
    return torch.ops.conette_torch.convnext_block(x, *args, eps)


fused_convnext_block.launches = 0
