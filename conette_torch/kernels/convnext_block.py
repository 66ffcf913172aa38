"""The fused ConvNeXt block: CUDA kernel wrapper and its plain version.

``fused_convnext_block`` computes one whole block,
``x + scale ⊙ (W2·GELU(W1·LN(dwconv7×7(x) + b_dw) + b1) + b2)``, with the
hand-written Hopper kernel ``conette_torch/csrc/convnext_block.cu``; it
replaces the TPU kernel ``conette_tpu/ops/pallas/convnext_block.py``
(``fused_convnext_block_padded``). For a tensor on the CPU it runs
:func:`convnext_block_reference`, the same function in plain PyTorch; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from conette_torch.kernels import _build
from conette_torch.models.layers import conv2d, gelu, layer_norm, linear

SUPPORTED_C = (96, 192, 384, 768)


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
    c = x.shape[-1]
    y = conv2d(
        {"weight": dw_weight.reshape(7, 7, 1, c), "bias": dw_bias},
        x, padding=((3, 3), (3, 3)), groups=c,
    )
    y = layer_norm({"weight": ln_weight, "bias": ln_bias}, y, eps=eps)
    y = gelu(linear({"weight": pw1_weight, "bias": pw1_bias}, y))
    y = linear({"weight": pw2_weight, "bias": pw2_bias}, y)
    return x + y * layer_scale.to(y.dtype)


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
    plain version rounds them). Each launch adds one to
    ``fused_convnext_block.launches``.
    """
    args = (dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight, pw1_bias,
            pw2_weight, pw2_bias, layer_scale)
    if x.device.type == "cpu":
        return convnext_block_reference(x, *args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convnext_block runs on cuda or cpu, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"expected (B, T, F, C) activations, got {tuple(x.shape)}")
    b, t, f, c = x.shape
    if c not in SUPPORTED_C:
        raise ValueError(f"the block kernel takes C in {SUPPORTED_C}, got {c}")
    h = 4 * c
    dev = x.device
    _build.require(x, "x", torch.bfloat16, (b, t, f, c), dev)
    if dw_weight.numel() != 49 * c or pw1_weight.shape != (c, h) or pw2_weight.shape != (h, c):
        raise ValueError(
            f"block weights do not match C={c}: dwconv {tuple(dw_weight.shape)}, "
            f"pwconv1 {tuple(pw1_weight.shape)}, pwconv2 {tuple(pw2_weight.shape)}"
        )
    bf16, f32 = torch.bfloat16, torch.float32
    # operands in the kernel's types, rounded where the plain version rounds
    dw = dw_weight.reshape(49, c).to(bf16).to(f32).contiguous()
    scale = layer_scale.to(bf16).to(f32).contiguous()
    vecs = [v.to(f32).contiguous() for v in (dw_bias, ln_weight, ln_bias, pw1_bias, pw2_bias)]
    w1 = pw1_weight.to(bf16).contiguous()
    w2 = pw2_weight.to(bf16).contiguous()
    for name, v, n in zip(("dw_bias", "ln_weight", "ln_bias", "pw1_bias", "pw2_bias"),
                          vecs, (c, c, c, h, c)):
        _build.require(v, name, f32, (n,), dev)
    _build.require(dw, "dw_weight", f32, (49, c), dev)
    _build.require(scale, "layer_scale", f32, (c,), dev)
    _build.require(w1, "pw1_weight", bf16, (c, h), dev)
    _build.require(w2, "pw2_weight", bf16, (h, c), dev)
    out = torch.empty_like(x)
    dw_b, ln_w, ln_b, b1, b2 = vecs
    with torch.cuda.device(dev):
        fn = _build.entry("conette_convnext_block", 11, 4)
        code = fn(
            x.data_ptr(), dw.data_ptr(), dw_b.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scale.data_ptr(),
            out.data_ptr(), b, t, f, c, eps, _build.stream_of(x),
        )
    _build.check(code, "conette_convnext_block")
    fused_convnext_block.launches += 1
    return out


fused_convnext_block.launches = 0
