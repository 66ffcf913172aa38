"""The fused downsample seam: CUDA kernel wrapper and its plain version.

``fused_downsample`` computes LayerNorm over C (f32 statistics) followed
by Conv2d(k=2, s=2) from C to 2C, with the hand-written Hopper kernel
``conette_torch/csrc/downsample.cu``; it replaces the TPU kernel
``conette_tpu/ops/pallas/downsample.py`` (``fused_downsample_padded``). An odd
T floors (the last row is dropped); F must be even. For a tensor on the
CPU it runs :func:`downsample_reference`; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from conette_torch.kernels import _build
from conette_torch.models.layers import conv2d, layer_norm

SUPPORTED_C = (96, 192, 384)


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


def fused_downsample(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """(B, T, F, C) → (B, T // 2, F // 2, 2C). On the card ``x`` must be
    contiguous bf16 with C in ``SUPPORTED_C``. Each launch adds one to
    ``fused_downsample.launches``."""
    if x.dim() != 4 or x.shape[1] < 2:
        raise ValueError(f"expected (B, T >= 2, F, C) activations, got {tuple(x.shape)}")
    b, t, f, c = x.shape
    if f % 2:
        raise ValueError(f"the downsample seam needs an even F, got {f}")
    if x.device.type == "cpu":
        return downsample_reference(x, ln_weight, ln_bias, conv_weight, conv_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_downsample runs on cuda or cpu, got {x.device}")
    if c not in SUPPORTED_C:
        raise ValueError(f"the seam kernel takes C in {SUPPORTED_C}, got {c}")
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    _build.require(x, "x", bf16, (b, t, f, c), dev)
    w = conv_weight.to(bf16).contiguous()
    ln_w = ln_weight.to(f32).contiguous()
    ln_b = ln_bias.to(f32).contiguous()
    bias = conv_bias.to(f32).contiguous()
    _build.require(w, "conv_weight", bf16, (2, 2, c, 2 * c), dev)
    _build.require(ln_w, "ln_weight", f32, (c,), dev)
    _build.require(ln_b, "ln_bias", f32, (c,), dev)
    _build.require(bias, "conv_bias", f32, (2 * c,), dev)
    out = torch.empty((b, t // 2, f // 2, 2 * c), dtype=bf16, device=dev)
    with torch.cuda.device(dev):
        fn = _build.entry("conette_downsample", 6, 4)
        code = fn(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, t, f, c, eps, _build.stream_of(x),
        )
    _build.check(code, "conette_downsample")
    fused_downsample.launches += 1
    return out


fused_downsample.launches = 0
