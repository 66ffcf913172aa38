"""Primitive NN layers as plain functions over parameter trees of tensors.

Counterpart of ``conette_tpu/models/layers.py`` with the same layouts and
numerics, so both packages load one weight tree:

- parameters are nested dicts of tensors: linear weights are ``(in, out)``,
  conv weights HWIO, activations NHWC;
- products accumulate in float32: operands are rounded to the input dtype
  first (as JAX casts the weight to ``x.dtype``), then multiplied as f32,
  which is exact for bf16 operands, so a bf16 call equals JAX's
  ``preferred_element_type=float32`` contraction up to summation order;
- ``layer_norm`` takes float32 statistics; ``gelu`` is the exact erf form.

A float32 convolution on the card runs through cuDNN, which defaults to
TF32; ``CoNeTTEModel`` turns TF32 off on the card so these stay float32.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------- init utils
def trunc_normal(
    gen: torch.Generator, shape: Sequence[int], std: float = 0.02
) -> torch.Tensor:
    """Truncated normal on [-2std, 2std] (timm convention)."""
    out = torch.empty(tuple(shape), dtype=torch.float32)
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std, generator=gen)


def uniform_fan_in(
    gen: torch.Generator, shape: Sequence[int], fan_in: int
) -> torch.Tensor:
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * bound


def xavier_uniform(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * bound


def linear_init(
    gen: torch.Generator,
    in_features: int,
    out_features: int,
    init: str = "torch",
    std: float = 0.02,
) -> Params:
    if init == "torch":
        weight = uniform_fan_in(gen, (in_features, out_features), in_features)
        bias = uniform_fan_in(gen, (out_features,), in_features)
    elif init == "trunc_normal":
        weight = trunc_normal(gen, (in_features, out_features), std)
        bias = torch.zeros(out_features)
    elif init == "xavier":
        weight = xavier_uniform(gen, (in_features, out_features))
        bias = torch.zeros(out_features)
    else:
        raise ValueError(f"Unknown linear {init=}")
    return {"weight": weight, "bias": bias}


def layer_norm_init(dim: int) -> Params:
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim)}


def batch_norm_init(dim: int) -> Params:
    return {
        "weight": torch.ones(dim),
        "bias": torch.zeros(dim),
        "running_mean": torch.zeros(dim),
        "running_var": torch.ones(dim),
    }


def conv2d_init(
    gen: torch.Generator,
    in_chans: int,
    out_chans: int,
    kernel_size: tuple[int, int],
    groups: int = 1,
    init: str = "trunc_normal",
    std: float = 0.02,
) -> Params:
    kh, kw = kernel_size
    shape = (kh, kw, in_chans // groups, out_chans)  # HWIO
    if init == "trunc_normal":
        return {"weight": trunc_normal(gen, shape, std), "bias": torch.zeros(out_chans)}
    if init == "torch":
        fan_in = (in_chans // groups) * kh * kw
        weight = uniform_fan_in(gen, shape, fan_in)
        return {"weight": weight, "bias": uniform_fan_in(gen, (out_chans,), fan_in)}
    raise ValueError(f"Unknown conv {init=}")


# ------------------------------------------------------------------- layers
def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``, and no operation at all where ``t`` has that dtype,
    so that a traced or exported program holds no cast that does nothing."""
    return t if t.dtype == dtype else t.to(dtype)


def f32(t: torch.Tensor) -> torch.Tensor:
    return cast(t, torch.float32)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with f32 accumulation and f32 bias, cast to ``x.dtype``."""
    w = f32(cast(params["weight"], x.dtype))
    y = torch.matmul(f32(x), w) + f32(params["bias"])
    return cast(y, x.dtype)


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32."""
    x32 = f32(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * f32(params["weight"]) + f32(params["bias"])
    return cast(y, x.dtype)


def batch_norm_inference(
    params: Params, x: torch.Tensor, axis: int = -1, eps: float = 1e-5
) -> torch.Tensor:
    """Inference-mode BN over the ``axis`` channel dimension with running
    stats (torch ``BatchNorm2d.eval()`` semantics)."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    scale = params["weight"].float() * torch.rsqrt(params["running_var"].float() + eps)
    shift = params["bias"].float() - params["running_mean"].float() * scale
    return (x.float() * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def conv2d(
    params: Params,
    x: torch.Tensor,
    stride: tuple[int, int] = (1, 1),
    padding: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0)),
    groups: int = 1,
) -> torch.Tensor:
    """NHWC conv with an HWIO kernel; f32 accumulation, VALID beyond the
    explicit zero ``padding`` (odd extents floor, as XLA's conv does)."""
    w = params["weight"].to(x.dtype).float().permute(3, 2, 0, 1)  # OIHW
    (t0, t1), (f0, f1) = padding
    xc = x.float().permute(0, 3, 1, 2)  # NCHW
    if t0 or t1 or f0 or f1:
        xc = F.pad(xc, (f0, f1, t0, t1))
    y = F.conv2d(xc, w, params["bias"].float(), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (torch ``nn.GELU`` default)."""
    return F.gelu(x)


def embedding_init(
    gen: torch.Generator, vocab_size: int, dim: int, padding_idx: int | None = None
) -> Params:
    """N(0, 1) embedding table, the ``padding_idx`` row zero."""
    weight = torch.randn((vocab_size, dim), generator=gen)
    if padding_idx is not None:
        weight[padding_idx] = 0.0
    return {"weight": weight}


def embedding(
    params: Params, ids: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return cast(params["weight"], dtype)[ids]


# ------------------------------------------------------------- training only
def batch_norm_train(
    params: Params, x: torch.Tensor, axis: int = -1, eps: float = 1e-5, momentum: float = 0.1
) -> tuple[torch.Tensor, Params]:
    """Training-mode BN: batch statistics, and the updated running
    statistics returned (not written), as torch ``BatchNorm2d.train()``
    computes them."""
    axis = axis % x.ndim
    reduce_dims = tuple(i for i in range(x.ndim) if i != axis)
    x32 = f32(x)
    mean = x32.mean(dim=reduce_dims)
    var = x32.var(dim=reduce_dims, unbiased=False)
    n = math.prod(x.shape[i] for i in reduce_dims)
    unbiased_var = var * (n / max(n - 1, 1))
    new_stats = {
        "weight": params["weight"],
        "bias": params["bias"],
        "running_mean": (1 - momentum) * params["running_mean"] + momentum * mean,
        "running_var": (1 - momentum) * params["running_var"] + momentum * unbiased_var,
    }
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    y = (x32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    y = y * f32(params["weight"]).reshape(shape) + f32(params["bias"]).reshape(shape)
    return cast(y, x.dtype), new_stats


class RowDraws(NamedTuple):
    """The draws of rows ``[row0, row0 + n)`` of a batch of ``rows`` rows
    that several processes share: each value is drawn at the whole batch's
    shape from ``gen`` and this process's rows are kept (:func:`rand`), so a
    row's draw is the one a single process would make for it, however the
    batch is split. Every process draws the same shapes in the same order,
    so their generators stay in step.

    Why whole-batch draws and not draws keyed by row (a hash of a key and
    the row's id, as the JAX package folds the row id into its key): torch's
    generators have no fold-in, so keying means hashing by hand in place of
    ``torch.rand``, a second source of randomness beside the generator's,
    while a whole-batch draw is ``torch.rand`` itself, and one process (a
    ``RowDraws`` of every row) draws exactly what a plain generator draws.
    The cost: each process makes the random numbers and masks of the whole
    batch, so that work does not shrink with the number of processes. At
    the production step (batch 512, d_model 256, 6 layers) the draws' kernels
    take 0.49-0.50 ms on each of four H100s, as on one, of a 52-56 ms step
    (a profiled step on each card; ``CHANGES.md`` records the run).
    """

    gen: torch.Generator
    row0: int
    rows: int


def rand(gen: torch.Generator | RowDraws, shape, device, dtype: torch.dtype = torch.float32,
         cols: tuple[int, int] | None = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``; from a :class:`RowDraws`, rows
    ``[row0, row0 + shape[0])`` of a draw at the whole batch's shape.
    ``cols=(rank, size)``: ``shape``'s last axis is block ``rank`` of
    ``size`` of the drawn one."""
    shape = tuple(shape)
    if cols is not None:
        shape = shape[:-1] + (shape[-1] * cols[1],)
    rows = slice(None)
    if isinstance(gen, RowDraws):
        rows = slice(gen.row0, gen.row0 + shape[0])
        gen, shape = gen.gen, (gen.rows,) + shape[1:]
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)[rows]
    if cols is not None:
        width = shape[-1] // cols[1]
        u = u[..., cols[0] * width:(cols[0] + 1) * width]
    return u


def _keep_mask(gen: torch.Generator | RowDraws | None, shape, keep: float, device,
               cols: tuple[int, int] | None = None) -> torch.Tensor:
    if gen is None:
        raise ValueError("a training-mode dropout needs a torch.Generator")
    return rand(gen, shape, device, cols=cols) < keep


def dropout(
    gen: torch.Generator | RowDraws | None, x: torch.Tensor, rate: float, deterministic: bool,
    cols: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    (a draw from ``gen``, on ``x``'s device) and scaled by ``1 / (1 - rate)``.
    ``cols=(rank, size)``: ``x`` is block ``rank`` of ``size`` of a wider
    last axis, and takes that block of the wider draw."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(gen, x.shape, keep, x.device, cols)
    return cast(torch.where(mask, x / keep, 0.0), x.dtype)


def drop_path(
    gen: torch.Generator | None, x: torch.Tensor, rate: float, deterministic: bool
) -> torch.Tensor:
    """Stochastic depth on the batch axis (reference ``DropPath``): a whole
    row kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(gen, (x.shape[0],) + (1,) * (x.ndim - 1), keep, x.device)
    return cast(torch.where(mask, x / keep, 0.0), x.dtype)
