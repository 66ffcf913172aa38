"""ConvNeXt-Tiny audio tagger on tensors (NHWC), inference only.

Counterpart of ``conette_tpu/models/convnext.py``: log-mel frontend →
per-mel-bin BatchNorm → stem Conv(4,4)/s(4,4)/pad(time=4) → 4 stages of
depths [3,3,9,3], dims [96,192,384,768] with 3 downsample seams →
frequency-mean frame embeddings + AudioSet clip head (max+mean time pool →
LN → Linear(768, 527) → sigmoid). Depths and dims are read from the
parameter shapes, so narrow encoders run through the same code.

Routing: on a CUDA waveform in bf16, the log-mel frontend with bn0 folded
into its affine epilogue goes through the hand-written log-mel kernel,
every block through the block kernel and every seam through the seam
kernel (``conette_torch/kernels/``), each called as its custom op
(``conette_torch::logmel`` through ``fused_logmel``,
``conette_torch::convnext_block``, ``conette_torch::downsample``), so
``torch.export`` and CUDA graph capture see one node a kernel call. Everywhere else (the CPU, or f32 on
the card) the encoder runs the plain PyTorch ops, as the JAX package runs
XLA off its TPU kernel path. ``use_fused_frontend=True`` takes the
frontend's kernel route on those paths too (its plain version on the CPU);
nothing turns a kernel off on the card's bf16 route.
"""

from __future__ import annotations

import torch

from conette_torch.kernels.convnext_block import convnext_block_reference
from conette_torch.kernels.logmel import fused_logmel
from conette_torch.models.layers import (
    Params,
    batch_norm_inference,
    batch_norm_init,
    conv2d,
    conv2d_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)
from conette_torch.ops.frontend import DEFAULT_LOGMEL, LogMelConfig, logmel_spectrogram

DEPTHS = (3, 3, 9, 3)
DIMS = (96, 192, 384, 768)
NUM_AUDIOSET_CLASSES = 527
LN_EPS = 1e-6
STEM_STRIDE = (4, 4)
STEM_PADDING = ((4, 4), (0, 0))  # time padded 4 + 4, frequency not


def convnext_init(
    gen: torch.Generator,
    in_chans: int = 1,
    num_classes: int = NUM_AUDIOSET_CLASSES,
    depths: tuple[int, ...] = DEPTHS,
    dims: tuple[int, ...] = DIMS,
    layer_scale_init_value: float = 1e-6,
    n_mels: int = 224,
    stem_kernel: tuple[int, int] = (4, 4),
) -> Params:
    """Random parameter tree with the JAX package's structure and
    distributions (trunc_normal(0.02) weights, zero biases), on the CPU."""
    params: Params = {
        "bn0": batch_norm_init(n_mels),
        "stem": {
            "conv": conv2d_init(gen, in_chans, dims[0], stem_kernel),
            "norm": layer_norm_init(dims[0]),
        },
        "downsample": [],
        "stages": [],
        "norm": layer_norm_init(dims[-1]),
        "head_audioset": linear_init(gen, dims[-1], num_classes, init="trunc_normal"),
    }
    for i in range(len(dims) - 1):
        params["downsample"].append(
            {
                "norm": layer_norm_init(dims[i]),
                "conv": conv2d_init(gen, dims[i], dims[i + 1], (2, 2)),
            }
        )
    for dim, depth in zip(dims, depths):
        params["stages"].append(
            [
                {
                    "dwconv": conv2d_init(gen, dim, dim, (7, 7), groups=dim),
                    "norm": layer_norm_init(dim),
                    "pwconv1": linear_init(gen, dim, 4 * dim, init="trunc_normal"),
                    "pwconv2": linear_init(gen, 4 * dim, dim, init="trunc_normal"),
                    "scale": torch.full((dim,), layer_scale_init_value),
                }
                for _ in range(depth)
            ]
        )
    return params


def block_args(block: Params) -> tuple[torch.Tensor, ...]:
    """A block's parameters in the order the block functions take them."""
    return (
        block["dwconv"]["weight"], block["dwconv"]["bias"],
        block["norm"]["weight"], block["norm"]["bias"],
        block["pwconv1"]["weight"], block["pwconv1"]["bias"],
        block["pwconv2"]["weight"], block["pwconv2"]["bias"],
        block["scale"],
    )


def seam_args(ds: Params) -> tuple[torch.Tensor, ...]:
    """A seam's parameters in the order the seam functions take them."""
    return (ds["norm"]["weight"], ds["norm"]["bias"], ds["conv"]["weight"], ds["conv"]["bias"])


def convnext_block(params: Params, x: torch.Tensor) -> torch.Tensor:
    """dwconv7x7 → LN → pwconv(4x) → GELU → pwconv → layer scale → residual,
    in plain PyTorch ops."""
    return convnext_block_reference(x, *block_args(params), eps=LN_EPS)


def uses_kernels(x: torch.Tensor) -> bool:
    """Whether the encoder runs ``x`` through the CUDA kernels."""
    return x.is_cuda and x.dtype == torch.bfloat16


def bn0_affine(bn: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """The inference bn0 as a per-mel-bin f32 affine: ``scale = w·rsqrt(var
    + 1e-5)``, ``shift = b − mean·scale``."""
    scale = bn["weight"].float() * torch.rsqrt(bn["running_var"].float() + 1e-5)
    return scale, bn["bias"].float() - bn["running_mean"].float() * scale


def convnext_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, T, F, 1) NHWC log-mel → (B, T', F', C_last) feature map."""
    y = conv2d(params["stem"]["conv"], x, stride=STEM_STRIDE, padding=STEM_PADDING)
    y = layer_norm(params["stem"]["norm"], y, eps=LN_EPS)
    kernels = uses_kernels(y)
    for i, stage in enumerate(params["stages"]):
        if i > 0:
            ds = params["downsample"][i - 1]
            if kernels:
                y = torch.ops.conette_torch.downsample(y, *seam_args(ds), LN_EPS)
            else:
                y = layer_norm(ds["norm"], y, eps=LN_EPS)
                y = conv2d(ds["conv"], y, stride=(2, 2))
        for block in stage:
            if kernels:
                y = torch.ops.conette_torch.convnext_block(y, *block_args(block), LN_EPS)
            else:
                y = convnext_block(block, y)
    return y


def convnext_heads(params: Params, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T', F', C) features → ((B, T', C) f32 frequency-mean frames,
    (B, 527) clip probabilities from max+mean → LN → Linear → sigmoid)."""
    frames = feats.float().mean(dim=2)
    pooled = frames.amax(dim=1) + frames.mean(dim=1)
    pooled = layer_norm(params["norm"], pooled, eps=LN_EPS)
    logits = linear(params["head_audioset"], pooled)
    return frames, torch.sigmoid(logits.float())


def convnext_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = DEFAULT_LOGMEL,
    waveform_input: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    use_fused_frontend: bool | None = None,
) -> dict[str, torch.Tensor]:
    """Full encoder forward.

    :param waveform: (B, T_samples), or a (B, T_frames, n_mels) log-mel
        spectrogram when ``waveform_input`` is False.
    :param waveform_lens: (B,) true lengths along the time axis of
        ``waveform``; defaults to the full length.
    :param use_fused_frontend: True runs the log-mel frontend through
        ``fused_logmel`` with bn0 folded into its affine, False through the
        plain ops; None picks the kernel for a CUDA waveform at bf16. False
        raises for a CUDA waveform at bf16: that route always takes the
        kernel.
    :returns: ``frame_embs`` (B, C, T') f32, ``frame_embs_lens`` (B,) int32
        and ``clipwise_output`` (B, 527) f32.
    """
    kernel_route = waveform_input and waveform.is_cuda and compute_dtype == torch.bfloat16
    if use_fused_frontend is None:
        use_fused_frontend = kernel_route
    elif kernel_route and not use_fused_frontend:
        raise ValueError("a CUDA waveform at bf16 always takes the log-mel kernel; "
                         "use_fused_frontend=False is for the CPU and f32 routes")
    if waveform_input and use_fused_frontend:
        scale, shift = bn0_affine(params["bn0"])
        mel = fused_logmel(waveform, logmel_cfg, bn_scale=scale, bn_shift=shift,
                           compute_dtype=compute_dtype)
        input_time_len = waveform.shape[-1]
    else:
        if waveform_input:
            mel = logmel_spectrogram(waveform, logmel_cfg, compute_dtype=compute_dtype)
            input_time_len = waveform.shape[-1]
        else:
            mel = waveform
            input_time_len = waveform.shape[1]
        mel = batch_norm_inference(params["bn0"], mel, axis=-1)
    feats = convnext_features(params, mel[..., None].to(compute_dtype))
    frames, clip = convnext_heads(params, feats)

    n_out = frames.shape[1]
    if waveform_lens is None:
        lens = torch.full((waveform.shape[0],), n_out, dtype=torch.int32, device=frames.device)
    else:
        # torch.round is half-to-even, as jnp.round
        lens = torch.round(waveform_lens.float() / (input_time_len // n_out)).to(torch.int32)
    return {"frame_embs": frames.transpose(1, 2), "frame_embs_lens": lens, "clipwise_output": clip}


def frame_reduction_factor(n_samples: int, logmel_cfg: LogMelConfig = DEFAULT_LOGMEL) -> int:
    """Waveform-samples → output-frames reduction factor for a given clip
    length (stem /4 then 3 × /2 on the spectrogram time axis)."""
    n_frames = 1 + n_samples // logmel_cfg.hop_length
    t = (n_frames + 8) // 4  # stem pad 4+4, stride 4
    for _ in range(3):
        t = t // 2
    return n_samples // t
