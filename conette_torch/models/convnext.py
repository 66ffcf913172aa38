"""ConvNeXt-Tiny audio tagger on tensors (NHWC).

Counterpart of ``conette_tpu/models/convnext.py``: log-mel frontend →
per-mel-bin BatchNorm → stem Conv(4,4)/s(4,4)/pad(time=4) → 4 stages of
depths [3,3,9,3], dims [96,192,384,768] with 3 downsample seams →
frequency-mean frame embeddings + AudioSet clip head (max+mean time pool →
LN → Linear(768, 527) → sigmoid). Depths and dims are read from the
parameter shapes, so narrow encoders run through the same code.

Routing: a deterministic call on a CUDA waveform in bf16 runs the log-mel
frontend, with bn0 folded into its affine epilogue, through the
hand-written log-mel kernel, every block through the block kernel and
every seam through the seam kernel (``conette_torch/kernels/``), each
through its wrapper (``fused_logmel``, ``fused_convnext_block``,
``fused_downsample``), which calls its custom op (``conette_torch::logmel``,
``::convnext_block``, ``::downsample``), so ``torch.export`` and CUDA graph
capture see one node a kernel call. Everywhere else (the CPU, or f32 on
the card) the encoder runs the plain PyTorch ops, as the JAX package runs
XLA off its TPU kernel path. ``use_fused_frontend=True`` takes the
frontend's kernel route on those paths too (its plain version on the CPU);
nothing turns a kernel off on the card's deterministic bf16 route.

Training mode (``deterministic=False``): bn0 normalises with the batch's
statistics and the call returns the updated running statistics as
``bn0_stats``; ``spec_augment_fn(mel)`` runs after bn0; block ``idx``
drops its residual branch per row at ``drop_path_rate · idx / (total −
1)``, the masks drawn from ``gen`` in block order. It takes the plain ops
on every device and dtype, as the JAX package gates its kernels on
``deterministic`` (a batch-statistic bn0 cannot fold into the log-mel
kernel's affine, and drop-path needs the branch apart from the residual);
the custom ops have no autograd formula.
"""

from __future__ import annotations

from typing import Callable

import torch

from conette_torch.kernels.convnext_block import block_branch, fused_convnext_block
from conette_torch.kernels.downsample import fused_downsample
from conette_torch.kernels.logmel import fused_logmel
from conette_torch.models.layers import (
    Params,
    batch_norm_inference,
    batch_norm_init,
    batch_norm_train,
    conv2d,
    conv2d_init,
    drop_path,
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
KERNEL_DEVICE = "cuda"  # the device type whose deterministic bf16 calls take the kernels


def convnext_init(
    gen: torch.Generator,
    in_chans: int = 1,
    num_classes: int = NUM_AUDIOSET_CLASSES,
    depths: tuple[int, ...] = DEPTHS,
    dims: tuple[int, ...] = DIMS,
    layer_scale_init_value: float = 1e-6,
    n_mels: int = 224,
    stem_kernel: tuple[int, int] = (4, 4),
    stem_stride: tuple[int, int] = STEM_STRIDE,
) -> Params:
    """Random parameter tree with the JAX package's structure and
    distributions (trunc_normal(0.02) weights, zero biases), on the CPU.
    ``stem_stride`` shapes no parameter; it is taken as the JAX package
    takes it, and the stem's stride is ``convnext_features``'."""
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


def convnext_block(
    params: Params,
    x: torch.Tensor,
    *,
    drop_path_rate: float = 0.0,
    deterministic: bool = True,
    gen: torch.Generator | None = None,
) -> torch.Tensor:
    """dwconv7x7 → LN → pwconv(4x) → GELU → pwconv → layer scale → drop-path
    → residual, in plain PyTorch ops."""
    y = block_branch(x, *block_args(params), eps=LN_EPS)
    return x + drop_path(gen, y, drop_path_rate, deterministic)


def uses_kernels(device: torch.device, dtype: torch.dtype, deterministic: bool = True) -> bool:
    """Whether the encoder runs through the CUDA kernels: a deterministic
    call computing in bf16 on a ``KERNEL_DEVICE``."""
    return deterministic and device.type == KERNEL_DEVICE and dtype == torch.bfloat16


def bn0_affine(bn: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """The inference bn0 as a per-mel-bin f32 affine: ``scale = w·rsqrt(var
    + 1e-5)``, ``shift = b − mean·scale``."""
    scale = bn["weight"].float() * torch.rsqrt(bn["running_var"].float() + 1e-5)
    return scale, bn["bias"].float() - bn["running_mean"].float() * scale


def convnext_features(
    params: Params,
    x: torch.Tensor,
    *,
    stem_stride: tuple[int, int] = STEM_STRIDE,
    stem_padding: tuple[tuple[int, int], tuple[int, int]] = STEM_PADDING,
    deterministic: bool = True,
    drop_path_rate: float = 0.0,
    gen: torch.Generator | None = None,
) -> torch.Tensor:
    """(B, T, F, 1) NHWC log-mel → (B, T', F', C_last) feature map. Block
    ``idx`` of ``total`` drops its branch at ``drop_path_rate · idx /
    max(total − 1, 1)`` in training mode, its masks drawn from ``gen`` in
    block order (torch's generators have no fold-in, ``layers.RowDraws``)."""
    y = conv2d(params["stem"]["conv"], x, stride=stem_stride, padding=stem_padding)
    y = layer_norm(params["stem"]["norm"], y, eps=LN_EPS)
    kernels = uses_kernels(y.device, y.dtype, deterministic)
    total = sum(len(stage) for stage in params["stages"])
    idx = 0
    for i, stage in enumerate(params["stages"]):
        if i > 0:
            ds = params["downsample"][i - 1]
            if kernels:
                y = fused_downsample(y, *seam_args(ds), eps=LN_EPS)
            else:
                y = layer_norm(ds["norm"], y, eps=LN_EPS)
                y = conv2d(ds["conv"], y, stride=(2, 2))
        for block in stage:
            if kernels:
                y = fused_convnext_block(y, *block_args(block), eps=LN_EPS)
            else:
                y = convnext_block(block, y, drop_path_rate=drop_path_rate * idx / max(total - 1, 1),
                                   deterministic=deterministic, gen=gen)
            idx += 1
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
    return_frame_outputs: bool = True,
    return_clip_outputs: bool = True,
    deterministic: bool = True,
    drop_path_rate: float = 0.0,
    gen: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    spec_augment_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    use_fused_frontend: bool | None = None,
) -> dict[str, torch.Tensor]:
    """Full encoder forward.

    :param waveform: (B, T_samples), or a (B, T_frames, n_mels) log-mel
        spectrogram when ``waveform_input`` is False.
    :param waveform_lens: (B,) true lengths along the time axis of
        ``waveform``; defaults to the full length.
    :param deterministic: False for training mode: bn0 from the batch's
        statistics, ``spec_augment_fn`` on the (B, T, n_mels) mel after bn0,
        and drop-path at ``drop_path_rate`` (the masks drawn from ``gen``).
        It takes the plain ops (module docstring).
    :param use_fused_frontend: True runs the log-mel frontend through
        ``fused_logmel`` with bn0 folded into its affine, False through the
        plain ops; None picks the kernel for a deterministic call on a CUDA
        waveform at bf16. False raises for such a call: that route always
        takes the kernel. A training-mode call takes the plain ops.
    :returns: ``frame_embs`` (B, C, T') f32 and ``frame_embs_lens`` (B,)
        int32 unless ``return_frame_outputs`` is False, ``clipwise_output``
        (B, 527) f32 unless ``return_clip_outputs`` is False, and in training
        mode ``bn0_stats``, bn0 with its running statistics updated.
    """
    kernel_route = waveform_input and uses_kernels(waveform.device, compute_dtype, deterministic)
    if use_fused_frontend is None:
        use_fused_frontend = kernel_route
    elif kernel_route and not use_fused_frontend:
        raise ValueError("a CUDA waveform at bf16 always takes the log-mel kernel; "
                         "use_fused_frontend=False is for the CPU and f32 routes")
    bn_stats = None
    if waveform_input and use_fused_frontend and deterministic:
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
        if deterministic:
            mel = batch_norm_inference(params["bn0"], mel, axis=-1)
        else:
            mel, bn_stats = batch_norm_train(params["bn0"], mel, axis=-1)
    if spec_augment_fn is not None and not deterministic:
        mel = spec_augment_fn(mel)
    feats = convnext_features(params, mel[..., None].to(compute_dtype), deterministic=deterministic,
                              drop_path_rate=drop_path_rate, gen=gen)
    frames, clip = convnext_heads(params, feats)

    out: dict[str, torch.Tensor] = {}
    if return_frame_outputs:
        n_out = frames.shape[1]
        if waveform_lens is None:
            lens = torch.full((waveform.shape[0],), n_out, dtype=torch.int32, device=frames.device)
        else:
            # torch.round is half-to-even, as jnp.round
            lens = torch.round(waveform_lens.float() / (input_time_len // n_out)).to(torch.int32)
        out["frame_embs"] = frames.transpose(1, 2)
        out["frame_embs_lens"] = lens
    if return_clip_outputs:
        out["clipwise_output"] = clip
    if bn_stats is not None:
        out["bn0_stats"] = bn_stats
    return out


def frame_reduction_factor(n_samples: int, logmel_cfg: LogMelConfig = DEFAULT_LOGMEL) -> int:
    """Waveform-samples → output-frames reduction factor for a given clip
    length (stem /4 then 3 × /2 on the spectrogram time axis)."""
    n_frames = 1 + n_samples // logmel_cfg.hop_length
    t = (n_frames + 8) // 4  # stem pad 4+4, stride 4
    for _ in range(3):
        t = t // 2
    return n_samples // t
