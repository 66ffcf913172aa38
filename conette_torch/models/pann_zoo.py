"""The PANN zoo beyond Cnn10/Cnn14 on tensors (NHWC, NWC for the 1-D
models).

Counterpart of ``conette_tpu/models/pann_zoo.py`` over the reference's
vendored PANN zoo (``src/conette/nn/pann_utils/models.py``), with the same
parameter trees, so that both packages load one weight tree
(``huggingface/convert_pann.py``):

- ResNet22/38 (basic blocks) and ResNet54 (bottlenecks), strided by a 2×2
  average pool before the block, with ``conv_block_after1`` after them;
- MobileNetV1 (depthwise-separable convs) and MobileNetV2 (inverted
  residuals, ReLU6), strided by an average pool after the depthwise conv;
- Cnn6 (one 5×5 conv a block);
- Wavegram_Cnn14, Wavegram_Logmel_Cnn14 and its 128-mel variant: a strided
  1-D conv front on the waveform, reshaped into a (T, 32 or 64) map;
- the raw-waveform LeeNet11/24, DaiNet19 and Res1dNet31/51;
- the Cnn14_DecisionLevelMax/Avg heads over Cnn14's body.

The trees hold Python values that steer the forward (``"stride"``,
``"kind"``, ``"use_res"``, ``"expand"``, ``"double"``, ``"bottleneck"``),
as the JAX package's do; ``weights.to_torch`` keeps them as Python values,
so the forward reads no tensor on the host. The log-mel frontend is the
plain one (``ops/frontend.py``), as in the JAX package; every name runs
through ``models/pann.py::apply_pann_model``. In training mode
(``deterministic=False``) every batch norm normalises with the batch's
statistics; as in the JAX package these architectures apply no dropout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conette_torch.models.layers import (
    Params,
    batch_norm_inference,
    batch_norm_init,
    batch_norm_train,
    cast,
    conv2d,
    conv2d_init,
    f32,
    linear,
    linear_init,
    uniform_fan_in,
)
from conette_torch.models.pann import (
    PANN_LOGMEL,
    avg_pool_nhwc,
    clip_head,
    conv_block,
    conv_block_init,
    frame_lens,
    pann_apply,
)
from conette_torch.ops.frontend import LogMelConfig, logmel_spectrogram

NUM_CLASSES = 527

PANN_LOGMEL128 = LogMelConfig(n_mels=128)
PANN_LOGMEL32 = LogMelConfig(n_mels=32)
PANN_LOGMEL_16K = LogMelConfig(
    sample_rate=16_000, n_fft=512, hop_length=160, n_mels=64, fmax=8_000.0
)
PANN_LOGMEL_8K = LogMelConfig(
    sample_rate=8_000, n_fft=256, hop_length=80, n_mels=64, fmax=4_000.0
)


# ------------------------------------------------------------------ helpers
def _bn(params: Params, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
    """BN over the last axis: running statistics, or in training mode the
    batch's (the updated running statistics are dropped, as in the JAX
    package)."""
    if deterministic:
        return batch_norm_inference(params, x)
    return batch_norm_train(params, x)[0]


def _avg_pool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k×k average pool of NHWC, stride k (odd extents floor)."""
    return avg_pool_nhwc(x, (k, k))


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _logmel_input(params: Params, waveform: torch.Tensor, cfg: LogMelConfig,
                  compute_dtype: torch.dtype, deterministic: bool) -> torch.Tensor:
    """(B, T) waveform → bn0(log-mel) as (B, frames, mels, 1)."""
    mel = logmel_spectrogram(waveform, cfg, compute_dtype=compute_dtype)
    return _bn(params["bn0"], mel, deterministic)[..., None].to(compute_dtype)


def _outputs(params: Params, x: torch.Tensor, input_time_len: int,
             waveform_lens: torch.Tensor | None, freq_mean: bool = True) -> dict[str, torch.Tensor]:
    """The zoo's output contract: frame embeddings (the frequency mean of
    NHWC ``x``, or NWC ``x`` as is), their lengths and the max + mean clip
    head."""
    frames = x.float().mean(dim=2) if freq_mean else x.float()  # (B, T', C)
    clip, emb = clip_head(params, frames)
    return {"frame_embs": frames.transpose(1, 2),
            "frame_embs_lens": frame_lens(frames, input_time_len, waveform_lens),
            "clipwise_output": clip, "embedding": emb}


def _conv1d_init(gen: torch.Generator, in_ch: int, out_ch: int, k: int) -> Params:
    """Bias-free WIO conv1d kernel, torch's default uniform bound."""
    return {"weight": uniform_fan_in(gen, (k, in_ch, out_ch), in_ch * k)}


def _conv1d(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 0,
            dilation: int = 1) -> torch.Tensor:
    """NWC conv1d with a WIO kernel and no bias; f32 accumulation, as
    ``layers.conv2d``."""
    w = f32(cast(p["weight"], x.dtype)).permute(2, 1, 0)  # (out, in, k)
    y = F.conv1d(f32(x).transpose(1, 2), w, stride=stride, padding=padding, dilation=dilation)
    return cast(y.transpose(1, 2), x.dtype)


def _max_pool1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Max pool of NWC over time, window and stride ``k`` (VALID)."""
    return F.max_pool1d(x.transpose(1, 2), k).transpose(1, 2)


def _max_pool1d_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """``F.max_pool1d(x, k, padding=k // 2)`` on NWC: pads with -inf."""
    return F.max_pool1d(x.transpose(1, 2), k, padding=k // 2).transpose(1, 2)


def _avg_pool1d(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool1d(x.transpose(1, 2), k).transpose(1, 2)


def _pool1d_same(x: torch.Tensor, kind: str, k: int = 3) -> torch.Tensor:
    """k3 s1 p1 max or average pool over the time axis of (B, T, C); the
    average divides by ``k`` everywhere (torch ``avg_pool1d`` with
    ``count_include_pad=True``), the max pads with -inf."""
    xc = x.transpose(1, 2)
    if kind == "max":
        y = F.max_pool1d(xc, k, stride=1, padding=k // 2)
    else:
        y = F.avg_pool1d(xc, k, stride=1, padding=k // 2, count_include_pad=True)
    return y.transpose(1, 2)


def _framewise(segments: torch.Tensor, mel_frames: int, ratio: int = 32) -> torch.Tensor:
    """(B, T', K) segment outputs repeated ``ratio`` times, then cut or
    padded with the last to ``mel_frames`` (pann_utils/pytorch_utils.py
    interpolate + pad_framewise_output)."""
    up = torch.repeat_interleave(segments, ratio, dim=1)
    if up.shape[1] < mel_frames:
        tail = up[:, -1:].expand(-1, mel_frames - up.shape[1], -1)
        return torch.cat([up, tail], dim=1)
    return up[:, :mel_frames]


# ---------------------------------------------------------- ResNet22 / 38
def _basic_block_init(gen: torch.Generator, inplanes: int, planes: int, stride: int) -> Params:
    p: Params = {
        "conv1": conv2d_init(gen, inplanes, planes, (3, 3), init="torch"),
        "bn1": batch_norm_init(planes),
        "conv2": conv2d_init(gen, planes, planes, (3, 3), init="torch"),
        # zero-init residual BN weight (models.py:778)
        "bn2": dict(batch_norm_init(planes), weight=torch.zeros(planes)),
        "stride": stride,
    }
    if stride != 1 or inplanes != planes:
        p["downsample"] = {
            "conv": conv2d_init(gen, inplanes, planes, (1, 1), init="torch"),
            "bn": batch_norm_init(planes),
        }
    return p


def _basic_block(p: Params, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
    identity = x
    out = _avg_pool(x) if p["stride"] == 2 else x
    out = torch.relu(_bn(p["bn1"], conv2d(p["conv1"], out, padding=((1, 1), (1, 1))),
                         deterministic))
    out = _bn(p["bn2"], conv2d(p["conv2"], out, padding=((1, 1), (1, 1))), deterministic)
    if "downsample" in p:
        if p["stride"] == 2:
            identity = _avg_pool(identity)
        identity = _bn(p["downsample"]["bn"], conv2d(p["downsample"]["conv"], identity),
                       deterministic)
    return torch.relu(out + identity)


def resnet22_init(
    gen: torch.Generator,
    num_classes: int = NUM_CLASSES,
    n_mels: int = 64,
    depths: tuple[int, int, int, int] = (2, 2, 2, 2),
) -> Params:
    """ResNet22 by default; ``depths=(3, 4, 6, 3)`` gives the ResNet38
    layout (models.py:1089-1200): the same basic blocks, deeper stages."""
    params: Params = {
        "bn0": batch_norm_init(n_mels),
        "conv_block1": conv_block_init(gen, 1, 64),
        "layers": [],
        "conv_block_after1": conv_block_init(gen, 512, 2048),
        "fc1": linear_init(gen, 2048, 2048, init="torch"),
        "fc_audioset": linear_init(gen, 2048, num_classes, init="torch"),
    }
    inplanes = 64
    for planes, stride, blocks in zip((64, 128, 256, 512), (1, 2, 2, 2), depths):
        stage = [_basic_block_init(gen, inplanes, planes, stride)]
        inplanes = planes
        stage += [_basic_block_init(gen, planes, planes, 1) for _ in range(1, blocks)]
        params["layers"].append(stage)
    return params


def resnet38_init(gen: torch.Generator, **kw) -> Params:
    return resnet22_init(gen, depths=(3, 4, 6, 3), **kw)


# --------------------------------------------------------------- MobileNetV1
_MBV1_SPEC = [  # (kind, in, out, pool stride), models.py:1745-1760
    ("bn", 1, 32, 2),
    ("dw", 32, 64, 1), ("dw", 64, 128, 2), ("dw", 128, 128, 1),
    ("dw", 128, 256, 2), ("dw", 256, 256, 1), ("dw", 256, 512, 2),
    ("dw", 512, 512, 1), ("dw", 512, 512, 1), ("dw", 512, 512, 1),
    ("dw", 512, 512, 1), ("dw", 512, 512, 1), ("dw", 512, 1024, 2),
    ("dw", 1024, 1024, 1),
]


def mobilenetv1_init(gen: torch.Generator, num_classes: int = NUM_CLASSES,
                     n_mels: int = 64) -> Params:
    params: Params = {"bn0": batch_norm_init(n_mels), "features": []}
    for kind, inp, oup, stride in _MBV1_SPEC:
        if kind == "bn":
            params["features"].append({
                "kind": "bn", "stride": stride,
                "conv": conv2d_init(gen, inp, oup, (3, 3), init="torch"),
                "bn": batch_norm_init(oup),
            })
        else:
            params["features"].append({
                "kind": "dw", "stride": stride,
                "dwconv": conv2d_init(gen, inp, inp, (3, 3), groups=inp, init="torch"),
                "bn1": batch_norm_init(inp),
                "pwconv": conv2d_init(gen, inp, oup, (1, 1), init="torch"),
                "bn2": batch_norm_init(oup),
            })
    params["fc1"] = linear_init(gen, 1024, 1024, init="torch")
    params["fc_audioset"] = linear_init(gen, 1024, num_classes, init="torch")
    return params


# ------------------------------------------------- ResNet22/38, MobileNetV1
def pann_zoo_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    arch: str,
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """ResNet22/38 (``arch="resnet22"``) or MobileNetV1 forward."""
    det = deterministic
    x = _logmel_input(params, waveform, logmel_cfg, compute_dtype, det)
    if arch == "resnet22":
        x, _ = conv_block(params["conv_block1"], x, deterministic=det)
        for stage in params["layers"]:
            for block in stage:
                x = _basic_block(block, x, det)
        x, _ = conv_block(params["conv_block_after1"], _avg_pool(x), pool_size=(1, 1),
                          deterministic=det)
    elif arch == "mobilenetv1":
        for layer in params["features"]:
            if layer["kind"] == "bn":
                x = conv2d(layer["conv"], x, padding=((1, 1), (1, 1)))
                if layer["stride"] > 1:
                    x = _avg_pool(x, layer["stride"])
                x = torch.relu(_bn(layer["bn"], x, det))
            else:
                x = conv2d(layer["dwconv"], x, padding=((1, 1), (1, 1)), groups=x.shape[-1])
                if layer["stride"] > 1:
                    x = _avg_pool(x, layer["stride"])
                x = torch.relu(_bn(layer["bn1"], x, det))
                x = torch.relu(_bn(layer["bn2"], conv2d(layer["pwconv"], x), det))
    else:
        raise ValueError(f"Unknown arch {arch!r}")
    return _outputs(params, x, waveform.shape[-1], waveform_lens)


# --------------------------------------------------------------------- Cnn6
def conv_block5x5_init(gen: torch.Generator, in_ch: int, out_ch: int) -> Params:
    """PANN ``ConvBlock5x5``: one 5×5 conv + BN (models.py:83-120)."""
    return {
        "conv1": conv2d_init(gen, in_ch, out_ch, (5, 5), init="torch"),
        "bn1": batch_norm_init(out_ch),
    }


def conv_block5x5(p: Params, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
    y = torch.relu(_bn(p["bn1"], conv2d(p["conv1"], x, padding=((2, 2), (2, 2))), deterministic))
    return _avg_pool(y)


def cnn6_init(gen: torch.Generator, num_classes: int = NUM_CLASSES, n_mels: int = 64) -> Params:
    channels = [(1, 64), (64, 128), (128, 256), (256, 512)]
    return {
        "bn0": batch_norm_init(n_mels),
        "blocks": [conv_block5x5_init(gen, i, o) for i, o in channels],
        "fc1": linear_init(gen, 512, 512, init="torch"),
        "fc_audioset": linear_init(gen, 512, num_classes, init="torch"),
    }


def cnn6_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Cnn6 forward (models.py:497-605): 4 ConvBlock5x5 stages."""
    x = _logmel_input(params, waveform, logmel_cfg, compute_dtype, deterministic)
    for block in params["blocks"]:
        x = conv_block5x5(block, x, deterministic)
    return _outputs(params, x, waveform.shape[-1], waveform_lens)


# ---------------------------------------------------------- Wavegram front
def _pre_wav_block_init(gen: torch.Generator, in_ch: int, out_ch: int) -> Params:
    return {
        "conv1": _conv1d_init(gen, in_ch, out_ch, 3),
        "bn1": batch_norm_init(out_ch),
        "conv2": _conv1d_init(gen, out_ch, out_ch, 3),
        "bn2": batch_norm_init(out_ch),
    }


def _pre_wav_block(p: Params, x: torch.Tensor, pool: int, deterministic: bool = True
                   ) -> torch.Tensor:
    """ConvPreWavBlock (models.py:2700-2740): conv1d k3 → BN → ReLU →
    dilated conv1d k3 d2 → BN → ReLU → max pool."""
    y = torch.relu(_bn(p["bn1"], _conv1d(p["conv1"], x, padding=1), deterministic))
    y = torch.relu(_bn(p["bn2"], _conv1d(p["conv2"], y, padding=2, dilation=2), deterministic))
    return _max_pool1d(y, pool)


def _wavegram_init(gen: torch.Generator, pre3_out: int) -> Params:
    """The wavegram front: conv0 k11 s5 and three pre-wav blocks, then
    ``pre_block4`` over the 4 channel groups."""
    return {
        "pre_conv0": _conv1d_init(gen, 1, 64, 11),
        "pre_bn0": batch_norm_init(64),
        "pre_block1": _pre_wav_block_init(gen, 64, 64),
        "pre_block2": _pre_wav_block_init(gen, 64, 128),
        "pre_block3": _pre_wav_block_init(gen, 128, pre3_out),
        "pre_block4": conv_block_init(gen, 4, 64),
    }


def _wavegram(params: Params, waveform: torch.Tensor, compute_dtype: torch.dtype,
              deterministic: bool) -> torch.Tensor:
    """(B, T) waveform → (B, T/640, C3/4, 64) NHWC: stride 5 · 3 × pool 4
    (/320, the hop of the spectrogram frames), the C3 channels of
    ``pre_block3`` as 4 groups of C3/4 "frequencies" (channel c = g·C3/4 +
    f, models.py:3103-3107), then ``pre_block4`` with a (2, 1) pool."""
    a = waveform[:, :, None].to(compute_dtype)
    a = torch.relu(_bn(params["pre_bn0"], _conv1d(params["pre_conv0"], a, stride=5, padding=5),
                       deterministic))
    for name in ("pre_block1", "pre_block2", "pre_block3"):
        a = _pre_wav_block(params[name], a, 4, deterministic)
    b, t, c = a.shape
    a = a.reshape(b, t, 4, c // 4).permute(0, 1, 3, 2)
    return conv_block(params["pre_block4"], a, pool_size=(2, 1), deterministic=deterministic)[0]


def _cnn14_tail(blocks: list[Params], x: torch.Tensor, deterministic: bool) -> torch.Tensor:
    """Cnn14's conv blocks after the first: 2×2 pools, none after the last."""
    for block in blocks[:-1]:
        x, _ = conv_block(block, x, deterministic=deterministic)
    return conv_block(blocks[-1], x, pool_size=(1, 1), deterministic=deterministic)[0]


# ---------------------------------------------------- Wavegram_Logmel_Cnn14
def wavegram_logmel_cnn14_init(gen: torch.Generator, num_classes: int = NUM_CLASSES,
                               n_mels: int = 64) -> Params:
    """64-mel dual-branch Cnn14 (models.py:2842-2990)."""
    channels = [(1, 64), (128, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048)]
    return {
        **_wavegram_init(gen, 128),
        "bn0": batch_norm_init(n_mels),
        "blocks": [conv_block_init(gen, i, o) for i, o in channels],
        "fc1": linear_init(gen, 2048, 2048, init="torch"),
        "fc_audioset": linear_init(gen, 2048, num_classes, init="torch"),
    }


def wavegram_logmel128_cnn14_init(gen: torch.Generator, num_classes: int = NUM_CLASSES) -> Params:
    """128-mel dual-branch variant (models.py:2988-3131): ``pre_block3``
    widens to 256 channels, 4 groups × 64 wavegram "frequencies" to match
    the 128-mel branch's width after its pool."""
    params = wavegram_logmel_cnn14_init(gen, num_classes, n_mels=128)
    params["pre_block3"] = _pre_wav_block_init(gen, 128, 256)
    return params


def wavegram_logmel_cnn14_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Wavegram + log-mel dual-branch Cnn14 (models.py:2842-3131; the
    128-mel variant with ``PANN_LOGMEL128``): the wavegram map joins the
    log-mel branch's channels after its first conv block, both cut to their
    common time (and frequency) extent."""
    det = deterministic
    a = _wavegram(params, waveform, compute_dtype, det)
    x, _ = conv_block(params["blocks"][0],
                      _logmel_input(params, waveform, logmel_cfg, compute_dtype, det),
                      deterministic=det)
    t_min, f_min = min(x.shape[1], a.shape[1]), min(x.shape[2], a.shape[2])
    x = torch.cat([x[:, :t_min, :f_min], a[:, :t_min, :f_min]], dim=-1)
    x = _cnn14_tail(params["blocks"][1:], x, det)
    return _outputs(params, x, waveform.shape[-1], waveform_lens)


def wavegram_logmel128_cnn14_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = PANN_LOGMEL128,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Wavegram_Logmel128_Cnn14: :func:`wavegram_logmel_cnn14_apply` with the
    128-mel frontend by default."""
    return wavegram_logmel_cnn14_apply(params, waveform, waveform_lens, logmel_cfg=logmel_cfg,
                                       deterministic=deterministic, compute_dtype=compute_dtype)


# ------------------------------------------------------------ Wavegram_Cnn14
def wavegram_cnn14_init(gen: torch.Generator, num_classes: int = NUM_CLASSES) -> Params:
    """Wavegram-only Cnn14 (models.py:2743-2860): the log-mel branch's
    ``bn0`` and ``conv_block1`` are in the torch checkpoint but unused in
    the forward; the tree keeps them, as the converter does."""
    channels = [(64, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048)]
    return {
        **_wavegram_init(gen, 128),
        "bn0": batch_norm_init(64),
        "conv_block1": conv_block_init(gen, 1, 64),
        "blocks": [conv_block_init(gen, i, o) for i, o in channels],
        "fc1": linear_init(gen, 2048, 2048, init="torch"),
        "fc_audioset": linear_init(gen, 2048, num_classes, init="torch"),
    }


def wavegram_cnn14_apply(params: Params, waveform: torch.Tensor, *, deterministic: bool = True,
                         compute_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    x = _cnn14_tail(params["blocks"], _wavegram(params, waveform, compute_dtype, deterministic),
                    deterministic)
    return _outputs(params, x, waveform.shape[-1], None)


# --------------------------------------------------------------- MobileNetV2
_MBV2_SETTING = [  # t (expand), c (out), n (repeats), s (stride): models.py:1921-1930
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 2), (6, 160, 3, 1), (6, 320, 1, 1),
]


def _inverted_residual_init(gen: torch.Generator, inp: int, oup: int, stride: int,
                            expand: int) -> Params:
    hidden = round(inp * expand)
    p: Params = {"stride": stride, "use_res": stride == 1 and inp == oup, "expand": expand}
    if expand != 1:
        p["expand_conv"] = conv2d_init(gen, inp, hidden, (1, 1), init="torch")
        p["expand_bn"] = batch_norm_init(hidden)
    p["dwconv"] = conv2d_init(gen, hidden, hidden, (3, 3), groups=hidden, init="torch")
    p["dw_bn"] = batch_norm_init(hidden)
    p["project_conv"] = conv2d_init(gen, hidden, oup, (1, 1), init="torch")
    p["project_bn"] = batch_norm_init(oup)
    return p


def _inverted_residual(p: Params, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
    """PANN InvertedResidual (models.py:1807-1862): the stride is an average
    pool after the depthwise conv; ReLU6; a linear projection."""
    y = x
    if p["expand"] != 1:
        y = _relu6(_bn(p["expand_bn"], conv2d(p["expand_conv"], y), deterministic))
    y = conv2d(p["dwconv"], y, padding=((1, 1), (1, 1)), groups=y.shape[-1])
    if p["stride"] == 2:
        y = _avg_pool(y)
    y = _relu6(_bn(p["dw_bn"], y, deterministic))
    y = _bn(p["project_bn"], conv2d(p["project_conv"], y), deterministic)
    return x + y if p["use_res"] else y


def mobilenetv2_init(gen: torch.Generator, num_classes: int = NUM_CLASSES,
                     n_mels: int = 64) -> Params:
    params: Params = {
        "bn0": batch_norm_init(n_mels),
        "stem_conv": conv2d_init(gen, 1, 32, (3, 3), init="torch"),
        "stem_bn": batch_norm_init(32),
        "blocks": [],
        "head_conv": conv2d_init(gen, 320, 1280, (1, 1), init="torch"),
        "head_bn": batch_norm_init(1280),
        "fc1": linear_init(gen, 1280, 1024, init="torch"),
        "fc_audioset": linear_init(gen, 1024, num_classes, init="torch"),
    }
    inp = 32
    for t, c, n, s in _MBV2_SETTING:
        for i in range(n):
            params["blocks"].append(_inverted_residual_init(gen, inp, c, s if i == 0 else 1, t))
            inp = c
    return params


def mobilenetv2_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """MobileNetV2 forward (models.py:1863-2020)."""
    det = deterministic
    x = _logmel_input(params, waveform, logmel_cfg, compute_dtype, det)
    x = _avg_pool(conv2d(params["stem_conv"], x, padding=((1, 1), (1, 1))))
    x = _relu6(_bn(params["stem_bn"], x, det))
    for block in params["blocks"]:
        x = _inverted_residual(block, x, det)
    x = _relu6(_bn(params["head_bn"], conv2d(params["head_conv"], x), det))
    return _outputs(params, x, waveform.shape[-1], waveform_lens)


# ------------------------------------------------------- LeeNet11 / LeeNet24
_LEENET11 = [(1, 64), (64, 64), (64, 64), (64, 128), (128, 128), (128, 128),
             (128, 128), (128, 128), (128, 256)]
_LEENET24 = [(1, 64), (64, 96), (96, 128), (128, 128), (128, 256), (256, 256),
             (256, 512), (512, 512), (512, 1024)]


def _leenet_block_init(gen: torch.Generator, in_ch: int, out_ch: int, double: bool) -> Params:
    p: Params = {"conv1": _conv1d_init(gen, in_ch, out_ch, 3), "bn1": batch_norm_init(out_ch)}
    if double:  # LeeNetConvBlock2 (models.py:2116-2155)
        p["conv2"] = _conv1d_init(gen, out_ch, out_ch, 3)
        p["bn2"] = batch_norm_init(out_ch)
    return p


def _leenet_block(p: Params, x: torch.Tensor, stride: int, pool: int,
                  deterministic: bool = True) -> torch.Tensor:
    y = torch.relu(_bn(p["bn1"], _conv1d(p["conv1"], x, stride=stride, padding=1), deterministic))
    if "conv2" in p:
        y = torch.relu(_bn(p["bn2"], _conv1d(p["conv2"], y, padding=1), deterministic))
    return _max_pool1d_pad(y, pool) if pool != 1 else y


def leenet_init(gen: torch.Generator, variant: str = "leenet11",
                num_classes: int = NUM_CLASSES) -> Params:
    """Raw-waveform LeeNet (models.py:2051-2110 LeeNet11 with single-conv
    blocks, 2157-2230 LeeNet24 with double-conv blocks)."""
    double = variant == "leenet24"
    spec = _LEENET24 if double else _LEENET11
    fc1_out = 1024 if double else 512
    return {
        "blocks": [_leenet_block_init(gen, i, o, double) for i, o in spec],
        "fc1": linear_init(gen, spec[-1][1], fc1_out, init="torch"),
        "fc_audioset": linear_init(gen, fc1_out, num_classes, init="torch"),
        "double": double,
    }


def leenet_apply(params: Params, waveform: torch.Tensor, *, deterministic: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    x = waveform[:, :, None].to(compute_dtype)  # (B, T, 1) NWC
    n = len(params["blocks"])
    for i, block in enumerate(params["blocks"]):
        # LeeNet24's last block is called with pool_size=1 (models.py:2230);
        # LeeNet11 pools every block but the first (models.py:2098-2106)
        pool = 1 if i == 0 or (params.get("double") and i == n - 1) else 3
        x = _leenet_block(block, x, 3 if i == 0 else 1, pool, deterministic)
    return _outputs(params, x, waveform.shape[-1], None, freq_mean=False)


# ------------------------------------------------------------------ DaiNet19
def _dainet_res_block_init(gen: torch.Generator, in_ch: int, out_ch: int) -> Params:
    p: Params = {}
    ch = in_ch
    for i in range(1, 5):
        p[f"conv{i}"] = _conv1d_init(gen, ch, out_ch, 3)
        p[f"bn{i}"] = batch_norm_init(out_ch)
        ch = out_ch
    if in_ch != out_ch:
        p["downsample"] = _conv1d_init(gen, in_ch, out_ch, 1)
        p["bn_downsample"] = batch_norm_init(out_ch)
    return p


def _dainet_res_block(p: Params, x: torch.Tensor, pool: int, deterministic: bool = True
                      ) -> torch.Tensor:
    """DaiNetResBlock (models.py:2230-2300): 4 conv1d + BN with a residual;
    DaiNet19.forward's max pool after it is unpadded (models.py:2363-2369),
    unlike LeeNet's."""
    y = x
    for i in range(1, 4):
        y = torch.relu(_bn(p[f"bn{i}"], _conv1d(p[f"conv{i}"], y, padding=1), deterministic))
    y = _bn(p["bn4"], _conv1d(p["conv4"], y, padding=1), deterministic)
    idn = (_bn(p["bn_downsample"], _conv1d(p["downsample"], x), deterministic)
           if "downsample" in p else x)
    y = torch.relu(y + idn)
    return _max_pool1d(y, pool) if pool != 1 else y


def dainet_init(gen: torch.Generator, num_classes: int = NUM_CLASSES) -> Params:
    return {
        "conv0": _conv1d_init(gen, 1, 64, 80),
        "bn0": batch_norm_init(64),
        "blocks": [_dainet_res_block_init(gen, i, o)
                   for i, o in ((64, 64), (64, 128), (128, 256), (256, 512))],
        "fc1": linear_init(gen, 512, 512, init="torch"),
        "fc_audioset": linear_init(gen, 512, num_classes, init="torch"),
    }


def dainet_apply(params: Params, waveform: torch.Tensor, *, deterministic: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """DaiNet19: conv0 k80 s4 → BN with no ReLU (models.py:2361-2363) → 4
    residual blocks, a max pool 4 after each of the first three."""
    x = waveform[:, :, None].to(compute_dtype)
    x = _bn(params["bn0"], _conv1d(params["conv0"], x, stride=4), deterministic)
    for i, block in enumerate(params["blocks"]):
        x = _dainet_res_block(block, x, 4 if i < 3 else 1, deterministic)
    return _outputs(params, x, waveform.shape[-1], None, freq_mean=False)


# ------------------------------------------------------- ResNet54 bottleneck
def _bottleneck_init(gen: torch.Generator, inplanes: int, planes: int, stride: int) -> Params:
    """PANN _ResnetBottleneck (expansion 4, the stride an average pool
    before it, zero-init last BN; models.py:805-872)."""
    out_ch = planes * 4
    p: Params = {
        "conv1": conv2d_init(gen, inplanes, planes, (1, 1), init="torch"),
        "bn1": batch_norm_init(planes),
        "conv2": conv2d_init(gen, planes, planes, (3, 3), init="torch"),
        "bn2": batch_norm_init(planes),
        "conv3": conv2d_init(gen, planes, out_ch, (1, 1), init="torch"),
        "bn3": dict(batch_norm_init(out_ch), weight=torch.zeros(out_ch)),
        "stride": stride,
    }
    if stride != 1 or inplanes != out_ch:
        p["downsample"] = {
            "conv": conv2d_init(gen, inplanes, out_ch, (1, 1), init="torch"),
            "bn": batch_norm_init(out_ch),
        }
    return p


def _bottleneck(p: Params, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
    if p["stride"] == 2:
        x = _avg_pool(x)
    out = torch.relu(_bn(p["bn1"], conv2d(p["conv1"], x), deterministic))
    out = torch.relu(_bn(p["bn2"], conv2d(p["conv2"], out, padding=((1, 1), (1, 1))),
                         deterministic))
    out = _bn(p["bn3"], conv2d(p["conv3"], out), deterministic)
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["bn"], conv2d(p["downsample"]["conv"], x), deterministic)
    return torch.relu(out + identity)


def resnet54_init(gen: torch.Generator, num_classes: int = NUM_CLASSES, n_mels: int = 64) -> Params:
    """ResNet54 (models.py:1202-1315): bottleneck stages [3, 4, 6, 3] to
    2048 channels, then ``conv_block_after1`` (2048→2048) after the 2×2
    average pool, the tail of ResNet22/38."""
    params: Params = {
        "bn0": batch_norm_init(n_mels),
        "conv_block1": conv_block_init(gen, 1, 64),
        "layers": [],
        "conv_block_after1": conv_block_init(gen, 2048, 2048),
        "fc1": linear_init(gen, 2048, 2048, init="torch"),
        "fc_audioset": linear_init(gen, 2048, num_classes, init="torch"),
        "bottleneck": True,
    }
    inplanes = 64
    for planes, blocks, stride in zip((64, 128, 256, 512), (3, 4, 6, 3), (1, 2, 2, 2)):
        stage = [_bottleneck_init(gen, inplanes, planes, stride)]
        inplanes = planes * 4
        stage += [_bottleneck_init(gen, inplanes, planes, 1) for _ in range(1, blocks)]
        params["layers"].append(stage)
    return params


def resnet54_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    det = deterministic
    x, _ = conv_block(params["conv_block1"],
                      _logmel_input(params, waveform, logmel_cfg, compute_dtype, det),
                      deterministic=det)
    for stage in params["layers"]:
        for block in stage:
            x = _bottleneck(block, x, det)
    x, _ = conv_block(params["conv_block_after1"], _avg_pool(x), pool_size=(1, 1),
                      deterministic=det)
    return _outputs(params, x, waveform.shape[-1], waveform_lens)


# ----------------------------------------------------- Res1dNet31 / Res1dNet51
_RES1D_PLANES = (64, 128, 256, 512, 1024, 1024, 2048)
_RES1D_STRIDES = (1, 4, 4, 4, 4, 4, 4)
_RES1D_DEPTHS = {
    "res1dnet31": (2, 2, 2, 2, 2, 2, 2),  # models.py:2576-2635
    "res1dnet51": (2, 3, 4, 6, 4, 3, 2),  # models.py:2638-2700
}


def _wav1d_block_init(gen: torch.Generator, inplanes: int, planes: int, stride: int) -> Params:
    """_ResnetBasicBlockWav1d (models.py:2404-2470): two bias-free k3
    conv1ds (the second dilated 2), BN2's weight zero at init; the stride a
    max pool before them; downsample = [average pool +] conv 1×1 + BN."""
    p: Params = {
        "conv1": _conv1d_init(gen, inplanes, planes, 3),
        "bn1": batch_norm_init(planes),
        "conv2": _conv1d_init(gen, planes, planes, 3),
        "bn2": dict(batch_norm_init(planes), weight=torch.zeros(planes)),
        "stride": stride,
    }
    if stride != 1 or inplanes != planes:
        p["downsample"] = {"conv": _conv1d_init(gen, inplanes, planes, 1),
                           "bn": batch_norm_init(planes)}
    return p


def _wav1d_block(p: Params, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
    out = _max_pool1d(x, p["stride"]) if p["stride"] != 1 else x
    out = torch.relu(_bn(p["bn1"], _conv1d(p["conv1"], out, padding=1), deterministic))
    # the reference's dropout of 0.1 here in training, which the JAX package leaves out
    out = _bn(p["bn2"], _conv1d(p["conv2"], out, padding=2, dilation=2), deterministic)
    identity = x
    if "downsample" in p:
        if p["stride"] != 1:
            identity = _avg_pool1d(identity, p["stride"])
        identity = _bn(p["downsample"]["bn"], _conv1d(p["downsample"]["conv"], identity),
                       deterministic)
    return torch.relu(out + identity)


def res1dnet_init(gen: torch.Generator, variant: str = "res1dnet31",
                  num_classes: int = NUM_CLASSES) -> Params:
    """Raw-waveform 1-D ResNet (Res1dNet31/51): bias-free conv0 k11 s5 p5 +
    BN, 7 stages of wav1d basic blocks, a 2048-wide max + mean head."""
    params: Params = {
        "conv0": _conv1d_init(gen, 1, 64, 11),
        "bn0": batch_norm_init(64),
        "layers": [],
        "fc1": linear_init(gen, 2048, 2048, init="torch"),
        "fc_audioset": linear_init(gen, 2048, num_classes, init="torch"),
    }
    inplanes = 64
    for planes, stride, blocks in zip(_RES1D_PLANES, _RES1D_STRIDES, _RES1D_DEPTHS[variant]):
        stage = [_wav1d_block_init(gen, inplanes, planes, stride)]
        inplanes = planes
        stage += [_wav1d_block_init(gen, planes, planes, 1) for _ in range(1, blocks)]
        params["layers"].append(stage)
    return params


def res1dnet_apply(params: Params, waveform: torch.Tensor, *, deterministic: bool = True,
                   compute_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    x = waveform[:, :, None].to(compute_dtype)
    x = _bn(params["bn0"], _conv1d(params["conv0"], x, stride=5, padding=5), deterministic)
    for stage in params["layers"]:
        for block in stage:
            x = _wav1d_block(block, x, deterministic)
    return _outputs(params, x, waveform.shape[-1], None, freq_mean=False)


# ------------------------------------------------ Cnn14_DecisionLevelMax / Avg
def cnn14_decisionlevel_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    pooling: str = "max",
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    interpolate_ratio: int = 32,
) -> dict[str, torch.Tensor]:
    """Cnn14_DecisionLevelMax/Avg (models.py:3731-3858 / 3859-3990): Cnn14's
    body → the segments' k3 max + avg smoothing → a sigmoid head a segment;
    the clip output is their max (or mean), the framewise output the
    segments repeated ``interpolate_ratio`` times to the spectrogram's frame
    count. Parameters: ``cnn14_init``'s. In training mode the body is
    ``pann_apply``'s, whose dropout needs a generator that this call does
    not take: it raises, as the JAX package's does for want of an rng."""
    if pooling not in ("max", "avg"):
        raise ValueError(f"Invalid {pooling=} (expected 'max' or 'avg').")
    body = pann_apply(params, waveform, waveform_lens, logmel_cfg=logmel_cfg,
                      deterministic=deterministic, compute_dtype=compute_dtype)
    frames = body["frame_embs"].transpose(1, 2)  # (B, T', 2048)
    smoothed = _pool1d_same(frames, "max") + _pool1d_same(frames, "avg")
    h = torch.relu(linear(params["fc1"], smoothed))
    segments = torch.sigmoid(linear(params["fc_audioset"], h))  # (B, T', classes)
    clip = segments.amax(dim=1) if pooling == "max" else segments.mean(dim=1)
    mel_frames = waveform.shape[-1] // logmel_cfg.hop_length + 1
    return {
        "frame_embs": body["frame_embs"],
        "frame_embs_lens": body["frame_embs_lens"],
        "clipwise_output": clip,
        "framewise_output": _framewise(segments, mel_frames, interpolate_ratio),
        "embedding": h.amax(dim=1),
    }
