"""The PANN encoders Cnn10, Cnn14 and Cnn14_DecisionLevelAtt on tensors
(NHWC).

Counterpart of ``conette_tpu/models/pann.py`` (reference
``src/conette/nn/encoders/cnn10.py:23-424``, ``cnn14.py:27-216``,
``cnn14_decisionlevel_att.py:23-245`` over the vendored PANN zoo
``nn/pann_utils/models.py``), with the same parameter trees, so that both
packages load one weight tree (``huggingface/convert_pann.py``):

- ``ConvBlock``: 3×3 conv → BN → ReLU twice, then a 2×2 average pool;
- ``Cnn10``: 4 blocks (64→512) over a 64-mel log-mel frontend, 512-wide
  frame embeddings;
- ``Cnn14``: 6 blocks (64→2048), 2048-wide frame embeddings, fc1 clip head;
- ``Cnn14_DecisionLevelAtt``: attention-pooled clip output (``AttBlock``,
  a softmax attention over frames).

Every encoder returns ``{frame_embs (B, C, T'), frame_embs_lens (B,),
clipwise_output (B, 527)}`` and ``embedding`` (B, C), or, with the
attention head, ``framewise_output`` (B, mel frames, 527). The log-mel
frontend is the plain one (``ops/frontend.py``), as in the JAX package.
``build_pann_model`` and ``apply_pann_model`` take every name of
``PANN_ZOO_NAMES``; the other architectures and the decision-level
max/avg heads live in ``models/pann_zoo.py``.

Training mode (``deterministic=False``), as in the JAX package: every
batch norm normalises with the batch's statistics (``conv_block`` returns
the updated running statistics; ``pann_apply`` drops them, as JAX's does),
and ``pann_apply`` applies dropout at ``dropout_p`` after each block and at
0.5 twice in the clip head, its masks drawn from ``gen`` in call order.
Without a generator that dropout raises ``ValueError`` (the JAX package
raises ``TypeError`` for want of an rng), so ``apply_pann_model``, which
takes no generator, raises in training mode for the Cnn family and runs
the zoo's architectures, which have no dropout.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from conette_torch.models.layers import (
    Params,
    batch_norm_inference,
    batch_norm_init,
    batch_norm_train,
    conv2d,
    conv2d_init,
    dropout,
    linear,
    linear_init,
)
from conette_torch.ops.frontend import LogMelConfig, logmel_spectrogram

PANN_LOGMEL = LogMelConfig(n_mels=64)
NUM_AUDIOSET_CLASSES = 527

CNN10_CHANNELS = (64, 128, 256, 512)
CNN14_CHANNELS = (64, 128, 256, 512, 1024, 2048)


# ----------------------------------------------------------------- ConvBlock
def conv_block_init(gen: torch.Generator, in_ch: int, out_ch: int) -> Params:
    return {
        "conv1": conv2d_init(gen, in_ch, out_ch, (3, 3), init="torch"),
        "bn1": batch_norm_init(out_ch),
        "conv2": conv2d_init(gen, out_ch, out_ch, (3, 3), init="torch"),
        "bn2": batch_norm_init(out_ch),
    }


def conv_block(
    params: Params,
    x: torch.Tensor,
    *,
    pool_size: tuple[int, int] = (2, 2),
    pool_type: str = "avg",
    deterministic: bool = True,
) -> tuple[torch.Tensor, list[Params]]:
    """NHWC PANN ``ConvBlock``: (y, the two batch norms with their running
    statistics updated in training mode, else []). The pool (``"avg"`` or
    ``"max"``) floors odd extents."""
    new_stats: list[Params] = []

    def bn(bp: Params, y: torch.Tensor) -> torch.Tensor:
        if deterministic:
            return batch_norm_inference(bp, y)
        out, stats = batch_norm_train(bp, y)
        new_stats.append(stats)
        return out

    y = torch.relu(bn(params["bn1"], conv2d(params["conv1"], x, padding=((1, 1), (1, 1)))))
    y = torch.relu(bn(params["bn2"], conv2d(params["conv2"], y, padding=((1, 1), (1, 1)))))
    if pool_size != (1, 1) and pool_type == "avg":
        y = avg_pool_nhwc(y, pool_size)
    elif pool_size != (1, 1) and pool_type == "max":
        y = max_pool_nhwc(y, pool_size)
    return y, new_stats


def avg_pool_nhwc(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Average pool of NHWC with stride = window (VALID: odd extents floor)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).contiguous()


def max_pool_nhwc(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Max pool of NHWC with stride = window (VALID: odd extents floor)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).contiguous()


def frame_lens(frames: torch.Tensor, input_time_len: int,
               waveform_lens: torch.Tensor | None) -> torch.Tensor:
    """Frame counts of (B, T', C) ``frames``: T' for all, or each input
    length over the reduction ``input_time_len // T'``, rounded half to even
    (``torch.round``, as ``jnp.round``)."""
    n_out = frames.shape[1]
    if waveform_lens is None:
        return torch.full((frames.shape[0],), n_out, dtype=torch.int32, device=frames.device)
    reduction = max(input_time_len // max(n_out, 1), 1)
    return torch.round(waveform_lens.float() / reduction).to(torch.int32)


def clip_head(params: Params, frames: torch.Tensor, deterministic: bool = True,
              gen: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(clip probabilities, embedding) of (B, T', C) frames: the max + mean
    over frames → relu(fc1) → sigmoid(fc_audioset); the reference returns
    the penultimate relu(fc1) activations as "embedding" (models.py:271-277).
    In training mode the pooled frames and the embedding each pass a
    dropout of 0.5 (Cnn10/Cnn14's head; the zoo's heads have none)."""
    h = dropout(gen, frames.amax(dim=1) + frames.mean(dim=1), 0.5, deterministic)
    h = torch.relu(linear(params["fc1"], h))
    return torch.sigmoid(linear(params["fc_audioset"], h)), dropout(gen, h, 0.5, deterministic)


# --------------------------------------------------------------------- init
def pann_init(
    gen: torch.Generator,
    channels: tuple[int, ...] = CNN14_CHANNELS,
    num_classes: int = NUM_AUDIOSET_CLASSES,
    n_mels: int = 64,
    att_head: bool = False,
) -> Params:
    """Random parameter tree with the JAX package's structure and the torch
    default distributions, on the CPU."""
    params: Params = {
        "bn0": batch_norm_init(n_mels),
        "blocks": [],
        "fc1": linear_init(gen, channels[-1], channels[-1], init="torch"),
    }
    in_ch = 1
    for ch in channels:
        params["blocks"].append(conv_block_init(gen, in_ch, ch))
        in_ch = ch
    if att_head:
        params["att"] = {
            "att": linear_init(gen, channels[-1], num_classes, init="torch"),
            "cla": linear_init(gen, channels[-1], num_classes, init="torch"),
        }
    else:
        params["fc_audioset"] = linear_init(gen, channels[-1], num_classes, init="torch")
    return params


def cnn10_init(gen: torch.Generator, **kw: Any) -> Params:
    return pann_init(gen, CNN10_CHANNELS, **kw)


def cnn14_init(gen: torch.Generator, **kw: Any) -> Params:
    return pann_init(gen, CNN14_CHANNELS, **kw)


def cnn14_emb_init(gen: torch.Generator, emb_dim: int = 512, **kw: Any) -> Params:
    """Cnn14_emb512/128/32 (reference ``models.py:1315-1660``): fc1 projects
    the pooled features to a smaller embedding before the AudioSet head."""
    params = pann_init(gen, CNN14_CHANNELS, **kw)
    params["fc1"] = linear_init(gen, CNN14_CHANNELS[-1], emb_dim, init="torch")
    params["fc_audioset"] = linear_init(
        gen, emb_dim, kw.get("num_classes", NUM_AUDIOSET_CLASSES), init="torch")
    return params


def cnn14_att_init(gen: torch.Generator, **kw: Any) -> Params:
    return pann_init(gen, CNN14_CHANNELS, att_head=True, **kw)


# ------------------------------------------------------------------ forward
def pann_apply(
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    logmel_cfg: LogMelConfig = PANN_LOGMEL,
    waveform_input: bool = True,
    deterministic: bool = True,
    dropout_p: float = 0.2,
    gen: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Cnn10 / Cnn14 / Cnn14_DecisionLevelAtt forward, the architecture read
    from the parameter tree (reference contract: ``nn/encoders/cnn14.py:27-216``).

    :param waveform: (B, T_samples), or a (B, T_frames, n_mels) log-mel
        spectrogram when ``waveform_input`` is False.
    :param deterministic: False for training mode: batch statistics, and
        dropout at ``dropout_p`` after each block and at 0.5 twice in the
        clip head, drawn from ``gen`` (which it needs, else ``ValueError``).
    """
    if waveform_input:
        mel = logmel_spectrogram(waveform, logmel_cfg, compute_dtype=compute_dtype)
        input_time_len = waveform.shape[-1]
    else:
        mel = waveform
        input_time_len = waveform.shape[1]
    if deterministic:
        mel = batch_norm_inference(params["bn0"], mel, axis=-1)
    else:
        mel, _ = batch_norm_train(params["bn0"], mel, axis=-1)

    x = mel[..., None].to(compute_dtype)  # (B, T, F, 1)
    n_blocks = len(params["blocks"])
    for i, block in enumerate(params["blocks"]):
        # the Cnn14 family pools (2, 2) after blocks 1-5 and not after the
        # last (cnn14.py:174-184); Cnn10 pools after all 4 (models.py:607-700)
        pool = (1, 1) if (n_blocks == 6 and i == n_blocks - 1) else (2, 2)
        x, _ = conv_block(block, x, pool_size=pool, deterministic=deterministic)
        x = dropout(gen, x, dropout_p, deterministic)

    frames = x.float().mean(dim=2)  # (B, T', C): the frequency mean
    out: dict[str, torch.Tensor] = {"frame_embs": frames.transpose(1, 2),
                                    "frame_embs_lens": frame_lens(frames, input_time_len, waveform_lens)}
    if "att" in params:
        from conette_torch.models.pann_zoo import _framewise, _pool1d_same

        # the Cnn14_DecisionLevelAtt head (cnn14_decisionlevel_att.py:225-245):
        # k3/s1/p1 max + avg smoothing over frames → fc1 → per-frame 2048-wide
        # embeddings (this encoder's captioning frame_embs) → AttBlock's
        # softmax attention pooling
        smoothed = _pool1d_same(frames, "max") + _pool1d_same(frames, "avg")
        h = torch.relu(linear(params["fc1"], smoothed))  # (B, T', 2048)
        out["frame_embs"] = h.transpose(1, 2)
        att = torch.softmax(torch.clamp(linear(params["att"]["att"], h), -10.0, 10.0), dim=1)
        cla = torch.sigmoid(linear(params["att"]["cla"], h))
        out["clipwise_output"] = torch.sum(att * cla, dim=1)
        mel_frames = input_time_len // logmel_cfg.hop_length + 1 if waveform_input else input_time_len
        out["framewise_output"] = _framewise(cla, mel_frames)
    else:
        out["clipwise_output"], out["embedding"] = clip_head(params, frames, deterministic, gen)
    return out


#: the reference zoo (nn/pann_utils/models.py, with the embedding-width and
#: frontend variants), every name buildable by build_pann_model
PANN_ZOO_NAMES = frozenset(
    {
        "cnn6", "cnn10", "cnn14", "cnn14_16k", "cnn14_8k", "cnn14_mel32",
        "cnn14_mel128", "cnn14_no_specaug", "cnn14_no_dropout",
        "cnn14_mixup_time_domain", "cnn14_emb512", "cnn14_emb128",
        "cnn14_emb32", "cnn14_decisionlevelatt", "cnn14_decisionlevelmax",
        "cnn14_decisionlevelavg", "resnet22", "resnet38", "resnet54",
        "res1dnet31", "res1dnet51", "mobilenetv1", "mobilenetv2",
        "leenet11", "leenet24", "dainet19", "wavegram_cnn14",
        "wavegram_logmel_cnn14", "wavegram_logmel128_cnn14",
    }
)


def build_pann_model(name: str, gen: torch.Generator | None = None) -> tuple[Params, int]:
    """(params, frame embedding width) by registry name (reference
    ``nn/pann_utils/hub.py:14-56``)."""
    from conette_torch.models import pann_zoo as zoo

    if gen is None:
        gen = torch.Generator().manual_seed(0)
    name_l = name.lower()
    if name_l == "cnn10":
        return cnn10_init(gen), CNN10_CHANNELS[-1]
    if name_l in ("cnn14_decisionlevelatt", "cnn14_att"):
        return cnn14_att_init(gen), CNN14_CHANNELS[-1]
    if name_l.startswith("cnn14_emb"):
        return cnn14_emb_init(gen, int(name_l.removeprefix("cnn14_emb"))), CNN14_CHANNELS[-1]
    if name_l in ("cnn14_mel32", "cnn14_mel128"):
        return cnn14_init(gen, n_mels=int(name_l.removeprefix("cnn14_mel"))), CNN14_CHANNELS[-1]
    if name_l in ("cnn14", "cnn14_16k", "cnn14_8k", "cnn14_no_specaug", "cnn14_no_dropout",
                  "cnn14_mixup_time_domain", "cnn14_decisionlevelmax", "cnn14_decisionlevelavg"):
        # Cnn14's parameters: the 16/8 kHz frontends (models.py:3134-3379),
        # the training-time differences (no SpecAugment, no dropout, waveform
        # mixup; models.py:282-496, 3380-3497) and the decision-level max/avg
        # heads (pann_zoo.cnn14_decisionlevel_apply, models.py:3731-3990)
        return cnn14_init(gen), CNN14_CHANNELS[-1]
    zoo_inits = {
        "resnet22": (zoo.resnet22_init, 2048), "resnet38": (zoo.resnet38_init, 2048),
        "resnet54": (zoo.resnet54_init, 2048), "mobilenetv1": (zoo.mobilenetv1_init, 1024),
        "mobilenetv2": (zoo.mobilenetv2_init, 1280), "dainet19": (zoo.dainet_init, 512),
        "cnn6": (zoo.cnn6_init, 512), "wavegram_cnn14": (zoo.wavegram_cnn14_init, 2048),
        "wavegram_logmel_cnn14": (zoo.wavegram_logmel_cnn14_init, 2048),
        "wavegram_logmel128_cnn14": (zoo.wavegram_logmel128_cnn14_init, 2048),
    }
    if name_l in zoo_inits:
        init, width = zoo_inits[name_l]
        return init(gen), width
    if name_l in ("leenet11", "leenet24"):
        return zoo.leenet_init(gen, name_l), 256 if name_l == "leenet11" else 1024
    if name_l in ("res1dnet31", "res1dnet51"):
        return zoo.res1dnet_init(gen, name_l), 2048
    raise ValueError(f"Unknown PANN model {name!r}. (expected one of {sorted(PANN_ZOO_NAMES)})")


def apply_pann_model(
    name: str,
    params: Params,
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None = None,
    *,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """The forward of a ``build_pann_model`` name, with its frontend
    configuration (reference ``classtype(**kwargs)`` + ``model(input)``,
    ``pann_utils/hub.py:14-56``). LeeNet, DaiNet, Res1dNet and
    Wavegram_Cnn14 take no ``waveform_lens``, as in the JAX package: their
    ``frame_embs_lens`` are the full frame count. ``deterministic=False``
    is training mode (module docstring): it raises ``ValueError`` for the
    Cnn family, whose dropout needs a generator that this call does not
    take (the JAX package's raises ``TypeError`` for want of an rng)."""
    from conette_torch.models import pann_zoo as zoo

    name_l = name.lower()
    kw: dict[str, Any] = dict(deterministic=deterministic, compute_dtype=compute_dtype)
    cfgs = {"cnn14_16k": zoo.PANN_LOGMEL_16K, "cnn14_8k": zoo.PANN_LOGMEL_8K,
            "cnn14_mel32": zoo.PANN_LOGMEL32, "cnn14_mel128": zoo.PANN_LOGMEL128}
    if name_l == "cnn14_no_dropout":
        return pann_apply(params, waveform, waveform_lens, dropout_p=0.0, **kw)
    if name_l in ("cnn10", "cnn14", "cnn14_decisionlevelatt", "cnn14_att", "cnn14_emb512",
                  "cnn14_emb128", "cnn14_emb32", "cnn14_no_specaug",
                  "cnn14_mixup_time_domain") or name_l in cfgs:
        return pann_apply(params, waveform, waveform_lens, logmel_cfg=cfgs.get(name_l, PANN_LOGMEL),
                          **kw)
    if name_l in ("cnn14_decisionlevelmax", "cnn14_decisionlevelavg"):
        return zoo.cnn14_decisionlevel_apply(params, waveform, waveform_lens,
                                             pooling=name_l.removeprefix("cnn14_decisionlevel"), **kw)
    if name_l in ("resnet22", "resnet38", "mobilenetv1"):
        arch = "mobilenetv1" if name_l == "mobilenetv1" else "resnet22"
        return zoo.pann_zoo_apply(params, waveform, waveform_lens, arch=arch, **kw)
    with_lens = {"resnet54": zoo.resnet54_apply, "mobilenetv2": zoo.mobilenetv2_apply,
                 "cnn6": zoo.cnn6_apply, "wavegram_logmel_cnn14": zoo.wavegram_logmel_cnn14_apply,
                 "wavegram_logmel128_cnn14": zoo.wavegram_logmel128_cnn14_apply}
    if name_l in with_lens:
        return with_lens[name_l](params, waveform, waveform_lens, **kw)
    raw = {"leenet11": zoo.leenet_apply, "leenet24": zoo.leenet_apply,
           "dainet19": zoo.dainet_apply, "res1dnet31": zoo.res1dnet_apply,
           "res1dnet51": zoo.res1dnet_apply, "wavegram_cnn14": zoo.wavegram_cnn14_apply}
    if name_l in raw:
        return raw[name_l](params, waveform, **kw)
    raise ValueError(f"Unknown PANN model {name!r}.")
