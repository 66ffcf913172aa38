"""Audio-frontend factories: named offline frontends, raw audio → features.

Counterpart of ``conette_tpu/ops/frontend_factories.py`` (reference
``src/conette/transforms/get.py``):

- ``resample_mean_convnext``: the production frontend (``get.py:240-310``);
- ``resample_mean_cnn10`` / ``cnn14`` / ``cnn14_att`` (``get.py:64-237``);
- ``resample_mean_spectrogram``: the log-mel frames (``get.py:313-647``);
- ``resample_mean_gammatonegram``: a 64-filter gammatone bank on the power
  spectrogram, in dB.

Each factory returns ``(fn, feature width)``, where ``fn(waveform (C, T) or
(T,), sr)`` resamples to 32 kHz on the host, averages the channels and
computes the (T', feature width) f32 features on ``device``, which the
caller names (TF32 is turned off on the card, so they compute in f32). The
Cnn frontends load as ``conette-prepare`` does (the channel mean resampled
by the native loader) and run ``models/pann.py::pann_frames_masked``, the
form ``conette-prepare`` batches, on the one clip.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from conette_torch.ops.frontend import DEFAULT_LOGMEL, logmel_spectrogram
from conette_torch.ops.resample import resample_numpy
from conette_torch.weights import to_torch

TARGET_SR = 32_000

FrontendFn = Callable[[np.ndarray, int], np.ndarray]

# Default sample rates per dataset (reference error message,
# transforms/get.py:650-660)
DEFAULT_SRC_SR = {"clotho": 44_100, "audiocaps": 32_000, "macs": 48_000}

FRONTENDS = (
    "resample_mean_convnext",
    "resample_mean_cnn10",
    "resample_mean_cnn14",
    "resample_mean_cnn14_att",
    "resample_mean_spectrogram",
    "resample_mean_gammatonegram",
)

# the PANN encoder of each PANN packing frontend (build_pann_model's
# names); conette-prepare packs them all, and get_frontend the Cnn family's
# (resample_mean_wavegram_logmel_cnn14 has no JAX twin)
PANN_FRONTENDS = {
    "resample_mean_cnn10": "Cnn10",
    "resample_mean_cnn14": "Cnn14",
    "resample_mean_cnn14_att": "Cnn14_DecisionLevelAtt",
    "resample_mean_wavegram_logmel_cnn14": "Wavegram_Logmel_Cnn14",
}


def _resample_mean(waveform: np.ndarray, sr: int) -> np.ndarray:
    waveform = np.asarray(waveform, np.float32)
    if waveform.ndim == 1:
        waveform = waveform[None]
    if sr != TARGET_SR:
        waveform = resample_numpy(waveform, sr, TARGET_SR)
    return waveform.mean(axis=0)


def _mean_resample_native(waveform: np.ndarray, sr: int) -> np.ndarray:
    """The channel mean resampled to 32 kHz by the native loader, as
    ``conette-prepare`` loads a file for the Cnn frontends."""
    from conette_torch.native import loader

    waveform = np.asarray(waveform, np.float32)
    return loader.resample_batch([waveform.reshape(-1, waveform.shape[-1])], [int(sr)], TARGET_SR)[0]


def get_frontend(
    name: str = "resample_mean_convnext",
    encoder_params: Any | None = None,
    seed: int = 0,
    *,
    device: torch.device | str,
) -> tuple[FrontendFn, int]:
    """→ (frontend_fn, feature width). ``encoder_params`` (a numpy or tensor
    tree) replaces the encoders' random initialisation from ``seed``."""
    from conette_torch.huggingface.model import resolve_device

    if name not in FRONTENDS:
        raise ValueError(f"Unknown frontend {name!r}. (expected one of {FRONTENDS})")
    dev = resolve_device(device)

    def mono_on_device(waveform: np.ndarray, sr: int) -> tuple[torch.Tensor, torch.Tensor]:
        mono = _resample_mean(waveform, sr)
        return torch.from_numpy(mono[None]).to(dev), torch.tensor([len(mono)], device=dev)

    if name == "resample_mean_convnext":
        from conette_torch.models.convnext import convnext_apply, convnext_init

        params = to_torch(encoder_params or convnext_init(torch.Generator().manual_seed(seed)), dev)

        @torch.inference_mode()
        def encoder_fn(waveform: np.ndarray, sr: int) -> np.ndarray:
            outs = convnext_apply(params, *mono_on_device(waveform, sr))
            n = int(outs["frame_embs_lens"][0])
            return outs["frame_embs"][0, :, :n].T.float().cpu().numpy()

        return encoder_fn, 768

    if name in PANN_FRONTENDS:
        from conette_torch.models.pann import build_pann_model, pann_frames_masked

        pann_name = PANN_FRONTENDS[name]
        params, feat = (
            (encoder_params, {"Cnn10": 512}.get(pann_name, 2048))
            if encoder_params is not None
            else build_pann_model(pann_name, torch.Generator().manual_seed(seed))
        )
        params = to_torch(params, dev)

        @torch.inference_mode()
        def pann_fn(waveform: np.ndarray, sr: int) -> np.ndarray:
            mono = _mean_resample_native(waveform, sr)
            outs = pann_frames_masked(params, torch.from_numpy(mono[None]).to(dev),
                                      torch.tensor([len(mono)]))
            n = int(outs["frame_embs_lens"][0])
            return outs["frame_embs"][0, :, :n].T.float().cpu().numpy()

        return pann_fn, feat

    if name == "resample_mean_spectrogram":

        @torch.inference_mode()
        def spectrogram_fn(waveform: np.ndarray, sr: int) -> np.ndarray:
            mono, _ = mono_on_device(waveform, sr)
            return logmel_spectrogram(mono, DEFAULT_LOGMEL)[0].cpu().numpy()

        return spectrogram_fn, DEFAULT_LOGMEL.n_mels

    from conette_torch.ops.gammatone import gammatone_filterbank
    from conette_torch.ops.stft import power_spectrogram

    n_filters = 64
    fb = torch.from_numpy(gammatone_filterbank(TARGET_SR, DEFAULT_LOGMEL.n_fft, n_filters)).to(dev)

    @torch.inference_mode()
    def gammatone_fn(waveform: np.ndarray, sr: int) -> np.ndarray:
        mono, _ = mono_on_device(waveform, sr)
        power = power_spectrogram(mono, DEFAULT_LOGMEL.n_fft, DEFAULT_LOGMEL.hop_length)
        out = 10.0 * torch.log10(torch.clamp_min(power @ fb, 1e-10))
        return out[0].cpu().numpy()

    return gammatone_fn, n_filters
