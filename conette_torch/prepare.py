"""conette-prepare: dataset download, filtering and HDF packing.

Counterpart of ``conette_tpu/prepare.py`` (reference ``main_prepare``,
``src/conette/prepare.py:548-593``):

- checkpoints resolve through the registries (``models/registries.py``;
  hosts without a network point ``CONETTE_CKPT_DIR`` at staged files);
- datasets come from **local audio directories and caption CSVs**
  (``--audio_dir``, ``--captions_csv``), or through ``aac-datasets`` where it
  is installed (the config mode, ``data=clotho ...``);
- items are filtered by index range, duration and sample rate, with their
  metadata cached on disk (reference ``prepare.py:279-366``);
- each subset is encoded by the frozen encoder that ``audio_t`` names on
  the card and packed into ``{data}_{subset}_{audio_t}_{text_t}.hdf`` by
  ``data/hdf.py`` (reference ``prepare.py:369-504``):
  ``resample_mean_convnext`` (resample → channel mean → log-mel →
  ConvNeXt-Tiny frame embeddings) in batches through the preprocessor's
  captured encoder programs; ``resample_mean_cnn10`` /
  ``cnn14`` / ``cnn14_att`` (PANNs' Cnn10, Cnn14, Cnn14_DecisionLevelAtt),
  each batch of files loaded on the native loader's pool and encoded as one
  length-masked batch (``models/pann.py::pann_frames_masked``);
- ``--debug`` re-encodes one random item and compares it with its packed row
  (reference ``prepare.py:485-545``).

Run as ``python -m conette_torch.prepare --audio_dir D --captions_csv C
--out_dir O [--audio_t resample_mean_cnn14]``; ``--device`` defaults to
``cuda`` and raises without a card.

Spans (``utils/profiling.py``): a root ``pack_dataset`` (``files``,
``batch``) around the encoding and the write; on the Cnn route, each
batch's ``load_ahead`` on a thread of its own (the loader's
``native_load``, its ``load_file`` spans on the pool) and a ``load_wait``
around each wait for one, ``pann_encode``
(``rows``, ``padded_frames``) and ``pack_collect`` (the rows' copy to the
host), with the counters ``pann_valid_frames`` and ``pann_pad_frames``, the
mel frames computed inside and past the rows' lengths; ``pack_write``
around the HDF write.
"""

from __future__ import annotations

import csv
import logging
import os
import random
import sys
from typing import Any, Optional, Sequence

import numpy as np
import torch

from conette_torch.utils.profiling import count, current, span

pylog = logging.getLogger(__name__)


# --------------------------------------------------------------- local data
def load_audio_metadata(fpath: str) -> dict[str, Any]:
    """Duration and sample-rate metadata of one file (disk-cached by
    :func:`filter_dataset`)."""
    from conette_torch.utils.audio_io import load_audio

    wav, sr = load_audio(fpath)
    return {
        "sample_rate": sr,
        "num_frames": wav.shape[1],
        "num_channels": wav.shape[0],
        "duration_s": wav.shape[1] / sr,
    }


def scan_local_dataset(
    audio_dir: str,
    captions_csv: str,
    dataset_name: str,
    subset: str,
    source: str | None = None,
) -> "LocalAudioDataset":
    """A dataset over a directory of audio files and a captions CSV with
    columns ``file_name,caption`` (one row per reference)."""
    captions: dict[str, list[str]] = {}
    with open(captions_csv) as f:
        for row in csv.DictReader(f):
            captions.setdefault(row["file_name"], []).append(row["caption"])
    fnames = sorted(captions.keys())
    missing = [f for f in fnames if not os.path.isfile(os.path.join(audio_dir, f))]
    if missing:
        pylog.warning(f"{len(missing)} caption rows without audio files (skipped)")
        fnames = [f for f in fnames if f not in set(missing)]
    return LocalAudioDataset(audio_dir, fnames, captions, dataset_name, subset, source)


class LocalAudioDataset:
    """AACDatasetLike over local audio files."""

    def __init__(self, audio_dir, fnames, captions, dataset, subset, source) -> None:
        self._audio_dir = audio_dir
        self._fnames = fnames
        self._captions = captions
        self._dataset = dataset
        self._subset = subset
        self._source = source

    @property
    def column_names(self) -> list[str]:
        return ["audio", "captions", "dataset", "subset", "source", "fname"]

    def path(self, idx: int) -> str:
        """The audio file of item ``idx``."""
        return os.path.join(self._audio_dir, self._fnames[idx])

    def at(self, idx: int, column: str) -> Any:
        fname = self._fnames[idx]
        if column == "audio":
            from conette_torch.utils.audio_io import load_audio

            return load_audio(self.path(idx))
        if column == "captions":
            return self._captions[fname]
        if column == "dataset":
            return self._dataset
        if column == "subset":
            return self._subset
        if column == "source":
            return self._source
        if column == "fname":
            return fname
        raise KeyError(column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return {c: self.at(idx, c) for c in self.column_names}

    def __len__(self) -> int:
        return len(self._fnames)


def filter_dataset(
    dataset: LocalAudioDataset,
    *,
    min_duration_s: float = 0.1,
    max_duration_s: float = 30.0,
    accepted_sample_rates: tuple[int, ...] | None = None,
    index_range: tuple[int, int] | None = None,
) -> list[int]:
    """Indexes that pass the duration, sample-rate and index filters."""
    from conette_torch.utils.disk_cache import disk_cache

    cached_meta = disk_cache(load_audio_metadata)
    file_backed = hasattr(dataset, "_audio_dir")
    keep: list[int] = []
    for i in range(len(dataset)):
        if index_range is not None and not (index_range[0] <= i < index_range[1]):
            continue
        if file_backed:
            fpath = os.path.join(dataset._audio_dir, dataset._fnames[i])
            meta = cached_meta(fpath)
        else:
            # in-memory datasets (the aac-datasets adapter): the metadata of
            # the loaded item, not of a file header
            wav, sr = dataset.at(i, "audio")
            meta = {
                "duration_s": float(np.asarray(wav).shape[-1]) / sr,
                "sample_rate": sr,
            }
        if not (min_duration_s <= meta["duration_s"] <= max_duration_s):
            continue
        if (
            accepted_sample_rates is not None
            and meta["sample_rate"] not in accepted_sample_rates
        ):
            continue
        keep.append(i)
    if len(keep) < len(dataset):
        pylog.info(f"Filtered {len(dataset) - len(keep)}/{len(dataset)} items")
    return keep


# --------------------------------------------------------- frontend packing
class ConvNeXtFrontend:
    """The offline ``resample_mean_convnext`` transform (reference
    ``src/conette/transforms/get.py:240-310``): per clip, resample → channel
    mean → frozen ConvNeXt → (T, 768) f32 frame embeddings, batched on
    ``device`` (the card unless the caller asks for the CPU; TF32 is turned
    off there, so the f32 encoder computes in f32)."""

    def __init__(self, encoder_params: Any | None = None, seed: int = 0,
                 device: torch.device | str | None = None) -> None:
        from conette_torch.huggingface.model import resolve_device
        from conette_torch.huggingface.preprocessor import CoNeTTEPreprocessor

        self.device = resolve_device(device)
        self.preprocessor = CoNeTTEPreprocessor(encoder_params, seed=seed, device=self.device)

    def __call__(self, wav_and_sr: tuple[np.ndarray, int]) -> np.ndarray:
        wav, sr = wav_and_sr
        batch = self.preprocessor(np.asarray(wav)[None], sr=sr)
        n = int(batch["audio_shape"][0, 1])
        return batch["audio"][0, :n].float().cpu().numpy()

    def encode_dataset_batched(
        self, dataset: Any, indexes: list[int], batch_size: int = 8
    ) -> list[np.ndarray]:
        out: list[np.ndarray] = []
        for start in range(0, len(indexes), batch_size):
            chunk = indexes[start : start + batch_size]
            wavs, srs = [], []
            for i in chunk:
                wav, sr = dataset.at(i, "audio")
                wavs.append(wav)
                srs.append(sr)
            batch = self.preprocessor(wavs, sr=srs)
            embs = batch["audio"].float().cpu().numpy()
            lens = batch["audio_shape"][:, 1].cpu().numpy()
            out.extend(embs[j, : int(lens[j])] for j in range(len(chunk)))
        return out


class PannFrontend:
    """The offline ``resample_mean_cnn10`` / ``resample_mean_cnn14`` /
    ``resample_mean_cnn14_att`` transforms (reference
    ``src/conette/transforms/get.py:64-237``): a batch's files decoded,
    averaged over their channels and resampled to 32 kHz on the native
    loader's pool (in-memory clips resampled on it), zero-padded to a length
    bucket, and encoded on ``device`` as one length-masked batch
    (``models/pann.py::pann_frames_masked``): (T', C) f32 frame embeddings
    a clip, each what the encoder gives the clip alone. A batch of more than
    ``MAX_ROWS`` files is encoded ``MAX_ROWS`` at a time (the config mode's
    ``data.bsize`` is 512; 32 rows of 30 s hold 1.57 GB in each of block 1's
    activations). Without ``encoder_params``, the architecture's random
    initialisation from ``seed``."""

    MAX_ROWS = 32

    def __init__(self, name: str, encoder_params: Any | None = None, seed: int = 0,
                 device: torch.device | str | None = None) -> None:
        from conette_torch.huggingface.model import resolve_device
        from conette_torch.models.pann import build_pann_model
        from conette_torch.ops.frontend_factories import PANN_FRONTENDS
        from conette_torch.weights import to_torch

        self.device = resolve_device(device)
        if encoder_params is None:
            encoder_params = build_pann_model(PANN_FRONTENDS[name], torch.Generator().manual_seed(seed))[0]
        self.params = to_torch(encoder_params, self.device)
        self._staging: torch.Tensor | None = None

    def load(self, dataset: Any, indexes: list[int]) -> list[np.ndarray]:
        """The items' mono 32 kHz clips, in order."""
        from conette_torch.native import loader
        from conette_torch.ops.frontend_factories import TARGET_SR

        if isinstance(dataset, LocalAudioDataset):
            return loader.load_batch([dataset.path(i) for i in indexes], TARGET_SR)
        clips = [dataset.at(i, "audio") for i in indexes]
        waves = [np.asarray(w, np.float32).reshape(-1, np.shape(w)[-1]) for w, _ in clips]
        return loader.resample_batch(waves, [int(sr) for _, sr in clips], TARGET_SR)

    def stage(self, monos: list[np.ndarray], samples: int) -> torch.Tensor:
        """The clips zero-padded to ``samples`` in a host buffer kept from
        batch to batch (pinned where a card is the device). numpy copies
        them on this thread: torch's CPU copies would wake its pool of
        threads, whose spinning slows the loader's threads (a batch's load
        beside them took 3-4 times as long on the H100 host)."""
        rows = len(monos)
        buf = self._staging
        if buf is None or buf.shape[0] < rows or buf.shape[1] < samples:
            buf = torch.empty((max(rows, buf.shape[0] if buf is not None else 0), samples),
                              pin_memory=self.device.type == "cuda")
            self._staging = buf
        out = buf[:rows, :samples]
        rows_np = out.numpy()
        for row, m in zip(rows_np, monos):
            row[: len(m)] = m
            row[len(m):] = 0.0
        return out

    @torch.inference_mode()
    def encode(self, monos: list[np.ndarray]) -> list[np.ndarray]:
        from conette_torch.huggingface.preprocessor import bucket_length
        from conette_torch.models.pann import PANN_LOGMEL, pann_frames_masked

        lens = [len(m) for m in monos]
        samples = bucket_length(max(lens))
        hop = PANN_LOGMEL.hop_length
        valid = sum(1 + n // hop for n in lens)
        computed = len(monos) * (1 + samples // hop)
        host = self.stage(monos, samples)
        with span("pann_encode", rows=len(monos), padded_frames=computed):
            wave = host.to(self.device, non_blocking=True)
            out = pann_frames_masked(self.params, wave, torch.tensor(lens))
            count("pann_valid_frames", valid)
            count("pann_pad_frames", computed - valid)
        with span("pack_collect"):
            embs = out["frame_embs"].transpose(1, 2).contiguous()
            host_embs = torch.empty(embs.shape, pin_memory=self.device.type == "cuda")
            host_embs.copy_(embs)
            n_out = out["frame_embs_lens"].tolist()
        return [host_embs.numpy()[j, :n] for j, n in enumerate(n_out)]

    def encode_dataset_batched(
        self, dataset: Any, indexes: list[int], batch_size: int = 8
    ) -> list[np.ndarray]:
        """The items' frame embeddings, in order: each batch of
        ``batch_size`` files loaded on a thread of its own (a ``load_ahead``
        span under the caller's, holding the loader's ``native_load``) while
        the card encodes the batch before it (``native.loader.load_ahead``,
        with a ``load_wait`` around each wait for a batch)."""
        from conette_torch.native.loader import load_ahead

        def load(chunk: list[int]) -> list[np.ndarray]:
            current().set(files=len(chunk))
            return self.load(dataset, chunk)

        chunks = [indexes[start : start + batch_size] for start in range(0, len(indexes), batch_size)]
        out: list[np.ndarray] = []
        with load_ahead(chunks, load) as loaded:
            for monos in loaded:
                for at in range(0, len(monos), self.MAX_ROWS):
                    out.extend(self.encode(monos[at : at + self.MAX_ROWS]))
        return out


def make_frontend(audio_t_name: str, encoder_params: Any | None = None,
                  device: torch.device | str | None = None) -> Any:
    """The packing frontend that ``audio_t_name`` names:
    ``resample_mean_convnext`` or a Cnn frontend (``PANN_FRONTENDS``);
    ``ValueError`` naming them for any other."""
    from conette_torch.ops.frontend_factories import PANN_FRONTENDS

    if audio_t_name == "resample_mean_convnext":
        return ConvNeXtFrontend(encoder_params, device=device)
    if audio_t_name in PANN_FRONTENDS:
        return PannFrontend(audio_t_name, encoder_params, device=device)
    raise ValueError(f"Unknown audio_t {audio_t_name!r}. (expected one of "
                     f"{['resample_mean_convnext', *PANN_FRONTENDS]})")


def load_registry_weights(name: str) -> Any:
    """The numpy tree of a registry checkpoint: a PANN name
    (``PANN_REGISTRY``) through ``load_registry_pann``, else a ConvNeXt."""
    from conette_torch.models.registries import PANN_REGISTRY, load_registry_encoder

    if name in PANN_REGISTRY:
        from conette_torch.huggingface.convert_pann import load_registry_pann

        return load_registry_pann(name)
    return load_registry_encoder(name)


def pack_dataset_to_hdf(
    dataset: LocalAudioDataset,
    out_dir: str,
    *,
    audio_t_name: str = "resample_mean_convnext",
    text_t_name: str = "ident",
    encoder_params: Any | None = None,
    batch_size: int = 8,
    indexes: list[int] | None = None,
    overwrite: bool = False,
    debug_check: bool = False,
    device: torch.device | str | None = None,
) -> str:
    """Encode and pack one subset with the frontend ``audio_t_name`` names
    (:func:`make_frontend`) under the reference's name
    ``{data}_{subset}_{audio_t}_{text_t}.hdf``; returns the file's path.

    ``debug_check`` re-encodes one random item in the batch it was packed
    in and holds the packed row to it (atol 1e-4). The JAX package
    re-encodes that item alone, padded to its own length bucket; its frame
    count ``round(n / (padded // frames))`` then depends on the bucket and
    can differ from the packed row's (a 20 s clip: 62 frames alone, 63 in a
    batch padded to 30 s), which fails that check on its shapes."""
    from conette_torch.data.hdf import HDFDataset

    if indexes is None:
        indexes = list(range(len(dataset)))
    with span("pack_dataset", files=len(indexes), batch=batch_size):
        frontend = make_frontend(audio_t_name, encoder_params, device)
        embs = frontend.encode_dataset_batched(dataset, indexes, batch_size)
        first = indexes[0]
        name = f"{dataset.at(first, 'dataset')}_{dataset.at(first, 'subset')}_{audio_t_name}_{text_t_name}.hdf"
        fpath = os.path.join(out_dir, name)
        write_pack(dataset, indexes, embs, fpath, overwrite)

    if debug_check:
        loaded = HDFDataset(fpath)
        j = random.Random(0).randrange(len(indexes))
        start = j - j % batch_size
        re_enc = frontend.encode_dataset_batched(
            dataset, indexes[start : start + batch_size], batch_size)[j - start]
        packed_audio = loaded.at(j, "audio")
        if re_enc.shape != packed_audio.shape or not np.allclose(re_enc, packed_audio, atol=1e-4):
            diff = (np.abs(re_enc - packed_audio).max() if re_enc.shape == packed_audio.shape
                    else f"shapes {re_enc.shape} and {packed_audio.shape}")
            raise RuntimeError(f"HDF sanity check failed for item {j} of {fpath} (max diff {diff})")
        pylog.info(f"HDF sanity check OK for {fpath}")
    return fpath


@span("pack_write")
def write_pack(dataset: Any, indexes: list[int], embs: list[np.ndarray], fpath: str,
               overwrite: bool = False) -> str:
    """The items' ``embs`` rows, lengths and metadata columns packed into
    one HDF file at ``fpath``."""
    from conette_torch.data.datasets import DictDataset
    from conette_torch.data.hdf import pack_to_hdf

    columns: dict[str, list] = {
        "audio": embs,
        "audio_lens": [int(e.shape[0]) for e in embs],
        "captions": [dataset.at(i, "captions") for i in indexes],
        "dataset": [dataset.at(i, "dataset") for i in indexes],
        "subset": [dataset.at(i, "subset") for i in indexes],
        "source": [dataset.at(i, "source") for i in indexes],
        "fname": [dataset.at(i, "fname") for i in indexes],
    }
    return pack_to_hdf(DictDataset(columns), fpath, overwrite=overwrite)


# ------------------------------------------------- download orchestration
#: aac-datasets class names per dataset (reference prepare.py:139-276)
_AAC_DATASET_CLASSES = {
    "clotho": "Clotho",
    "audiocaps": "AudioCaps",
    "macs": "MACS",
    "wavcaps": "WavCaps",
}


def download_dataset(
    name: str,
    root: str = "data",
    subsets: Sequence[str] | None = None,
    verbose: int = 1,
    **dataset_kwargs: Any,
) -> list[Any]:
    """Download a captioning dataset through ``aac-datasets`` (reference
    ``prepare.py:139-276``; AudioCaps also needs yt-dlp and ffmpeg on PATH).
    Without the package this raises with the staging instructions."""
    name_l = name.lower()
    if name_l not in _AAC_DATASET_CLASSES:
        raise ValueError(
            f"Unknown dataset {name!r} (expected one of "
            f"{sorted(_AAC_DATASET_CLASSES)})"
        )
    try:
        import aac_datasets
    except ImportError as err:
        raise RuntimeError(
            "Dataset download needs the `aac-datasets` package (not installed "
            "here). Stage the audio + captions manually and use "
            "--audio_dir/--captions_csv instead, or `pip install aac-datasets` "
            "on a connected host."
        ) from err
    cls = getattr(aac_datasets, _AAC_DATASET_CLASSES[name_l])
    subsets = list(subsets) if subsets is not None else [None]
    out = []
    for subset in subsets:
        kwargs = dict(root=root, download=True, verbose=verbose, **dataset_kwargs)
        if subset is not None:
            kwargs["subset"] = subset
        out.append(cls(**kwargs))
        pylog.info(f"Downloaded {name}/{subset or 'default'} into {root}.")
    return out


def download_metric_resources(cache_dir: str | None = None, verbose: int = 1) -> None:
    """Fetch the PTB/METEOR/SPICE jars and FENSE models through
    ``aac-metrics`` (reference ``prepare.py:567-576``); without it this raises
    and points at ``scripts/download_metric_resources.sh``."""
    cache_dir = cache_dir or os.path.expanduser("~/.cache/conette_torch/aac-metrics")
    try:
        from aac_metrics.download import download_metrics
    except ImportError as err:
        raise RuntimeError(
            "Metric-resource download needs `aac-metrics` (not installed "
            "here). Run scripts/download_metric_resources.sh on a connected "
            f"host and stage the jars under {cache_dir} "
            "(or set CONETTE_PTB_JAR / CONETTE_METEOR_JAR / CONETTE_SPICE_JAR)."
        ) from err
    download_metrics(cache_path=cache_dir, verbose=verbose)


class AacDatasetAdapter:
    """AACDatasetLike over an ``aac-datasets`` dataset object (Clotho,
    AudioCaps, MACS, WavCaps): maps its item dicts onto the packing
    protocol, so that downloaded datasets flow into HDF packing."""

    def __init__(self, ds: Any, dataset: str, subset: str,
                 source: str | None = None) -> None:
        self._ds = ds
        self._dataset = dataset
        self._subset = subset
        self._source = source

    @property
    def column_names(self) -> list[str]:
        return ["audio", "captions", "dataset", "subset", "source", "fname"]

    def at(self, idx: int, column: str) -> Any:
        if column in ("dataset", "subset", "source"):
            return getattr(self, f"_{column}")
        item = self._ds[idx]
        if column == "audio":
            wav = np.asarray(item["audio"], np.float32)
            if wav.ndim == 1:
                wav = wav[None]
            return wav, int(item.get("sr", item.get("sample_rate", 32_000)))
        if column == "captions":
            return list(item["captions"])
        if column == "fname":
            return str(item.get("fname", item.get("file_name", f"item_{idx}.wav")))
        raise KeyError(column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return {c: self.at(idx, c) for c in self.column_names}

    def __len__(self) -> int:
        return len(self._ds)


def main_prepare_config(argv: list[str], device: torch.device | str | None = None) -> int:
    """Hydra-style config mode (the reference's ``conf/prepare.yaml`` flow):

        python -m conette_torch.prepare data=clotho data.subsets=[dev,val] data.download=true

    Composes ``conf/prepare.yaml``, downloads through aac-datasets where
    asked, and packs each subset with the frontend of ``audio_t._target_``
    (``audio_t=resample_mean_cnn14``: Cnn14, its ``pretrain_path`` through
    the PANN registry) on ``device`` (else the config's ``device``, else the
    card)."""
    from conette_torch.config import load_config
    from conette_torch.huggingface.model import resolve_device

    cfg = load_config("prepare", argv)
    device = resolve_device(device if device is not None else cfg.get("device") or "cuda")
    data_cfg = dict(cfg.get("data", {}))
    name = data_cfg.get("name", "none")
    if cfg.get("download_metric_resources"):
        download_metric_resources(verbose=int(cfg.get("verbose", 1)))
    if name in ("none", "hdf", None):
        pylog.info("No dataset selected (data=none/hdf); nothing to pack.")
        return 0

    subsets = data_cfg.get("subsets") or [None]
    root = str(data_cfg.get("root", "data"))
    if data_cfg.get("download"):
        datasets = download_dataset(
            name, root, subsets=subsets, verbose=int(cfg.get("verbose", 1))
        )
    else:
        try:
            import aac_datasets
        except ImportError:
            pylog.error(
                "Config-mode packing reads datasets through `aac-datasets` "
                "(not installed here). Use the local flags instead: "
                "python -m conette_torch.prepare --audio_dir ... --captions_csv ..."
            )
            return 2
        cls = getattr(aac_datasets, _AAC_DATASET_CLASSES[name])
        datasets = [
            cls(root=root, subset=s, download=False) if s is not None
            else cls(root=root, download=False)
            for s in subsets
        ]

    encoder_params = None
    pretrain = dict(cfg.get("audio_t", {})).get("pretrain_path")
    if pretrain:
        try:
            encoder_params = load_registry_weights(str(pretrain))
        except FileNotFoundError as err:
            pylog.warning(f"Encoder checkpoint not staged ({err}); random init.")

    audio_t_name = str(
        dict(cfg.get("audio_t", {})).get("_target_", "resample_mean_convnext")
    ).rsplit("get_", 1)[-1]
    out_root = str(cfg.get("out_root", "data/HDF"))
    filters = dict(cfg.get("filters", {}))
    for ds, subset in zip(datasets, subsets):
        adapter = AacDatasetAdapter(ds, name, subset or "full")
        indexes = filter_dataset(
            adapter,
            min_duration_s=float(filters.get("min_duration_s", 0.1) or 0.0),
            max_duration_s=float(filters.get("max_duration_s", 30.0) or 1e9),
        )
        fpath = pack_dataset_to_hdf(
            adapter, out_root,
            audio_t_name=audio_t_name,
            encoder_params=encoder_params,
            batch_size=int(dict(cfg.get("data", {})).get("bsize", 8) or 8),
            indexes=indexes,
            overwrite=bool(cfg.get("overwrite_hdf", False)),
            debug_check=bool(cfg.get("debug", False)),
            device=device,
        )
        pylog.info(f"Packed {name}/{subset}: {len(indexes)} items -> {fpath}")
    return 0


def get_prepare_args(argv: Optional[list[str]] = None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Pack local audio datasets into HDF for conette-train (PyTorch/CUDA build)."
    )
    parser.add_argument("--audio_dir", type=str, required=False)
    parser.add_argument("--captions_csv", type=str, required=False)
    parser.add_argument("--dataset", type=str, default="clotho")
    parser.add_argument("--subset", type=str, default="dev")
    parser.add_argument("--source", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default="data/HDF")
    parser.add_argument("--audio_t", type=str, default="resample_mean_convnext",
                        help="The packing encoder: resample_mean_convnext, resample_mean_cnn10, "
                             "resample_mean_cnn14 or resample_mean_cnn14_att.")
    parser.add_argument("--encoder", type=str, default=None,
                        help="Registry name (e.g. cnext_bl_75, Cnn14) or params.npz path.")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--min_duration", type=float, default=0.1)
    parser.add_argument("--max_duration", type=float, default=30.0)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device; 'cpu' runs without a card.")
    parser.add_argument("--download", type=str, default=None,
                        help="Download a dataset first via aac-datasets "
                             "(clotho|audiocaps|macs|wavcaps; connected hosts only).")
    parser.add_argument("--download_root", type=str, default="data")
    parser.add_argument("--download_subsets", type=str, nargs="*", default=None)
    parser.add_argument("--download_metric_resources", action="store_true",
                        help="Fetch PTB/METEOR/SPICE jars via aac-metrics.")
    return parser.parse_args(argv)


def main_prepare(argv: Optional[list[str]] = None) -> int:
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s | %(message)s")
    if raw_argv and all("=" in a and not a.startswith("-") for a in raw_argv):
        # hydra-style overrides -> config mode (the reference's conf/prepare.yaml)
        return main_prepare_config(raw_argv)
    args = get_prepare_args(argv)
    if args.download:
        download_dataset(
            args.download, args.download_root,
            subsets=args.download_subsets, verbose=args.verbose,
        )
    if args.download_metric_resources:
        download_metric_resources(verbose=args.verbose)
        if not args.audio_dir:
            return 0
    if not args.audio_dir or not args.captions_csv:
        pylog.error(
            "conette-prepare packs LOCAL datasets: pass --audio_dir and "
            "--captions_csv (file_name,caption rows). The reference's "
            "aac-datasets downloads must be staged beforehand."
        )
        return 2

    from conette_torch.huggingface.model import resolve_device

    device = resolve_device(args.device)  # before any file is read: no card, no work
    encoder_params = None
    if args.encoder:
        if os.path.isfile(args.encoder):
            from conette_torch.huggingface.convert import load_params_npz

            encoder_params = load_params_npz(args.encoder)
        else:
            encoder_params = load_registry_weights(args.encoder)

    dataset = scan_local_dataset(
        args.audio_dir, args.captions_csv, args.dataset, args.subset, args.source
    )
    indexes = filter_dataset(
        dataset, min_duration_s=args.min_duration, max_duration_s=args.max_duration
    )
    fpath = pack_dataset_to_hdf(
        dataset,
        args.out_dir,
        audio_t_name=args.audio_t,
        encoder_params=encoder_params,
        batch_size=args.batch_size,
        indexes=indexes,
        overwrite=args.overwrite,
        debug_check=args.debug,
        device=device,
    )
    pylog.info(f"Packed {len(indexes)} items → {fpath}")
    return 0


if __name__ == "__main__":
    sys.exit(main_prepare())
