"""HDF5-packed dataset storage (host-side).

A copy of ``conette_tpu/data/hdf.py`` that reads and writes through
``conette_torch/data/hdf5.py`` (numpy) in place of h5py, so that the port
needs no h5py; the files are the same HDF5, and either package reads the
other's.

Capability twin of the reference HDF pipeline: ``pack_to_hdf``
(``src/conette/prepare.py:467-476`` via torchoutil) writes each column as a
dataset — variable-length audio embeddings are stored padded with a
``*_shape``/length column; ``HDFDataset`` reads items lazily.

File naming follows the reference convention
``{data}_{subset}_{audio_t}_{text_t}.hdf`` (``prepare.py:369-504``) and
``get_hdf_fpaths`` reproduces the helpful missing-suffix error
(``datamodules/common.py:19-73``).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Sequence

import numpy as np

from conette_torch.data.datasets import AACDatasetLike

pylog = logging.getLogger(__name__)


def pack_to_hdf(
    dataset: AACDatasetLike,
    fpath: str,
    pre_save_transform: dict[str, Callable] | None = None,
    batch_size: int = 32,
    overwrite: bool = False,
) -> str:
    """Pack a dataset to one HDF file. Variable-length float arrays are
    padded to the corpus max with a ``{col}_len`` companion; strings and
    nested caption lists are stored as JSON."""
    from conette_torch.data import hdf5 as h5py

    if os.path.exists(fpath) and not overwrite:
        raise FileExistsError(f"{fpath} exists (pass overwrite=True)")
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)

    n = len(dataset)
    tfms = pre_save_transform or {}
    columns = dataset.column_names

    items = []
    for i in range(n):
        item = dict(dataset[i])
        for col, tfm in tfms.items():
            if col in item:
                item[col] = tfm(item[col])
        items.append(item)

    with h5py.File(fpath, "w") as f:
        f.attrs["num_rows"] = n
        f.attrs["columns"] = json.dumps(columns)
        for col in columns:
            values = [it[col] for it in items]
            first = values[0]
            if isinstance(first, np.ndarray) and first.dtype.kind == "f":
                max_shape = tuple(
                    max(v.shape[d] for v in values) for d in range(first.ndim)
                )
                buf = np.zeros((n, *max_shape), np.float32)
                lens = np.zeros((n, first.ndim), np.int64)
                for i, v in enumerate(values):
                    sl = (i,) + tuple(slice(0, s) for s in v.shape)
                    buf[sl] = v
                    lens[i] = v.shape
                f.create_dataset(col, data=buf, compression=None)
                f.create_dataset(f"{col}_shape", data=lens)
            elif isinstance(first, (int, np.integer)):
                f.create_dataset(col, data=np.asarray(values, np.int64))
            elif isinstance(first, (float, np.floating)):
                f.create_dataset(col, data=np.asarray(values, np.float64))
            else:
                data = np.array(
                    [json.dumps(v).encode() for v in values], dtype=object
                )
                f.create_dataset(
                    col, data=data, dtype=h5py.string_dtype(encoding="utf-8")
                )
    pylog.info(f"Packed {n} items to {fpath}")
    return fpath


class HDFDataset:
    """Lazy reader for files produced by :func:`pack_to_hdf`."""

    def __init__(self, fpath: str, keep_padding: bool = False) -> None:
        from conette_torch.data import hdf5 as h5py

        self._fpath = fpath
        self._file = h5py.File(fpath, "r")
        self._columns = json.loads(self._file.attrs["columns"])
        self._n = int(self._file.attrs["num_rows"])
        self._keep_padding = keep_padding

    @property
    def fpath(self) -> str:
        return self._fpath

    @property
    def column_names(self) -> list[str]:
        return list(self._columns)

    def at(self, idx: int, column: str) -> Any:
        ds = self._file[column]
        value = ds[idx]
        if f"{column}_shape" in self._file and not self._keep_padding:
            shape = self._file[f"{column}_shape"][idx]
            value = value[tuple(slice(0, int(s)) for s in shape)]
        if isinstance(value, bytes):
            return json.loads(value.decode())
        if isinstance(value, str):
            return json.loads(value)
        return value

    def column(self, column: str) -> list:
        """Bulk-read a whole column in ONE vectorized h5py read (the
        reference's ``at(None, column)``, torchoutil HDFDataset) — per-row
        ``at`` calls cost a dataset lookup + scalar read each, which is
        minutes of startup on a 400k-row WavCaps pack."""
        values = self._file[column][:]
        if values.dtype.kind in ("S", "O", "U"):
            out = []
            for v in values:
                if isinstance(v, bytes):
                    out.append(json.loads(v.decode()))
                elif isinstance(v, str):
                    out.append(json.loads(v))
                else:
                    out.append(v)
            return out
        return list(values)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return {c: self.at(idx, c) for c in self._columns}

    def __len__(self) -> int:
        return self._n

    def close(self) -> None:
        self._file.close()


def get_hdf_fpaths(
    dataname: str,
    subsets: Sequence[str],
    hdf_root: str,
    hdf_suffix: str | None,
) -> dict[str, str]:
    """Map subset → hdf path with the reference naming scheme and a helpful
    error listing available suffixes (``datamodules/common.py:19-73``)."""
    if hdf_suffix is None:
        return {}
    out: dict[str, str] = {}
    for subset in subsets:
        fname = f"{dataname}_{subset}_{hdf_suffix}.hdf"
        fpath = os.path.join(hdf_root, fname)
        if not os.path.isfile(fpath):
            prefix = f"{dataname}_{subset}_"
            available = sorted(
                f.removeprefix(prefix).removesuffix(".hdf")
                for f in os.listdir(hdf_root)
                if f.startswith(prefix) and f.endswith(".hdf")
            ) if os.path.isdir(hdf_root) else []
            raise FileNotFoundError(
                f"Cannot find HDF file {fpath!r}. "
                f"(available suffixes for {dataname}_{subset}: {available})"
            )
        out[subset] = fpath
    return out
