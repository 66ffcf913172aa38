"""Dataset protocol + composable wrappers (host-side).

Capability twins of the reference dataset toolkit
(``src/conette/datasets/typing.py:8-26``, ``datasets/utils.py:77-917``):
``AACDatasetLike`` protocol (column_names / at / __getitem__ / __len__),
subset, concat, duplicate-oversampling, per-epoch random re-subsampling
(dataset balancing), column selection/replacement, item transforms, and a
``DummyAACDataset`` test fixture.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class AACDatasetLike(Protocol):
    """Structural protocol (parity: ``datasets/typing.py:8-26``)."""

    @property
    def column_names(self) -> list[str]: ...

    def at(self, idx: int, column: str) -> Any: ...

    def __getitem__(self, idx: int) -> dict[str, Any]: ...

    def __len__(self) -> int: ...


class DictDataset:
    """In-memory column store; the base building block."""

    def __init__(self, data: dict[str, Sequence]) -> None:
        lengths = {k: len(v) for k, v in data.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"Column length mismatch: {lengths}")
        self._data = data
        self._len = next(iter(lengths.values())) if lengths else 0

    @property
    def column_names(self) -> list[str]:
        return list(self._data.keys())

    def at(self, idx: int, column: str) -> Any:
        return self._data[column][idx]

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return {k: v[idx] for k, v in self._data.items()}

    def __len__(self) -> int:
        return self._len


class Wrapper:
    """Base pass-through wrapper (parity: ``datasets/utils.py:77``)."""

    def __init__(self, source: AACDatasetLike) -> None:
        self._source = source

    @property
    def source(self) -> AACDatasetLike:
        return self._source

    def unwrap(self, recursive: bool = True) -> AACDatasetLike:
        ds = self._source
        while recursive and isinstance(ds, Wrapper):
            ds = ds._source
        return ds

    @property
    def column_names(self) -> list[str]:
        return self._source.column_names

    def at(self, idx: int, column: str) -> Any:
        return self._source.at(idx, column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return self._source[idx]

    def __len__(self) -> int:
        return len(self._source)


class AACSubset(Wrapper):
    """Index-filtered view (parity: ``datasets/utils.py:119``)."""

    def __init__(self, source: AACDatasetLike, indexes: Iterable[int]) -> None:
        super().__init__(source)
        self._indexes = list(indexes)

    def at(self, idx: int, column: str) -> Any:
        return self._source.at(self._indexes[idx], column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return self._source[self._indexes[idx]]

    def __len__(self) -> int:
        return len(self._indexes)


class AACConcat:
    """Concatenation over the shared columns (parity: ``datasets/utils.py:192``)."""

    def __init__(self, *sources: AACDatasetLike) -> None:
        if not sources:
            raise ValueError("AACConcat requires at least one dataset")
        self._sources = sources
        cols = set(sources[0].column_names)
        for s in sources[1:]:
            cols &= set(s.column_names)
        self._columns = [c for c in sources[0].column_names if c in cols]
        self._offsets = np.cumsum([0] + [len(s) for s in sources])

    @property
    def column_names(self) -> list[str]:
        return list(self._columns)

    def _locate(self, idx: int) -> tuple[AACDatasetLike, int]:
        if idx < 0:
            idx += len(self)
        src_i = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self._sources[src_i], idx - int(self._offsets[src_i])

    def at(self, idx: int, column: str) -> Any:
        src, local = self._locate(idx)
        return src.at(local, column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        src, local = self._locate(idx)
        item = src[local]
        return {k: item[k] for k in self._columns}

    def __len__(self) -> int:
        return int(self._offsets[-1])


class AACDuplicate(Wrapper):
    """Oversample a small dataset to a target size by repeating indexes
    (parity: ``datasets/utils.py:384`` — dataset-balancing mode
    ``main_hdf_duplicate``)."""

    def __init__(self, source: AACDatasetLike, target_size: int) -> None:
        super().__init__(source)
        n = len(source)
        reps = max(1, -(-target_size // max(n, 1)))
        self._indexes = (list(range(n)) * reps)[:target_size]

    def at(self, idx: int, column: str) -> Any:
        return self._source.at(self._indexes[idx], column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return self._source[self._indexes[idx]]

    def __len__(self) -> int:
        return len(self._indexes)


class WrapperSampler(Wrapper):
    """Random re-subsample of ``n_max`` items, reshuffled per epoch via
    ``resample()`` (parity: ``datasets/utils.py:322`` +
    ``datamodules/hdf.py:180-187``)."""

    def __init__(self, source: AACDatasetLike, n_max: int, seed: int = 1234) -> None:
        super().__init__(source)
        self._n_max = min(n_max, len(source))
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._indexes = np.arange(self._n_max)
        self.resample()

    def resample(self, epoch: int | None = None) -> None:
        """Re-draw the subsample. With ``epoch`` the draw is a pure
        function of ``(seed, epoch)`` — resumed runs re-draw the same
        subset for the same epoch regardless of how many prior epochs were
        replayed; without it the stateful stream advances (legacy)."""
        rng = (
            self._rng
            if epoch is None
            else np.random.default_rng((self._seed, int(epoch)))
        )
        self._indexes = rng.permutation(len(self._source))[: self._n_max]

    def at(self, idx: int, column: str) -> Any:
        return self._source.at(int(self._indexes[idx]), column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return self._source[int(self._indexes[idx])]

    def __len__(self) -> int:
        return self._n_max


class AACSelectColumnsWrapper(Wrapper):
    """Column projection (parity: ``datasets/utils.py:666``)."""

    def __init__(self, source: AACDatasetLike, include: Iterable[str]) -> None:
        super().__init__(source)
        self._include = [c for c in include if c in source.column_names]

    @property
    def column_names(self) -> list[str]:
        return list(self._include)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return {c: self._source.at(idx, c) for c in self._include}


class AACReplaceColumnWrapper(Wrapper):
    """Replace one column with provided values (parity: ``datasets/utils.py:768``)."""

    def __init__(self, source: AACDatasetLike, column: str, values: Sequence) -> None:
        super().__init__(source)
        if len(values) != len(source):
            raise ValueError(f"{len(values)=} != {len(source)=}")
        self._column = column
        self._values = values

    def at(self, idx: int, column: str) -> Any:
        if column == self._column:
            return self._values[idx]
        return self._source.at(idx, column)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        item = dict(self._source[idx])
        item[self._column] = self._values[idx]
        return item


class AACTransformWrapper(Wrapper):
    """Apply per-column callables to each item (parity: ``datasets/utils.py:850``)."""

    def __init__(
        self, source: AACDatasetLike, transforms: dict[str, Callable[[Any], Any]]
    ) -> None:
        super().__init__(source)
        self._transforms = transforms

    def at(self, idx: int, column: str) -> Any:
        value = self._source.at(idx, column)
        tfm = self._transforms.get(column)
        return tfm(value) if tfm is not None else value

    def __getitem__(self, idx: int) -> dict[str, Any]:
        item = dict(self._source[idx])
        for col, tfm in self._transforms.items():
            if col in item:
                item[col] = tfm(item[col])
        return item


class DummyAACDataset(DictDataset):
    """Synthetic fixture (parity: ``datasets/utils.py:917``)."""

    def __init__(
        self,
        size: int = 16,
        n_refs: int = 5,
        audio_frames: int = 31,
        feat: int = 768,
        seed: int = 0,
        dataset_name: str = "dummy",
        subset: str = "train",
    ) -> None:
        rng = np.random.default_rng(seed)
        words = ["a", "dog", "barks", "rain", "falls", "wind", "blows", "man",
                 "speaks", "bird", "sings", "engine", "hums", "water", "flows"]
        captions = [
            [
                " ".join(rng.choice(words, size=rng.integers(3, 8)))
                for _ in range(n_refs)
            ]
            for _ in range(size)
        ]
        lens = rng.integers(audio_frames // 2, audio_frames + 1, size=size)
        audio = [
            rng.standard_normal((audio_frames, feat)).astype(np.float32)
            for _ in range(size)
        ]
        super().__init__(
            {
                "audio": audio,
                "audio_lens": [int(l) for l in lens],
                "captions": captions,
                "dataset": [dataset_name] * size,
                "subset": [subset] * size,
                "source": [None] * size,
                "fname": [f"clip_{i}.wav" for i in range(size)],
            }
        )
