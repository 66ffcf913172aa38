"""Batch collation with shape bucketing (host-side numpy).

Capability twin of ``AdvancedCollateDict`` (``src/conette/datamodules/
collate.py:26-108``): dict-collate with automatic pad-and-stack per key,
``*_shape`` companions, and per-key pad values.

TPU-first addition: caption lengths and audio frame counts are padded to
**buckets** (next multiple of a quantum) instead of the exact batch max, so
an epoch compiles to a handful of XLA programs instead of one per length.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np


def round_up(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


def pad_and_stack(
    arrays: Sequence[np.ndarray],
    pad_value: float | int = 0,
    length_quantum: int = 1,
    min_length: int = 0,
    min_first_axis: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of arrays (pad on every axis) and stack; returns
    (stacked, shapes (B, ndim)). ``length_quantum``/``min_length`` apply to
    the LAST axis (the sequence-length axis for 1-D captions and 2-D
    multi-reference captions); ``min_first_axis`` floors the FIRST axis of
    >=2-D items (the time axis of (T, F) audio) — multi-host training pads
    it to the dataset max so every process collates identical global
    shapes."""
    arrays = [np.asarray(a) for a in arrays]
    ndim = arrays[0].ndim
    max_shape = [max(a.shape[d] for a in arrays) for d in range(ndim)]
    max_shape[-1] = max(round_up(max_shape[-1], length_quantum), min_length)
    if ndim >= 2:
        max_shape[0] = max(max_shape[0], min_first_axis)
    out = np.full((len(arrays), *max_shape), pad_value, dtype=arrays[0].dtype)
    shapes = np.zeros((len(arrays), ndim), np.int64)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        shapes[i] = a.shape
    return out, shapes


class CollateDict:
    """Collate a list of item dicts into a batch dict.

    Numeric-array values are padded+stacked with a ``{key}_shape`` tensor;
    scalars stack; strings and nested lists stay as Python lists.
    """

    def __init__(
        self,
        pad_values: Mapping[str, float | int] | None = None,
        length_quantums: Mapping[str, int] | None = None,
        min_lengths: Mapping[str, int] | None = None,
        min_first_axes: Mapping[str, int] | None = None,
    ) -> None:
        self.pad_values = dict(pad_values or {})
        self.length_quantums = dict(length_quantums or {})
        self.min_lengths = dict(min_lengths or {})
        self.min_first_axes = dict(min_first_axes or {})

    def __call__(self, items: Sequence[Mapping[str, Any]]) -> dict[str, Any]:
        keys = items[0].keys()
        batch: dict[str, Any] = {}
        for key in keys:
            values = [it[key] for it in items]
            first = values[0]
            if isinstance(first, np.ndarray) and first.ndim >= 1:
                stacked, shapes = pad_and_stack(
                    values,
                    self.pad_values.get(key, 0),
                    self.length_quantums.get(key, 1),
                    self.min_lengths.get(key, 0),
                    self.min_first_axes.get(key, 0),
                )
                batch[key] = stacked
                batch[f"{key}_shape"] = shapes
            elif isinstance(first, (int, np.integer)):
                batch[key] = np.asarray(values, np.int64)
            elif isinstance(first, (float, np.floating)):
                batch[key] = np.asarray(values, np.float64)
            else:
                batch[key] = list(values)
        return batch
