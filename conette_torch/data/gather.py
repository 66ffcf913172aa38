"""A training batch gathered from its datasets in one pass.

``HDFDataModule.train_batches`` builds each batch with :class:`BatchGather`
in place of reading each item (the JAX package's
``HDFDataModule._train_item``), collating the items (``CollateDict``) and
copying the arrays into pinned memory:

- the batch's rows are followed through the wrappers that map indices
  (``AACConcat``, ``AACSubset``, ``AACDuplicate``, ``WrapperSampler``) down
  to the datasets that hold them;
- the audio's padded shape comes from the rows' stored shapes, which the
  reader of an HDF pack holds from its ``audio_shape`` and ``audio_lens``
  columns, each read once;
- each row of a pack is read with one ``os.preadv`` straight into the
  batch's audio array, on a small pool of threads, and only its tail past
  its length is filled with the pad value; the rows of any other dataset,
  or of a pack whose rows are not whole contiguous float32 rows, are read as
  items and copied in (route ``items``), as are all rows under an
  ``audio_transform``, which is applied row by row;
- a caption's tokens come from a memo filled on the sentence's first use,
  which raises on a word out of the vocabulary as the train transform does;
- where a card is present, each array of the batch is the numpy view of a
  new pinned tensor, which ``train/loop.py::pinned_batches`` hands on.

The batch is the one that ``_train_item``, ``CollateDict`` and
``_postprocess`` give, which ``tests/test_torch_batch_gather.py`` holds it
to: the same keys, dtypes, shapes and values.
"""

from __future__ import annotations

import concurrent.futures
import os
import weakref
from typing import Any, NamedTuple

import numpy as np

from conette_torch.data.collate import CollateDict, round_up
from conette_torch.data.datasets import AACConcat, AACDuplicate, AACSubset, WrapperSampler
from conette_torch.data.hdf import HDFDataset
from conette_torch.utils.profiling import count

# wrappers whose row ``i`` is their source's row ``_indexes[i]``, item for item
_INDEXED = (AACSubset, AACDuplicate, WrapperSampler)

# numpy's SeedSequence (its hash and mix constants) and PCG64 (its multiplier)
_M32 = np.uint64(0xFFFFFFFF)
_HASH_A, _MUL_A, _HASH_B, _MUL_B = 0x43B0D7E5, 0x931E8875, 0x8B51F9DD, 0x58F38DED
_MIX_L, _MIX_R = np.uint64(0xCA01F9DD), np.uint64(0x4973F715)
_PCG_HI, _PCG_LO = np.uint64(0x2360ED051FC65DA4), np.uint64(0x4385DF649FCCF645)


def _words(n: int) -> list[int]:
    """``n`` as SeedSequence takes it in: 32-bit words, the lowest first."""
    out = [n & 0xFFFFFFFF]
    while n >> 32:
        n >>= 32
        out.append(n & 0xFFFFFFFF)
    return out


def _hashmix(value: np.ndarray, const: list) -> np.ndarray:
    value = value ^ np.uint64(const[0])
    const[0] = const[0] * const[1] & 0xFFFFFFFF
    value = value * np.uint64(const[0]) & _M32
    return value ^ (value >> np.uint64(16))


def _mix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    r = (_MIX_L * x - _MIX_R * y) & _M32
    return r ^ (r >> np.uint64(16))


def _pcg_step(hi: np.ndarray, lo: np.ndarray, inc_hi: np.ndarray, inc_lo: np.ndarray) -> tuple:
    """PCG64's step, state · multiplier + increment mod 2**128, on (high,
    low) halves; the low halves' 128-bit product from 32-bit limbs."""
    a0, a1 = lo & _M32, lo >> np.uint64(32)
    b0, b1 = _PCG_LO & _M32, _PCG_LO >> np.uint64(32)
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    p_lo = (p00 & _M32) | (mid << np.uint64(32))
    p_hi = a1 * b1 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))
    p_hi = p_hi + lo * _PCG_HI + hi * _PCG_LO
    n_lo = p_lo + inc_lo
    return p_hi + inc_hi + (n_lo < p_lo).astype(np.uint64), n_lo


def reference_draws(seed: int, epoch: int, idxs: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """``int(np.random.default_rng((seed, epoch, idx)).integers(count))`` for
    each row, the same bits, computed for all rows at once: the seed
    sequence's hash of (seed, epoch, idx), PCG64 seeded from its state, its
    first output's low 32 bits scaled to ``count`` (Lemire's method). The
    rare row whose draw Lemire's method rejects, and any argument outside
    what this follows, is drawn by numpy itself."""
    idxs, counts = np.asarray(idxs, np.int64), np.asarray(counts, np.int64)
    n = len(idxs)

    def by_numpy(i: int) -> int:
        return int(np.random.default_rng((seed, epoch, int(idxs[i]))).integers(int(counts[i])))

    if seed < 0 or epoch < 0 or not n or idxs.min() < 0 or idxs.max() >> 32 or counts.max() >> 32:
        return np.asarray([by_numpy(i) for i in range(n)], np.int64)
    entropy = [np.full(n, w, np.uint64) for w in _words(seed) + _words(epoch)] + [idxs.astype(np.uint64)]
    const = [_HASH_A, _MUL_A]
    pool = [_hashmix(entropy[i] if i < len(entropy) else np.zeros(n, np.uint64), const) for i in range(4)]
    for src in range(4):
        for dst in range(4):
            if src != dst:
                pool[dst] = _mix(pool[dst], _hashmix(pool[src], const))
    for src in range(4, len(entropy)):
        for dst in range(4):
            pool[dst] = _mix(pool[dst], _hashmix(entropy[src], const))
    const = [_HASH_B, _MUL_B]
    state = [_hashmix(pool[i % 4], const) for i in range(8)]
    # PCG64's seed (words 0, 1) and stream (words 2, 3), each 128 bits, high word first
    val = [state[2 * i] | (state[2 * i + 1] << np.uint64(32)) for i in range(4)]
    inc_hi = (val[2] << np.uint64(1)) | (val[3] >> np.uint64(63))
    inc_lo = (val[3] << np.uint64(1)) | np.uint64(1)
    zero = np.zeros(n, np.uint64)
    hi, lo = _pcg_step(zero, zero, inc_hi, inc_lo)
    lo2 = lo + val[1]
    hi, lo = _pcg_step(hi + val[0] + (lo2 < lo).astype(np.uint64), lo2, inc_hi, inc_lo)
    hi, lo = _pcg_step(hi, lo, inc_hi, inc_lo)  # the first output
    rot, x = hi >> np.uint64(58), hi ^ lo
    out = (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))
    c = counts.astype(np.uint64)
    m = (out & _M32) * c
    got = np.where(counts > 1, m >> np.uint64(32), 0).astype(np.int64)
    threshold = (np.uint64(2**32) - c) % np.maximum(c, np.uint64(1))
    for i in np.flatnonzero(((m & _M32) < threshold) & (counts > 1)).tolist():
        got[i] = by_numpy(i)
    return got


def _values(values: list) -> Any:
    """A column of scalars as ``CollateDict`` stacks it."""
    first = values[0]
    if isinstance(first, (int, np.integer)):
        return np.asarray(values, np.int64)
    if isinstance(first, (float, np.floating)):
        return np.asarray(values, np.float64)
    return values


class _Part(NamedTuple):
    """Some rows of a batch that one dataset holds, in its own indices."""

    leaf: Any
    rows: np.ndarray
    pos: np.ndarray  # the rows' places in the batch
    shapes: np.ndarray | None  # their audio's shapes, where known before a read
    arrays: list | None  # their audio, where read as items
    lens: list  # the stored ``audio_lens``, or None where there is none
    refs: list
    dataset: list
    source: list


class _ItemRows:
    """A dataset read item by item (``ds[i]``), as the JAX package's
    ``_train_item`` reads it."""

    route = "items"

    def __init__(self, ds: Any) -> None:
        self.ds = ds

    def part(self, rows: np.ndarray, pos: np.ndarray, allowed: set | None) -> _Part:
        items = [self.ds[i] for i in rows.tolist()]

        def col(key: str, default: Any) -> list:
            if allowed is not None and key not in allowed:
                return [default] * len(items)
            return [it.get(key, default) for it in items]

        if allowed is not None and "captions" not in allowed:
            raise KeyError("captions")
        return _Part(self, rows, pos, None, [np.asarray(it["audio"], np.float32) for it in items],
                     col("audio_lens", None), [it["captions"] for it in items], col("dataset", "unknown"),
                     col("source", None))

    def stored_lens(self) -> np.ndarray:
        """Each row's audio length as the fixed-shape probe reads it: its
        ``audio_lens``, else its ``audio_shape``'s first, else its audio's."""
        from conette_torch.data.datamodule import _item_audio_len

        return np.asarray([_item_audio_len(self.ds, i) for i in range(len(self.ds))], np.int64)


class _PackRows(_ItemRows):
    """An HDF pack whose audio rows are contiguous float32 rows of one
    width: shapes, lengths and the small columns read once, each row's audio
    read straight into the batch."""

    route = "gather"

    def __init__(self, ds: HDFDataset, audio: Any, shapes: np.ndarray, lens: np.ndarray | None) -> None:
        super().__init__(ds)
        self.audio, self.shapes, self.lens = audio, shapes, lens
        self.row_shape = tuple(audio.shape[1:])
        self._columns: dict[str, list] = {}

    @classmethod
    def of(cls, ds: HDFDataset) -> "_PackRows | None":
        """The reader of ``ds``, or None where its rows are not whole
        contiguous float32 rows (they are then read as items)."""
        f, names = ds._file, ds.column_names
        if "audio" not in names or "audio" not in f:
            return None
        audio = f["audio"]
        if audio.dtype != np.dtype("<f4") or len(audio.shape) < 2 or audio.shape[0] < len(ds):
            return None
        row_shape = np.asarray(audio.shape[1:], np.int64)
        if "audio_shape" in f and not ds._keep_padding:
            shapes = np.asarray(f["audio_shape"][:])
            if (shapes.dtype.kind not in "iu" or shapes.shape != (audio.shape[0], len(row_shape))
                    or (shapes < 0).any()):
                return None
            shapes = np.minimum(shapes.astype(np.int64), row_shape)
            if not (shapes[:, 1:] == row_shape[1:]).all():
                return None
        else:
            shapes = np.broadcast_to(row_shape, (audio.shape[0], len(row_shape)))
        lens = None
        if "audio_lens" in names:
            if "audio_lens" not in f or "audio_lens_shape" in f:
                return None
            col = f["audio_lens"]
            if np.dtype(col.dtype).kind not in "iuf" or len(col.shape) != 1:
                return None
            lens = np.asarray(col[:]).astype(np.int64)
        return cls(ds, audio, shapes, lens)

    def _column(self, key: str) -> list:
        got = self._columns.get(key)
        if got is None:
            got = self._columns[key] = self.ds.column(key)
        return got

    def part(self, rows: np.ndarray, pos: np.ndarray, allowed: set | None) -> _Part:
        n = len(self.ds)
        rows = np.where(rows < 0, rows + n, rows)
        if len(rows) and not (0 <= rows.min() and rows.max() < n):
            raise IndexError(f"row out of range for {n} rows")
        names = self.ds.column_names

        def col(key: str, default: Any) -> list:
            if key not in names or (allowed is not None and key not in allowed):
                return [default] * len(rows)
            values = self._column(key)
            return [values[r] for r in rows.tolist()]

        if "captions" not in names or (allowed is not None and "captions" not in allowed):
            raise KeyError("captions")
        lens = (self.lens[rows].tolist() if self.lens is not None and (allowed is None or "audio_lens" in allowed)
                else [None] * len(rows))
        return _Part(self, rows, pos, self.shapes[rows], None, lens, col("captions", None),
                     col("dataset", "unknown"), col("source", None))

    def arrays(self, rows: np.ndarray) -> list:
        """The rows' audio as items: ``ds.at(row, "audio")``."""
        return [np.asarray(self.ds.at(r, "audio"), np.float32) for r in rows.tolist()]

    def stored_lens(self) -> np.ndarray:
        f = self.ds._file
        if "audio_lens" in f:
            if self.lens is not None:
                return self.lens
            return super().stored_lens()
        if "audio_shape" in f:
            return np.asarray(f["audio_shape"][:])[:, 0].astype(np.int64)
        return self.shapes[:, 0]

    def read_into(self, rows: list, frames: list, out: np.ndarray, pos: list, pad: float) -> None:
        """Each row's first ``frames`` frames straight into ``out[pos]``, its
        tail past them filled with ``pad``."""
        frame = int(np.prod(out.shape[2:], dtype=np.int64))
        row_bytes = frame * out.shape[1] * out.itemsize
        self.audio.read_rows_into(rows, [n * frame for n in frames], memoryview(out).cast("B"),
                                  [p * row_bytes for p in pos])
        for p, n in zip(pos, frames):
            if n < out.shape[1]:
                out[p, n:] = pad


class Rows(NamedTuple):
    """A batch's rows once read: its audio, their lengths and tokens."""

    route: str
    audio: np.ndarray
    shapes: np.ndarray
    lens: np.ndarray
    tokens: list
    dataset: list
    source: list


class BatchGather:
    """Builds the training batches of one ``HDFDataModule``: ``read`` then
    ``collate``, between which ``train_batches`` puts its spans."""

    def __init__(self, dm: Any, datasets: list = ()) -> None:
        self.dm = dm
        self._leaves: dict[int, _ItemRows] = {}
        self._tokens: dict[str, np.ndarray] = {}
        self._token_key: tuple = ()
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        # preadv runs without the GIL: a few threads, leaving the rest of
        # the process's CPUs to the step's issue and the prefetch thread
        self.workers = max(1, min(4, len(os.sched_getaffinity(0)) // 2))
        import torch

        self.pin = torch.cuda.is_available()
        for ds in datasets:
            self.leaf(ds)

    def leaf(self, ds: Any) -> _ItemRows:
        got = self._leaves.get(id(ds))
        if got is None or got.ds is not ds:
            got = (_PackRows.of(ds) if type(ds) is HDFDataset else None) or _ItemRows(ds)
            self._leaves[id(ds)] = got
        return got

    def empty(self, shape: tuple, dtype: Any) -> np.ndarray:
        """A new array, the view of a new pinned tensor where a card is
        present (torch's caching host allocator recycles the blocks)."""
        if self.pin:
            import torch

            try:
                t_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
            except TypeError:
                return np.empty(shape, dtype)
            return torch.empty(shape, dtype=t_dtype, pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def _resolve(self, ds: Any, idx: np.ndarray, pos: np.ndarray, allowed: set | None, out: list) -> None:
        kind = type(ds)
        if kind in _INDEXED:
            index = ds._indexes
            if isinstance(index, np.ndarray):
                mapped = index[idx].astype(np.int64)
            else:
                mapped = np.fromiter((index[i] for i in idx.tolist()), np.int64, len(idx))
            self._resolve(ds._source, mapped, pos, allowed, out)
        elif kind is AACConcat:
            allowed = set(ds._columns) if allowed is None else allowed & set(ds._columns)
            idx = np.where(idx < 0, idx + len(ds), idx)
            src = np.searchsorted(ds._offsets, idx, side="right") - 1
            for s in np.unique(src).tolist():
                m = src == s
                self._resolve(ds._sources[s], idx[m] - int(ds._offsets[s]), pos[m], allowed, out)
        else:
            out.append(self.leaf(ds).part(idx, pos, allowed))

    def read(self, train: Any, idxs: np.ndarray, epoch: int, collate: CollateDict) -> Rows:
        """The rows ``idxs`` of ``train``: their audio in one padded array,
        their lengths, and the tokens of the caption each draws."""
        n = len(idxs)
        idxs = np.asarray(idxs, np.int64)
        parts: list[_Part] = []
        self._resolve(train, idxs, np.arange(n), None, parts)
        lens, refs, dataset, source, arrays = ([None] * n for _ in range(5))
        for part in parts:
            pos = part.pos.tolist()
            for store, values in ((lens, part.lens), (refs, part.refs), (dataset, part.dataset),
                                  (source, part.source), (arrays, part.arrays)):
                if values is not None:
                    for p, v in zip(pos, values):
                        store[p] = v
        transform = self.dm.audio_transform
        if transform is not None:  # applied row by row, in the batch's order
            for part in parts:
                if part.arrays is None:
                    for p, a in zip(part.pos.tolist(), part.leaf.arrays(part.rows)):
                        arrays[p] = a
            arrays = [np.asarray(transform(a)) for a in arrays]
        packs = [part for part in parts if part.arrays is None and transform is None]
        shapes = np.empty((n, packs[0].shapes.shape[1] if packs else arrays[0].ndim), np.int64)
        for part in packs:
            shapes[part.pos] = part.shapes
        for p, a in enumerate(arrays):
            if a is not None:
                shapes[p] = a.shape
        size = shapes.max(axis=0)
        if len(size) >= 2:
            size[0] = max(size[0], collate.min_first_axes.get("audio", 0))
        pad = collate.pad_values.get("audio", 0)
        audio = self.empty((n, *size.tolist()), np.float32 if transform is None else arrays[0].dtype)
        gathered = len(packs) == len(parts)
        for part in packs:
            if tuple(size[1:].tolist()) == part.leaf.row_shape[1:]:
                self._read_pack(part, audio, pad)
            else:  # another dataset's rows are wider: copied in
                gathered = False
                for p, a in zip(part.pos.tolist(), part.leaf.arrays(part.rows)):
                    arrays[p] = a
        for p, a in enumerate(arrays):
            if a is None:
                continue
            if a.shape[1:] == audio.shape[2:]:
                audio[p, :a.shape[0]] = a
                audio[p, a.shape[0]:] = pad
            else:
                audio[p] = pad
                audio[(p,) + tuple(slice(0, s) for s in a.shape)] = a
        audio_lens = self.empty((n,), np.int32)
        audio_lens[:] = [shapes[p, 0] if v is None else int(v) for p, v in enumerate(lens)]
        return Rows("gather" if gathered else "items", audio, shapes, audio_lens,
                    self._caption_tokens(idxs, refs, epoch), dataset, source)

    def _read_pack(self, part: _Part, audio: np.ndarray, pad: float) -> None:
        rows, frames, pos = part.rows.tolist(), part.shapes[:, 0].tolist(), part.pos.tolist()
        k = len(rows)
        if self.workers == 1 or k <= self.workers:
            part.leaf.read_into(rows, frames, audio, pos, pad)
            return
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(self.workers, thread_name_prefix="pack_read")
            weakref.finalize(self, self._pool.shutdown, wait=False)
        bounds = np.linspace(0, k, self.workers + 1).astype(int).tolist()
        jobs = [self._pool.submit(part.leaf.read_into, rows[a:b], frames[a:b], audio, pos[a:b], pad)
                for a, b in zip(bounds[:-1], bounds[1:])]
        errors = [job.exception() for job in jobs]
        for err in errors:
            if err is not None:
                raise err

    def _caption_tokens(self, idxs: np.ndarray, refs: list, epoch: int) -> list:
        """Each row's caption tokens: a random 1-of-R reference derived from
        (seed, epoch, idx), as the JAX package's ``_train_item`` draws it,
        its tokens from the memo (a first use encodes it, and raises on a
        word out of the vocabulary)."""
        dm = self.dm
        tok, max_len, seed = dm.tokenizer, dm.caption_max_len, dm.seed
        key = (id(tok), tok.get_vocab_size(), max_len)
        if key != self._token_key:
            self._tokens.clear()
            self._token_key = key
        listed = [i for i, r in enumerate(refs) if isinstance(r, list)]
        drawn = reference_draws(seed, epoch, idxs[listed], [len(refs[i]) for i in listed])
        picks = dict(zip(listed, drawn.tolist()))
        memo, hits, out = self._tokens, 0, []
        for i, r in enumerate(refs):
            if isinstance(r, list):
                r = r[picks[i]]
            got = memo.get(r) if type(r) is str else None
            if got is None:
                got = tok.encode_single(r, add_bos_eos=True)[:max_len].astype(np.int32)
                if type(r) is str:
                    memo[r] = got
            else:
                hits += 1
            out.append(got)
        count("caption_memo_hits", hits)
        return out

    def collate(self, rows: Rows, collate: CollateDict) -> dict[str, Any]:
        """The batch of ``rows`` as ``CollateDict`` stacks the items, before
        ``_postprocess``."""
        n = len(rows.tokens)
        lengths = np.asarray([len(t) for t in rows.tokens], np.int64)
        width = max(round_up(int(lengths.max()), collate.length_quantums.get("captions", 1)),
                    collate.min_lengths.get("captions", 0))
        captions = self.empty((n, width), np.int32)
        captions[:] = collate.pad_values.get("captions", 0)
        captions[np.arange(width) < lengths[:, None]] = np.concatenate(rows.tokens)
        audio_shape = self.empty(rows.shapes.shape, np.int64)
        audio_shape[:] = rows.shapes
        captions_shape = self.empty((n, 1), np.int64)
        captions_shape[:, 0] = lengths
        return {"audio": rows.audio, "audio_shape": audio_shape, "audio_lens": rows.lens,
                "captions": captions, "captions_shape": captions_shape,
                "dataset": _values(rows.dataset), "source": _values(rows.source)}
