"""HDFDataModule — the training input pipeline.

Capability twin of the reference ``HDFDataModule``
(``src/conette/datamodules/hdf.py:43-457``):

- loads lists of packed HDF files per split and concatenates them;
- dataset-balancing modes ``main_hdf_duplicate`` / ``main_hdf_min`` /
  ``main_hdf_balanced`` with ``n_added_data`` (``hdf.py:234-319``), the
  added data re-subsampled per epoch (``WrapperSampler`` reshuffled in
  ``train_dataloader``, ``hdf.py:180-187``);
- fits the train tokenizer on all train captions when not already fit
  (``hdf.py:328-330``);
- train items pick one random reference (unpadded), val/test items carry
  all references padded per batch + raw ``mult_references``
  (``OnlineEncodeCaptionsTransform``, ``datamodules/common.py:76-156``);
- the first caption token is rewritten to the ``<bos_task>`` id by the
  batch post-processor (parity with ``on_after_batch_transfer``,
  ``pl_modules/conette.py:527-550``).

TPU-first: batches are host-prefetched numpy with bucketed static shapes.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from conette_torch.data.collate import CollateDict
from conette_torch.data.datasets import (
    AACConcat,
    AACDatasetLike,
    AACDuplicate,
    WrapperSampler,
)
from conette_torch.data.gather import BatchGather
from conette_torch.data.hdf import HDFDataset
from conette_torch.tokenization import AACTokenizer
from conette_torch.utils.profiling import span

pylog = logging.getLogger(__name__)

BALANCE_MODES = ("none", "main_hdf_duplicate", "main_hdf_min", "main_hdf_balanced")


def _item_audio_len(ds: AACDatasetLike, i: int) -> int:
    """True audio time length of one item WITHOUT reading the audio bytes
    when a length/shape column exists."""
    try:
        return int(ds.at(i, "audio_lens"))
    except Exception:
        pass
    try:
        return int(np.asarray(ds.at(i, "audio_shape"))[0])
    except Exception:
        return int(np.asarray(ds.at(i, "audio")).shape[0])


class HDFDataModule:
    def __init__(
        self,
        tokenizer: AACTokenizer,
        train_fpaths: Sequence[str] = (),
        val_fpaths: Sequence[str] = (),
        test_fpaths: Sequence[str] = (),
        predict_fpaths: Sequence[str] = (),
        *,
        bsize: int = 512,
        main_hdf_pattern: str | None = None,
        balance_mode: str = "none",
        main_hdf_duplicate: str | None = None,
        main_hdf_min: str | None = None,
        main_hdf_balanced: Sequence[str] | None = None,
        n_added_data: int | None = None,
        reload_every_n_epochs: int = 0,
        caption_quantum: int = 4,
        caption_max_len: int = 64,
        seed: int = 1234,
        task_token_fn: Callable[[dict], int] | None = None,
        audio_transform: Callable[[np.ndarray], np.ndarray] | None = None,
        process_rank: int = 0,
        process_count: int = 1,
        fixed_shapes: bool = False,
    ) -> None:
        if balance_mode not in BALANCE_MODES:
            raise ValueError(f"Invalid {balance_mode=}. (expected {BALANCE_MODES})")
        # reference-style mode keys (conf/dm/hdf.yaml:21-24): the key that
        # is set both names the main HDF(s) and selects the mode, like the
        # if/elif chain in the reference's HDFDataModule._setup_fit
        # (datamodules/hdf.py:234-319). They take precedence over the
        # legacy (balance_mode, main_hdf_pattern) pair.
        set_modes = [
            m
            for m, v in (
                ("main_hdf_duplicate", main_hdf_duplicate),
                ("main_hdf_min", main_hdf_min),
                ("main_hdf_balanced", main_hdf_balanced),
            )
            if v
        ]
        if len(set_modes) > 1:
            raise ValueError(
                f"At most one of main_hdf_duplicate/min/balanced may be set "
                f"(found {set_modes})"
            )
        if set_modes:
            balance_mode = set_modes[0]
            if balance_mode == "main_hdf_balanced":
                main_hdf_names = [str(x) for x in main_hdf_balanced or ()]
            else:
                main_hdf_names = [str(main_hdf_duplicate or main_hdf_min)]
        else:
            main_hdf_names = []
        self.main_hdf_names = main_hdf_names
        self.tokenizer = tokenizer
        self.train_fpaths = list(train_fpaths)
        self.val_fpaths = list(val_fpaths)
        self.test_fpaths = list(test_fpaths)
        self.predict_fpaths = list(predict_fpaths)
        self.bsize = bsize
        self.main_hdf_pattern = main_hdf_pattern
        self.balance_mode = balance_mode
        self.n_added_data = n_added_data
        self.reload_every_n_epochs = int(reload_every_n_epochs)
        self.caption_quantum = caption_quantum
        self.caption_max_len = caption_max_len
        self.seed = seed
        if not (0 <= process_rank < process_count):
            raise ValueError(f"Invalid {process_rank=} for {process_count=}")
        self.process_rank = process_rank
        self.process_count = process_count
        # fixed global pad shapes: mandatory under multi-host (every
        # process must collate the same global shapes), opt-in otherwise
        # (one compiled train-step shape instead of one per batch-max)
        self.fixed_shapes = fixed_shapes or process_count > 1
        self.task_token_fn = task_token_fn
        self.audio_transform = audio_transform

        self._train: AACDatasetLike | None = None
        self._val: list[HDFDataset] = []
        self._test: list[HDFDataset] = []
        self._predict: list[HDFDataset] = []
        self._samplers: list[WrapperSampler] = []

    # ------------------------------------------------------------- setup
    def setup_fit(self) -> None:
        datasets = [HDFDataset(p) for p in self.train_fpaths]
        if not datasets:
            raise ValueError("No train HDF files provided")

        # main selection: exact basename match on the reference-style mode
        # keys (the reference indexes hp.train_hdfs by filename,
        # datamodules/hdf.py:235,250,274-277); legacy substring pattern
        # kept as fallback.
        import os.path as osp

        main_order: list[int] = []
        if self.main_hdf_names:
            names = [osp.basename(ds.fpath) for ds in datasets]
            missing = [n for n in self.main_hdf_names if n not in names]
            if missing:
                raise ValueError(
                    f"main HDF name(s) {missing} not in train_hdfs {names}"
                )
            # the reference resolves each main via train_hdfs.index(name)
            # (hdf.py:235,250,277): FIRST occurrence only (a second listing
            # of the same file counts as added data), and — for balanced —
            # mains keep the main_hdf_balanced LIST order, not train order
            main_order = [names.index(n) for n in self.main_hdf_names]
            is_main = [i in main_order for i in range(len(datasets))]
        else:
            is_main = [
                self.main_hdf_pattern is not None
                and self.main_hdf_pattern in ds.fpath
                for ds in datasets
            ]
            main_order = [i for i, m in enumerate(is_main) if m]
        if self.balance_mode == "none" or not any(is_main):
            if self.balance_mode != "none" and not any(is_main):
                pylog.warning(
                    f"balance_mode={self.balance_mode} set but no train HDF "
                    f"matches main_hdf_pattern={self.main_hdf_pattern!r}; "
                    "training UNBALANCED"
                )
            train: AACDatasetLike = (
                datasets[0] if len(datasets) == 1 else AACConcat(*datasets)
            )
        else:
            # mains in main_hdf_balanced LIST order (reference hdf.py:277
            # builds tgt_dsets by iterating main_hdf_balanced, not
            # train_hdfs — the shipped for_ac recipe lists them reversed)
            mains = [datasets[i] for i in main_order]
            added = [
                d for i, d in enumerate(datasets) if i not in main_order
            ]
            if not added:
                raise ValueError(
                    f"balance mode {self.balance_mode!r} needs at least one "
                    f"non-main train HDF (all {len(datasets)} train_hdfs are "
                    "main)"
                )
            pooled = added[0] if len(added) == 1 else AACConcat(*added)
            parts: list[AACDatasetLike]
            if self.balance_mode == "main_hdf_duplicate":
                # reference hdf.py:234-248: duplicate the main dataset IN
                # PLACE up to the sum of the others (only if smaller);
                # others kept whole, original dataset order preserved
                main = mains[0] if len(mains) == 1 else AACConcat(*mains)
                other_sum = sum(len(d) for d in added)
                if len(main) < other_sum:
                    main = AACDuplicate(main, other_sum)
                first_main = main_order[0]
                parts = [
                    main if i == first_main else d
                    for i, d in enumerate(datasets)
                    if i == first_main or i not in main_order
                ]
            elif self.balance_mode == "main_hdf_min":
                # reference hdf.py:249-269: others POOLED into one concat,
                # then ONE sampler draws n_added_data (default len(main))
                # items from the pool — NOT len(main) from each
                main = mains[0] if len(mains) == 1 else AACConcat(*mains)
                n = (
                    self.n_added_data
                    if self.n_added_data is not None
                    else len(main)
                )
                sampler = WrapperSampler(pooled, min(n, len(pooled)), self.seed)
                self._samplers.append(sampler)
                parts = [main, sampler]
            else:  # main_hdf_balanced
                # reference hdf.py:271-311: each main stays a separate
                # part, others pooled; EVERY part is equalized to exactly
                # n = n_added_data or max(part sizes): duplicate if
                # smaller, subsample if bigger
                all_parts: list[AACDatasetLike] = [*mains, pooled]
                n = (
                    self.n_added_data
                    if self.n_added_data is not None
                    else max(len(p) for p in all_parts)
                )
                parts = []
                for k, p in enumerate(all_parts):
                    if len(p) == n:
                        parts.append(p)
                    elif len(p) < n:
                        parts.append(AACDuplicate(p, n))
                    else:
                        # per-part seed offset: equal-sized parts must not
                        # draw lockstep permutations (the reference uses
                        # independent unseeded generators, utils.py:329-343;
                        # we keep determinism but decorrelate)
                        sampler = WrapperSampler(p, n, self.seed + k)
                        self._samplers.append(sampler)
                        parts.append(sampler)
            train = AACConcat(*parts) if len(parts) > 1 else parts[0]
        self._train = train

        if not self.tokenizer.is_fit():
            # fit on ALL RAW train captions in train_hdfs order, NOT the
            # balanced view (reference hdf.py:224-231,330-332 collects
            # train_mrefs from the pre-balance dataset list): balancing
            # would change the vocab SET (a pool sampler surfaces only an
            # epoch-1 subset of e.g. WavCaps), the id ORDER (min mode puts
            # the main dataset first regardless of its train_hdfs slot)
            # and the counts (duplicated mains double their words).
            captions = []
            for ds in datasets:
                if hasattr(ds, "column"):
                    rows = ds.column("captions")  # one vectorized h5py read
                else:
                    rows = [ds.at(i, "captions") for i in range(len(ds))]
                for refs in rows:
                    captions.extend(refs if isinstance(refs, list) else [refs])
            self.tokenizer.fit(captions)
            pylog.info(
                f"Fit tokenizer on {len(captions)} captions "
                f"(vocab={self.tokenizer.get_vocab_size()})"
            )

        # multi-host: every process must collate identical global shapes
        # for jax.make_array_from_process_local_data, so the audio time
        # axis is floored to the train-set max (captions are floored to
        # caption_max_len in _collate). The probe runs over the RAW source
        # datasets, not the balanced view: WrapperSampler re-subsamples
        # every epoch, so any source item can appear later — the bound
        # must cover them all. Lengths come from the stored audio_lens /
        # audio_shape columns; reading full audio rows is the last resort.
        self._audio_pad_to = 0
        # the training batches' reader: each pack's lengths and small
        # columns read once, in one vectorised read each
        self._gather = BatchGather(self, datasets)
        if self.fixed_shapes:
            lens = [self._gather.leaf(ds).stored_lens() for ds in datasets]
            self._audio_pad_to = max((int(x.max()) for x in lens if len(x)), default=0)

        self._val = [HDFDataset(p) for p in self.val_fpaths]

    def setup_test(self) -> None:
        self._test = [HDFDataset(p) for p in self.test_fpaths]
        # predict corpora: caption-less datasets to decode + export only
        # (reference _setup_predict, hdf.py:419-457; e.g. clotho_test for
        # the DCASE submission)
        self._predict = [HDFDataset(p) for p in self.predict_fpaths]

    @property
    def train_dataset(self) -> AACDatasetLike:
        assert self._train is not None, "call setup_fit() first"
        return self._train

    # --------------------------------------------------------------- items
    def _eval_item(self, ds: AACDatasetLike, idx: int, subset: str) -> dict[str, Any]:
        item = ds[idx]
        raw = item.get("captions", [])
        refs = raw if isinstance(raw, list) else [raw]
        refs = [r for r in refs if r]
        if refs:
            # eval maps OOV to <unk> explicitly like the reference's
            # val/test transforms (hdf.py:339-349,386-396 pass
            # default=unk_token)
            encoded = self.tokenizer.encode_batch(
                refs, add_bos_eos=True, padding="batch",
                default=self.tokenizer.unk_token,
            )
            if isinstance(encoded, list):
                encoded, _ = _stack_ragged(encoded)
        else:
            # caption-less predict corpora (e.g. clotho_test): a single
            # <bos><eos> row keeps the batch schema (BOS is rewritten to
            # the task token by the batch post-processor)
            encoded = np.asarray(
                [[self.tokenizer.bos_token_id, self.tokenizer.eos_token_id]],
                np.int32,
            )
        audio = np.asarray(item["audio"], np.float32)
        return {
            "audio": audio,
            "audio_lens": int(item.get("audio_lens", audio.shape[0])),
            "mult_captions": encoded.astype(np.int32),
            "mult_references": refs,
            "dataset": item.get("dataset", "unknown"),
            "subset": item.get("subset") or subset,
            "source": item.get("source"),
            "fname": item.get("fname", str(idx)),
        }

    # ------------------------------------------------------------ batching
    def _collate(self) -> CollateDict:
        pad = self.tokenizer.pad_token_id if self.tokenizer.is_fit() else 0
        min_lengths: dict[str, int] = {}
        min_first_axes: dict[str, int] = {}
        if self.fixed_shapes:
            # fixed global shapes across processes (see setup_fit)
            min_lengths = {
                "captions": self.caption_max_len,
                "mult_captions": self.caption_max_len,
            }
            min_first_axes = {"audio": getattr(self, "_audio_pad_to", 0)}
        return CollateDict(
            pad_values={"captions": pad, "mult_captions": pad, "audio": 0.0},
            length_quantums={"captions": self.caption_quantum,
                             "mult_captions": self.caption_quantum},
            min_lengths=min_lengths,
            min_first_axes=min_first_axes,
        )

    def _postprocess(self, batch: dict[str, Any]) -> dict[str, Any]:
        """Rewrite first caption ids to task tokens + pack lens."""
        if batch.get("audio_lens") is None and "audio_shape" in batch:
            # audio_shape rows are (FEAT_SIZE, len) — the length is the LAST
            # column (preprocessor layout), not column 0 (= feature dim 768)
            batch["audio_lens"] = batch["audio_shape"][:, -1]
        batch["audio_lens"] = np.asarray(batch["audio_lens"], np.int32)
        if self.task_token_fn is not None:
            ids = np.asarray(
                [self.task_token_fn(
                    {"dataset": d, "source": s}
                ) for d, s in zip(batch["dataset"], batch["source"])],
                np.int32,
            )
            if "captions" in batch:
                batch["captions"][:, 0] = ids
            if "mult_captions" in batch:
                batch["mult_captions"][:, :, 0] = ids[:, None]
        return batch

    def train_batches(self, epoch: int = 0) -> Iterator[dict[str, Any]]:
        """Per-epoch shuffled local batches of ``bsize`` rows. Under
        multi-host training each process yields its contiguous slice of the
        global batch (``bsize × process_count`` rows): rank r takes rows
        [r·bsize, (r+1)·bsize) of every global batch — the DDP
        DistributedSampler twin, so the assembled global batch equals the
        single-process run's batch row-for-row (the per-epoch permutation
        is seed-deterministic and identical on all processes)."""
        assert self._train is not None, "call setup_fit() first"
        # samplers re-draw only when the reference would rebuild the
        # dataloader: trainer.reload_dataloaders_every_n_epochs (default 0
        # = keep the fit-start draw; the camw_* balancing recipes set 1 —
        # reference hdf.py:180-187 reset_indexes on each dataloader build)
        reload_n = self.reload_every_n_epochs
        if reload_n and epoch > 0 and epoch % reload_n == 0:
            for sampler in self._samplers:
                sampler.resample(epoch=epoch)
        collate = self._collate()
        order = np.random.default_rng(self.seed + epoch).permutation(len(self._train))
        global_bsize = self.bsize * self.process_count
        n_full = len(order) // global_bsize
        for b in range(n_full):
            start = b * global_bsize + self.process_rank * self.bsize
            idxs = order[start : start + self.bsize]
            # spans rooted at (epoch, the batch's index), as fit's for it;
            # the rows gathered in one pass (data/gather.py), the batch the
            # items collated would give
            with span("build_batch", root=(epoch, b)):
                with span("read_items") as read:
                    rows = self._gather.read(self._train, idxs, epoch, collate)
                    read.set(route=rows.route, rows=len(idxs))
                with span("collate"):
                    batch = self._postprocess(self._gather.collate(rows, collate))
            yield batch

    def eval_batches(
        self, split: str = "val", dl_idx: int = 0
    ) -> Iterator[dict[str, Any]]:
        ds_list = {
            "val": self._val, "test": self._test, "predict": self._predict
        }[split]
        ds = ds_list[dl_idx]
        collate = self._collate()
        for start in range(0, len(ds), self.bsize):
            idxs = range(start, min(start + self.bsize, len(ds)))
            items = [self._eval_item(ds, i, split) for i in idxs]
            batch = collate(items)
            batch["audio_lens"] = np.asarray(
                [it["audio_lens"] for it in items], np.int32
            )
            yield self._postprocess(batch)

    def num_eval_loaders(self, split: str = "val") -> int:
        return len(
            {
                "val": self._val,
                "test": self._test,
                "predict": self._predict,
            }[split]
        )


def _stack_ragged(arrays: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    max_len = max(a.shape[-1] for a in arrays)
    out = np.zeros((len(arrays), max_len), arrays[0].dtype)
    lens = np.zeros((len(arrays),), np.int64)
    for i, a in enumerate(arrays):
        out[i, : a.shape[-1]] = a
        lens[i] = a.shape[-1]
    return out, lens


class Prefetcher:
    """Background-thread batch prefetcher (the host-side analogue of the
    reference's DataLoader workers, ``datamodules/aac_dm.py:129-142``)."""

    def __init__(self, iterator: Iterator, depth: int = 4) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._thread = threading.Thread(
            target=self._fill, args=(iterator,), daemon=True
        )
        self._thread.start()

    def _fill(self, iterator: Iterator) -> None:
        try:
            for item in iterator:
                self._q.put(item)
        finally:
            self._q.put(self._sentinel)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is self._sentinel:
            raise StopIteration
        return item
