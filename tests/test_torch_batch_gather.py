"""The port's training batches, gathered from the packs in one pass
(``conette_torch/data/gather.py``), against the JAX package's
``HDFDataModule.train_batches``, which reads each item, collates the items
and post-processes the batch: every key, in the same order, with the same
dtype, shape and values, batch for batch over three epochs. Over one pack,
a pack that h5py wrote, ``AACConcat`` of two packs, each balance mode
(``main_hdf_duplicate``, ``main_hdf_min`` with its ``WrapperSampler`` drawn
again each epoch, ``main_hdf_balanced``), two processes at ranks 0 and 1,
``fixed_shapes``, a ``DictDataset`` train set (without ``audio_lens`` and
``source``), a set ``audio_transform``, a pack whose padding holds non-zero
values and a pack without ``audio_shape``, with rows read on pools of 1 to
16 reader threads; and a train caption with a word out of the vocabulary
raises in both. The references' draws, computed for a batch at once,
against numpy's ``default_rng((seed, epoch, idx))`` row by row."""

import json
import sys

import numpy as np
import pytest

from conette_tpu.data.datamodule import HDFDataModule as JaxDataModule
from conette_tpu.data.datasets import DictDataset as JaxDictDataset
from conette_tpu.data.datasets import DummyAACDataset as JaxDummy
from conette_tpu.data.hdf import pack_to_hdf as jax_pack_to_hdf
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
from conette_torch.data import hdf5
from conette_torch.data.datamodule import HDFDataModule
from conette_torch.data.datasets import DictDataset, DummyAACDataset
from conette_torch.data.gather import reference_draws
from conette_torch.data.hdf import pack_to_hdf
from conette_torch.tokenization import AACTokenizer
from conette_torch.utils import profiling

EPOCHS = 3


def _pack(tmp_path, name, size, seed, frames=31, writer=pack_to_hdf):
    fpath = str(tmp_path / f"{name}_train_x.hdf")
    writer(DummyAACDataset(size=size, seed=seed, dataset_name=name, audio_frames=frames, feat=12), fpath)
    return fpath


def _raw_pack(fpath, size, seed, *, pad_value=7.5, with_shape=True, name="clotho", width=6,
              columns=("audio", "audio_lens", "captions", "dataset", "source")):
    """A pack written through ``data/hdf5.File``: rows of 3–11 frames of
    ``width`` features, its padding ``pad_value``, with or without
    ``audio_shape``, its ``audio_lens`` one less than its length."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 12, size)
    audio = np.full((size, 11, width), pad_value, np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rng.standard_normal((n, width))
    words = ["a", "dog", "barks", "rain", "falls", "wind", "blows"]
    caps = [[" ".join(rng.choice(words, rng.integers(2, 6))) for _ in range(3)] for _ in range(size)]
    with hdf5.File(fpath, "w") as f:
        f.attrs["num_rows"] = size
        f.attrs["columns"] = json.dumps(list(columns))
        f.create_dataset("audio", data=audio)
        if with_shape:
            f.create_dataset("audio_shape", data=np.stack([lens, np.full(size, width)], 1).astype(np.int64))
        f.create_dataset("audio_lens", data=lens.astype(np.int64) - 1)
        for col, values in (("captions", caps), ("dataset", [name] * size), ("source", ["src"] * size)):
            f.create_dataset(col, data=np.array([json.dumps(v).encode() for v in values], dtype=object),
                             dtype=hdf5.string_dtype())
    return fpath


def _modules(fpaths, **kw):
    """The port's and the JAX package's data modules, set up alike."""
    out = []
    for cls, tok in ((HDFDataModule, AACTokenizer), (JaxDataModule, JaxTokenizer)):
        dm = cls(tok(), list(fpaths), **kw)
        dm.setup_fit()
        out.append(dm)
    return out


def _assert_same(port, jax_dm, epochs=EPOCHS):
    n = 0
    for epoch in range(epochs):
        got, want = list(port.train_batches(epoch)), list(jax_dm.train_batches(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert isinstance(g[k], np.ndarray) and g[k].dtype == w[k].dtype, k
                    assert g[k].shape == w[k].shape and np.array_equal(g[k], w[k]), k
                else:
                    assert g[k] == w[k], k
            n += 1
    return n


def _task(item):
    return {"clotho": 5, "wavcaps": 6}.get(item["dataset"], 1)


def test_one_pack_three_epochs(tmp_path):
    port, ref = _modules([_pack(tmp_path, "clotho", 14, 0)], bsize=4, seed=3, task_token_fn=_task)
    profiling.clear()
    assert _assert_same(port, ref) == 9
    reads = [r for r in profiling.records() if r.name == "read_items"]
    assert [r.attrs for r in reads] == [{"route": "gather", "rows": 4}] * 9
    assert profiling.summary()["counters"]["caption_memo_hits"] > 0


@pytest.mark.parametrize("workers", [1, 3, 16])
def test_the_reader_pool(tmp_path, workers):
    """Rows read on a pool of 1, 3 and 16 threads (more than the CPUs),
    threads switched every 10 µs, each filling its rows of one buffer."""
    port, ref = _modules([_pack(tmp_path, "clotho", 60, 4)], bsize=24, seed=7)
    port._gather.workers = workers
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert _assert_same(port, ref, epochs=4) == 8
    finally:
        sys.setswitchinterval(interval)
    assert (port._gather._pool is None) == (workers == 1)


def test_a_pack_that_h5py_wrote(tmp_path):
    port, ref = _modules([_pack(tmp_path, "clotho", 10, 1, writer=jax_pack_to_hdf)], bsize=3, seed=0)
    _assert_same(port, ref)


def test_concat_of_two_packs(tmp_path):
    a = _pack(tmp_path, "clotho", 7, 0, frames=20)
    b = _pack(tmp_path, "wavcaps", 9, 1, frames=31)
    port, ref = _modules([a, b], bsize=5, seed=1, task_token_fn=_task)
    _assert_same(port, ref)


@pytest.mark.parametrize("width", [6, 8])
def test_concat_of_packs_with_other_columns(tmp_path, width):
    """The concatenation's columns are those both packs hold: here no
    ``audio_lens`` and no ``source``, so a row's length is its audio's. Rows
    of a narrower pack, padded to the wider's features, are copied in."""
    a = _raw_pack(str(tmp_path / "clotho_train_x.hdf"), 9, 2, columns=("audio", "captions", "dataset"))
    b = _raw_pack(str(tmp_path / "wavcaps_train_x.hdf"), 7, 3, name="wavcaps", width=width)
    port, ref = _modules([a, b], bsize=4, seed=9, task_token_fn=_task)
    profiling.clear()
    _assert_same(port, ref)
    routes = {r.attrs["route"] for r in profiling.records() if r.name == "read_items"}
    assert routes == {"gather"} if width == 6 else "items" in routes


@pytest.mark.parametrize("mode", ["main_hdf_duplicate", "main_hdf_min", "main_hdf_balanced"])
def test_balance_modes(tmp_path, mode):
    main = _pack(tmp_path, "clotho", 5, 0)
    added = [_pack(tmp_path, "wavcaps", 13, 1), _pack(tmp_path, "audiocaps", 8, 2)]
    key = {"main_hdf_balanced": ["clotho_train_x.hdf"]}.get(mode, "clotho_train_x.hdf")
    port, ref = _modules([main, *added], bsize=4, seed=2, reload_every_n_epochs=1, task_token_fn=_task,
                         **{mode: key})
    assert len(port.train_dataset) == len(ref.train_dataset)
    _assert_same(port, ref)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_processes(tmp_path, rank):
    fpath = _pack(tmp_path, "clotho", 19, 0)
    port, ref = _modules([fpath], bsize=3, seed=4, process_rank=rank, process_count=2)
    assert port._audio_pad_to == ref._audio_pad_to
    _assert_same(port, ref)


def test_fixed_shapes(tmp_path):
    port, ref = _modules([_pack(tmp_path, "clotho", 11, 0), _pack(tmp_path, "wavcaps", 6, 3, frames=40)],
                         bsize=4, seed=0, fixed_shapes=True)
    assert port._audio_pad_to == ref._audio_pad_to > 0
    _assert_same(port, ref)


def test_a_dict_dataset_train_set(tmp_path):
    port, ref = _modules([_pack(tmp_path, "clotho", 12, 0)], bsize=4, seed=5, task_token_fn=_task)
    for dm, dummy, dict_ds in ((port, DummyAACDataset, DictDataset), (ref, JaxDummy, JaxDictDataset)):
        data = dummy(size=10, seed=7, dataset_name="clotho", audio_frames=17, feat=12)._data
        dm._train = dict_ds({k: v for k, v in data.items() if k not in ("audio_lens", "source")})
    profiling.clear()
    _assert_same(port, ref)
    assert {r.attrs["route"] for r in profiling.records() if r.name == "read_items"} == {"items"}


def test_an_audio_transform(tmp_path):
    port, ref = _modules([_pack(tmp_path, "clotho", 12, 0)], bsize=4, seed=6)

    def transform(a):  # changes the length and the dtype
        return (np.concatenate([a, a[:1]])[::2] * 2).astype(np.float64)

    port.audio_transform = ref.audio_transform = transform
    _assert_same(port, ref)


@pytest.mark.parametrize("with_shape", [True, False], ids=["audio_shape", "no_audio_shape"])
def test_a_pack_with_non_zero_padding(tmp_path, with_shape):
    fpath = _raw_pack(str(tmp_path / "clotho_train_x.hdf"), 13, 0, with_shape=with_shape)
    port, ref = _modules([fpath], bsize=4, seed=8)
    _assert_same(port, ref)
    batch = next(port.train_batches(0))
    if with_shape:  # each row's tail past its length is zero, whatever the pack held there
        for row, n in zip(batch["audio"], batch["audio_shape"][:, 0]):
            assert not row[n:].any() and (row[:n] != 7.5).all()
    else:  # no shapes stored: each row whole, padding and all
        assert (batch["audio"] == 7.5).any()


def test_an_out_of_vocabulary_train_caption_raises(tmp_path):
    fpath = _raw_pack(str(tmp_path / "clotho_train_x.hdf"), 8, 1)
    errors = []
    for cls, tok in ((HDFDataModule, AACTokenizer), (JaxDataModule, JaxTokenizer)):
        t = tok()
        t.fit(["a dog barks"])  # fit already: setup_fit does not refit on the pack
        dm = cls(t, [fpath], bsize=4, seed=0)
        dm.setup_fit()
        with pytest.raises(ValueError) as err:
            next(dm.train_batches(0))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", [0, 1234, 2**31 + 5, 2**32 + 7, 2**70 + 11])
@pytest.mark.parametrize("epoch", [0, 5, 2**33])
def test_reference_draws_are_numpys(seed, epoch):
    """Every row as ``int(np.random.default_rng((seed, epoch, idx)).integers(count))``,
    with counts where Lemire's method often rejects its first draw."""
    rng = np.random.default_rng(seed % 97 + epoch % 89)
    idxs = np.concatenate([np.arange(40), rng.integers(0, 2**32, 300)])
    counts = rng.choice([1, 2, 5, 7, 2**31 + 1, 3 * 2**30, 2**32 - 1], len(idxs))
    want = [int(np.random.default_rng((seed, epoch, int(i))).integers(int(c))) for i, c in zip(idxs, counts)]
    assert reference_draws(seed, epoch, idxs, counts).tolist() == want


def test_reference_draws_outside_the_hash_are_numpys():
    want = [int(np.random.default_rng((3, 1, 2**40)).integers(5)),
            int(np.random.default_rng((3, 1, 5)).integers(2**33))]
    assert reference_draws(3, 1, np.asarray([2**40, 5]), np.asarray([5, 2**33])).tolist() == want
    with pytest.raises(ValueError):
        reference_draws(-1, 0, np.arange(3), np.full(3, 5))
