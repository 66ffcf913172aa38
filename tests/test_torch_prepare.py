"""``conette_torch.prepare`` against ``conette_tpu.prepare`` on the CPU:
the local corpus scan and filters, packing through the ConvNeXt frontend
into HDF (same file name, columns and captions; ``audio`` rows within
1e-4 of JAX's at f32, the ``debug_check`` tolerance), packs read across
the packages (JAX's ``HDFDataset`` over h5py, the port's over
``data/hdf5.py``), the CLI on ``--device cpu`` and the config mode with a
fake ``aac_datasets``, the checkpoint registries with a ``CONETTE_CKPT_DIR``
under ``tmp_path``, the preprocessor built from a seed, and ``info``.

The encoder is a narrow ConvNeXt (depths 1, widths 16…128) made by JAX's
``convnext_init`` and handed to both packages as one numpy tree."""

import ast
import csv
import os
import random
import sys
import types

import jax
import numpy as np
import pytest
import torch

from conette_tpu import prepare as jax_prepare
from conette_tpu.data.hdf import HDFDataset as JaxHDFDataset
from conette_tpu.models import registries as jax_registries
from conette_tpu.models.convnext import convnext_init as jax_convnext_init
from conette_torch import prepare
from conette_torch.data.hdf import HDFDataset
from conette_torch.huggingface.convert import flatten_pytree, save_params_npz
from conette_torch.models import registries
from conette_torch.utils.audio_io import save_wav
from conette_torch.utils.flac import save_flac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK_ATOL = 1e-4
COLUMNS = ("audio_lens", "captions", "dataset", "subset", "source", "fname")

# (file, seconds, sample rate, channels): a clip too short for the filter,
# WAV and FLAC, the corpus rates, mono and stereo
CLIPS = [("a.wav", 1.0, 32_000, 1), ("b.wav", 0.7, 44_100, 2), ("c.wav", 0.05, 32_000, 1),
         ("d.flac", 0.8, 44_100, 1), ("e.wav", 1.2, 48_000, 1), ("f.wav", 0.9, 32_000, 2)]


@pytest.fixture(scope="module")
def encoder():
    return jax.tree.map(np.asarray, jax_convnext_init(
        jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128)))


def write_corpus(root, clips) -> tuple[str, str]:
    audio_dir = os.path.join(root, "audio")
    os.makedirs(audio_dir, exist_ok=True)
    rows = []
    for i, (fname, secs, sr, ch) in enumerate(clips):
        x = (0.1 * np.random.default_rng(i).standard_normal((ch, int(sr * secs)))).astype(np.float32)
        (save_flac if fname.endswith(".flac") else save_wav)(os.path.join(audio_dir, fname),
                                                              x[0] if ch == 1 else x, sr)
        rows += [{"file_name": fname, "caption": f"sound number {i} ref {r}"} for r in range(2)]
    rows.append({"file_name": "missing.wav", "caption": "no audio for this row"})
    csv_path = os.path.join(root, "caps.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        w.writerows(rows)
    return audio_dir, csv_path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("raw")), CLIPS)


def assert_packs_equal(got_path, want_path, n):
    assert os.path.basename(got_path) == os.path.basename(want_path)
    got, want = HDFDataset(got_path), JaxHDFDataset(want_path)
    assert len(got) == len(want) == n
    for i in range(n):
        for c in COLUMNS:
            assert got.at(i, c) == want.at(i, c), (i, c)
        a, b = got.at(i, "audio"), want.at(i, "audio")
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (got.at(i, "audio_lens"), 128)
        np.testing.assert_allclose(a, b, atol=PACK_ATOL)
    # and across: JAX reads the port's pack, the port JAX's
    for i in range(n):
        np.testing.assert_array_equal(JaxHDFDataset(got_path).at(i, "audio"), got.at(i, "audio"))
        assert JaxHDFDataset(got_path).at(i, "captions") == got.at(i, "captions")
        np.testing.assert_array_equal(HDFDataset(want_path).at(i, "audio"), want.at(i, "audio"))


def test_scan_and_filter_match_jax(corpus):
    audio_dir, csv_path = corpus
    got = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev", "src")
    want = jax_prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev", "src")
    assert len(got) == len(want) == len(CLIPS)
    for c in ("captions", "dataset", "subset", "source", "fname"):
        assert [got.at(i, c) for i in range(len(got))] == [want.at(i, c) for i in range(len(want))]
    for kw in ({}, {"accepted_sample_rates": (32_000,)}, {"index_range": (1, 5)},
               {"min_duration_s": 0.75, "max_duration_s": 1.1}):
        assert prepare.filter_dataset(got, **kw) == jax_prepare.filter_dataset(want, **kw), kw
    assert prepare.filter_dataset(got) == [0, 1, 3, 4, 5]
    wav, sr = got.at(3, "audio")
    assert (sr, wav.shape) == (44_100, (1, int(0.8 * 44_100)))


def test_pack_matches_jax_and_reads_across_packages(corpus, encoder, tmp_path):
    audio_dir, csv_path = corpus
    got_ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    want_ds = jax_prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    keep = prepare.filter_dataset(got_ds)
    got = prepare.pack_dataset_to_hdf(got_ds, str(tmp_path / "torch"), encoder_params=encoder,
                                      indexes=keep, batch_size=2, debug_check=True, device="cpu")
    want = jax_prepare.pack_dataset_to_hdf(want_ds, str(tmp_path / "jax"), encoder_params=encoder,
                                           indexes=keep, batch_size=2)
    assert os.path.basename(got) == "clotho_dev_resample_mean_convnext_ident.hdf"
    assert_packs_equal(got, want, len(keep))
    with pytest.raises(FileExistsError):
        prepare.pack_dataset_to_hdf(got_ds, str(tmp_path / "torch"), encoder_params=encoder,
                                    indexes=keep, batch_size=2, device="cpu")


def test_debug_check_reencodes_the_item_in_its_packed_batch(encoder, tmp_path):
    """The check's item (``random.Random(0)``, here the 20 s clip) has 62
    frames alone in its 20 s bucket and 63 in the batch padded to 30 s by
    its 25 s neighbour: the check re-encodes it in that batch."""
    assert random.Random(0).randrange(2) == 1
    audio_dir, csv_path = write_corpus(str(tmp_path), [("a.wav", 25.0, 32_000, 1),
                                                       ("b.wav", 20.0, 32_000, 1)])
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "val")
    frontend = prepare.ConvNeXtFrontend(encoder, device="cpu")
    assert frontend(ds.at(1, "audio")).shape == (62, 128)
    fpath = prepare.pack_dataset_to_hdf(ds, str(tmp_path / "hdf"), encoder_params=encoder,
                                        batch_size=2, debug_check=True, device="cpu")
    assert [HDFDataset(fpath).at(i, "audio_lens") for i in range(2)] == [78, 63]


def test_main_prepare_cli_on_the_cpu_matches_jax(corpus, encoder, tmp_path):
    audio_dir, csv_path = corpus
    npz = str(tmp_path / "encoder.npz")
    save_params_npz(npz, encoder)
    args = ["--audio_dir", audio_dir, "--captions_csv", csv_path, "--dataset", "clotho",
            "--subset", "val", "--batch_size", "4", "--encoder", npz, "--overwrite"]
    assert prepare.main_prepare(args + ["--out_dir", str(tmp_path / "torch"), "--device", "cpu",
                                        "--debug"]) == 0
    assert jax_prepare.main_prepare(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    name = "clotho_val_resample_mean_convnext_ident.hdf"
    assert_packs_equal(str(tmp_path / "torch" / name), str(tmp_path / "jax" / name), 5)


def test_main_prepare_runs_on_the_card_by_default(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    audio_dir, csv_path = corpus
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare.main_prepare(["--audio_dir", audio_dir, "--captions_csv", csv_path,
                              "--out_dir", str(tmp_path)])


def test_main_prepare_requires_local_data():
    assert prepare.main_prepare([]) == 2 == jax_prepare.main_prepare([])


def reference_convnext_state(enc) -> dict[str, torch.Tensor]:
    """A ConvNeXt tree in the released checkpoint's layout (the converter's
    inverse, no prefix)."""
    def oihw(w):
        return np.transpose(w, (3, 2, 0, 1))

    s = {f"bn0.{k}": v for k, v in enc["bn0"].items()}
    s["downsample_layers.0.0.weight"] = oihw(enc["stem"]["conv"]["weight"])
    s["downsample_layers.0.0.bias"] = enc["stem"]["conv"]["bias"]
    s["downsample_layers.0.1.weight"] = enc["stem"]["norm"]["weight"]
    s["downsample_layers.0.1.bias"] = enc["stem"]["norm"]["bias"]
    for i, ds in enumerate(enc["downsample"], 1):
        s[f"downsample_layers.{i}.0.weight"] = ds["norm"]["weight"]
        s[f"downsample_layers.{i}.0.bias"] = ds["norm"]["bias"]
        s[f"downsample_layers.{i}.1.weight"] = oihw(ds["conv"]["weight"])
        s[f"downsample_layers.{i}.1.bias"] = ds["conv"]["bias"]
    for i, stage in enumerate(enc["stages"]):
        for j, blk in enumerate(stage):
            p = f"stages.{i}.{j}."
            s[p + "dwconv.weight"] = oihw(blk["dwconv"]["weight"])
            s[p + "dwconv.bias"] = blk["dwconv"]["bias"]
            s[p + "norm.weight"] = blk["norm"]["weight"]
            s[p + "norm.bias"] = blk["norm"]["bias"]
            for name in ("pwconv1", "pwconv2"):
                s[p + name + ".weight"] = blk[name]["weight"].T
                s[p + name + ".bias"] = blk[name]["bias"]
            s[p + "gamma"] = blk["scale"]
    s["norm.weight"] = enc["norm"]["weight"]
    s["norm.bias"] = enc["norm"]["bias"]
    s["head_audioset.weight"] = enc["head_audioset"]["weight"].T
    s["head_audioset.bias"] = enc["head_audioset"]["bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in s.items()}


@pytest.fixture()
def ckpt_dir(encoder, tmp_path, monkeypatch):
    d = tmp_path / "ckpts"
    d.mkdir()
    torch.save({"model": reference_convnext_state(encoder)},
               d / registries.CNEXT_REGISTRY["cnext_bl_75"].fname)
    monkeypatch.setenv("CONETTE_CKPT_DIR", str(d))
    return d


def test_load_registry_encoder_from_ckpt_dir(ckpt_dir, encoder):
    got = flatten_pytree(registries.load_registry_encoder("cnext_bl_75"))
    want = flatten_pytree(jax_registries.load_registry_encoder("cnext_bl_75"))
    assert got.keys() == want.keys() == flatten_pytree(encoder).keys()
    for k, v in flatten_pytree(encoder).items():
        assert got[k].tobytes() == want[k].tobytes() == v.tobytes(), k
    with pytest.raises(FileNotFoundError, match="CONETTE_CKPT_DIR"):
        registries.load_registry_encoder("cnext_nobl")
    with pytest.raises(KeyError, match="Unknown encoder"):
        registries.load_registry_encoder("cnext_huge")


@pytest.mark.parametrize("name", ["RegistryEntry", "CNEXT_REGISTRY", "PANN_REGISTRY",
                                  "resolve_checkpoint", "download_checkpoint"])
def test_registry_copies_hold_the_original_code(name):
    def node(path):
        with open(os.path.join(REPO, path)) as f:
            tree = ast.parse(f.read())
        for n in tree.body:
            names = [t.id for t in getattr(n, "targets", [getattr(n, "target", None)]) if t is not None
                     and hasattr(t, "id")] + [getattr(n, "name", None)]
            if name in names:
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and ast.get_docstring(n):
                    n.body.pop(0)
                return ast.dump(n)
        raise KeyError(name)

    assert node("conette_torch/models/registries.py") == node("conette_tpu/models/registries.py")


class FakeClotho:
    def __init__(self, root=None, subset=None, download=False, verbose=0, **kw):
        rng = np.random.default_rng(0)
        self._items = [{"audio": (0.1 * rng.standard_normal(32_000 // 4)).astype(np.float32),
                        "sr": 32_000, "captions": [f"caption {i} a", f"caption {i} b"],
                        "fname": f"clip_{i}.wav"} for i in range(3)]

    def __getitem__(self, idx):
        return self._items[idx]

    def __len__(self):
        return len(self._items)


def test_config_mode_with_fake_aac_datasets(monkeypatch, ckpt_dir, tmp_path):
    """``data=clotho data.download=true`` flows download → adapter → filter
    → pack, with the encoder from the registry's staged checkpoint, as in
    ``tests/test_prepare.py``; held against JAX's config mode."""
    fake = types.ModuleType("aac_datasets")
    fake.Clotho = FakeClotho
    monkeypatch.setitem(sys.modules, "aac_datasets", fake)
    argv = ["data=clotho", "data.download=true", "data.subsets=[dev]", "data.bsize=2", "debug=true"]
    assert prepare.main_prepare(argv + [f"out_root={tmp_path / 'torch'}", "device=cpu"]) == 0
    assert jax_prepare.main_prepare(argv[:-1] + [f"out_root={tmp_path / 'jax'}"]) == 0
    name = "clotho_dev_resample_mean_convnext_ident.hdf"
    assert os.listdir(tmp_path / "torch") == [name]
    assert_packs_equal(str(tmp_path / "torch" / name), str(tmp_path / "jax" / name), 3)
    assert HDFDataset(str(tmp_path / "torch" / name)).at(0, "captions") == ["caption 0 a", "caption 0 b"]


def test_downloads_raise_with_the_staging_message_without_their_packages(monkeypatch):
    monkeypatch.setitem(sys.modules, "aac_datasets", None)
    monkeypatch.setitem(sys.modules, "aac_metrics", None)
    with pytest.raises(RuntimeError, match="aac-datasets"):
        prepare.download_dataset("clotho")
    with pytest.raises(ValueError, match="Unknown dataset"):
        prepare.download_dataset("esc50")
    with pytest.raises(RuntimeError, match="aac-metrics"):
        prepare.download_metric_resources()
    assert prepare.main_prepare(["data=clotho", "device=cpu"]) == 2


def test_preprocessor_builds_its_encoder_from_a_seed():
    from conette_torch.huggingface.preprocessor import CoNeTTEPreprocessor
    from conette_torch.models.convnext import convnext_init

    got = flatten_pytree({k: v for k, v in CoNeTTEPreprocessor(seed=3, device="cpu").params.items()
                          if k in ("stem", "head_audioset")})
    want = convnext_init(torch.Generator().manual_seed(3))
    want = flatten_pytree({k: want[k] for k in ("stem", "head_audioset")})
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_install_info_reports_the_port_stack(capsys):
    from conette_torch import info

    rows = info.get_install_info()
    assert rows["conette_torch"] and rows["torch"] == torch.__version__
    assert rows["cuda.devices"] == ("none" if not torch.cuda.is_available() else rows["cuda.devices"])
    assert "jax" not in rows
    assert info.print_install_info() == 0
    assert "torch.version.cuda" in capsys.readouterr().out


# ------------------------------------------------------------ Cnn frontends
PANN_CHANNELS = {"resample_mean_cnn14": (8, 8, 16, 16, 32, 32), "resample_mean_cnn10": (8, 8, 16, 16),
                 "resample_mean_cnn14_att": (8, 8, 16, 16, 32, 32)}


def pann_tree(audio_t: str) -> dict:
    """A toy Cnn tree of the frontend's structure, batch norms drawn."""
    from torch_fixtures import random_batch_norms
    from conette_torch.models import pann
    from conette_torch.weights import to_numpy

    params = pann.pann_init(torch.Generator().manual_seed(5), PANN_CHANNELS[audio_t],
                            att_head=audio_t.endswith("_att"))
    return random_batch_norms(to_numpy(params), np.random.default_rng(5))


def each_clip_alone(ds, indexes, tree) -> list[np.ndarray]:
    """Each file's mono 32 kHz signal from the native loader, through
    ``pann_apply`` alone: (T', C) a clip."""
    from conette_torch.models import pann
    from conette_torch.native import loader
    from conette_torch.weights import to_torch

    out = []
    for i in indexes:
        mono = loader.load_resample_mono(ds.path(i), 32_000)
        embs = pann.pann_apply(to_torch(tree), torch.from_numpy(mono[None]))["frame_embs"]
        out.append(embs[0].T.numpy())
    return out


def assert_rows_equal(fpath, want, width):
    got = HDFDataset(fpath)
    assert len(got) == len(want)
    for i, w in enumerate(want):
        a = got.at(i, "audio")
        assert a.shape == w.shape == (got.at(i, "audio_lens"), width), i
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-6 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("audio_t", sorted(PANN_CHANNELS))
def test_a_cnn_pack_holds_each_clip_alone(corpus, tmp_path, audio_t):
    """The masked batches (2 files a batch, of several lengths, rates and
    channel counts, FLAC among them) pack the rows the encoder gives each
    clip alone, in the dataset's order, under the frontend's file name."""
    audio_dir, csv_path = corpus
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    keep = prepare.filter_dataset(ds)
    tree = pann_tree(audio_t)
    fpath = prepare.pack_dataset_to_hdf(ds, str(tmp_path), audio_t_name=audio_t, encoder_params=tree,
                                        indexes=keep, batch_size=2, debug_check=True, device="cpu")
    assert os.path.basename(fpath) == f"clotho_dev_{audio_t}_ident.hdf"
    width = tree["fc1"]["weight"].shape[1] if audio_t.endswith("_att") else PANN_CHANNELS[audio_t][-1]
    assert_rows_equal(fpath, each_clip_alone(ds, keep, tree), width)
    packed = HDFDataset(fpath)
    assert [packed.at(i, "fname") for i in range(len(keep))] == [ds.at(i, "fname") for i in keep]
    assert [packed.at(i, "captions") for i in range(len(keep))] == [ds.at(i, "captions") for i in keep]


def test_get_frontend_gives_the_packed_row(corpus, tmp_path):
    """``get_frontend``'s Cnn14 on a file's samples and rate equals its row
    of the pack: one load, resample and forward for both."""
    from conette_torch.ops.frontend_factories import get_frontend

    audio_dir, csv_path = corpus
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    keep = prepare.filter_dataset(ds)
    tree = pann_tree("resample_mean_cnn14")
    fpath = prepare.pack_dataset_to_hdf(ds, str(tmp_path), audio_t_name="resample_mean_cnn14",
                                        encoder_params=tree, indexes=keep, batch_size=4, device="cpu")
    fn, width = get_frontend("resample_mean_cnn14", tree, device="cpu")
    assert width == 2048  # the name's width, whatever the tree
    packed = HDFDataset(fpath)
    for row, i in enumerate(keep):
        want = packed.at(row, "audio")
        np.testing.assert_allclose(fn(*ds.at(i, "audio")), want, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())))


def test_the_cnn_pack_records_its_spans_and_counters(corpus, tmp_path):
    from conette_torch.utils import profiling

    audio_dir, csv_path = corpus
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    keep = prepare.filter_dataset(ds)
    profiling.clear()
    prepare.pack_dataset_to_hdf(ds, str(tmp_path), audio_t_name="resample_mean_cnn14",
                                encoder_params=pann_tree("resample_mean_cnn14"), indexes=keep, batch_size=2,
                                device="cpu")
    recs = profiling.records()
    by = {name: [r for r in recs if r.name == name] for name in
          ("pack_dataset", "load_ahead", "native_load", "load_file", "pann_encode", "pack_collect",
           "pack_write")}
    batches = -(-len(keep) // 2)
    assert [len(v) for v in by.values()] == [1, batches, batches, len(keep), batches, batches, 1]
    root = by["pack_dataset"][0]
    assert root.attrs == {"files": len(keep), "batch": 2}
    assert all(r.root == root.id for v in by.values() for r in v)
    assert all(r.parent == root.id for n in ("load_ahead", "pann_encode", "pack_collect", "pack_write")
               for r in by[n])
    ahead = {r.id for r in by["load_ahead"]}
    assert all(r.parent in ahead and r.thread != root.thread for r in by["native_load"])
    assert [r.attrs["files"] for r in by["load_ahead"]] == [len(keep[b:b + 2]) for b in range(0, len(keep), 2)]
    lens = [len(m) for m in prepare.PannFrontend("resample_mean_cnn14", pann_tree("resample_mean_cnn14"),
                                                  device="cpu").load(ds, keep)]
    valid = sum(1 + n // 320 for n in lens)
    from conette_torch.huggingface.preprocessor import bucket_length

    padded = sum(len(lens[b:b + 2]) * (1 + bucket_length(max(lens[b:b + 2])) // 320)
                 for b in range(0, len(lens), 2))
    assert sum(r.attrs["padded_frames"] for r in by["pann_encode"]) == padded
    assert [r.attrs["rows"] for r in by["pann_encode"]] == [len(lens[b:b + 2]) for b in range(0, len(lens), 2)]
    assert profiling.summary()["counters"] == {"pann_valid_frames": valid, "pann_pad_frames": padded - valid}


def test_a_clip_too_short_for_the_pools_raises():
    from conette_torch.models import pann
    from conette_torch.weights import to_torch

    tree = to_torch(pann_tree("resample_mean_cnn14"))
    wav = torch.zeros((2, 32_000))
    with pytest.raises(ValueError, match="shorter than 9920 samples"):
        pann.pann_frames_masked(tree, wav, torch.tensor([32_000, 31 * 320 - 1]))
    assert pann.pann_frames_masked(tree, wav, torch.tensor([32_000, 31 * 320]))["frame_embs_lens"].tolist() == [3, 1]


def test_an_unknown_audio_t_raises_naming_the_known_ones(corpus, tmp_path):
    audio_dir, csv_path = corpus
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    with pytest.raises(ValueError, match="resample_mean_cnn14"):
        prepare.pack_dataset_to_hdf(ds, str(tmp_path), audio_t_name="resample_mean_beats", device="cpu")
    with pytest.raises(ValueError, match="resample_mean_convnext"):
        prepare.main_prepare(["--audio_dir", audio_dir, "--captions_csv", csv_path, "--out_dir", str(tmp_path),
                              "--audio_t", "cnn14", "--device", "cpu"])


def test_the_cli_packs_cnn14_rows(corpus, tmp_path):
    audio_dir, csv_path = corpus
    tree = pann_tree("resample_mean_cnn14")
    npz = str(tmp_path / "cnn14.npz")
    save_params_npz(npz, tree)
    assert prepare.main_prepare(["--audio_dir", audio_dir, "--captions_csv", csv_path, "--out_dir", str(tmp_path),
                                 "--audio_t", "resample_mean_cnn14", "--encoder", npz, "--batch_size", "3",
                                 "--device", "cpu", "--debug"]) == 0
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    assert_rows_equal(str(tmp_path / "clotho_dev_resample_mean_cnn14_ident.hdf"),
                      each_clip_alone(ds, prepare.filter_dataset(ds), tree), 32)


class LongerClotho(FakeClotho):
    """``FakeClotho``'s items at 1.2 s, long enough for Cnn14's pools."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        rng = np.random.default_rng(1)
        for item in self._items:
            item["audio"] = (0.1 * rng.standard_normal(38_400)).astype(np.float32)


def test_config_mode_packs_cnn14_through_the_pann_registry(monkeypatch, tmp_path):
    """``audio_t=resample_mean_cnn14``: its ``pretrain_path`` (Cnn14) loads
    through ``load_registry_pann``, and the pack holds Cnn14 rows under the
    Cnn14 file name."""
    from conette_torch.huggingface import convert_pann

    tree = pann_tree("resample_mean_cnn14")
    asked = []
    monkeypatch.setattr(convert_pann, "load_registry_pann", lambda name: asked.append(name) or tree)
    fake = types.ModuleType("aac_datasets")
    fake.Clotho = LongerClotho
    monkeypatch.setitem(sys.modules, "aac_datasets", fake)
    argv = ["data=clotho", "data.download=true", "data.subsets=[dev]", "data.bsize=2",
            "audio_t=resample_mean_cnn14", f"out_root={tmp_path}", "device=cpu"]
    assert prepare.main_prepare(argv) == 0
    assert asked == ["Cnn14"]
    name = "clotho_dev_resample_mean_cnn14_ident.hdf"
    assert os.listdir(tmp_path) == [name]
    from conette_torch.models import pann
    from conette_torch.native import loader
    from conette_torch.weights import to_torch

    packed = HDFDataset(str(tmp_path / name))
    for i, item in enumerate(LongerClotho()._items):
        mono = loader.resample_batch([item["audio"][None]], [item["sr"]], 32_000)[0]
        want = pann.pann_apply(to_torch(tree), torch.from_numpy(mono[None]))["frame_embs"][0].T.numpy()
        np.testing.assert_allclose(packed.at(i, "audio"), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
        assert packed.at(i, "captions") == item["captions"]


def test_registry_weights_dispatch_on_the_name(monkeypatch, ckpt_dir, encoder):
    from conette_torch.huggingface import convert_pann

    monkeypatch.setattr(convert_pann, "load_registry_pann", lambda name: {"pann": name})
    assert prepare.load_registry_weights("Cnn14") == {"pann": "Cnn14"}
    assert prepare.load_registry_weights("Cnn10") == {"pann": "Cnn10"}
    got = flatten_pytree(prepare.load_registry_weights("cnext_bl_75"))
    assert got.keys() == flatten_pytree(encoder).keys()
