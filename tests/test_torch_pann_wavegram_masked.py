"""``models/pann_zoo.py::wavegram_logmel_cnn14_frames_masked``,
Wavegram_Logmel_Cnn14's frame embeddings of a padded batch of clips of
several lengths, on the CPU at f32: each row equals what the port's
``wavegram_logmel_cnn14_apply``, JAX's and the benchmark's plain reference
(``benchmark/reference/wavegram.py``) give that clip alone, within 1e-5 of
the larger of 1 and its largest magnitude; its frame count is the stated
chain; zeros past it. The same batch padded and encoded without the masks
differs, so the masks are what makes it equal. ``conette-prepare`` packs
it through ``make_frontend``, and config mode through the PANN registry.

The encoder runs the published structure at toy widths (``pre_block3``
keeps 128 channels, so the wavegram's 4 groups hold the log-mel branch's
32 frequencies, as JAX's reshape needs) with drawn batch norms. The rows'
lengths give the stride-5 convolution, each pool of 4 and the (2, 1) pool
remainders, and the join's lesser length on the wavegram branch for some
rows and on both for others: the log-mel branch is never the shorter
(the wavegram's ``ceil(n / 5) // 128`` steps are at most the log-mel's
``(1 + n // 320) // 2``)."""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from benchmark.reference import wavegram as ref_wavegram
from conette_tpu.models import pann_zoo as jax_zoo
from conette_torch import prepare
from conette_torch.data.hdf import HDFDataset
from conette_torch.models import pann, pann_zoo
from conette_torch.models.layers import batch_norm_init, linear_init
from conette_torch.utils import profiling
from conette_torch.weights import to_numpy, to_torch
from test_torch_prepare import LongerClotho, write_corpus
from torch_fixtures import random_batch_norms

TOL = 1e-5
# ((n - 1) % 5, the remainders of the three pools of 4 and the (2, 1) pool,
# the wavegram's / the log-mel's joined length): (0, 1 1 1 1, 57 / 58),
# (2, 3 2 3 0, 73 / 73), (4, 1 1 1 1, 31 / 32), (0, 0 0 0 0, 16 / 16: the
# shortest clip that keeps a frame), (3, 0 0 0 1, 64 / 64)
LENS = [36_901, 47_013, 20_265, 10_236, 41_279]
PADDED = 52_000


def chain(n: int) -> int:
    """T' of a clip of n samples, as the module docstring states it."""
    wave = (n - 1) // 5 + 1
    for pool in (4, 4, 4, 2):
        wave //= pool
    t = min(wave, (1 + n // 320) // 2)
    for _ in range(4):
        t //= 2
    return t


def tree() -> dict:
    g = torch.Generator().manual_seed(22)

    def pre(cin, cout):
        return pann_zoo._pre_wav_block_init(g, cin, cout)

    params = {"pre_conv0": pann_zoo._conv1d_init(g, 1, 8, 11), "pre_bn0": batch_norm_init(8),
              "pre_block1": pre(8, 8), "pre_block2": pre(8, 16), "pre_block3": pre(16, 128),
              "pre_block4": pann.conv_block_init(g, 4, 8), "bn0": batch_norm_init(64),
              "blocks": [pann.conv_block_init(g, i, o) for i, o in
                         [(1, 8), (16, 8), (8, 16), (16, 16), (16, 32), (32, 32)]],
              "fc1": linear_init(g, 32, 32, init="torch"), "fc_audioset": linear_init(g, 32, 527, init="torch")}
    return random_batch_norms(to_numpy(params), np.random.default_rng(22))


def batch(lens=LENS, padded=PADDED, seed=0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lens), padded), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 32_000
        wav[i, :n] = 0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
    return wav, np.asarray(lens)


@pytest.fixture(scope="module")
def masked():
    params = tree()
    wav, lens = batch()
    out = pann_zoo.wavegram_logmel_cnn14_frames_masked(to_torch(params), torch.from_numpy(wav),
                                                       torch.from_numpy(lens))
    return params, wav, lens, out


def alone(kind: str, params: dict, clip: np.ndarray) -> np.ndarray:
    """(C, T') of one clip through the port, JAX or the plain reference."""
    if kind == "port":
        return pann_zoo.wavegram_logmel_cnn14_apply(to_torch(params), torch.from_numpy(clip))["frame_embs"][0].numpy()
    if kind == "jax":
        return np.asarray(jax_zoo.wavegram_logmel_cnn14_apply(params, clip)["frame_embs"][0])
    return ref_wavegram.frames(to_torch(params), torch.from_numpy(clip))[0].T.numpy()


@pytest.mark.parametrize("kind", ["port", "jax", "reference"])
def test_each_row_is_the_clip_alone(masked, kind):
    """JAX sees the first two rows (the wavegram the shorter, then both
    equal): each length compiles its programs anew, ~6 s on the CPU."""
    params, wav, lens, out = masked
    embs, n_out = out["frame_embs"], out["frame_embs_lens"]
    assert embs.shape[:2] == (len(lens), 32) and n_out.dtype == torch.int32
    for i, n in enumerate(lens[:2] if kind == "jax" else lens):
        want = alone(kind, params, wav[i:i + 1, :n])
        t = want.shape[1]
        assert int(n_out[i]) == t == chain(int(n))
        np.testing.assert_allclose(embs[i, :, :t].numpy(), want, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want).max())))
        assert not embs[i, :, t:].any()


@pytest.mark.parametrize("n", [10_236, 20_265, 36_901, 32_000 * 30, 32_000 * 30 + 3_199])
def test_frame_count_is_the_stated_chain(n):
    """A 30 s clip keeps 93 frames, as Cnn14's does; the row counts of the
    masked batch, the reference's and the chain agree."""
    assert ref_wavegram.frame_count(n) == chain(n)
    if n > 100_000:  # the published length: the count alone
        assert chain(32_000 * 30) == 93
        return
    wav, lens = batch([n], padded=n + 4_000)
    got = pann_zoo.wavegram_logmel_cnn14_frames_masked(to_torch(tree()), torch.from_numpy(wav), torch.from_numpy(lens))
    assert int(got["frame_embs_lens"][0]) == chain(n)


def test_a_clip_too_short_to_keep_a_frame_raises():
    wav = torch.zeros((2, 32_000))
    with pytest.raises(ValueError, match="10235 samples has no frame"):
        pann_zoo.wavegram_logmel_cnn14_frames_masked(to_torch(tree()), wav, torch.tensor([32_000, 10_235]))


def test_a_padded_batch_without_the_masks_differs(masked):
    """The same padded batch through the per-clip forward: every row
    shorter than the padding reads its padding into its last frames."""
    params, wav, lens, out = masked
    plain = pann_zoo.wavegram_logmel_cnn14_apply(to_torch(params), torch.from_numpy(wav))["frame_embs"]
    for i in range(len(lens)):
        t = int(out["frame_embs_lens"][i])
        gap = float((plain[i, :, :t] - out["frame_embs"][i, :, :t]).abs().max())
        assert gap > 1e2 * TOL * max(1.0, float(out["frame_embs"][i].abs().max())), i


def test_make_frontend_packs_each_clip_alone_with_its_spans(tmp_path):
    """Three WAV files (mono and stereo, 44.1 and 32 kHz) packed at batch 2
    hold each file's frames alone; each batch's ``wavegram`` span sits in
    its ``pann_encode``, and the counters sum the samples."""
    from conette_torch.huggingface.preprocessor import bucket_length
    from conette_torch.native import loader

    audio_dir, csv_path = write_corpus(str(tmp_path), [("a.wav", 1.3, 44_100, 1), ("b.wav", 0.9, 32_000, 2),
                                                       ("c.wav", 1.1, 44_100, 1)])
    params = tree()
    ds = prepare.scan_local_dataset(audio_dir, csv_path, "clotho", "dev")
    keep = prepare.filter_dataset(ds)
    assert isinstance(prepare.make_frontend("resample_mean_wavegram_logmel_cnn14", params, "cpu"),
                      prepare.PannFrontend)
    profiling.clear()
    fpath = prepare.pack_dataset_to_hdf(ds, str(tmp_path), audio_t_name="resample_mean_wavegram_logmel_cnn14",
                                        encoder_params=params, indexes=keep, batch_size=2, device="cpu")
    assert os.path.basename(fpath) == "clotho_dev_resample_mean_wavegram_logmel_cnn14_ident.hdf"
    packed = HDFDataset(fpath)
    monos = [loader.load_resample_mono(ds.path(i), 32_000) for i in keep]
    assert len(packed) == len(keep) == 3
    for i, mono in enumerate(monos):
        want = alone("port", params, mono[None]).T
        assert packed.at(i, "audio").shape == want.shape == (packed.at(i, "audio_lens"), 32)
        np.testing.assert_allclose(packed.at(i, "audio"), want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    spans = [r for r in recs if r.name == "wavegram"]
    batches = [monos[:2], monos[2:]]
    assert [(by_id[r.parent].name, r.attrs) for r in spans] == [
        ("pann_encode", {"rows": len(b), "samples": bucket_length(max(map(len, b)))}) for b in batches]
    valid = sum(map(len, monos))
    computed = sum(len(b) * bucket_length(max(map(len, b))) for b in batches)
    counters = profiling.summary()["counters"]
    assert (counters["wavegram_valid_samples"], counters["wavegram_pad_samples"]) == (valid, computed - valid)


def test_config_mode_packs_through_the_pann_registry(monkeypatch, tmp_path):
    """``audio_t=resample_mean_wavegram_logmel_cnn14``: its ``pretrain_path``
    (Wavegram_Logmel_Cnn14) loads through ``load_registry_pann`` and the
    pack holds its rows under its file name."""
    from conette_torch.huggingface import convert_pann
    from conette_torch.native import loader

    params = tree()
    asked = []
    monkeypatch.setattr(convert_pann, "load_registry_pann", lambda name: asked.append(name) or params)
    fake = types.ModuleType("aac_datasets")
    fake.Clotho = LongerClotho
    monkeypatch.setitem(sys.modules, "aac_datasets", fake)
    argv = ["data=clotho", "data.download=true", "data.subsets=[dev]", "data.bsize=2",
            "audio_t=resample_mean_wavegram_logmel_cnn14", f"out_root={tmp_path}", "device=cpu"]
    assert prepare.main_prepare(argv) == 0
    assert asked == ["Wavegram_Logmel_Cnn14"]
    name = "clotho_dev_resample_mean_wavegram_logmel_cnn14_ident.hdf"
    assert os.listdir(tmp_path) == [name]
    packed = HDFDataset(str(tmp_path / name))
    for i, item in enumerate(LongerClotho()._items):
        mono = loader.resample_batch([item["audio"][None]], [item["sr"]], 32_000)[0]
        want = alone("port", params, mono[None]).T
        np.testing.assert_allclose(packed.at(i, "audio"), want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


def test_the_expt_composes_over_this_packs_names():
    from conette_torch.config import load_config

    cfg = load_config("train", ["expt=clotho_wavegram_logmel_cnn14"])
    assert cfg["dm"]["train_hdfs"] == ["clotho_dev_resample_mean_wavegram_logmel_cnn14_ident_pann.hdf"]
    assert cfg["pl"]["proj_name"] == "lin2048"


def test_jax_is_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
