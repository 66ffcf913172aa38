"""The slice as a whole: a directory saved by conette_tpu's CoNeTTEModel
captions identically through conette_torch's CoNeTTEModel at float32 on
the CPU, and the port's predict CLI and facade run end to end."""

import csv

import jax
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.config import CoNeTTEConfig as JaxConfig
from conette_tpu.huggingface.model import CoNeTTEModel as JaxModel
from conette_tpu.models.conette import conette_init as jax_conette_init
from conette_tpu.models.convnext import convnext_init as jax_convnext_init
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
import conette_torch
from conette_torch.huggingface.config import CoNeTTEConfig
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.models.convnext import convnext_init
from conette_torch.predict import main_predict
from conette_torch.tokenization import AACTokenizer
from conette_torch.utils.audio_io import load_audio, save_wav
from conette_torch.utils.flac import save_flac

CORPUS = [
    "a bird sings loudly in the trees",
    "an engine hums near a busy road",
    "people talk while a dog barks",
    "rain falls on a tin roof and thunder rumbles",
]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A narrow random JAX model with a fitted tokenizer, saved to disk."""
    tok = JaxTokenizer()
    tok.fit(CORPUS)
    cfg = JaxConfig(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64,
                    beam_size=3, min_pred_size=1, max_pred_size=8,
                    tokenizer_state=tok.get_txt_state())
    enc = jax_convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    rng = np.random.default_rng(0)
    for stage in enc["stages"]:
        for block in stage:
            block["scale"] = (rng.standard_normal(block["scale"].shape) * 0.1).astype(np.float32)
    probe = JaxModel(cfg, encoder_params=enc, seed=0)
    params = jax_conette_init(jax.random.PRNGKey(1), probe.model_cfg._replace(proj_in=128))
    model = JaxModel(cfg, encoder_params=enc, model_params=params)
    path = tmp_path_factory.mktemp("ckpt")
    model.save_pretrained(str(path))
    clips = [(rng.standard_normal(32000) * 0.1).astype(np.float32),
             (rng.standard_normal(21000) * 0.1).astype(np.float32)]
    return model, str(path), clips


@pytest.mark.parametrize("beam", [3, 1])
def test_port_captions_like_jax(saved, beam):
    jax_model, path, clips = saved
    port = CoNeTTEModel.from_pretrained(path, device="cpu")
    tasks = ["clotho", "audiocaps"]
    want = jax_model(clips, sr=32000, beam_size=beam, task=tasks)
    got = port(clips, sr=32000, beam_size=beam, task=tasks)
    assert got["cands"] == want["cands"]
    assert got["mult_cands"] == want["mult_cands"]
    np.testing.assert_array_equal(got["preds"], np.asarray(want["preds"]))
    np.testing.assert_array_equal(got["mult_preds"], np.asarray(want["mult_preds"]))
    np.testing.assert_allclose(got["tags_probs"], np.asarray(want["tags_probs"]), atol=1e-5)
    np.testing.assert_allclose(got["lprobs"], np.asarray(want["lprobs"]), atol=1e-5)
    assert got["tags"] == want["tags"] and got["tasks"] == tasks


def test_save_reload_and_task_validation(saved, tmp_path):
    _, path, clips = saved
    port = CoNeTTEModel.from_pretrained(path, device="cpu")
    port.save_pretrained(str(tmp_path))
    again = conette_torch.conette(str(tmp_path), device="cpu")
    assert again(clips, sr=32000)["cands"] == port(clips, sr=32000)["cands"]
    with pytest.raises(ValueError, match="Invalid task"):
        port(clips, task="nope")


def test_predict_cli_on_cpu(saved, tmp_path):
    _, path, clips = saved
    wav = str(tmp_path / "clip.wav")
    save_wav(wav, np.clip(clips[0] * 3, -1, 1), 44100)
    out_csv = str(tmp_path / "out.csv")
    rc = main_predict(["--audio", wav, "--model_path", path, "--device", "cpu",
                       "--csv_export", out_csv, "--verbose", "0"])
    assert rc == 0
    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    port = CoNeTTEModel.from_pretrained(path, device="cpu")
    audio, sr = load_audio(wav)
    assert rows[0]["candidate"] == port(audio, sr=sr)["cands"][0]


def test_unported_loaders_raise(tmp_path):
    """The train-run loader is still to port and raises, as a missing
    directory does; FLAC input, once unported, now decodes."""
    (tmp_path / "run" / "checkpoints" / "best").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="train-run"):
        CoNeTTEModel.from_pretrained(str(tmp_path / "run"), device="cpu")
    with pytest.raises(FileNotFoundError):
        CoNeTTEModel.from_pretrained(str(tmp_path / "missing"), device="cpu")
    flac = tmp_path / "a.flac"
    x = (0.25 * np.sin(np.arange(4000) / 7.0)).astype(np.float32)
    save_flac(str(flac), x, 16000)
    audio, sr = load_audio(str(flac))
    assert sr == 16000 and audio.shape == (1, 4000)
    assert np.abs(audio[0] - x).max() <= 1 / 32768


def test_frame_embedding_input_matches_jax(saved):
    """``preprocess=False``: the caller passes (B, T, 768)-style frame
    embeddings and their shapes, and only the decoder runs."""
    jax_model, path, _ = saved
    port = CoNeTTEModel.from_pretrained(path, device="cpu")
    rng = np.random.default_rng(9)
    embs = rng.standard_normal((2, 5, 128)).astype(np.float32)
    shapes = np.array([[128, 5], [128, 3]])
    want = jax_model(embs, x_shapes=shapes, preprocess=False, task="macs")
    got = port(embs, x_shapes=shapes, preprocess=False, task="macs")
    assert got["cands"] == want["cands"] and "tags" not in got
    np.testing.assert_array_equal(got["mult_preds"], np.asarray(want["mult_preds"]))


def test_random_init_model_runs_on_cpu():
    """A model built from a seed (no weights given) has the JAX package's
    init structure and captions."""
    tok = AACTokenizer()
    tok.fit(CORPUS)
    cfg = CoNeTTEConfig(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64,
                        max_pred_size=5, tokenizer_state=tok.get_txt_state())
    enc = convnext_init(torch.Generator().manual_seed(0), depths=(1, 1, 1, 1),
                        dims=(16, 32, 64, 768))
    model = CoNeTTEModel(cfg, encoder_params=enc, seed=3, device="cpu")
    emb = model.params["decoder"]["emb"]["weight"]
    assert float(emb[model.model_cfg.pad_id].abs().max()) == 0.0
    w = enc["stages"][0][0]["pwconv1"]["weight"]
    assert float(w.abs().max()) <= 0.04 and float(w.std()) > 0.01  # trunc_normal(0.02)
    out = model([np.zeros(16000, np.float32)], task="clotho")
    assert out["preds"].shape == (1, 5) and isinstance(out["cands"][0], str)
