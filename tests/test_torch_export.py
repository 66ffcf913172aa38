"""``conette_torch/export.py`` on the CPU at f32: a ``save_exported`` →
``ExportedCaptioner`` round trip equals the live port model on the same
padded batch, and the artifact's ``meta.json`` equals the one that
``conette_tpu.export.save_exported`` writes for the same model (weights,
tokenizer and config shared by both packages)."""

import json
import os

import numpy as np
import pytest
import torch

from conette_tpu.export import save_exported as jax_save_exported
from conette_tpu.huggingface.config import CoNeTTEConfig as JaxConfig
from conette_tpu.huggingface.model import CoNeTTEModel as JaxModel
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
from conette_torch.export import (
    ARTIFACT_NAME,
    ExportedCaptioner,
    build_caption_fn,
    export_caption_program,
    save_exported,
)
from conette_torch.huggingface.config import CoNeTTEConfig
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.models.convnext import convnext_init
from conette_torch.tokenization import AACTokenizer
from conette_torch.weights import to_numpy

SENTENCES = ["a bird sings in a tree", "an engine hums loudly", "rain falls"]
DECODE = dict(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64, beam_size=2,
              min_pred_size=1, max_pred_size=6)


@pytest.fixture(scope="module")
def model():
    """A port model on the CPU: two blocks a stage, narrow widths but the
    768 the projection takes, the decoder of ``tests/test_export.py``."""
    tok = AACTokenizer()
    tok.fit(SENTENCES)
    cfg = CoNeTTEConfig(tokenizer_state=tok.get_txt_state(), **DECODE)
    enc = convnext_init(torch.Generator().manual_seed(0), depths=(2, 2, 2, 2),
                        dims=(16, 32, 64, 768))
    return CoNeTTEModel(cfg, encoder_params=enc, seed=0, device="cpu")


@pytest.fixture(scope="module")
def art_dir(model, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_export"))
    save_exported(model, d, batch_size=3, clip_seconds=1.0)
    return d


@pytest.fixture(scope="module")
def captioner(art_dir):
    return ExportedCaptioner(art_dir)


def _wavs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(32_000).astype(np.float32) * 0.1,
            rng.standard_normal(24_000).astype(np.float32) * 0.1]


def test_artifact_files(art_dir):
    for f in (ARTIFACT_NAME, "tokenizer.json", "meta.json"):
        assert os.path.isfile(os.path.join(art_dir, f)), f


def test_exported_program_equals_the_live_model(model, captioner):
    cap = captioner
    batch, lens, bos = cap.prepare_batch(_wavs(), task=["clotho", "audiocaps"])
    preds, lprobs, mult_preds, mult_lprobs, clip_probs = cap.run(batch, lens, bos)
    tasks = ["clotho", "audiocaps", "clotho"]  # the pad row takes the first task
    live = model(list(batch), sr=32_000, x_shapes=np.stack([np.ones(3), lens], 1), task=tasks)
    np.testing.assert_array_equal(preds.numpy(), live["preds"])
    np.testing.assert_array_equal(mult_preds.numpy(), live["mult_preds"])
    np.testing.assert_allclose(lprobs.numpy(), live["lprobs"], atol=1e-5)
    np.testing.assert_allclose(mult_lprobs.numpy(), live["mult_lprobs"], atol=1e-5)
    np.testing.assert_allclose(clip_probs.numpy(), live["tags_probs"], atol=1e-6)
    assert cap(_wavs(), task=["clotho", "audiocaps"]) == live["cands"][:2]


def test_exported_meta_equals_the_jax_artifacts(model, art_dir, tmp_path):
    """The JAX model of ``tests/test_export.py`` on the port model's weights."""
    tok = JaxTokenizer()
    tok.fit(SENTENCES)
    jax_model = JaxModel(JaxConfig(tokenizer_state=tok.get_txt_state(), **DECODE),
                         encoder_params=to_numpy(model.encoder_params),
                         model_params=to_numpy(model.params))
    jax_save_exported(jax_model, str(tmp_path), batch_size=3, clip_seconds=1.0)
    with open(os.path.join(tmp_path, "meta.json")) as f:
        want = json.load(f)
    with open(os.path.join(art_dir, "meta.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(want)
    assert got == want


def test_greedy_caption_fn_equals_the_live_model(model):
    fn, meta = build_caption_fn(model, beam_size=1)
    assert meta == {"beam_size": 1, "min_pred_size": 1, "max_pred_size": 6}
    wav = np.stack([np.pad(w, (0, 32_000 - len(w))) for w in _wavs()])
    lens = np.array([32_000, 24_000], np.int32)
    bos = np.full((2,), model.task_token_ids["clotho"], np.int32)
    with torch.no_grad():
        preds, lprobs, _, _, _ = fn(*map(torch.from_numpy, (wav, lens, bos)))
    live = model(list(wav), sr=32_000, x_shapes=np.stack([np.ones(2), lens], 1), task="clotho",
                 beam_size=1)
    np.testing.assert_array_equal(preds.numpy(), live["preds"])
    np.testing.assert_allclose(lprobs.numpy(), live["lprobs"], atol=1e-5)


def test_exported_task_conditioning_and_bounds(model, captioner):
    cap = captioner
    assert set(cap.meta["task_bos_ids"]) == set(model.config.task_names)
    with pytest.raises(ValueError, match="Invalid task"):
        cap([np.zeros(16_000, np.float32)], task="nope")
    with pytest.raises(ValueError, match="exported batch size"):
        cap([np.zeros(16_000, np.float32)] * 4)
    with pytest.raises(ValueError, match="model's device"):
        export_caption_program(model, 3, 1.0, platforms=["cuda"])
