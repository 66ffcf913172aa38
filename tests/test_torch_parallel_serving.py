"""Sharded captioning on the CPU: the port's ``caption_corpus(mesh=)`` and
``make_sharded_caption_fn`` on two ``gloo`` processes against one process,
and against conette_tpu's ``make_sharded_caption_fn`` on a mesh of four of
the suite's virtual CPU devices.

At f32 (the serving module with its bf16 casts made f32) two processes
give one process's captions and tokens, and its lprobs within 1e-5 (a
process multiplies half the rows, which sums in another order). The bf16 path as
shipped is held to JAX's sharded function as ``test_torch_serving.py``
holds bf16 captions: equal captions on a decoder whose beams are separated
(its classifier scaled by 8)."""

import jax
import numpy as np
import pytest

from conette_tpu.huggingface.model import CoNeTTEModel as JaxModel
from conette_tpu.parallel.mesh import make_mesh as jax_make_mesh
from conette_tpu.serving import make_sharded_caption_fn as jax_sharded_caption_fn
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.utils.audio_io import save_wav
from conette_torch.utils.flac import save_flac
from torch_parallel_workers import captions, sharded_captions, spawn

SHARP = 8.0
F32_LPROB_ATOL = 1e-5
CORPUS = ["a bird sings in the rain", "an engine hums and water flows",
          "someone speaks while wind blows"]
# two buckets (1 s, 3 s); batches of 2 rows, one a process, and a tail row
CLIPS = [(0.7, 32_000, "wav"), (2.2, 44_100, "flac"), (0.9, 32_000, "flac"),
         (1.8, 32_000, "wav"), (2.6, 44_100, "wav")]
TASKS = ["clotho", "audiocaps", "macs", "clotho", "audiocaps"]


def _saved(tmp_path_factory, scale):
    from conette_tpu.huggingface.config import CoNeTTEConfig as JaxConfig
    from conette_tpu.models.conette import conette_init as jax_conette_init
    from conette_tpu.models.convnext import convnext_init as jax_convnext_init
    from conette_tpu.tokenization import AACTokenizer as JaxTokenizer

    tok = JaxTokenizer()
    tok.fit(CORPUS)
    cfg = JaxConfig(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64, beam_size=2,
                    min_pred_size=1, max_pred_size=6, tokenizer_state=tok.get_txt_state())
    enc = jax_convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    rng = np.random.default_rng(0)
    for stage in enc["stages"]:
        for block in stage:
            block["scale"] = (rng.standard_normal(block["scale"].shape) * 0.1).astype(np.float32)
    probe = JaxModel(cfg, encoder_params=enc, seed=0)
    params = jax.tree.map(np.asarray, jax_conette_init(jax.random.PRNGKey(1),
                                                       probe.model_cfg._replace(proj_in=128)))
    params["decoder"]["classifier"]["weight"] = params["decoder"]["classifier"]["weight"] * scale
    jax_model = JaxModel(cfg, encoder_params=enc, model_params=params)
    path = str(tmp_path_factory.mktemp("ckpt"))
    jax_model.save_pretrained(path)
    return jax_model, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    paths = []
    for i, (secs, sr, kind) in enumerate(CLIPS):
        sig = (rng.standard_normal(int(sr * secs)) * 0.1).astype(np.float32)
        p = str(d / f"clip_{i}.{kind}")
        (save_wav if kind == "wav" else save_flac)(p, sig, sr)
        paths.append(p)
    return paths


def _batch(model_dir):
    model = CoNeTTEModel.from_pretrained(model_dir, device="cpu")
    rng = np.random.default_rng(1)
    ids = model.task_token_ids
    return {"wav": (rng.standard_normal((4, 32_000)) * 0.1).astype(np.float32),
            "lens": np.array([32_000, 20_000, 32_000, 9_000]),
            "bos": np.array([ids[t] for t in ("clotho", "audiocaps", "macs", "clotho")])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, files):
    """Each case once alone and once on two processes: (one, two)."""
    out = {}
    for scale, dtype, beam in ((1.0, "float32", 2), (SHARP, "bfloat16", 2)):
        jax_model, model_dir = _saved(tmp_path_factory, scale)
        batch = _batch(model_dir)
        args = (model_dir, files, TASKS, batch, 2, beam, dtype)
        one = captions(*args)
        two = spawn(sharded_captions, 2, *args)
        out[dtype] = (one, two, jax_model, model_dir, batch)
    return out


def test_two_processes_caption_a_corpus_as_one_does_at_f32(runs, files):
    one, two, *_ = runs["float32"]
    assert [r[0] for r in one[0]] == files and [r[3] for r in one[0]] == TASKS
    # every process returns the whole list, in input order, equal to one process's
    for rank in range(2):
        got = two[rank][0]
        assert [(r[0], r[1], r[3]) for r in got] == [(r[0], r[1], r[3]) for r in one[0]]
        np.testing.assert_allclose([r[2] for r in got], [r[2] for r in one[0]], atol=F32_LPROB_ATOL)


def test_sharded_caption_fn_gives_caption_batch_tokens_at_f32(runs):
    one, two, *_ = runs["float32"]
    for rank in range(2):
        np.testing.assert_array_equal(two[rank][1], one[1])
        np.testing.assert_allclose(two[rank][2], one[2], atol=F32_LPROB_ATOL)


def test_sharded_bf16_captions_equal_one_process_and_jax(runs):
    one, two, jax_model, model_dir, batch = runs["bfloat16"]
    for rank in range(2):
        assert [r[1] for r in two[rank][0]] == [r[1] for r in one[0]]
        np.testing.assert_array_equal(two[rank][1], one[1])
    mesh = jax_make_mesh(4)
    want_preds, want_lprobs = jax_sharded_caption_fn(jax_model, mesh, beam_size=2)(
        batch["wav"], batch["lens"], batch["bos"])
    port = CoNeTTEModel.from_pretrained(model_dir, device="cpu")
    got = [port._decode_pred(p) for p in two[0][1]]
    want = [jax_model._decode_pred(p) for p in np.asarray(want_preds)]
    assert got == want
    np.testing.assert_allclose(two[0][2], np.asarray(want_lprobs), atol=5e-2)
