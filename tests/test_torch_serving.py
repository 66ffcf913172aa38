"""Corpus serving: the port's ``caption_corpus`` and ``warmup`` against
conette_tpu's, on the CPU, over WAV and FLAC files written by the port.

Both packages load one saved directory (a narrow encoder and a tiny
decoder) and caption the same files. ``caption_corpus`` runs the encoder
and the decode at bf16 in both; the two frameworks round at the same points
but sum in other orders, so single logits differ by about one bf16 ulp.
- With ``beam_size=1`` every choice is an argmax over the vocabulary:
  captions must be equal, and the per-token average lprobs agree within
  1e-2.
- With beam search the final choice compares the beams' average lprobs.
  The random decoder leaves them within a few thousandths of each other,
  so one ulp can pick the other beam. Two witnesses hold beam search to
  equal captions all the same: the same files through both packages'
  ``caption_corpus`` with their bf16 casts made f32 (no rounding to
  differ by, so beam reordering and batching must agree exactly), and the
  bf16 path as shipped on a decoder whose classifier is scaled by 8, which
  separates the beams by more than a rounding can move them.
"""

import inspect
import struct
import sys
import threading
import types

import jax
import numpy as np
import pytest

import conette_tpu.serving as jax_serving
import conette_torch.serving as port_serving
from conette_tpu.huggingface.config import CoNeTTEConfig as JaxConfig
from conette_tpu.huggingface.model import CoNeTTEModel as JaxModel
from conette_tpu.models.conette import conette_init as jax_conette_init
from conette_tpu.models.convnext import convnext_init as jax_convnext_init
from conette_tpu.serving import caption_corpus as jax_caption_corpus
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.huggingface.preprocessor import HostBatches, bucket_length
from conette_torch.kernels.logmel import fused_logmel
from conette_torch.models.conette import task_names_to_bos_ids
from conette_torch.serving import CaptionResult, caption_corpus, warmup
from conette_torch.utils import profiling
from conette_torch.utils.audio_io import save_wav
from conette_torch.utils.flac import save_flac

LPROB_ATOL = 1e-2       # argmax decode (beam_size=1)
BEAM_LPROB_ATOL = 5e-2  # beam search at bf16
F32_LPROB_ATOL = 1e-5   # both serving paths at f32
SHARP = 8.0             # classifier scale of the decoder with separated beams
CORPUS = [
    "a bird sings in the rain",
    "an engine hums and water flows",
    "someone speaks while wind blows",
]
# (seconds, sample rate, container): buckets of 1 s and 3 s at 32 kHz
CLIPS = [(0.7, 32_000, "wav"), (2.2, 44_100, "flac"), (0.9, 32_000, "flac"),
         (1.8, 32_000, "wav"), (2.6, 44_100, "wav")]
# the batch layout's corpus at batch 2: buckets of 1 s (five files: batches of
# 0.9 + 0.6, 0.8 + 0.95 and 0.4 alone, whose rows are shorter than, or
# missing where, batch 0 laid rows into the same kept buffer) and 2 s
LAYOUT_CLIPS = [(0.9, 32_000, "wav"), (1.5, 32_000, "flac"), (0.6, 44_100, "flac"),
                (0.8, 44_100, "wav"), (1.2, 44_100, "wav"), (0.95, 32_000, "wav"),
                (0.4, 32_000, "wav")]
LAYOUT_TASKS = ["clotho", "audiocaps", "macs", "clotho", "macs", "audiocaps", "audiocaps"]


def _save_and_load(tmp_path_factory, classifier_scale: float = 1.0):
    tok = JaxTokenizer()
    tok.fit(CORPUS)
    cfg = JaxConfig(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64,
                    beam_size=2, min_pred_size=1, max_pred_size=6,
                    tokenizer_state=tok.get_txt_state())
    enc = jax_convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    rng = np.random.default_rng(0)
    for stage in enc["stages"]:
        for block in stage:
            block["scale"] = (rng.standard_normal(block["scale"].shape) * 0.1).astype(np.float32)
    probe = JaxModel(cfg, encoder_params=enc, seed=0)
    params = jax_conette_init(jax.random.PRNGKey(1), probe.model_cfg._replace(proj_in=128))
    params = jax.tree.map(np.asarray, params)
    params["decoder"]["classifier"]["weight"] = params["decoder"]["classifier"]["weight"] * classifier_scale
    jax_model = JaxModel(cfg, encoder_params=enc, model_params=params)
    path = tmp_path_factory.mktemp("ckpt")
    jax_model.save_pretrained(str(path))
    return jax_model, CoNeTTEModel.from_pretrained(str(path), device="cpu")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _save_and_load(tmp_path_factory)


@pytest.fixture(scope="module")
def sharp_models(tmp_path_factory):
    return _save_and_load(tmp_path_factory, SHARP)


def _at_f32(module: types.ModuleType) -> types.ModuleType:
    """The serving module with its bf16 casts (encoder compute type and
    memory) made f32, built from its own source; the package is unchanged."""
    src = inspect.getsource(module)
    bf16 = "jnp.bfloat16" if "jnp.bfloat16" in src else "torch.bfloat16"
    assert src.count(bf16) >= 2, module.__name__
    mod = types.ModuleType(f"{module.__name__}_at_f32")
    sys.modules[mod.__name__] = mod  # dataclasses look their module up
    exec(compile(src.replace(bf16, bf16.replace("bfloat16", "float32")), module.__file__, "exec"),
         mod.__dict__)
    return mod


def _write_clips(d, clips) -> list[str]:
    rng = np.random.default_rng(0)
    paths = []
    for i, (secs, sr, kind) in enumerate(clips):
        sig = (rng.standard_normal(int(sr * secs)) * 0.1).astype(np.float32)
        p = str(d / f"clip_{i}.{kind}")
        (save_wav if kind == "wav" else save_flac)(p, sig, sr)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write_clips(tmp_path_factory.mktemp("corpus"), CLIPS)


@pytest.fixture(scope="module")
def layout_files(tmp_path_factory):
    return _write_clips(tmp_path_factory.mktemp("layout"), LAYOUT_CLIPS)


TASKS = ["clotho", "audiocaps", "macs", "clotho", "audiocaps"]


def test_caption_corpus_matches_jax(models, files):
    jax_model, port = models
    want = jax_caption_corpus(jax_model, files, task=TASKS, batch_size=2, beam_size=1)
    got = caption_corpus(port, files, task=TASKS, batch_size=2, beam_size=1)
    assert [r.fname for r in got] == files
    assert all(isinstance(r, CaptionResult) and isinstance(r.caption, str) for r in got)
    assert [r.task for r in got] == TASKS
    assert [r.caption for r in got] == [r.caption for r in want]
    np.testing.assert_allclose([r.lprob for r in got], [r.lprob for r in want], atol=LPROB_ATOL)


@pytest.mark.parametrize("beam", [2, 3])
def test_caption_corpus_beam_search_at_f32_equals_jax(models, files, beam):
    """The decoder whose beams the bf16 path flips, with both serving paths
    at f32: equal captions and lprobs, so the flips come from bf16 rounding
    alone and not from bucketing, padding or beam reordering."""
    jax_model, port = models
    want = _at_f32(jax_serving).caption_corpus(jax_model, files, task=TASKS, batch_size=2,
                                               beam_size=beam)
    got = _at_f32(port_serving).caption_corpus(port, files, task=TASKS, batch_size=2,
                                               beam_size=beam)
    assert [r.fname for r in got] == files and [r.task for r in got] == TASKS
    assert [r.caption for r in got] == [r.caption for r in want]
    np.testing.assert_allclose([r.lprob for r in got], [r.lprob for r in want],
                               atol=F32_LPROB_ATOL)


def test_caption_corpus_beam_search_near_jax(sharp_models, files):
    """The bf16 path as shipped, at beam 2 (the model's) and 3, on a decoder
    whose beams are separated: equal captions."""
    jax_model, port = sharp_models
    for beam in (None, 3):
        want = jax_caption_corpus(jax_model, files, task=TASKS, batch_size=2, beam_size=beam)
        got = caption_corpus(port, files, task=TASKS, batch_size=2, beam_size=beam)
        assert [r.fname for r in got] == files and [r.task for r in got] == TASKS
        assert [r.caption for r in got] == [r.caption for r in want], beam
        np.testing.assert_allclose([r.lprob for r in got], [r.lprob for r in want],
                                   atol=BEAM_LPROB_ATOL)


def test_caption_corpus_one_task_for_all(models, files):
    _, port = models
    got = caption_corpus(port, files[:3], task="macs", batch_size=4)
    assert [r.task for r in got] == ["macs"] * 3
    assert [r.fname for r in got] == files[:3]
    assert all(np.isfinite(r.lprob) for r in got)


def test_caption_corpus_mixed_tasks_in_one_bucket(models, files):
    """Per-clip tasks are honoured inside one batch of one bucket: clip 0
    (0.7 s) and clip 2 (0.9 s) share the 1 s bucket (the case of
    ``tests/test_serving.py``)."""
    jax_model, port = models
    paths, tasks = [files[0], files[2]], ["clotho", "audiocaps"]
    want = jax_caption_corpus(jax_model, paths, task=tasks, batch_size=2, beam_size=1)
    got = caption_corpus(port, paths, task=tasks, batch_size=2, beam_size=1)
    assert [r.task for r in got] == tasks
    assert [r.caption for r in got] == [r.caption for r in want]
    np.testing.assert_allclose([r.lprob for r in got], [r.lprob for r in want], atol=LPROB_ATOL)


class _TwoDataRanks:
    """The queries ``caption_corpus`` makes of a mesh whose ``data`` dim has
    two processes."""

    mesh_dim_names = ("data", "model")

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0

    def size(self, dim):
        return (2, 1)[dim]


def test_caption_corpus_rejects_what_it_does_not_take(models, files):
    _, port = models
    with pytest.raises(ValueError, match="not divisible by mesh data=2"):
        caption_corpus(port, files, batch_size=3, mesh=_TwoDataRanks())
    with pytest.raises(ValueError, match="len"):
        caption_corpus(port, files, task=["clotho"])
    with pytest.raises(ValueError, match="Invalid task"):
        caption_corpus(port, files[:1], task="nope")


def _file_by_file(model, paths, tasks, batch_size):
    """The batches ``caption_corpus`` hands ``caption_batch``, laid out as it
    laid them one file at a time: (indexes, waveforms, lengths, BOS ids) a
    batch, each file's own ``load_resample`` cut at its bucket's length into
    a zeroed buffer, a row with no file zeros of the bucket's length, and a
    tail batch's tasks padded with its first."""
    pre = model.preprocessor
    loaded = [pre.load_resample(p) for p in paths]
    buckets: dict[int, list[int]] = {}
    for i, (_, wl) in enumerate(loaded):
        buckets.setdefault(bucket_length(int(wl[0])), []).append(i)
    out = []
    for blen, idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            wav = np.zeros((batch_size, blen), np.float32)
            lens = np.full((batch_size,), blen, np.int64)
            for row, i in enumerate(chunk):
                w, wl = loaded[i]
                m = min(int(wl[0]), blen)
                wav[row, :m] = w[0, :m]
                lens[row] = m
            chunk_tasks = [tasks[i] for i in chunk]
            chunk_tasks += [chunk_tasks[0]] * (batch_size - len(chunk))
            out.append((chunk, wav, lens, task_names_to_bos_ids(model.model_cfg, model.task_token_ids,
                                                                  chunk_tasks)))
    return out


def test_caption_corpus_hands_each_batch_as_laid_out_file_by_file(models, layout_files, monkeypatch):
    """Two calls back to back on one model, the second over the files in
    reverse, so that the kept buffers are laid into again with shorter rows
    and rows with no file where longer rows were: every batch handed to
    ``caption_batch`` is byte for byte the one laid out a file at a time, and
    the results are those of ``caption_batch`` on those batches, captions and
    lprobs exactly."""
    _, port = models
    real = port_serving.caption_batch
    seen, buffers = [], []

    def recording(model, wav, lens, bos_ids, beam, steps_out=None):
        seen.append((wav.copy(), np.array(lens), np.array(bos_ids)))
        buffers.append(wav.__array_interface__["data"][0])
        return real(model, wav, lens, bos_ids, beam, steps_out=steps_out)

    monkeypatch.setattr(port_serving, "caption_batch", recording)
    beam = port.model_cfg.beam_size
    for paths, tasks in ((layout_files, LAYOUT_TASKS), (layout_files[::-1], LAYOUT_TASKS[::-1])):
        seen.clear()
        got = caption_corpus(port, paths, task=tasks, batch_size=2)
        want = _file_by_file(port, paths, tasks, 2)
        assert len(seen) == len(want) == 4
        for (wav, lens, bos), (_, w, ln, b) in zip(seen, want):
            assert wav.dtype == w.dtype and wav.shape == w.shape and wav.tobytes() == w.tobytes()
            assert lens.dtype == ln.dtype and lens.tolist() == ln.tolist()
            assert bos.tolist() == b.tolist()
        expect = {}
        for chunk, w, ln, b in want:
            _, preds, lprobs = real(port, w, ln, b, beam)
            for row, i in enumerate(chunk):
                expect[i] = (port._decode_pred(preds[row].numpy()), float(lprobs[row]))
        assert [(r.caption, r.lprob) for r in got] == [expect[i] for i in range(len(paths))]
        assert [r.fname for r in got] == paths and [r.task for r in got] == tasks
    # the 1 s bucket's pair in turn, then the 2 s bucket's second buffer; the
    # second call lays its batches into the same buffers
    a, b, c, d = buffers[:4]
    assert a == c and len({a, b, d}) == 3 and buffers[4:] == buffers[:4]


def test_caption_corpus_loads_each_batch_ahead_on_a_thread_of_its_own(models, layout_files):
    """One ``load_ahead`` a batch, on a thread other than the caller's and
    rooted under the call, holding the batch's one ``load_resample`` (its
    ``native_load`` with a ``load_file`` a file, its ``pad_bucket``); a
    ``load_wait`` on the caller's thread around each wait for a batch."""
    _, port = models
    profiling.clear()
    caption_corpus(port, layout_files, task=LAYOUT_TASKS, batch_size=2)
    recs = profiling.records()

    def named(name, parents):
        return [r for r in recs if r.name == name and r.parent in {p.id for p in parents}]

    (call,) = [r for r in recs if r.name == "caption_corpus"]
    ahead = named("load_ahead", [call])
    assert [r.attrs for r in ahead] == [{"files": f, "rows": 2} for f in (2, 2, 1, 2)]
    assert all(r.root == call.id and r.thread != call.thread for r in ahead)
    loads = named("load_resample", ahead)
    assert sorted(r.parent for r in loads) == sorted(r.id for r in ahead)
    native = named("native_load", loads)
    assert len(native) == len(named("pad_bucket", loads)) == len(ahead)
    files = named("load_file", native)
    assert len(files) == len(layout_files)
    assert all(r.root == call.id for r in loads + native + files)
    assert all(r.thread == ahead[0].thread for r in loads + native)
    waits = named("load_wait", [call])
    assert len(waits) == len(ahead) and all(r.thread == call.thread for r in waits)
    assert len([r for r in recs if r.name == "load_wait"]) == len(waits)
    profiling.clear()


def test_caption_corpus_raises_a_file_that_fails_to_load_and_leaves_no_thread(models, layout_files,
                                                                             tmp_path):
    """A WAV whose header reads (the bucket pass takes it) in an encoding
    the loader does not decode (ADPCM), in the second batch, which is
    loaded ahead: the load's error raises from ``caption_corpus`` as it did
    when each file was loaded alone, and no thread of the call is left."""
    _, port = models
    data = b"\x00" * 6400
    fmt = struct.pack("<HHIIHH", 2, 1, 32_000, 64_000, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)) + data
    bad = tmp_path / "adpcm.wav"
    bad.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    before = set(threading.enumerate())
    with pytest.raises(OSError, match=r"conette_load_resample_mono\(.*adpcm.wav'\): unsupported WAV encoding"):
        caption_corpus(port, layout_files[:4] + [str(bad)], batch_size=2)
    assert set(threading.enumerate()) <= before


def test_host_batches_keep_a_pair_a_shape_and_drop_the_least_recently_used():
    kept = HostBatches(2)
    a0, a1 = kept.take((2, 8), 0), kept.take((2, 8), 1)
    assert a0 is not a1 and a0.dtype == np.float32 and a0.shape == (2, 8)
    assert kept.take((2, 8), 2) is a0 and kept.take((2, 8), 3) is a1
    b0 = kept.take((2, 16), 0)
    kept.take((2, 8), 0)
    kept.take((4, 8), 0)  # drops (2, 16), the least recently used
    assert list(kept.pairs) == [(2, 8), (4, 8)]
    assert kept.take((2, 8), 0) is a0 and kept.take((2, 16), 0) is not b0


def test_warmup_runs_each_bucket(models):
    _, port = models
    n = fused_logmel.launches
    warmup(port, bucket_seconds=(1, 2), batch_size=2)
    assert fused_logmel.launches == n  # the CPU takes the plain frontend
