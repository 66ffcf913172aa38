"""The port's decode and request path as one program a batch, on the CPU:
beam and greedy search read nothing back to the host (every host read of a
tensor is patched to raise), run all their steps and still equal
conette_tpu's early-exit searches at f32; the device constants cached for
the decoder and the plain frontend equal the values they replaced, bit for
bit; the names the port's modules lacked equal their JAX counterparts; the
graph cache runs its function eagerly on the CPU; and a request is run at
a fixed batch, padded or cut into chunks, with its rows put back in order."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.decoding.beam import beam_search as jax_beam
from conette_tpu.decoding.greedy import greedy_search as jax_greedy
from conette_tpu.huggingface import model as jax_model
from conette_tpu.huggingface.preprocessor import CoNeTTEPreprocessor as JaxPreprocessor
from conette_tpu.models import decoder as jd
from conette_tpu.models import layers as jl
from conette_tpu.ops import mel as jmel
from conette_tpu.ops import stft as jstft
from conette_torch.decoding.beam import beam_search
from conette_torch.decoding.greedy import greedy_search
from conette_torch.graphs import GraphCache, run_in_batches
from conette_torch.huggingface import model as tmodel
from conette_torch.huggingface.preprocessor import CoNeTTEPreprocessor
from conette_torch.models import decoder as td
from conette_torch.models import layers as tl
from conette_torch.models.convnext import convnext_init
from conette_torch.ops import mel as tmel
from conette_torch.ops import stft as tstft
from conette_torch.ops.frontend import DEFAULT_LOGMEL, _mel_matrix, mel_matrix_tensor
from conette_torch.weights import to_numpy, to_torch

CFG_KW = dict(vocab_size=48, d_model=32, nhead=2, num_layers=2, dim_feedforward=64,
              dropout_p=0.0, bos_id=1, eos_id=2, pad_id=0)
JCFG = jd.DecoderConfig(**CFG_KW)
TCFG = td.DecoderConfig(**CFG_KW)
B, T_MEM, MAX_P = 3, 6, 9


def _setup(seed, eos_boost=0.0):
    params = jax.tree.map(np.array, jd.decoder_init(jax.random.PRNGKey(seed), JCFG))
    params["classifier"]["bias"][JCFG.eos_id] += eos_boost
    rng = np.random.default_rng(seed)
    memory = (rng.standard_normal((B, T_MEM, JCFG.d_model)) * 0.5).astype(np.float32)
    pad = rng.random((B, T_MEM)) > 0.7
    pad[:, 0] = False
    bos = rng.integers(1, 8, size=B).astype(np.int32)
    forbid = rng.random(JCFG.vocab_size) > 0.5
    forbid[JCFG.eos_id] = False
    return params, memory, pad, bos, forbid


def _refuse(*_args, **_kwargs):
    raise AssertionError("a host read of a tensor")


@contextlib.contextmanager
def no_host_reads():
    """Every way to read a tensor's value on the host raises."""
    names = ("__bool__", "item", "tolist", "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, _refuse)
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


def test_the_patch_catches_a_host_read():
    with no_host_reads(), pytest.raises(AssertionError, match="host read"):
        bool(torch.ones(2).any())


def _early_schedule():
    """An EOS bias that forces every beam of every clip to end by step 3."""
    sched = np.zeros((B, MAX_P), np.float32)
    sched[:, 3:] = 1e4
    return sched


@pytest.mark.parametrize("early", [True, False], ids=["all-end-by-step-3", "full-length"])
@pytest.mark.parametrize("beam", [2, 3])
def test_beam_search_without_host_reads_equals_jax(beam, early):
    params, memory, pad, bos, forbid = _setup(10 + beam)
    sched = _early_schedule() if early else None
    kw = dict(beam_size=beam, min_pred_size=2, max_pred_size=MAX_P)
    want = jax_beam(
        jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(memory), jnp.asarray(pad),
        jnp.asarray(bos), forbid_rep_mask=jnp.asarray(forbid), kv_reorder="physical",
        eos_bias_schedule=None if sched is None else jnp.asarray(sched), **kw,
    )
    args = (to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
            torch.from_numpy(bos))
    with no_host_reads():
        got = beam_search(*args, forbid_rep_mask=torch.from_numpy(forbid),
                          eos_bias_schedule=None if sched is None else torch.from_numpy(sched),
                          **kw)
    preds = got.global_preds.numpy()
    if early:  # every hypothesis ends by step 3: EOS there or before, pad after it
        assert (preds[:, :, :4] == JCFG.eos_id).any(-1).all()
        assert (preds[:, :, 4:] == JCFG.pad_id).all()
    else:
        assert (preds[:, :, -1] != JCFG.pad_id).any()  # some beam runs to the last step
    np.testing.assert_array_equal(got.best_preds.numpy(), np.asarray(want.best_preds))
    np.testing.assert_array_equal(preds, np.asarray(want.global_preds))
    # f32 on the CPU in two frameworks: the sums differ in the last bits
    np.testing.assert_allclose(got.best_avg_lprobs.numpy(), np.asarray(want.best_avg_lprobs),
                               atol=1e-5)
    np.testing.assert_allclose(got.global_avg_lprobs.numpy(),
                               np.asarray(want.global_avg_lprobs), atol=1e-5)


@pytest.mark.parametrize("early", [True, False], ids=["all-end-at-step-3", "full-length"])
def test_greedy_search_without_host_reads_equals_jax(early):
    # a boosted EOS logit ends every row at the first step the min length allows
    params, memory, pad, bos, forbid = _setup(20, eos_boost=1e4 if early else 0.0)
    kw = dict(min_pred_size=3, max_pred_size=MAX_P)
    want = jax_greedy(jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(memory),
                      jnp.asarray(pad), jnp.asarray(bos), forbid_rep_mask=jnp.asarray(forbid),
                      **kw)
    args = (to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
            torch.from_numpy(bos))
    with no_host_reads():
        got = greedy_search(*args, forbid_rep_mask=torch.from_numpy(forbid), **kw)
    preds = got.preds.numpy()
    if early:
        assert (preds[:, 3] == JCFG.eos_id).all() and (preds[:, 4:] == JCFG.pad_id).all()
    else:
        assert (preds[:, -1] != JCFG.pad_id).any()
    np.testing.assert_array_equal(preds, np.asarray(want.preds))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-5, atol=1e-5)


def test_cached_position_table_equals_the_per_step_rows():
    table = td.position_table(torch.device("cpu"), 32, 5000)
    assert table.shape == (5000, 32) and table.dtype == torch.float32
    assert td.position_table(torch.device("cpu"), 32, 5000) is table  # built once
    for step in range(20):
        old = torch.from_numpy(td.sinusoidal_positions(step + 1, 32)[step])
        assert torch.equal(table[step].view(torch.int32), old.view(torch.int32)), step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_frontend_constants_equal_the_per_call_copies(dtype):
    cpu = torch.device("cpu")
    basis = tstft.basis_tensor(1024, cpu, dtype)
    old_basis = torch.from_numpy(tstft.dft_basis(1024)).to(cpu, dtype).float()
    assert torch.equal(basis.view(torch.int32), old_basis.view(torch.int32))
    assert tstft.basis_tensor(1024, cpu, dtype) is basis
    fb = mel_matrix_tensor(DEFAULT_LOGMEL, cpu, dtype)
    old_fb = torch.from_numpy(_mel_matrix(DEFAULT_LOGMEL)).to(cpu, dtype).float()
    assert torch.equal(fb.view(torch.int32), old_fb.view(torch.int32))
    assert mel_matrix_tensor(DEFAULT_LOGMEL, cpu, dtype) is fb


def test_use_buckets_pads_as_jax_does():
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal(n).astype(np.float32) for n in (20_000, 33_001)]
    for use_buckets in (True, False):
        want_wav, want_lens = JaxPreprocessor(params={}, use_buckets=use_buckets).load_resample(
            clips, sr=32_000)
        got_wav, got_lens = CoNeTTEPreprocessor({}, device="cpu", use_buckets=use_buckets
                                                ).load_resample(clips, sr=32_000)
        assert got_wav.shape == want_wav.shape == (2, 64_000 if use_buckets else 33_001)
        np.testing.assert_array_equal(got_wav, want_wav)
        np.testing.assert_array_equal(got_lens, want_lens)


def test_eval_and_disable_grad_as_jax_does():
    module = torch.nn.Linear(2, 2)
    assert jax_model.eval_and_disable_grad(object()) is None
    assert tmodel.eval_and_disable_grad(module) is None
    assert not module.training and not any(p.requires_grad for p in module.parameters())


@pytest.mark.parametrize("n_samples", [0, 319, 320, 32_000, 320_000])
def test_num_frames_as_jax(n_samples):
    assert tstft.num_frames(n_samples, 1024, 320) == jstft.num_frames(n_samples, 1024, 320)


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_power_to_db_as_jax(top_db):
    power = np.random.default_rng(1).random((4, 64)).astype(np.float32) ** 8
    power[0, :3] = 0.0
    np.testing.assert_array_equal(tmel.power_to_db(power, top_db=top_db),
                                  jmel.power_to_db(power, top_db=top_db))


def test_embedding_init_as_jax():
    want = jl.embedding_init(jax.random.PRNGKey(0), 400, 64, padding_idx=3)["weight"]
    got = tl.embedding_init(torch.Generator().manual_seed(0), 400, 64, padding_idx=3)["weight"]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert not got[3].any() and not np.asarray(want[3]).any()
    # both draw N(0, 1) (different generators): the same moments
    rest = np.delete(got.numpy(), 3, axis=0)
    assert abs(rest.mean()) < 0.02 and abs(rest.std() - 1.0) < 0.02


def test_init_cache_and_count_params_as_jax():
    params, memory, pad, _, _ = _setup(30)
    jcache, jctx = jd.init_cache(jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(memory),
                                 jnp.asarray(pad), 7)
    cache, ctx = td.init_cache(to_torch(params), TCFG, torch.from_numpy(memory),
                               torch.from_numpy(pad), 7)
    np.testing.assert_allclose(ctx.cross_k.numpy(), np.asarray(jctx.cross_k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ctx.cross_v.numpy(), np.asarray(jctx.cross_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ctx.memory_pad.numpy(), np.asarray(jctx.memory_pad))
    # the port keeps K and V of a layer in one (rows, 2, H, L, dh) buffer
    assert len(cache) == len(jcache.self_k) == JCFG.num_layers
    for buf, k, v in zip(cache, jcache.self_k, jcache.self_v):
        assert buf.shape == (k.shape[0], 2, *k.shape[1:]) and not buf.any()
        assert not np.asarray(k).any() and not np.asarray(v).any()
    assert td.count_params(to_torch(params)) == jd.count_params(params)
    enc = convnext_init(torch.Generator().manual_seed(0), depths=(1, 1, 1, 1))
    assert td.count_params(enc) == jd.count_params(to_numpy(enc))


def test_graph_cache_runs_eagerly_on_the_cpu():
    cache = GraphCache(max_graphs=2)
    calls = []

    def fn(a, b):
        calls.append((a.device, b.device))
        return a + b

    out = cache.run("k", fn, (np.ones(3, np.float32), torch.ones(3)), torch.device("cpu"))
    assert torch.equal(out, torch.full((3,), 2.0)) and calls == [(torch.device("cpu"),) * 2]
    assert not cache.programs  # no graph on the CPU


@pytest.mark.parametrize("b", [1, 3, 4, 11])
def test_run_in_batches_pads_and_cuts_to_fixed_rows(b):
    """Chunks of 4 rows under the key (4, *key), a short one padded with its
    first row; the unbatched input passed whole; each chunk's outputs copied
    out of the run's one static buffer before the next run overwrites it."""
    static = torch.zeros(4, 2)
    keys, chunks = [], []

    def run(key, xs):
        a, c, extra = xs
        keys.append(key)
        chunks.append((np.array(a), c.clone(), extra))
        static.copy_(torch.as_tensor(a) * 2 + c[:, None])
        return static, c + 1

    a = np.arange(b * 2, dtype=np.float32).reshape(b, 2)
    c = torch.arange(10, 10 + b)
    extra = np.ones(5)
    out, out_c = run_in_batches(run, ("k",), (a, c, extra), n_batched=2, rows=4)
    n_chunks = -(-b // 4)
    assert keys == [(4, "k")] * n_chunks
    for i, (ca, cc, ce) in enumerate(chunks):
        n = min(4, b - 4 * i)
        np.testing.assert_array_equal(ca[:n], a[4 * i:4 * i + n])
        np.testing.assert_array_equal(ca[n:], np.repeat(a[4 * i:4 * i + 1], 4 - n, axis=0))
        assert torch.equal(cc[n:], c[4 * i].repeat(4 - n)) and ce is extra
    assert torch.equal(out, torch.from_numpy(a) * 2 + c[:, None].float())
    assert torch.equal(out_c, c + 1)
