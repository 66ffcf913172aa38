"""The port's decoder step, beam search and greedy search against
conette_tpu at float32 on the CPU, with bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.decoding.beam import beam_search as jax_beam
from conette_tpu.decoding.greedy import greedy_search as jax_greedy
from conette_tpu.models import decoder as jd
from conette_torch.decoding.beam import beam_search, top_k_lowest_index
from conette_torch.decoding.greedy import greedy_search
from conette_torch.models import decoder as td
from conette_torch.weights import to_torch

CFG_KW = dict(vocab_size=48, d_model=32, nhead=2, num_layers=2, dim_feedforward=64,
              dropout_p=0.0, bos_id=1, eos_id=2, pad_id=0)
JCFG = jd.DecoderConfig(**CFG_KW)
TCFG = td.DecoderConfig(**CFG_KW)


def _setup(seed, b=3, t=6):
    params = jax.tree.map(np.array, jd.decoder_init(jax.random.PRNGKey(seed), JCFG))
    rng = np.random.default_rng(seed)
    memory = (rng.standard_normal((b, t, JCFG.d_model)) * 0.5).astype(np.float32)
    pad = rng.random((b, t)) > 0.7
    pad[:, 0] = False
    bos = rng.integers(1, 8, size=b).astype(np.int32)
    forbid = rng.random(JCFG.vocab_size) > 0.5
    forbid[JCFG.eos_id] = False
    return params, memory, pad, bos, forbid


def _jnp(params):
    return jax.tree.map(jnp.asarray, params)


def test_decode_step_logits_match_jax_physical():
    params, memory, pad, _, _ = _setup(0, b=2)
    beams, steps = 3, 5
    rng = np.random.default_rng(1)
    jctx = jd.init_cross(params, JCFG, jnp.asarray(memory), jnp.asarray(pad))
    jcache = jd.init_self(JCFG, 2 * beams, steps, jnp.float32)
    tp = to_torch(params)
    tctx = td.init_cross(tp, TCFG, torch.from_numpy(memory), torch.from_numpy(pad))
    tcache = td.init_self(TCFG, 2 * beams, steps, torch.float32, "cpu")
    for step in range(steps):
        tok = rng.integers(0, JCFG.vocab_size, size=2 * beams).astype(np.int32)
        jl, jcache = jd.decode_step(params, JCFG, jcache, jctx, jnp.asarray(tok), jnp.int32(step))
        tl = td.decode_step(tp, TCFG, tcache, tctx, torch.from_numpy(tok).long(), step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        parent = rng.integers(0, beams, size=(2, beams)).astype(np.int32)
        jcache = jd.reorder_cache(jcache, jnp.asarray(parent))
        tcache = td.reorder_cache(tcache, torch.from_numpy(parent).long())


@pytest.mark.parametrize("seed,beam,max_p,eos_sched", [
    (0, 3, 10, False), (1, 2, 7, True), (2, 4, 9, False), (3, 3, 12, True),
])
def test_beam_search_matches_jax(seed, beam, max_p, eos_sched):
    params, memory, pad, bos, forbid = _setup(seed)
    sched = None
    if eos_sched:
        sched = np.zeros((3, max_p), np.float32)
        for i, length in enumerate((3, 5, max_p)):
            sched[i, length - 1:] = 1e4
    kw = dict(beam_size=beam, min_pred_size=2, max_pred_size=max_p)
    want = jax_beam(
        _jnp(params), JCFG, jnp.asarray(memory), jnp.asarray(pad), jnp.asarray(bos),
        forbid_rep_mask=jnp.asarray(forbid), kv_reorder="physical",
        eos_bias_schedule=None if sched is None else jnp.asarray(sched), **kw,
    )
    got = beam_search(
        to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
        torch.from_numpy(bos), forbid_rep_mask=torch.from_numpy(forbid),
        eos_bias_schedule=None if sched is None else torch.from_numpy(sched), **kw,
    )
    np.testing.assert_array_equal(got.best_preds.numpy(), np.asarray(want.best_preds))
    np.testing.assert_array_equal(got.global_preds.numpy(), np.asarray(want.global_preds))
    np.testing.assert_allclose(got.best_avg_lprobs.numpy(), np.asarray(want.best_avg_lprobs), atol=1e-5)
    np.testing.assert_allclose(got.global_avg_lprobs.numpy(), np.asarray(want.global_avg_lprobs), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_search_matches_jax(seed):
    params, memory, pad, bos, forbid = _setup(seed)
    kw = dict(min_pred_size=2, max_pred_size=9)
    want = jax_greedy(_jnp(params), JCFG, jnp.asarray(memory), jnp.asarray(pad), jnp.asarray(bos),
                      forbid_rep_mask=jnp.asarray(forbid), **kw)
    got = greedy_search(to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
                        torch.from_numpy(bos), forbid_rep_mask=torch.from_numpy(forbid), **kw)
    np.testing.assert_array_equal(got.preds.numpy(), np.asarray(want.preds))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-5, atol=1e-5)


def test_top_k_keeps_lowest_index_on_ties():
    x = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0, 1.0]])
    values, idx = top_k_lowest_index(x, 3)
    assert idx.tolist() == [[1, 2, 4]]
    assert values.tolist() == [[1.0, 1.0, 1.0]]


def test_beam_exact_tie_breaks_like_jax():
    """Two tokens made interchangeable (equal embedding and classifier rows,
    boosted so they lead): both stacks must pick the lower token id, at
    every step, and agree on everything else (after the JAX package's
    tests/test_beam_tiebreak.py construction)."""
    params, memory, pad, bos, _ = _setup(4)
    tok_a, tok_b = 5, 6
    params["emb"]["weight"][tok_b] = params["emb"]["weight"][tok_a]
    params["classifier"]["weight"][:, tok_b] = params["classifier"]["weight"][:, tok_a]
    params["classifier"]["bias"][[tok_a, tok_b]] = params["classifier"]["bias"][tok_a] + 2.0
    kw = dict(beam_size=3, min_pred_size=3, max_pred_size=8)
    want = jax_beam(_jnp(params), JCFG, jnp.asarray(memory), jnp.asarray(pad), jnp.asarray(bos),
                    kv_reorder="physical", **kw)
    got = beam_search(to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
                      torch.from_numpy(bos), **kw)
    assert tok_a in np.asarray(want.global_preds)  # the tie is really hit
    np.testing.assert_array_equal(got.global_preds.numpy(), np.asarray(want.global_preds))
    np.testing.assert_array_equal(got.best_preds.numpy(), np.asarray(want.best_preds))
    np.testing.assert_allclose(got.global_avg_lprobs.numpy(), np.asarray(want.global_avg_lprobs), atol=1e-5)


def test_attention_matches_jax():
    params, memory, pad, _, _ = _setup(5)
    sa = params["layers"][0]["self_attn"]
    rng = np.random.default_rng(5)
    q_in = (rng.standard_normal((3, 4, JCFG.d_model)) * 0.5).astype(np.float32)
    causal = np.triu(np.ones((4, 6), bool), k=1)
    want = jd.attention(_jnp(sa), jnp.asarray(q_in), jnp.asarray(memory), JCFG.nhead,
                        mask=jnp.asarray(causal), key_padding_mask=jnp.asarray(pad))
    got = td.attention(to_torch(sa), torch.from_numpy(q_in), torch.from_numpy(memory), TCFG.nhead,
                       mask=torch.from_numpy(causal), key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
