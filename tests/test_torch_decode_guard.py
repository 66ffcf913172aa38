"""The decode's early exit on the CPU: beam and greedy search under a step
guard that runs a step's body only while the previous step left a beam (a
row) alive, reading the flag on the host, as a CUDA graph *if* node does on
the card. Their tokens equal conette_tpu's ``while_loop`` searches, their
lprobs agree within 1e-5 at f32, exactly as many bodies run as JAX's loop
runs, and a batch padded by repeating its first row runs as many steps as
the batch itself. The default guard, which runs every step, still reads
nothing back to the host and equals JAX as well."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.decoding.beam import beam_search as jax_beam
from conette_tpu.decoding.greedy import greedy_search as jax_greedy
from conette_tpu.models import decoder as jd
from conette_torch.decoding.beam import beam_search
from conette_torch.decoding.greedy import greedy_search
from conette_torch.decoding.guard import every_step
from conette_torch.graphs import _pad_rows, conditional_step
from conette_torch.models import decoder as td
from conette_torch.weights import to_torch
from test_torch_graph_path import CFG_KW, no_host_reads

JCFG = jd.DecoderConfig(**CFG_KW)
TCFG = td.DecoderConfig(**CFG_KW)
B, T_MEM, MAX_P, MIN_P = 4, 6, 9, 2
EOS_FORCE = 1.0e4
# captions of these lengths (EOS included) end the beams of each clip at
# different steps; the loop leaves after the longest
LENGTHS = np.array([4, 7, 5, 6])
# a classifier EOS bias that ends greedy rows after 4, 6, 4 and 6 tokens
# (seed 35), and one that leaves them running to MAX_P
GREEDY_SEED = 35
GREEDY_EOS_BIAS = {"rows-end-at-4-and-6": 1.0, "full-length": 0.0}


class HostGuard:
    """Runs a step's body only while its flag is set, reading the flag on
    the host: the CPU's stand-in for the graph's *if* node. Counts the
    bodies it ran."""

    def __init__(self) -> None:
        self.ran = 0

    def __call__(self, flag: torch.Tensor, body) -> None:
        if bool(flag):
            self.ran += 1
            body()


def _setup(seed, eos_bias=0.0, rows=B):
    params = jax.tree.map(np.array, jd.decoder_init(jax.random.PRNGKey(seed), JCFG))
    params["classifier"]["bias"][JCFG.eos_id] += eos_bias
    rng = np.random.default_rng(seed)
    memory = (rng.standard_normal((rows, T_MEM, JCFG.d_model)) * 0.5).astype(np.float32)
    pad = rng.random((rows, T_MEM)) > 0.7
    pad[:, 0] = False
    bos = rng.integers(1, 8, size=rows).astype(np.int32)
    forbid = rng.random(JCFG.vocab_size) > 0.5
    forbid[JCFG.eos_id] = False
    return params, memory, pad, bos, forbid


def _schedule(lengths):
    """The EOS bias that ends every beam of clip b after ``lengths[b]``
    tokens (``bench.py``'s ``eos_schedule``)."""
    steps = np.arange(MAX_P)[None, :]
    return np.where(steps >= lengths[:, None] - 1, EOS_FORCE, 0.0).astype(np.float32)


def _loop_count(hypotheses: np.ndarray) -> int:
    """The steps JAX's ``while_loop`` ran: the longest hypothesis through
    its EOS (``MAX_P`` for one that never emitted EOS)."""
    is_eos = hypotheses == JCFG.eos_id
    ends = np.where(is_eos.any(-1), is_eos.argmax(-1) + 1, MAX_P)
    return int(ends.max())


def _jax_beam(params, memory, pad, bos, forbid, sched, beam):
    return jax_beam(
        jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(memory), jnp.asarray(pad),
        jnp.asarray(bos), beam_size=beam, min_pred_size=MIN_P, max_pred_size=MAX_P,
        forbid_rep_mask=jnp.asarray(forbid), kv_reorder="physical",
        eos_bias_schedule=None if sched is None else jnp.asarray(sched))


def _beam(params, memory, pad, bos, forbid, sched, beam, guard):
    return beam_search(
        to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
        torch.from_numpy(bos), beam_size=beam, min_pred_size=MIN_P, max_pred_size=MAX_P,
        forbid_rep_mask=torch.from_numpy(forbid),
        eos_bias_schedule=None if sched is None else torch.from_numpy(sched), guard=guard)


def _assert_beam_equal(got, want):
    np.testing.assert_array_equal(got.best_preds.numpy(), np.asarray(want.best_preds))
    np.testing.assert_array_equal(got.global_preds.numpy(), np.asarray(want.global_preds))
    # f32 on the CPU in two frameworks: the sums differ in the last bits
    np.testing.assert_allclose(got.best_avg_lprobs.numpy(), np.asarray(want.best_avg_lprobs),
                               atol=1e-5)
    np.testing.assert_allclose(got.global_avg_lprobs.numpy(),
                               np.asarray(want.global_avg_lprobs), atol=1e-5)


@pytest.mark.parametrize("scripted", [True, False], ids=["scripted-lengths", "full-length"])
@pytest.mark.parametrize("beam", [2, 3])
def test_guarded_beam_search_equals_jax_and_runs_its_steps(beam, scripted):
    params, memory, pad, bos, forbid = _setup(40 + beam)
    sched = _schedule(LENGTHS) if scripted else None
    want = _jax_beam(params, memory, pad, bos, forbid, sched, beam)
    guard = HostGuard()
    got = _beam(params, memory, pad, bos, forbid, sched, beam, guard)
    _assert_beam_equal(got, want)
    assert guard.ran == _loop_count(np.asarray(want.global_preds))
    if scripted:  # every beam of clip b ends after LENGTHS[b] tokens
        assert guard.ran == LENGTHS.max() < MAX_P
        ends = (got.global_preds.numpy() == JCFG.eos_id).argmax(-1) + 1
        np.testing.assert_array_equal(ends, np.repeat(LENGTHS[:, None], beam, 1))
    else:
        assert guard.ran == MAX_P


@pytest.mark.parametrize("case", list(GREEDY_EOS_BIAS))
def test_guarded_greedy_search_equals_jax_and_runs_its_steps(case):
    params, memory, pad, bos, forbid = _setup(GREEDY_SEED, eos_bias=GREEDY_EOS_BIAS[case])
    kw = dict(min_pred_size=MIN_P, max_pred_size=MAX_P)
    want = jax_greedy(jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(memory),
                      jnp.asarray(pad), jnp.asarray(bos), forbid_rep_mask=jnp.asarray(forbid),
                      **kw)
    guard = HostGuard()
    got = greedy_search(to_torch(params), TCFG, torch.from_numpy(memory), torch.from_numpy(pad),
                        torch.from_numpy(bos), forbid_rep_mask=torch.from_numpy(forbid),
                        guard=guard, **kw)
    preds = got.preds.numpy()
    np.testing.assert_array_equal(preds, np.asarray(want.preds))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-5, atol=1e-5)
    assert guard.ran == _loop_count(np.asarray(want.preds))
    if GREEDY_EOS_BIAS[case]:
        ends = (preds == JCFG.eos_id).argmax(-1) + 1
        np.testing.assert_array_equal(ends, [4, 6, 4, 6])
        assert guard.ran == 6
    else:
        assert guard.ran == MAX_P


@pytest.mark.parametrize("search", ["beam3", "greedy"])
def test_rows_padded_with_the_first_row_run_as_many_steps(search):
    """``graphs.run_in_batches`` pads a short chunk by repeating its first
    row: a pad row ends when row 0 ends and holds no step open."""
    if search == "beam3":
        params, memory, pad, bos, forbid = _setup(43)
        sched = _schedule(LENGTHS)
    else:
        params, memory, pad, bos, forbid = _setup(GREEDY_SEED, eos_bias=1.0)
        sched = None
    rows = B + 3
    runs = {}
    for name, xs in (("batch", (memory, pad, bos, sched)),
                     ("padded", [None if x is None else _pad_rows(x, rows)
                                 for x in (memory, pad, bos, sched)])):
        guard = HostGuard()
        m, p, b, s = xs
        if search == "beam3":
            out = _beam(params, m, p, b, forbid, s, 3, guard)
            out = (out.best_preds, out.best_avg_lprobs, out.global_preds, out.global_avg_lprobs)
        else:
            out = tuple(greedy_search(
                to_torch(params), TCFG, torch.from_numpy(m), torch.from_numpy(p),
                torch.from_numpy(b), min_pred_size=MIN_P, max_pred_size=MAX_P,
                forbid_rep_mask=torch.from_numpy(forbid), guard=guard))
        runs[name] = (guard.ran, out)
    (n_batch, batch), (n_padded, padded) = runs["batch"], runs["padded"]
    assert n_padded == n_batch < MAX_P
    for a, b in zip(batch, padded):
        torch.testing.assert_close(b[:B], a, rtol=0, atol=0)


@pytest.mark.parametrize("guard", [every_step, conditional_step], ids=["every_step", "conditional"])
@pytest.mark.parametrize("search", ["beam2", "beam3", "greedy"])
def test_unread_guards_run_every_step_and_equal_jax(search, guard):
    """The default guard, and the captured programs' guard outside a
    capture (here on the CPU), run every step with no host read: the
    fixed-step program, still equal to JAX's early exit."""
    if search == "greedy":
        params, memory, pad, bos, forbid = _setup(GREEDY_SEED, eos_bias=1.0)
        kw = dict(min_pred_size=MIN_P, max_pred_size=MAX_P)
        want = jax_greedy(jax.tree.map(jnp.asarray, params), JCFG, jnp.asarray(memory),
                          jnp.asarray(pad), jnp.asarray(bos),
                          forbid_rep_mask=jnp.asarray(forbid), **kw)
        with no_host_reads():
            got = greedy_search(to_torch(params), TCFG, torch.from_numpy(memory),
                                torch.from_numpy(pad), torch.from_numpy(bos),
                                forbid_rep_mask=torch.from_numpy(forbid), guard=guard, **kw)
        np.testing.assert_array_equal(got.preds.numpy(), np.asarray(want.preds))
        np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-5,
                                   atol=1e-5)
        return
    beam = int(search[-1])
    params, memory, pad, bos, forbid = _setup(40 + beam)
    sched = _schedule(LENGTHS)
    want = _jax_beam(params, memory, pad, bos, forbid, sched, beam)
    with no_host_reads():
        got = _beam(params, memory, pad, bos, forbid, sched, beam, guard)
    _assert_beam_equal(got, want)
