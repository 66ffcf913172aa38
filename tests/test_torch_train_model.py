"""The training forms of the port's model against conette_tpu, on the CPU
at f32 and small widths: dropout, drop_path and training-mode batch norm,
the teacher-forcing decoder, ``embed_tokens`` with its frozen PAD row, the
training loss and its gradients (dropout 0, mixup fixed by
``mixup_override`` since the two packages' generators draw different
numbers), the per-reference validation losses, and the draws of λ and of
the mixup pairing by their ranges."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conette_tpu.models import conette as jax_conette
from conette_tpu.models import layers as jax_layers
from conette_tpu.train import objective as jax_obj
from conette_torch.models import conette, decoder, layers
from conette_torch.train import objective
from conette_torch.weights import named_leaves, to_torch

VOCAB, PAD, BOS, EOS = 40, 0, 1, 2


def small_cfg(**kw):
    base = dict(vocab_size=VOCAB, proj_in=48, d_model=32, nhead=2, num_decoder_layers=2,
                dim_feedforward=64, proj_dropout_p=0.0, decoder_dropout_p=0.0,
                label_smoothing=0.2, mixup_alpha=0.4, bos_id=BOS, eos_id=EOS, pad_id=PAD)
    base.update(kw)
    return jax_conette.ConetteConfig(**base), conette.ConetteConfig(**base)


@functools.lru_cache(maxsize=None)
def jax_params(cfg, seed=0):
    """JAX's initial parameters (a tree of immutable arrays, so shared)."""
    return jax.jit(jax_conette.conette_init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def captions(rng, b, length, task_ids=(5, 6)):
    """(B, L) ids: a task token, 2..L-2 words, EOS, then PAD."""
    caps = np.full((b, length), PAD, np.int64)
    for i in range(b):
        n = rng.integers(2, length - 1)
        caps[i, 0] = task_ids[i % len(task_ids)]
        caps[i, 1:n] = rng.integers(7, VOCAB, n - 1)
        caps[i, n] = EOS
    return caps


def batch(seed=0, b=4, t=7, length=9, proj_in=48):
    rng = np.random.default_rng(seed)
    return {
        "audio": rng.standard_normal((b, t, proj_in)).astype(np.float32),
        "audio_lens": rng.integers(3, t + 1, b).astype(np.int64),
        "captions": captions(rng, b, length),
    }


def t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def j_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


# ------------------------------------------------------------------ layers
def test_batch_norm_train_matches_jax():
    """Batch statistics and the running-statistics update within 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 4, 6)).astype(np.float32) * 2 + 1
    p = {"weight": rng.standard_normal(6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32),
         "running_mean": rng.standard_normal(6).astype(np.float32),
         "running_var": rng.random(6).astype(np.float32) + 0.5}
    for axis in (-1, 1):
        want_y, want_s = jax_layers.batch_norm_train(jax.tree.map(jnp.asarray, p), jnp.asarray(x), axis=axis)
        got_y, got_s = layers.batch_norm_train(to_torch(p), torch.from_numpy(x), axis=axis)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-6)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), rtol=1e-6, atol=1e-6)


def test_dropout_and_drop_path_draw_from_the_generator():
    x = torch.ones((4000, 8))
    gen = torch.Generator().manual_seed(0)
    y = layers.dropout(gen, x, 0.2, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    again = layers.dropout(torch.Generator().manual_seed(0), x, 0.2, deterministic=False)
    assert torch.equal(y, again)
    assert layers.dropout(None, x, 0.2, deterministic=True) is x
    assert layers.dropout(None, x, 0.0, deterministic=False) is x
    with pytest.raises(ValueError, match="Generator"):
        layers.dropout(None, x, 0.2, deterministic=False)
    rows = layers.drop_path(gen, x, 0.5, deterministic=False)
    row_kept = (rows != 0).all(dim=1)
    assert ((rows == 0).all(dim=1) | row_kept).all()  # whole rows
    assert 0.45 < row_kept.float().mean().item() < 0.55


# ---------------------------------------------------------- teacher forcing
@pytest.mark.parametrize("embedded", [False, True])
def test_forward_forcing_matches_jax(embedded):
    """``forward_forcing`` (causal mask, both key-padding masks) → (B, vocab,
    L) logits within 1e-5 of JAX's, from ids or from embeddings."""
    jcfg, tcfg = small_cfg()
    params = jax_params(jcfg)
    b = batch(1)
    caps_in = b["captions"][:, :-1]
    mem_j, pad_j = jax_conette.encode_audio(params, jcfg, jnp.asarray(b["audio"]), jnp.asarray(b["audio_lens"]))
    tp = to_torch(params)
    mem_t, pad_t = conette.encode_audio(tp, tcfg, torch.from_numpy(b["audio"]), torch.from_numpy(b["audio_lens"]))
    if embedded:
        x_j = jax_conette.embed_tokens(params, jnp.asarray(caps_in), pad_id=PAD)
        x_t = conette.embed_tokens(tp, torch.from_numpy(caps_in), pad_id=PAD)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    else:
        x_j, x_t = jnp.asarray(caps_in), torch.from_numpy(caps_in)
    mask = caps_in == PAD
    want = jax.jit(lambda p, m, pm, x, cm: jax_conette.forward_forcing(
        p, jcfg, m, pm, x, caps_in_pad_mask=cm, caps_in_embedded=embedded))(
        params, mem_j, pad_j, x_j, jnp.asarray(mask))
    got = conette.forward_forcing(tp, tcfg, mem_t, pad_t, x_t, caps_in_pad_mask=torch.from_numpy(mask),
                                  caps_in_embedded=embedded)
    assert got.shape == (4, VOCAB, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_decoder_forward_training_mode_uses_every_dropout_site():
    """With dropout on, the pass draws from the generator (two generators of
    one seed give the same logits, another seed other logits) and equals the
    deterministic pass at rate 0."""
    _, tcfg = small_cfg(decoder_dropout_p=0.3)
    dcfg = tcfg.decoder_config()
    params = conette.conette_init(torch.Generator().manual_seed(0), tcfg)["decoder"]
    b = t_batch(batch(2))
    mem = torch.randn((4, 7, 32), generator=torch.Generator().manual_seed(1))
    ids = b["captions"][:, :-1]

    def run(seed, deterministic=False, cfg=dcfg):
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        return decoder.decoder_forward(params, cfg, mem, ids, caps_in_pad_mask=ids == PAD,
                                       deterministic=deterministic, gen=gen)

    assert torch.equal(run(3), run(3))
    assert not torch.allclose(run(3), run(4))
    off = run(None, deterministic=True)
    assert not torch.allclose(run(3), off)
    torch.testing.assert_close(run(5, cfg=dcfg._replace(dropout_p=0.0)), off)


# ------------------------------------------------------------ the objective
@pytest.mark.parametrize("lbd", [0.5, 0.83])
def test_training_loss_and_gradients_match_jax(lbd):
    """The training loss (mixup with a fixed (λ, perm), teacher forcing,
    label smoothing 0.2) within 1e-6 relative, every gradient within 1e-5 of
    its leaf's largest value, and the PAD row's gradient exactly 0 in both.
    The attention key biases have a gradient of zero in exact arithmetic
    (each shifts every score of a row alike); both packages give rounding
    noise there, held below 1e-8."""
    jcfg, tcfg = small_cfg()
    params = jax_params(jcfg, seed=3)
    b = batch(4)
    perm = np.array([2, 3, 1, 0])

    def jax_loss(p):
        return jax_obj.training_loss(p, jcfg, j_batch(b), jax.random.PRNGKey(0),
                                     mixup_override=(jnp.float32(lbd), jnp.asarray(perm)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    tp = to_torch(params)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(tp)]
    loss = objective.training_loss(tp, tcfg, t_batch(b), None,
                                   mixup_override=(lbd, torch.from_numpy(perm)))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    want_flat = dict(named_leaves(jax.tree.map(np.asarray, want_grads)))
    for (name, _), g in zip(named_leaves(tp), grads):
        if name.endswith("k/bias"):
            assert max(np.abs(want_flat[name]).max(), g.abs().max().item()) < 1e-8, name
        else:
            assert rel(want_flat[name], g.numpy()) <= 1e-5, name
    emb_grad = dict(zip([n for n, _ in named_leaves(tp)], grads))["decoder/emb/weight"]
    assert torch.count_nonzero(emb_grad[PAD]) == 0
    assert np.count_nonzero(want_flat["decoder/emb/weight"][PAD]) == 0
    # the pad row does move without the freeze: mixup leaks emb[pad]
    free = conette.embed_tokens(tp, t_batch(b)["captions"][:, :-1])
    (free * 0 + free).sum().backward()
    assert torch.count_nonzero(tp["decoder"]["emb"]["weight"].grad[PAD]) > 0


def test_label_smoothed_ce_equals_jax_and_torch_cross_entropy():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, VOCAB, 6)).astype(np.float32) * 3
    targets = captions(rng, 3, 7)[:, 1:]
    want = jax_obj.label_smoothed_ce(jnp.asarray(logits), jnp.asarray(targets), PAD, 0.2)
    got = objective.label_smoothed_ce(torch.from_numpy(logits), torch.from_numpy(targets), PAD, 0.2)
    lib = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), ignore_index=PAD,
                          label_smoothing=0.2)
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    assert abs(got.item() - lib.item()) <= 1e-6 * abs(lib.item())
    per = objective.per_caption_ce(torch.from_numpy(logits), torch.from_numpy(targets), PAD)
    np.testing.assert_allclose(per.numpy(), np.asarray(
        jax_obj.per_caption_ce(jnp.asarray(logits), jnp.asarray(targets), PAD)), rtol=1e-6)


def test_per_ref_losses_and_validation_loss_match_jax():
    """(B, R, L) references with all-pad rows that carry the task token in
    column 0 (clips with fewer references than the batch's most): those rows
    are invalid in both packages, the rest within 1e-5."""
    jcfg, tcfg = small_cfg()
    params = jax_params(jcfg, seed=6)
    b = batch(7, b=3)
    rng = np.random.default_rng(8)
    mult = np.stack([captions(rng, 3, 9, task_ids=(5,)) for _ in range(4)], axis=1)
    mult[0, 3, 1:] = PAD
    mult[2, 2:, 1:] = PAD
    vb = {"audio": b["audio"], "audio_lens": b["audio_lens"], "mult_captions": mult}
    want_l, want_v = jax.jit(lambda p, b: jax_obj.per_ref_losses(p, jcfg, b))(params, j_batch(vb))
    got_l, got_v = objective.per_ref_losses(to_torch(params), tcfg, t_batch(vb))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.sum() == 9 and not got_v[0, 3] and not got_v[2, 2:].any()
    np.testing.assert_allclose(got_l.numpy()[got_v.numpy()], np.asarray(want_l)[np.asarray(want_v)],
                               rtol=1e-5)
    want = jax.jit(lambda p, b: jax_obj.validation_loss(p, jcfg, b))(params, j_batch(vb))
    got = objective.validation_loss(to_torch(params), tcfg, t_batch(vb))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


def test_mixup_draws_hold_their_ranges():
    """λ in [0.5, 1] (asymmetric Beta(0.4, 0.4)), with both ends reached
    and a mean near Beta's folded mean; the pairing has no fixed point."""
    gen = torch.Generator().manual_seed(0)
    lbd = torch.stack([objective.sample_lambda(gen, 0.4) for _ in range(2000)])
    assert lbd.min() >= 0.5 and lbd.max() <= 1.0
    assert lbd.min() < 0.52 and lbd.max() > 0.99
    ref = np.random.default_rng(0).beta(0.4, 0.4, 200_000)
    assert abs(lbd.mean().item() - np.maximum(ref, 1 - ref).mean()) < 0.01
    sym = torch.stack([objective.sample_lambda(gen, 0.4, asymmetric=False) for _ in range(2000)])
    assert sym.min() < 0.1 and abs(sym.mean().item() - 0.5) < 0.03
    assert objective.sample_lambda(gen, 0.0).item() == 1.0
    coins = {objective.sample_lambda(gen, 0.0, asymmetric=False).item() for _ in range(50)}
    assert coins == {0.0, 1.0}
    for n in (2, 3, 17):
        for _ in range(20):
            perm = objective.randperm_diff(gen, n)
            assert sorted(perm.tolist()) == list(range(n))
            assert (perm != torch.arange(n)).all()
