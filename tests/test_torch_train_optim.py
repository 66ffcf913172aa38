"""The port's optimizer, schedules, averaging and train step against
conette_tpu's optax ones, on the CPU at f32: one AdamW step with the
custom weight-decay split, global-norm clipping with 2-step accumulation
(``optax.MultiSteps``) over 4 steps, every schedule of ``get_schedule`` at
each epoch of a short run, ``ReduceLROnPlateau``, EMA and SWA, and five
train steps on a fixed batch (dropout 0, mixup off, no augmentation)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conette_tpu.train import objective as jax_obj
from conette_tpu.train import optim as jax_optim
from conette_tpu.train import step as jax_step
from conette_torch.train import optim, step
from conette_torch.weights import named_leaves, to_numpy, to_torch
from test_torch_train_model import PAD, batch, j_batch, jax_params, small_cfg, t_batch

LR, WD = 5e-3, 2.0


def grads_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(np.shape(p)) * scale).astype(np.float32), params)


def max_abs(a_tree, b_tree, key_bias=True):
    """The largest difference of two trees; ``key_bias=False`` leaves out
    the attention key biases. Their gradient is zero in exact arithmetic
    (each shifts every score of a row alike), so each package's is rounding
    noise (~1e-9), which Adam divides by its own root mean square: a step
    moves them by up to the lr either way, in both packages, apart."""
    fa, fb = dict(named_leaves(to_numpy(a_tree))), dict(named_leaves(to_numpy(b_tree)))
    assert fa.keys() == fb.keys()
    return max(float(np.abs(fa[k].astype(np.float64) - fb[k]).max()) for k in fa
               if key_bias or not k.endswith("k/bias"))


def jax_adamw(params):
    return optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD,
                       mask=jax_optim.decay_mask(params))


def feed(grads):
    """A loss whose gradient is ``grads`` (a tree of arrays), for the
    port's train step."""
    flat = {k: torch.from_numpy(np.asarray(g)) for k, g in named_leaves(grads)}

    def loss_fn(params, batch, gen):
        return sum((t * flat[k]).sum() for k, t in named_leaves(params))

    return loss_fn


def test_adamw_step_with_the_custom_split_matches_optax():
    """Two steps fed the same gradients: parameters within 1e-6 of
    ``optax.adamw(mask=decay_mask)`` (torch decays before its Adam update,
    optax adds ``wd·p`` to it; the same to f32 rounding). Biases and norms
    are not decayed: with zero gradients they stay as they are."""
    jcfg, _ = small_cfg()
    params = jax_params(jcfg)
    tx = jax_adamw(params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    tp = to_torch(params)
    opt, sched = optim.get_optimizer(tp, "AdamW", lr=LR, weight_decay=WD, sched_name="none")
    assert [g["weight_decay"] for g in opt.param_groups] == [WD, 0.0]
    assert all(t.ndim >= 2 for t in opt.param_groups[0]["params"])
    assert all(t.ndim < 2 for t in opt.param_groups[1]["params"])
    for seed in (1, 2):
        g = grads_like(params, seed)
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
        gd = dict(named_leaves(g))
        for name, t in named_leaves(tp):
            t.grad = torch.from_numpy(np.asarray(gd[name]))
        opt.step()
        assert max_abs(params, tp) <= 1e-6
    zeros = jax.tree.map(np.zeros_like, params)
    before = to_numpy(tp)
    for t in [t for _, t in named_leaves(tp)]:
        t.grad = torch.zeros_like(t)
    opt.step()
    for name, t in named_leaves(tp):
        if t.ndim < 2:  # the Adam moments still move them; no decay term
            want = dict(named_leaves(before))[name]
            upd, _ = update(zeros, state, params)
            np.testing.assert_allclose(t.detach().numpy(), want + np.asarray(dict(named_leaves(upd))[name]),
                                       atol=1e-6)


def test_clip_and_accumulate_match_optax_multisteps():
    """``chain(clip_by_global_norm(1), adamw)`` under ``MultiSteps(k=2)``
    over 4 calls with gradients large enough to clip: the parameters stay
    put on calls 1 and 3 and match optax within 1e-6 after each call; the
    clip has no epsilon in its divisor (``clip_grad_norm_`` divides by
    norm + 1e-6, a 1e-6/norm relative difference)."""
    jcfg, tcfg = small_cfg()
    params = jax_params(jcfg, seed=1)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), jax_adamw(params)), every_k_schedule=2)
    state = tx.init(params)
    update = jax.jit(tx.update)
    tp = to_torch(params)
    opt, _ = optim.get_optimizer(tp, "AdamW", lr=LR, weight_decay=WD, sched_name="none")
    ts = step.init_train_state(tp, opt)
    for i in range(4):
        g = grads_like(params, 10 + i, scale=0.5)
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
        before = to_numpy(ts.params)
        train_step = step.make_train_step(tcfg, grad_clip_norm=1.0, accumulate_grad_batches=2,
                                          loss_fn=feed(g))
        ts, metrics = train_step(ts, {}, None)
        assert float(metrics["train/grad_norm"]) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        if i % 2 == 0:
            assert max_abs(before, ts.params) == 0.0
        assert max_abs(params, ts.params) <= 1e-6, i
    assert ts.step == 4 and opt.state[tp["projection"]["weight"]]["step"].item() == 2


def test_clip_by_global_norm_matches_optax():
    g = grads_like({"a": np.zeros((3, 4)), "b": np.zeros(5)}, 3, scale=2.0)
    for max_norm in (0.5, 1e3):
        want = optax.clip_by_global_norm(max_norm).update(g, None)[0]
        got = [torch.from_numpy(np.asarray(v)).clone() for _, v in named_leaves(g)]
        step.clip_by_global_norm_(got, max_norm)
        for (_, w), t in zip(named_leaves(want), got):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6)


SCHEDULES = [
    ("cos_decay", {}),
    ("trf", {"warmup_steps": 3}),
    ("multistep", {"milestones": [2, 4], "gamma": 0.5}),
    ("swalr", {"swa_lr": 0.01, "anneal_epochs": 3}),
    ("swalr", {"swa_lr": 0.01, "anneal_epochs": 3, "anneal_strategy": "cos"}),
    ("cyclic_cos_decay", {"init_decay_epochs": 3, "min_decay_lr": 1e-4}),
    ("cyclic_cos_decay", {"init_decay_epochs": 2, "min_decay_lr": 1e-4, "restart_interval": 2,
                          "warmup_epochs": 2, "warmup_start_lr": 1e-5}),
    ("cyclic_cos_decay", {"init_decay_epochs": 2, "min_decay_lr": 1e-4, "restart_interval": 2,
                          "restart_interval_multiplier": 1.5, "restart_lr": 2e-3}),
    ("none", {}),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULES, ids=lambda v: v if isinstance(v, str) else None)
def test_every_schedule_matches_jax_at_each_epoch(name, kwargs):
    """lr at each epoch 0..11 of a 6-epoch run within 1e-6 of the base lr
    (JAX's schedules compute in f32, the port's in Python floats)."""
    want = jax_optim.get_schedule(name, 1e-3, 6, **kwargs)
    got = optim.get_schedule(name, 1e-3, 6, **kwargs)
    for epoch in range(12):
        assert got(epoch) == pytest.approx(float(want(jnp.asarray(epoch))), rel=0, abs=1e-9), epoch


def test_lr_is_set_per_epoch_where_jax_main_indexes_the_optimizer_step():
    """A difference of wiring, logged in ROADMAP Queue 3: ``conette_tpu``'s
    ``main_train`` gives optax the schedule of ``max_epochs`` steps, which
    optax reads at its update count, so its lr moves every step; the port
    (as the reference, whose scheduler steps each epoch) sets the lr of
    epoch e for all of epoch e's steps."""
    params = {"w": np.ones((2, 2), np.float32)}
    tx, state = jax_optim.get_optimizer(params, lr=1e-3, weight_decay=0.0, sched_name="cos_decay",
                                        sched_n_steps=4)
    g = {"w": np.ones((2, 2), np.float32)}
    lrs_jax = []
    for _ in range(3):  # three steps of epoch 0: Adam's first updates are -lr·sign(g)
        before = params["w"].copy()
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        lrs_jax.append(float(before[0, 0] - params["w"][0, 0]))
    sched = optim.get_schedule("cos_decay", 1e-3, 4)
    np.testing.assert_allclose(lrs_jax, [sched(0), sched(1), sched(2)], rtol=1e-4)
    opt, _ = optim.get_optimizer({"w": torch.ones(2, 2)}, lr=1e-3, weight_decay=0.0,
                                 sched_name="cos_decay", sched_n_steps=4)
    assert opt.param_groups[0]["lr"] == sched(0)  # epoch 0, whatever the step


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.95, 0.96, 0.97, 0.98, 0.99, 0.5, 0.6, 0.7]
    for kw in ({"patience": 2, "factor": 0.5}, {"patience": 1, "factor": 0.1, "cooldown": 2,
                                                 "min_lr_factor": 0.02}, {"mode": "max", "patience": 1}):
        j, t = jax_optim.ReduceLROnPlateau(**kw), optim.ReduceLROnPlateau(**kw)
        assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]
        assert t.factor < 1.0


def test_ema_and_swa_match_jax():
    jcfg, _ = small_cfg()
    a, b = jax_params(jcfg, 1), jax_params(jcfg, 2)
    want = jax_optim.ema_update(a, b, 0.9)
    got = optim.ema_update(to_torch(a), to_torch(b), 0.9)
    assert max_abs(want, got) <= 1e-7
    want = jax_optim.swa_update(a, b, 3)
    got = optim.swa_update(to_torch(a), to_torch(b), 3)
    assert max_abs(want, got) <= 1e-7
    snap = optim.snapshot(to_torch(a))
    assert all(not t.requires_grad for _, t in named_leaves(snap))


def test_five_train_steps_track_jax():
    """Five steps of ``make_train_step`` on one batch (dropout 0, mixup off,
    no augmentation, clip 1, AdamW with the split at a constant lr): each
    step's loss and gradient norm within 1e-5 relative of JAX's
    ``make_train_step``, and the parameters after the fifth within 1e-4,
    the attention key biases apart (``max_abs``): those within 2·5·lr."""
    jcfg, tcfg = small_cfg()
    params = jax_params(jcfg, seed=4)
    b = batch(9)
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_adamw(params))
    jstate = jax_step.init_train_state(params, tx)
    jfn = jax_step.make_train_step(jcfg, tx, use_mixup=False, donate=False)
    tp = to_torch(params)
    opt, _ = optim.get_optimizer(tp, "AdamW", lr=LR, weight_decay=WD, sched_name="none")
    ts = step.init_train_state(tp, opt)
    tfn = step.make_train_step(tcfg, use_mixup=False, grad_clip_norm=1.0)
    losses = []
    for i in range(5):
        jstate, jm = jfn(jstate, j_batch(b), jax.random.PRNGKey(0))
        ts, tm = tfn(ts, t_batch(b), torch.Generator().manual_seed(0))
        losses.append((float(jm["train/loss"]), tm["train/loss"].item()))
        assert tm["train/loss"].item() == pytest.approx(float(jm["train/loss"]), rel=1e-5), i
        assert tm["train/grad_norm"].item() == pytest.approx(float(jm["train/grad_norm"]), rel=1e-5)
    assert losses[-1][1] < losses[0][1]
    assert max_abs(jstate.params, ts.params, key_bias=False) <= 1e-4
    assert max_abs(jstate.params, ts.params) <= 2 * 5 * LR


def test_pad_row_stays_zero_after_a_mixup_step():
    """A step with mixup (fixed λ and pairing): the PAD embedding row gets
    a zero gradient and stays exactly zero after AdamW's step, in both
    packages; the other parameters within 1e-5 (``max_abs``: an element
    whose gradient is near Adam's eps of 1e-8 turns the gradients' 1e-5
    relative difference into up to that much of its update)."""
    jcfg, tcfg = small_cfg()
    params = jax_params(jcfg, seed=5)
    b = batch(10)
    perm = np.array([1, 2, 3, 0])
    tx = jax_adamw(params)

    def jloss(p):
        return jax_obj.training_loss(p, jcfg, j_batch(b), jax.random.PRNGKey(0),
                                     mixup_override=(jnp.float32(0.7), jnp.asarray(perm)))

    g = jax.jit(jax.grad(jloss))(params)
    upd, _ = jax.jit(tx.update)(g, tx.init(params), params)
    jparams = optax.apply_updates(params, upd)
    tp = to_torch(params)
    opt, _ = optim.get_optimizer(tp, "AdamW", lr=LR, weight_decay=WD, sched_name="none")
    ts = step.init_train_state(tp, opt)

    def loss_fn(p, bt, gen):
        return step.training_loss(p, tcfg, bt, gen, mixup_override=(0.7, torch.from_numpy(perm)))

    ts, _ = step.make_train_step(tcfg, loss_fn=loss_fn)(ts, t_batch(b), None)
    assert np.count_nonzero(np.asarray(jparams["decoder"]["emb"]["weight"][PAD])) == 0
    assert torch.count_nonzero(ts.params["decoder"]["emb"]["weight"][PAD]) == 0
    assert max_abs(jparams, ts.params, key_bias=False) <= 1e-5
