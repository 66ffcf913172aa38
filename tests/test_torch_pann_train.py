"""The PANN encoders' training mode (``deterministic=False``) against
conette_tpu's at float32 on the CPU, at full width on two clips of 1.5 s
(``test_torch_pann_zoo``'s trees and waveform): the zoo's architectures
through ``apply_pann_model`` (batch statistics, no dropout, as in the JAX
package); ``conv_block``'s output and updated running statistics with
either pool; and ``cnn14_decisionlevel_apply``'s ``interpolate_ratio``.
The Cnn family, whose dropout needs a generator, is in
``test_torch_pann_train_cnn.py``; gradients in
``test_torch_pann_train_grads.py``.

Tolerance. Batch statistics over few values are ill-conditioned: at two
clips of 1.5 s the last stages normalise over as few as 4 values a
channel (Res1dNet: 2 frames a clip), and a change of 1e-7 of the waveform
(f32 rounding) moves the port's own training-mode outputs by up to 1.2e-3
(Res1dNet31's frame embeddings; 2.8e-7 in inference mode). So each key is
held within the larger of ``TRAIN_REL`` = 1e-5 of the larger of 1 and its
largest absolute value, and ``COND`` = 4 times that sensitivity (the
port's outputs on the waveform scaled by 1 + 1e-7·N(0, 1), against its
outputs on the waveform); integers equal. Observed: the difference from
JAX at most 1.93 times the sensitivity (LeeNet24's frame embeddings), and
within ``TRAIN_REL`` for Cnn6, Cnn10 and the decision-level heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models import pann as jax_pann
from conette_tpu.models import pann_zoo as jax_zoo
from conette_torch.models import layers, pann, pann_zoo
from conette_torch.weights import to_torch
from test_torch_pann_zoo import _wave, zoo_tree

TRAIN_REL = 1e-5
COND = 4.0
NUDGE = 1e-7
# the zoo's architectures: batch statistics and no dropout in training mode
NO_DROPOUT = sorted({
    "cnn6", "dainet19", "leenet11", "leenet24", "mobilenetv1", "mobilenetv2", "res1dnet31",
    "res1dnet51", "resnet22", "resnet38", "resnet54", "wavegram_cnn14", "wavegram_logmel_cnn14",
    "wavegram_logmel128_cnn14",
})


def nudged(wav: np.ndarray) -> np.ndarray:
    """``wav`` scaled by 1 + ``NUDGE``·N(0, 1), about its f32 rounding."""
    noise = np.random.default_rng(0).standard_normal(wav.shape)
    return (wav * (1 + NUDGE * noise)).astype(np.float32)


def sensitivity(out: dict, out_nudged: dict) -> dict:
    """Per key, how far the port's own output moved on the nudged waveform."""
    return {k: float((v - out_nudged[k]).abs().max()) for k, v in out.items()
            if v.is_floating_point()}


def assert_train_close(got, want, sens: dict | None = None) -> None:
    """Every key (nested dicts and lists too) within the larger of
    ``TRAIN_REL`` of the larger of 1 and its largest absolute value and
    ``COND`` times its ``sens``; integers equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_train_close(got[k], want[k], None if sens is None else sens.get(k))
        return
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_train_close(g, w)
        return
    w, g = np.asarray(want), got.detach().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype
    if w.dtype.kind == "i":
        np.testing.assert_array_equal(g, w)
    else:
        atol = max(TRAIN_REL * max(1.0, float(np.abs(w).max())), COND * (sens or 0.0))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def inject_dropout(monkeypatch, seed: int) -> tuple[list, list]:
    """JAX's ``jax.random.bernoulli`` draws from a numpy generator seeded
    ``seed`` and records each (keep probability, mask); the port's
    ``layers._keep_mask`` replays the record in call order, checking each
    shape and keep probability (clear the returned replay list to replay it
    again)."""
    rng, record, replay = np.random.default_rng(seed), [], []

    def jax_bernoulli(key, p, shape):
        record.append((float(p), rng.random(tuple(shape)) < p))
        return jnp.asarray(record[-1][1])

    def port_keep_mask(gen, shape, keep, device, cols=None):
        p, m = record[len(replay)]
        replay.append(m)
        assert m.shape == tuple(shape) and p == pytest.approx(keep)
        return torch.from_numpy(m)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(layers, "_keep_mask", port_keep_mask)
    return record, replay


@pytest.mark.parametrize("name", NO_DROPOUT)
def test_zoo_training_mode_matches_jax(name):
    tree = zoo_tree(name)
    wav, lens = _wave()
    want = jax_pann.apply_pann_model(name, tree, wav, lens, deterministic=False)
    tree, lens = to_torch(tree), torch.from_numpy(lens)
    got = pann.apply_pann_model(name, tree, torch.from_numpy(wav), lens, deterministic=False)
    again = pann.apply_pann_model(name, tree, torch.from_numpy(nudged(wav)), lens, deterministic=False)
    assert_train_close(got, want, sensitivity(got, again))


@pytest.mark.parametrize("pool_type", ["avg", "max"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_conv_block_returns_its_running_statistics(pool_type, deterministic):
    """``conv_block`` → (y, [bn1, bn2] with updated running statistics in
    training mode, [] otherwise), both pools, an odd extent floored."""
    block = zoo_tree("cnn14")["blocks"][1]  # 64 → 128 channels
    x = np.random.default_rng(4).standard_normal((2, 13, 9, 64)).astype(np.float32)
    want = jax_pann.conv_block(block, jnp.asarray(x), pool_type=pool_type,
                               deterministic=deterministic)
    got = pann.conv_block(to_torch(block), torch.from_numpy(x), pool_type=pool_type,
                          deterministic=deterministic)
    assert isinstance(got, tuple) and len(got[1]) == (0 if deterministic else 2)
    assert got[0].shape == (2, 6, 4, 128)
    assert_train_close(list(got), [want[0], want[1]])


@pytest.mark.parametrize("deterministic", [True, False])
def test_decision_level_interpolate_ratio_matches_jax(monkeypatch, deterministic):
    """``interpolate_ratio`` repeats each segment that many times to the
    spectrogram's frame count, as JAX's does; in training mode the Cnn14
    body's dropout takes the injected masks."""
    tree = zoo_tree("cnn14_decisionlevelmax")
    wav, lens = _wave()
    inject_dropout(monkeypatch, 5)
    kw = dict(pooling="avg", interpolate_ratio=16, deterministic=deterministic)
    want = jax_zoo.cnn14_decisionlevel_apply(tree, wav, lens, **kw)
    got = pann_zoo.cnn14_decisionlevel_apply(to_torch(tree), torch.from_numpy(wav),
                                             torch.from_numpy(lens), **kw)
    assert_train_close(got, want)
    assert got["framewise_output"].shape[1] == wav.shape[1] // 320 + 1
