"""The Cnn family's training mode (Cnn10, Cnn14 and its frontend,
embedding and training-time variants, Cnn14_DecisionLevelAtt/Max/Avg)
against conette_tpu's at float32 on the CPU, at full width on two clips of
1.5 s: ``apply_pann_model(deterministic=False)`` takes no generator, so it
raises in both packages (JAX: ``TypeError`` for want of an rng; the port:
``ValueError`` for want of a ``torch.Generator``); with the same dropout
masks injected into both in call order (``jax.random.bernoulli`` and the
port's ``layers._keep_mask`` patched), the same call runs ``pann_apply``'s
training mode in both: batch statistics, dropout at 0.2 after each block
(0 for ``cnn14_no_dropout``) and at 0.5 twice in the clip head.
Tolerance: ``test_torch_pann_train.assert_train_close``'s (the larger of
1e-5 of the larger of 1 and each key's largest value, and 4 times the
port's own change on a waveform nudged by 1e-7; at most 1.48 times it
observed, Cnn14_DecisionLevelMax's clip output)."""

import numpy as np
import pytest
import torch

from conette_tpu.models import pann as jax_pann
from conette_torch.models import pann
from conette_torch.weights import to_torch
from test_torch_pann_train import NO_DROPOUT, assert_train_close, inject_dropout, nudged, sensitivity
from test_torch_pann_zoo import _wave, zoo_tree

CNN_FAMILY = sorted(pann.PANN_ZOO_NAMES - set(NO_DROPOUT))


def test_the_names_split_into_the_cnn_family_and_the_zoo():
    assert len(CNN_FAMILY) == 15 and len(NO_DROPOUT) == 14
    assert pann.PANN_ZOO_NAMES == jax_pann.PANN_ZOO_NAMES


@pytest.mark.parametrize("name", CNN_FAMILY)
def test_cnn_family_training_mode_matches_jax_with_injected_masks(monkeypatch, name):
    tree = zoo_tree(name)
    wav, lens = _wave()
    args = (torch.from_numpy(wav), torch.from_numpy(lens))
    with pytest.raises(TypeError, match="PRNG key"):
        jax_pann.apply_pann_model(name, tree, wav, lens, deterministic=False)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        pann.apply_pann_model(name, to_torch(tree), *args, deterministic=False)
    record, replay = inject_dropout(monkeypatch, len(name))
    want = jax_pann.apply_pann_model(name, tree, wav, lens, deterministic=False)
    tree = to_torch(tree)
    got = pann.apply_pann_model(name, tree, *args, deterministic=False)
    replay.clear()
    again = pann.apply_pann_model(name, tree, torch.from_numpy(nudged(wav)), args[1],
                                  deterministic=False)
    assert_train_close(got, want, sensitivity(got, again))
    # a block dropout at 0.2 after each of Cnn14's 6 blocks (Cnn10's 4; none
    # for cnn14_no_dropout), then the head's two at 0.5 (none with the
    # attention head; the decision-level heads run Cnn14's and drop it)
    blocks = 4 if name == "cnn10" else 6
    want_keeps = [] if name == "cnn14_no_dropout" else [0.8] * blocks
    want_keeps += [] if name == "cnn14_decisionlevelatt" else [0.5, 0.5]
    np.testing.assert_allclose([p for p, _ in record], want_keeps, rtol=1e-6)
