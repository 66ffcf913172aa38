"""Gradients of the PANN encoders' training mode against conette_tpu's at
float32 on the CPU, at full width on two clips of 1.5 s: ``jax.grad`` and
torch autograd of one fixed scalar of the outputs (each float output
weighted by numbers drawn from a seed), leaf by leaf, for Cnn14 (through
``apply_pann_model`` with the same dropout masks injected into both
packages) and Cnn6, ResNet22 and Res1dNet31 (no dropout).

Tolerances. A 2-D conv's bias has a gradient of zero in exact arithmetic
(a batch norm follows every such conv, at most behind an average pool, and
takes out any constant a channel), so both packages give rounding noise
there: each held below ``BIAS_NOISE`` = 1e-4 of the largest gradient of
its conv's weight (1.6e-5 observed at worst, Cnn6's first conv).
Every other leaf within the larger of ``GRAD_REL`` = 1e-4 of its largest
absolute value and ``COND_GRAD`` = 8 times the port's own change of that
leaf when the waveform and every float leaf are scaled by 1 + 1e-7·N(0, 1):
batch statistics over few values are ill-conditioned (``test_torch_pann_train``),
and a gradient through them more so (Res1dNet31's stage-5 weights move by
2 % of their largest value under that nudge). Observed: at most 4.2 times
that change (Res1dNet31's ``layers/4/1/bn2/bias``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models import pann as jax_pann
from conette_torch.huggingface.convert import unflatten_pytree
from conette_torch.models import pann
from conette_torch.weights import named_leaves, to_torch
from test_torch_pann_train import NUDGE, inject_dropout, nudged
from test_torch_pann_zoo import _wave, zoo_tree

GRAD_REL = 1e-4
COND_GRAD = 8.0
BIAS_NOISE = 1e-4


@pytest.mark.parametrize("name", ["cnn14", "cnn6", "resnet22", "res1dnet31"])
def test_training_gradients_match_jax(monkeypatch, name):
    tree = zoo_tree(name)
    wav, lens = _wave()
    _, replay = inject_dropout(monkeypatch, 11)
    leaves = dict(named_leaves(tree))
    floats = {k: v for k, v in leaves.items() if isinstance(v, np.ndarray) and v.dtype == np.float32}
    static = {k: v for k, v in leaves.items() if k not in floats}
    weights = {}

    def jax_scalar(fl):
        out = jax_pann.apply_pann_model(name, unflatten_pytree({**static, **fl}), wav, lens,
                                        deterministic=False)
        if not weights:  # drawn once from the outputs' shapes (concrete under jax.grad)
            rng = np.random.default_rng(3)
            weights.update({k: rng.standard_normal(v.shape).astype(np.float32)
                            for k, v in out.items() if v.dtype == jnp.float32})
        return sum((out[k] * w).sum() for k, w in weights.items())

    want = {k: np.asarray(v) for k, v in
            jax.grad(jax_scalar)({k: jnp.asarray(v) for k, v in floats.items()}).items()}

    def port_grads(nudge: bool) -> dict:
        """The port's gradients; with ``nudge``, of the waveform and every
        float leaf scaled by 1 + 1e-7·N(0, 1)."""
        replay.clear()
        ttree = to_torch(tree)
        params = {k: t for k, t in named_leaves(ttree) if k in floats}
        if nudge:
            gen = torch.Generator().manual_seed(5)
            for t in params.values():
                t.mul_(1 + NUDGE * torch.randn(t.shape, generator=gen))
        for t in params.values():
            t.requires_grad_()
        out = pann.apply_pann_model(name, ttree, torch.from_numpy(nudged(wav) if nudge else wav),
                                    torch.from_numpy(lens), deterministic=False)
        sum((out[k] * torch.from_numpy(w)).sum() for k, w in weights.items()).backward()
        return {k: np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
                for k, t in params.items()}

    got, again = port_grads(False), port_grads(True)
    assert got.keys() == want.keys()
    for k, w in want.items():
        conv_weight = k.removesuffix("bias") + "weight"
        if k.endswith("/bias") and np.ndim(floats.get(conv_weight)) == 4:
            bound = BIAS_NOISE * float(np.abs(want[conv_weight]).max())
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= bound, k
            continue
        atol = max(GRAD_REL * float(np.abs(w).max()), COND_GRAD * float(np.abs(got[k] - again[k]).max()))
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)
