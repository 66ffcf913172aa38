"""The port's batch-size tuner on the CPU against conette_tpu's: the same
doubling search stops at the same size when the port's fake step raises
``torch.cuda.OutOfMemoryError`` above N and JAX's raises
``RESOURCE_EXHAUSTED``; any other error propagates; and
``tune_batch_size_for_model`` runs the decoder's loss and backward pass at
each size up to its cap."""

import numpy as np
import pytest
import torch

from conette_tpu.train import tune as jax_tune
from conette_torch.models.conette import ConetteConfig, conette_init
from conette_torch.train import tune


def _fakes(limit):
    tried = []

    def port_step(batch):
        tried.append(batch["b"])
        if batch["b"] > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return torch.zeros(1)

    def jax_step(batch):
        if batch["b"] > limit:
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate")
        return np.zeros(1)

    return port_step, jax_step, tried


@pytest.mark.parametrize("limit, start", [(100, 32), (32, 32), (5000, 8), (10**6, 32)])
def test_find_max_batch_size_matches_jax(limit, start):
    port_step, jax_step, tried = _fakes(limit)
    want = jax_tune.find_max_batch_size(lambda b: {"b": b}, jax_step, start=start, max_bsize=65536)
    got = tune.find_max_batch_size(lambda b: {"b": b}, port_step, start=start, max_bsize=65536)
    assert got == want
    assert tried[-1] == (got if got * 2 > 65536 else got * 2)


def test_find_max_batch_size_raises_what_is_not_out_of_memory():
    def step(batch):
        raise ValueError("a shape error")

    with pytest.raises(ValueError, match="shape"):
        tune.find_max_batch_size(lambda b: {"b": b}, step)
    port_step, _, _ = _fakes(16)
    with pytest.raises(RuntimeError, match="even bsize=32"):
        tune.find_max_batch_size(lambda b: {"b": b}, port_step)


def test_tune_batch_size_for_model_runs_the_training_step():
    cfg = ConetteConfig(vocab_size=40, proj_in=48, d_model=32, nhead=2, num_decoder_layers=2,
                        dim_feedforward=64, max_pred_size=6)
    params = conette_init(torch.Generator().manual_seed(0), cfg)
    assert tune.tune_batch_size_for_model(cfg, params, t_frames=5, start=2, max_bsize=8) == 8
