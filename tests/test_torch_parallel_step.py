"""The sharded train step on the CPU: the port's ``make_sharded_train_step``
on two ``gloo`` processes, data parallel (DP = 2) and tensor parallel
(TP = 2, the decoder's feed-forward blocks split), against the port's
one-process step over three steps with mixup and dropout on; its first
loss against conette_tpu's ``make_sharded_train_step`` on a mesh of four
virtual CPU devices (mixup and dropout off, as ``tests/test_train_step.py``
holds JAX's own sharded step); and the spec-aug draws of a process's rows
of a global batch.

Parameters are held within 1e-5 apart from the attention key biases: their
gradient is zero in exact arithmetic, so each run's is rounding noise
(~1e-9) that Adam divides by its own root mean square, and a step moves
them by up to the lr either way (``test_torch_train_optim.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models.conette import ConetteConfig as JaxConetteConfig
from conette_tpu.models.conette import conette_init as jax_conette_init
from conette_tpu.parallel.mesh import make_mesh as jax_make_mesh
from conette_tpu.parallel.mesh import shard_batch as jax_shard_batch
from conette_tpu.train.optim import get_optimizer as jax_get_optimizer
from conette_tpu.train.step import init_train_state as jax_init_train_state
from conette_tpu.train.step import make_sharded_train_step as jax_make_sharded_train_step
from conette_torch.models import layers
from conette_torch.train import augment
from conette_torch.weights import named_leaves
from torch_parallel_workers import (
    BOS,
    EOS,
    PAD,
    VOCAB,
    first_loss,
    run_steps,
    sharded_steps,
    spawn,
    step_batches,
)

N_STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def one_process():
    return run_steps(N_STEPS)


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["dp2", "tp2"])
def test_sharded_step_equals_one_process_with_mixup_and_dropout(one_process, model_parallel):
    want_losses, want_params = one_process
    ranks = spawn(sharded_steps, 2, model_parallel, N_STEPS, True, 0.2)
    want = dict(named_leaves(want_params))
    for losses, params in ranks:  # every process reports the global loss
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        got = dict(named_leaves(params))
        assert got.keys() == want.keys()
        for k in want:
            if not k.endswith("k/bias"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_data_parallel_loss_equals_jax_sharded_step():
    config = dict(vocab_size=VOCAB, proj_in=48, d_model=32, nhead=2, num_decoder_layers=2,
                  dim_feedforward=64, proj_dropout_p=0.0, decoder_dropout_p=0.0,
                  label_smoothing=0.2, mixup_alpha=0.4, bos_id=BOS, eos_id=EOS, pad_id=PAD)
    cfg = JaxConetteConfig(**config)
    params = jax_conette_init(jax.random.PRNGKey(0), cfg)
    batch = step_batches(1)[0]
    tx, _ = jax_get_optimizer(params, lr=1e-3, weight_decay=0.01, sched_n_steps=10)
    mesh = jax_make_mesh(4, model_parallel=1)
    with mesh:
        state, fn = jax_make_sharded_train_step(cfg, tx, mesh, jax_init_train_state(params, tx),
                                                batch, use_mixup=False)
        j_batch = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        _, metrics = fn(state, j_batch, jax.random.PRNGKey(3))
    want = float(metrics["train/loss"])
    got = spawn(first_loss, 2, jax.tree.map(np.asarray, params), batch, config)
    np.testing.assert_allclose(got, [want, want], rtol=LOSS_RTOL)


@pytest.mark.parametrize("fn", [augment.spec_augment, augment.spec_augment_ratio,
                                augment.cutout_spec])
def test_row_ids_key_each_rows_draws(fn):
    """A process holding rows 4..7 of a global batch of 8 (a ``RowDraws`` of
    those rows, in place of the JAX package's ``row_ids``) draws for them
    what one process holding all 8 draws; a ``RowDraws`` of every row draws
    what the plain generator draws."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 40, 24)).astype(np.float32))
    kw = {} if fn is augment.cutout_spec else {"time_valid": torch.tensor([40, 31, 20, 40] * 2)}

    def run(rows, row0):
        gen = layers.RowDraws(torch.Generator().manual_seed(5), row0, 8)
        extra = {k: v[rows] for k, v in kw.items()}
        return fn(gen, x[rows], **extra)

    whole = run(slice(None), 0)
    np.testing.assert_array_equal(run(slice(4, 8), 4), whole[4:])
    np.testing.assert_array_equal(run(slice(0, 4), 0), whole[:4])
    assert not torch.equal(whole, x)
    plain = fn(torch.Generator().manual_seed(5), x, **kw)
    np.testing.assert_array_equal(plain, whole)
    other = fn(torch.Generator().manual_seed(6), x, **kw)
    assert not torch.equal(other, plain)
