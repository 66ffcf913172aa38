"""The port's parallel layer on the CPU: ``initialize`` from torchrun's and
SLURM's variables (the group's own ``init_process_group`` replaced by a
recorder), ``gather_to_host0`` tiled and replicated on two ``gloo``
processes, and ``param_sharding`` leaf for leaf against conette_tpu's
``param_sharding`` on the same tree (JAX on the suite's virtual CPU
devices)."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conette_tpu.models.conette import ConetteConfig as JaxConetteConfig
from conette_tpu.models.conette import conette_init as jax_conette_init
from conette_tpu.parallel.mesh import make_mesh as jax_make_mesh
from conette_tpu.parallel.mesh import param_sharding as jax_param_sharding
from conette_torch.parallel import distributed
from torch_parallel_workers import gathers_and_placements, spawn

LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
               "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NODELIST")


@pytest.fixture
def calls(monkeypatch):
    """The arguments of every ``init_process_group`` and ``set_device`` call."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw["init_method"],
                                                           kw["world_size"], kw["rank"])))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: seen.append(("set_device", i)))
    return seen


@pytest.mark.parametrize("env, kwargs, want", [
    # torchrun
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "node7",
      "MASTER_PORT": "1234"}, {"device": "cpu"}, [("gloo", "tcp://node7:1234", 4, 2)]),
    # SLURM's variables win over torchrun's; the address is the node list's first host
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1", "WORLD_SIZE": "2",
      "SLURM_JOB_NODELIST": "gpu[03-05,07],cpu1", "MASTER_PORT": "2345"}, {"device": "cpu"},
     [("gloo", "tcp://gpu03:2345", 8, 5)]),
    # the lightning plugin: SLURM ignored, one process, nothing to join
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "1", "SLURM_JOB_NODELIST": "gpu01"},
     {"device": "cpu", "use_scheduler_env": False}, []),
    # one process joins a group only when a backend is asked for
    ({}, {"device": "cpu"}, []),
    ({}, {"device": "cpu", "backend": "gloo"}, [("gloo", "tcp://localhost:29500", 1, 0)]),
    # the card: nccl, and the card of the local rank set first
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "h", "MASTER_PORT": "9"},
     {}, [("set_device", 1), ("nccl", "tcp://h:9", 2, 1)]),
])
def test_initialize_reads_the_launcher(calls, monkeypatch, env, kwargs, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    distributed.initialize(**kwargs)
    assert calls == want


def test_initialize_needs_an_address_and_never_falls_back(calls, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize(device="cpu")

    def nccl_fails(backend, **kw):
        raise RuntimeError(f"{backend} failed")

    monkeypatch.setattr(dist, "init_process_group", nccl_fails)
    with pytest.raises(RuntimeError, match="nccl failed"):
        distributed.initialize("h:1", device="cuda")


@pytest.fixture(scope="module")
def two_ranks():
    cfg = JaxConetteConfig(vocab_size=40, d_model=32, nhead=2, num_decoder_layers=2,
                           dim_feedforward=64)
    params = jax.tree.map(np.asarray, jax_conette_init(jax.random.PRNGKey(0), cfg))
    return params, spawn(gathers_and_placements, 2, params)


def test_gather_to_host0_tiles_rows_and_reads_replicated_values(two_ranks):
    _, (r0, r1) = two_ranks
    want = np.concatenate([np.arange(6).reshape(3, 2), np.arange(6).reshape(3, 2) + 100])
    np.testing.assert_array_equal(r0[0], want)
    np.testing.assert_array_equal(r0[1], [7.0, 7.0])  # rank 0's own, not a tiled copy
    assert r1[0] is None and r1[1] is None


def test_param_sharding_places_every_leaf_as_jax(two_ranks):
    params, (r0, r1) = two_ranks
    specs = r0[2]
    jax_specs = jax_param_sharding(params, jax_make_mesh(2, model_parallel=2))
    flat = jax.tree_util.tree_flatten_with_path(jax_specs)[0]
    want = {}
    for path, sharding in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        want[name] = {d: a for d, a in enumerate(sharding.spec) if a is not None}
    assert specs == want == r1[2]
    assert sum(bool(v) for v in specs.values()) == 4  # linear1/linear2 of 2 layers


def test_blocks_round_trip_and_batches_split_by_rank(two_ranks):
    _, ranks = two_ranks
    for rank, r in enumerate(ranks):
        assert r[3] == (32, 32) and r[4]  # linear1 (32, 64): 32 columns a rank, gathered back
        np.testing.assert_array_equal(r[5], np.arange(8).reshape(4, 2)[2 * rank:2 * rank + 2])
        assert tuple(r[6]) == (rank, 0) and tuple(r[7]) == (0, rank)
