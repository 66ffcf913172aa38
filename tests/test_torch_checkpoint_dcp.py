"""The sharded checkpoint backend (``train/checkpoint.py``,
``backend="orbax"`` → ``torch.distributed.checkpoint`` under ``dcp/``) on
the CPU: two ``gloo`` processes save a tree whose feed-forward matrices
are split over ``model``, each writing its own blocks, and one process
loads it bit for bit equal to the gathered ``params.npz`` (and the
optimizer state and meta equal to the npz checkpoint's); a PANN tree with
its Python steering values round-trips in one process; ``params.npz`` is
read before ``dcp/``; a JAX ``orbax/`` tree still raises."""

import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint import FileSystemReader

from conette_torch.models.pann import build_pann_model
from conette_torch.train import checkpoint
from conette_torch.weights import named_leaves
from torch_parallel_workers import sharded_checkpoint, spawn


def _assert_trees_equal(got, want) -> None:
    got, want = named_leaves(got), named_leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype and torch.equal(g, w), name
        else:
            assert type(g) is type(w) and g == w, name


def test_two_processes_save_a_model_split_tree_that_one_loads_equal_to_the_gathered_npz(tmp_path):
    split = spawn(sharded_checkpoint, 2, str(tmp_path))
    assert split[0] == split[1] and len(split[0]) == 4  # linear1/linear2 of 2 layers
    assert all(shape == (32, 32) for _, shape in split[0])  # of (32, 64) and (64, 32)
    stored = FileSystemReader(str(tmp_path / "dcp" / "dcp")).read_metadata().state_dict_metadata
    chunks = {name: len(m.chunks) for name, m in stored.items()}
    assert {n for n, c in chunks.items() if c == 2} == {n for n, _ in split[0]}
    assert set(chunks.values()) == {1, 2}
    files = os.listdir(tmp_path / "dcp" / "dcp")
    assert sum(f.endswith(".distcp") for f in files) == 2  # each process wrote its blocks
    dcp_ckpt = checkpoint.load_checkpoint(str(tmp_path / "dcp"))
    npz_ckpt = checkpoint.load_checkpoint(str(tmp_path / "npz"))
    _assert_trees_equal(dcp_ckpt["params"], npz_ckpt["params"])
    assert dcp_ckpt["meta"] == npz_ckpt["meta"] == {"step": 1, "world": 2}
    want_opt = npz_ckpt["opt_state_flat"]
    assert dcp_ckpt["opt_state_flat"].keys() == want_opt.keys()
    assert all(np.array_equal(dcp_ckpt["opt_state_flat"][k], v) for k, v in want_opt.items())


def test_a_pann_tree_round_trips_with_its_steering_values(tmp_path):
    tree = build_pann_model("mobilenetv1", torch.Generator().manual_seed(1))[0]
    checkpoint.save_checkpoint(str(tmp_path), tree, step=3, backend="orbax")
    with open(tmp_path / "dcp" / "values.json") as f:
        assert json.load(f)["values"]["features/0/kind"] == "bn"
    loaded = checkpoint.load_checkpoint(str(tmp_path))
    _assert_trees_equal(loaded["params"], tree)
    assert loaded["meta"] == {"step": 3}


def test_params_npz_is_read_before_dcp_and_a_jax_orbax_tree_raises(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path / "c"), {"w": torch.zeros(2)}, backend="orbax")
    checkpoint.save_checkpoint(str(tmp_path / "c"), {"w": torch.ones(2)})
    assert torch.equal(checkpoint.load_checkpoint(str(tmp_path / "c"))["params"]["w"], torch.ones(2))
    os.makedirs(tmp_path / "j" / "orbax")
    with open(tmp_path / "j" / "meta.json", "w") as f:
        json.dump({"step": 0}, f)
    with pytest.raises(NotImplementedError, match="orbax checkpoint of the JAX package"):
        checkpoint.load_checkpoint(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        checkpoint.save_checkpoint(str(tmp_path / "x"), {"w": torch.ones(2)}, backend="tensorstore")
