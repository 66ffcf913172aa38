"""``conette-train`` on two ``gloo`` processes against one, on the CPU, as
``tests/test_multihost_fit_equality.py`` holds the JAX package's: the one
process trains at ``dm.bsize=8``, the two at ``dm.bsize=4`` each (rank r
reads rows [4r, 4r + 4) of every global batch of 8), both with the pad
shapes fixed and dropout, mixup and SpecAugmentRatio on. Per-step losses
agree within 1e-5 and the best checkpoint's parameters within 1e-4, and
only rank 0 writes checkpoints and artifacts; a ``torchrun`` launch of
four processes of the CLI equals one process too. A ``trainer.data_parallel``
or ``trainer.model_parallel`` larger than the launch raises and names the
launch it needs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conette_torch.data.datasets import DummyAACDataset
from conette_torch.data.hdf import pack_to_hdf
from torch_parallel_workers import free_port, spawn, train, train_args

LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def hdf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hdf")
    for name, subset, size, seed in [("clotho", "dev", 16, 0), ("clotho", "val", 6, 1)]:
        ds = DummyAACDataset(size=size, seed=seed, dataset_name=name, subset=subset)
        pack_to_hdf(ds, str(d / f"{name}_{subset}_x.hdf"))
    return str(d)


def _losses(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["train/loss"] for r in sorted((r for r in recs if "train/loss" in r),
                                            key=lambda r: r["step"])]


def _best(run_dir):
    with np.load(os.path.join(run_dir, "checkpoints", "best", "params.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("extra", [[], ["trainer.model_parallel=2"]], ids=["dp2", "tp2"])
def test_two_process_fit_equals_one_process(hdf_dir, tmp_path, extra):
    (dir_a, steps_a), = spawn(train, 1, hdf_dir, str(tmp_path / "a"), 8, [])
    # the same log root, as torchrun on one machine gives every rank
    bsize = 8 if extra else 4  # TP: both ranks read the whole global batch
    ranks = spawn(train, 2, hdf_dir, str(tmp_path / "b"), bsize, extra)
    (dir_b, steps_b), (dir_b1, _) = ranks
    assert dir_b == dir_b1  # rank 0's clock names the run directory
    assert steps_a == steps_b == 4
    la, lb = _losses(dir_a), _losses(dir_b)
    assert len(la) == len(lb) == 4
    np.testing.assert_allclose(lb, la, rtol=0, atol=LOSS_ATOL)
    pa, pb = _best(dir_a), _best(dir_b)  # the one-process layout, whole leaves
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].shape == pb[k].shape, k
        np.testing.assert_allclose(pb[k], pa[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    # the optimizer's moments too, whole, so that either run resumes from the other's
    with np.load(os.path.join(dir_a, "checkpoints", "best", "opt_state.npz")) as za, \
            np.load(os.path.join(dir_b, "checkpoints", "best", "opt_state.npz")) as zb:
        assert za.files == zb.files
        assert all(za[k].shape == zb[k].shape for k in za.files)
    # rank 1 logs under its own subdirectory and writes no checkpoint
    assert os.path.isfile(os.path.join(dir_b, "rank1", "scalars.jsonl"))
    assert not os.path.exists(os.path.join(dir_b, "rank1", "checkpoints"))
    assert _losses(os.path.join(dir_b, "rank1")) == lb


def test_torchrun_launch_of_four_equals_one_process(hdf_dir, tmp_path):
    """The launch users make: ``torchrun`` (``python -m torch.distributed.run``)
    of four processes of ``python -m conette_torch.train.main``, each
    joining the group from torchrun's variables, 2 rows a process."""
    (dir_a, _), = spawn(train, 1, hdf_dir, str(tmp_path / "a"), 8, [])
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SLURM_", "MASTER_"))}
    env.update(HF_HUB_OFFLINE="1", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
         "--master-port", str(free_port()), "-m", "conette_torch.train.main",
         *train_args(hdf_dir, str(tmp_path / "b"), 2)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (dir_b,) = [os.path.join(tmp_path / "b", d) for d in os.listdir(tmp_path / "b")]
    np.testing.assert_allclose(_losses(dir_b), _losses(dir_a), rtol=0, atol=LOSS_ATOL)
    pa, pb = _best(dir_a), _best(dir_b)
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert sorted(d for d in os.listdir(dir_b) if d.startswith("rank")) == ["rank1", "rank2", "rank3"]


@pytest.mark.parametrize("extra, launch", [(["trainer.data_parallel=4"], 4),
                                           (["trainer.model_parallel=3"], 3)])
def test_a_mesh_larger_than_the_launch_names_the_launch(hdf_dir, tmp_path, extra, launch):
    with pytest.raises(AssertionError, match=f"torchrun --nproc-per-node {launch}"):
        spawn(train, 2, hdf_dir, str(tmp_path), 4, extra)
