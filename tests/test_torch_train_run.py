"""``conette-train`` in the port end to end on the CPU, against conette_tpu:
the HDF5 files of both packages read in the other, ``main_train`` at tiny
widths on HDF files packed by the JAX package's ``pack_to_hdf`` (its run
directory holds what the JAX ``finalize_run`` writes), run directories
that load across the two packages with equal captions, checkpoints with
the optimizer's state, ``csum_module``, and the device and launch rules of
the entry point.

The model-backed metrics (BERTScore, FENSE, fluency) are held unavailable
here, as on a host without their weights, so that no test reaches for a
download."""

import json
import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from conette_tpu.data.datasets import DictDataset, DummyAACDataset
from conette_tpu.data.hdf import HDFDataset as JaxHDFDataset
from conette_tpu.data.hdf import pack_to_hdf as jax_pack_to_hdf
from conette_tpu.huggingface.model import CoNeTTEModel as JaxModel
from conette_tpu.models.conette import ConetteConfig as JaxConetteConfig
from conette_tpu.models.conette import add_task_tokens as jax_add_task_tokens
from conette_tpu.models.conette import conette_init as jax_conette_init
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
from conette_tpu.train.artifacts import finalize_run as jax_finalize_run
from conette_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from conette_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from conette_tpu.utils.csum import csum_module as jax_csum_module
from conette_tpu.utils.run_logger import RunLogger as JaxRunLogger
from conette_torch.data import hdf5
from conette_torch.data.hdf import HDFDataset, pack_to_hdf
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.metrics.functional import bert_score, fense, fluency
from conette_torch.train import checkpoint, optim, step
from conette_torch.train.main import main_train
from conette_torch.utils.csum import csum_module
from conette_torch.weights import named_leaves, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["pl.d_model=32", "pl.nhead=2", "pl.num_decoder_layers=2", "pl.dim_feedforward=64",
        "pl.max_pred_size=6", "pl.min_pred_size=1", "pl.beam_size=2"]


@pytest.fixture(autouse=True)
def _no_model_metrics():
    for cache, key in ((bert_score._CACHE, "embed"), (fense._CACHE, "model"), (fluency._CACHE, "echecker")):
        cache[key] = None


@pytest.fixture(scope="module")
def hdf_dir(tmp_path_factory):
    """Packs written by the JAX package (h5py), as ``tests/test_train_e2e.py``
    packs them."""
    d = tmp_path_factory.mktemp("hdf")
    for name, subset, size, seed in [("clotho", "dev", 12, 0), ("clotho", "val", 6, 1),
                                     ("clotho", "eval", 6, 2)]:
        ds = DummyAACDataset(size=size, seed=seed, dataset_name=name, subset=subset)
        jax_pack_to_hdf(ds, str(d / f"{name}_{subset}_x.hdf"))
    return str(d)


def _args(hdf_dir, log_root, *extra):
    return ["trainer=lim2", "ckpts=loss", f"dm.hdf_root={hdf_dir}", "dm.train_hdfs=[clotho_dev_x.hdf]",
            "dm.val_hdfs=[clotho_val_x.hdf]", "dm.test_hdfs=[clotho_eval_x.hdf]", "dm.bsize=3",
            f"log_root={log_root}", *TINY, *extra]


@pytest.fixture(scope="module")
def run(hdf_dir, tmp_path_factory):
    for cache, key in ((bert_score._CACHE, "embed"), (fense._CACHE, "model"), (fluency._CACHE, "echecker")):
        cache[key] = None
    return main_train(_args(hdf_dir, tmp_path_factory.mktemp("logs"), "device=cpu"))


# -------------------------------------------------------------------- HDF5
def _items(n, seed):
    rng = np.random.default_rng(seed)
    return DictDataset({
        "audio": [rng.standard_normal((int(rng.integers(3, 9)), 768)).astype(np.float32) for _ in range(n)],
        "audio_lens": [int(v) for v in rng.integers(3, 9, n)],
        "captions": [["a bird sings", f"caption {i} ünïcode"] for i in range(n)],
        "dataset": ["clotho"] * n,
        "source": [None] * n,
        "fname": [f"f{i}.wav" for i in range(n)],
        "score": [float(i) / 3 for i in range(n)],
    })


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf_packs_read_alike_in_both_packages(tmp_path, writer):
    """A pack written by either package's ``pack_to_hdf`` reads item for
    item the same in both packages' ``HDFDataset`` and in h5py."""
    ds = _items(5, 0)
    path = str(tmp_path / "x.hdf")
    (jax_pack_to_hdf if writer == "jax" else pack_to_hdf)(ds, path)
    port, ref = HDFDataset(path), JaxHDFDataset(path)
    assert port.column_names == ref.column_names and len(port) == len(ref) == 5
    for i in range(5):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        np.testing.assert_array_equal(a["audio"], ds[i]["audio"])
    assert port.column("captions") == ref.column("captions")
    np.testing.assert_array_equal(port.column("audio_lens"), ref.column("audio_lens"))
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["audio"][:], port._file["audio"][:])
        assert list(f["captions"][:]) == list(port._file["captions"][:])
        assert json.loads(f.attrs["columns"]) == port.column_names
    port.close()


def test_hdf5_module_refuses_what_it_does_not_write(tmp_path):
    path = str(tmp_path / "c.hdf")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.ones((4, 3)), chunks=(2, 3), compression="gzip")
        f.create_group("g")
    r = hdf5.File(path)
    with pytest.raises(NotImplementedError, match="contiguous"):
        r["x"]
    with pytest.raises(NotImplementedError, match="group"):
        r["g"]
    with hdf5.File(str(tmp_path / "w.hdf"), "w") as w:
        with pytest.raises(NotImplementedError):
            w.create_dataset("y", data=np.ones(3), compression="gzip")
        w.create_dataset("empty", data=np.zeros((0, 2), np.float32))
    with h5py.File(str(tmp_path / "w.hdf"), "r") as f:
        assert f["empty"].shape == (0, 2)


# ------------------------------------------------------------- main_train
def test_main_train_runs_on_jax_packed_hdf(run, tmp_path):
    """Validation, the ``best`` checkpoint, test scoring and CSV export, and
    every artifact that the JAX package's ``finalize_run`` writes, with the
    same keys in ``hparams.yaml``."""
    run_dir = run["run_dir"]
    assert run["test"] and "cider_d" in next(iter(run["test"].values()))
    assert np.isfinite(run["best"])
    best = os.path.join(run_dir, "checkpoints", "best")
    assert {"params.npz", "meta.json", "tokenizer.json", "opt_state.npz"} <= set(os.listdir(best))
    corpus = next(iter(run["test"]))
    assert os.path.isfile(os.path.join(run_dir, f"best_loss_outputs_{corpus}.csv"))
    assert os.path.isfile(os.path.join(run_dir, f"submission_output_best_loss_{corpus}.csv"))
    assert run["fit"].global_step == 2

    # what conette_tpu's finalize_run writes, on a run of its own objects
    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    tok = JaxTokenizer()
    tok.fit(["a bird sings"])
    ckpt = JaxCheckpointManager(os.path.join(ref_dir, "checkpoints"), monitor="val/loss", mode="min")
    from conette_tpu.config import load_config

    jax_finalize_run(cfg=load_config("train", ["trainer=lim2"]), run_dir=ref_dir,
                     logger=JaxRunLogger(ref_dir), tokenizer=tok, params={"w": np.ones(2)}, ckpt=ckpt,
                     monitor="val/loss", t_start=0.0)
    want = {f for f in os.listdir(ref_dir) if os.path.isfile(os.path.join(ref_dir, f))}
    assert want <= set(os.listdir(run_dir)), want - set(os.listdir(run_dir))
    import yaml

    with open(os.path.join(ref_dir, "hparams.yaml")) as f:
        ref_keys = set(yaml.safe_load(f))
    with open(os.path.join(run_dir, "hparams.yaml")) as f:
        keys = set(yaml.safe_load(f))
    assert ref_keys <= keys


def _tiny_encoder():
    """A small ConvNeXt for the models' constructors: ``preprocess=False``
    never runs it, and the default ConvNeXt-Tiny takes seconds to build."""
    from conette_tpu.models.convnext import convnext_init

    return jax.tree.map(np.asarray, convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1),
                                                  dims=(8, 16, 32, 64)))


def _frame_inputs(seed, b=3, t=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 768)).astype(np.float32)
    shapes = np.array([[768, t], [768, t - 3], [768, t - 1]][:b])
    return x, shapes


@pytest.mark.parametrize("beam", [1, 2])
def test_port_run_dir_loads_in_jax_with_equal_captions(run, beam):
    """``from_pretrained`` on the port's train-run directory, in both
    packages: from the same frame embeddings (``preprocess=False``; the
    encoder is not part of a run) equal captions and lprobs within 1e-5."""
    enc = _tiny_encoder()
    port = CoNeTTEModel.from_pretrained(run["run_dir"], device="cpu", encoder_params=enc)
    ref = JaxModel.from_pretrained(run["run_dir"], encoder_params=enc)
    x, shapes = _frame_inputs(0)
    got = port(x, x_shapes=shapes, preprocess=False, beam_size=beam)
    want = ref(x, x_shapes=shapes, preprocess=False, beam_size=beam)
    assert got["cands"] == want["cands"]
    np.testing.assert_array_equal(got["preds"], np.asarray(want["preds"]))
    np.testing.assert_allclose(got["lprobs"], np.asarray(want["lprobs"]), atol=1e-5)


def test_jax_run_dir_loads_in_the_port_with_equal_captions(tmp_path):
    """A ``checkpoints/best`` written by the JAX package's
    ``save_checkpoint`` (its flat ``params.npz``, ``meta.json`` with the
    model config, ``tokenizer.json``) loads in the port and captions as the
    JAX model does, lprobs within 1e-5."""
    tok = JaxTokenizer()
    tok.fit(["a bird sings loudly", "an engine hums near a road", "rain falls on a roof"])
    ids = jax_add_task_tokens(tok, ("clotho",), "ds_src")
    cfg = JaxConetteConfig(vocab_size=tok.get_vocab_size(), task_names=("clotho",), d_model=32, nhead=2,
                           num_decoder_layers=2, dim_feedforward=64, max_pred_size=6, min_pred_size=1,
                           beam_size=2, bos_id=tok.bos_token_id, eos_id=tok.eos_token_id,
                           pad_id=tok.pad_token_id)
    assert ids
    params = jax.tree.map(np.asarray, jax.jit(jax_conette_init, static_argnums=1)(jax.random.PRNGKey(7), cfg))
    run_dir = tmp_path / "run"
    best = run_dir / "checkpoints" / "epoch_000-val_loss_1.0"
    jax_save_checkpoint(str(best), params, meta={"model_cfg": {k: (list(v) if isinstance(v, tuple) else v)
                                                               for k, v in cfg._asdict().items()}},
                        tokenizer=tok)
    os.symlink(best.name, run_dir / "checkpoints" / "best")
    enc = _tiny_encoder()
    port = CoNeTTEModel.from_pretrained(str(run_dir), device="cpu", encoder_params=enc)
    ref = JaxModel.from_pretrained(str(run_dir), encoder_params=enc)
    x, shapes = _frame_inputs(1)
    got = port(x, x_shapes=shapes, preprocess=False)
    want = ref(x, x_shapes=shapes, preprocess=False)
    assert got["cands"] == want["cands"]
    np.testing.assert_allclose(got["lprobs"], np.asarray(want["lprobs"]), atol=1e-5)


def test_main_train_needs_cuda_unless_told_cpu(hdf_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_train(_args(hdf_dir, tmp_path))
    # one process is one card: a mesh of two names the launch that holds it
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        main_train(_args(hdf_dir, tmp_path, "device=cpu", "trainer.data_parallel=2"))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        main_train(_args(hdf_dir, tmp_path, "device=cpu", "trainer.model_parallel=2"))


def test_main_train_refuses_several_processes(hdf_dir, tmp_path, monkeypatch):
    """A launch of several processes without rank 0's address is refused
    before it waits for the others (``tests/test_torch_parallel_train.py``
    trains over two)."""
    for var in ("MASTER_ADDR", "SLURM_NTASKS", "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        main_train(_args(hdf_dir, tmp_path, "device=cpu"))


def test_cli_runs_as_a_module_and_defaults_to_cuda(hdf_dir, tmp_path):
    """``python -m conette_torch.train.main`` without ``device=`` raises on
    a host without CUDA before any training, and names ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "conette_torch.train.main", *_args(hdf_dir, tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


# ------------------------------------------------------------ checkpoints
def test_checkpoint_round_trip_resumes_with_momentum(tmp_path):
    """Parameters, meta and the AdamW moments survive ``save_checkpoint`` →
    ``load_checkpoint`` → ``restore_opt_state``: the next step from the
    restored state equals the next step of the original bit for bit;
    ``ign_weights`` drops by regex; a payload of another optimizer raises;
    ``backend="orbax"`` writes ``dcp/``, which loads back bit for bit."""
    _, tcfg = __import__("test_torch_train_model").small_cfg()
    from conette_torch.models.conette import conette_init

    def state():
        p = conette_init(torch.Generator().manual_seed(0), tcfg)
        opt, _ = optim.get_optimizer(p, lr=1e-3, sched_name="none")
        return step.init_train_state(p, opt)

    g = {k: torch.randn(t.shape, generator=torch.Generator().manual_seed(i))
         for i, (k, t) in enumerate(named_leaves(state().params))}

    def loss_fn(params, batch, gen):
        return sum((t * g[k]).sum() for k, t in named_leaves(params))

    fn = step.make_train_step(tcfg, loss_fn=loss_fn)
    a, _ = fn(state(), {}, None)
    checkpoint.save_checkpoint(str(tmp_path / "c"), a.params, opt_state=a.opt_state, step=1,
                               meta={"x": 1})
    loaded = checkpoint.load_checkpoint(str(tmp_path / "c"))
    assert loaded["meta"] == {"step": 1, "x": 1}
    b = state()
    with torch.no_grad():
        for (_, t), (_, s) in zip(named_leaves(b.params), named_leaves(loaded["params"])):
            t.copy_(s)
    checkpoint.restore_opt_state(loaded["opt_state_flat"], b.opt_state)
    a, _ = fn(a, {}, None)
    b, _ = fn(b, {}, None)
    for (_, x), (_, y) in zip(named_leaves(a.params), named_leaves(b.params)):
        assert torch.equal(x, y)
    dropped = checkpoint.load_checkpoint(str(tmp_path / "c"), ign_weights=r"^decoder/classifier")
    assert "classifier" not in dropped["params"]["decoder"] and "projection" in dropped["params"]
    sgd, _ = optim.get_optimizer(b.params, optim_name="SGD", lr=1e-3, sched_name="none")
    with pytest.raises(ValueError, match="opt_state mismatch"):
        checkpoint.restore_opt_state(loaded["opt_state_flat"], sgd)
    checkpoint.save_checkpoint(str(tmp_path / "o"), a.params, backend="orbax")
    assert sorted(os.listdir(tmp_path / "o")) == ["dcp", "meta.json"]
    from_dcp = checkpoint.load_checkpoint(str(tmp_path / "o"))["params"]
    for (n, x), (m, y) in zip(named_leaves(a.params), named_leaves(from_dcp)):
        assert n == m and torch.equal(x, y)


def test_checkpoint_manager_keeps_the_top_k_and_links_best(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), monitor="val/loss", mode="min", top_k=2)
    params = {"w": torch.ones(2)}
    for epoch, score in enumerate([3.0, 2.0, 2.5, 1.0]):
        mgr.step(epoch, {"val/loss": score}, params)
    assert mgr.best_score == 1.0 and sorted(s for s, _ in mgr._saved) == [1.0, 2.0]
    assert os.path.realpath(os.path.join(tmp_path, "ck", "best")) == os.path.realpath(mgr.best_dir)
    assert len([d for d in os.listdir(tmp_path / "ck") if d.startswith("epoch_")]) == 2


def test_csum_module_equals_jax():
    from conette_tpu.models.conette import ConetteConfig

    cfg = ConetteConfig(vocab_size=30, proj_in=16, d_model=16, nhead=2, num_decoder_layers=1,
                        dim_feedforward=32)
    params = jax.tree.map(np.asarray, jax.jit(jax_conette_init, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    assert csum_module(to_torch(params)) == jax_csum_module(params)
    assert csum_module(to_torch(params), with_names=False) == jax_csum_module(params, with_names=False)


def test_main_train_with_ema_swa_plateau_accumulation_and_resume(run, hdf_dir, tmp_path):
    """The loop's options: EMA and SWA snapshots, the plateau schedule, 2-step
    accumulation and ``testing.run=[last,swa,best]`` (three test passes,
    named as the JAX package names them), then a warm start from the first
    run's best checkpoint with its optimizer moments (``resume=``)."""
    out = main_train(_args(hdf_dir, tmp_path / "a", "device=cpu", "trainer.max_epochs=2",
                           "trainer.limit_train_batches=4", "trainer.ema_decay=0.9",
                           "trainer.swa_start=0", "trainer.accumulate_grad_batches=2",
                           "pl.sched_name=reduce_lr_on_plateau", "testing.run=[last,swa,best]"))
    assert set(out["test_by_model"]) == {"last", "swa", "best_loss"}
    assert out["fit"].global_step == 8 and out["fit"].state.opt_state.state
    assert out["fit"].swa_params is not None and out["fit"].ema_params is not None
    best = os.path.join(run["run_dir"], "checkpoints", "best")
    resumed = main_train(_args(hdf_dir, tmp_path / "b", "device=cpu", f"resume={best}",
                               "test_after_fit=false"))
    assert resumed["fit"].global_step == 2 and np.isfinite(resumed["best"])
