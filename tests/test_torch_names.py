"""The port holds a counterpart of every top-level name of conette_tpu, file
for file, apart from those it leaves out on purpose; every function and
method that both define takes the same parameters, in the same order,
apart from an explicit table of renames and of parameters one package has
on purpose; and the names it gained last against conette_tpu on the CPU:
``apply_pann_model``'s ``deterministic=`` keyword (its training mode too),
``wavegram_logmel128_cnn14_apply`` and the native loader's
``is_available``."""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from conette_tpu.models import pann as jax_pann
from conette_tpu.models import pann_zoo as jax_zoo
from conette_torch.models import pann, pann_zoo
from conette_torch.native import loader
from conette_torch.weights import to_numpy, to_torch
from test_torch_pann_train import assert_train_close
from test_torch_pann_zoo import _wave, assert_outputs_close
from torch_fixtures import random_batch_norms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (file, name): left out on purpose (ROADMAP "Copy rule" and Queue 1)
LEFT_OUT = {
    ("decoding/beam.py", "KV_REORDER"), ("decoding/beam.py", "REORDER_L_CHUNKS"),
    ("models/decoder.py", "DecodeCache"), ("models/decoder.py", "init_self_grouped"),
    ("huggingface/config.py", "pylog"), ("train/loop.py", "set_injected_lr"),
    ("utils/misc.py", "enable_compilation_cache"), ("utils/misc.py", "hard_exit"),
    ("utils/profiling.py", "TimeTracker"),
}


# parameters renamed wherever the port lacks the old name: a torch.Generator
# where JAX takes a PRNG key
RENAMES = {"key": "gen", "rng": "gen"}

# (file, function) → (parameters only conette_tpu's takes, parameters only the
# port's takes, why)
PARAMS_APART = {
    ("decoding/beam.py", "beam_search"): (
        {"kv_reorder", "l_chunks"}, {"guard"},
        "TPU formulations of the beam reorder (Copy rule); the step guard that leaves the "
        "unrolled loop where JAX's while_loop tests its condition (decoding/guard.py)"),
    ("models/conette.py", "forward_generate"): (
        {"kv_reorder", "l_chunks"}, {"guard"},
        "TPU formulations of the beam reorder (Copy rule); the step guard that leaves the "
        "unrolled loop where JAX's while_loop tests its condition (decoding/guard.py)"),
    ("decoding/greedy.py", "greedy_search"): (
        set(), {"guard"},
        "the step guard that leaves the unrolled loop where JAX's while_loop tests its condition"),
    ("models/conette.py", "forward_greedy"): (
        set(), {"guard"},
        "the step guard that leaves the unrolled loop where JAX's while_loop tests its condition"),
    ("models/decoder.py", "decode_step"): (
        {"ancestry", "ancestry_impl"}, set(), "the ancestry cache layout, a TPU formulation"),
    ("models/decoder.py", "reorder_cache"): (
        {"step", "l_chunks"}, set(), "the chunked reorder's bound, a TPU formulation"),
    ("models/decoder.py", "init_self"): (
        {"batch"}, {"rows", "device"}, "one K/V tensor a layer, allocated on a device"),
    ("models/conette.py", "forward_forcing"): (
        set(), {"ff_split"}, "the feed-forward's block over model, where JAX shards by annotation"),
    ("models/decoder.py", "decoder_forward"): (
        set(), {"ff_split"}, "the feed-forward's block over model, where JAX shards by annotation"),
    ("models/convnext.py", "convnext_apply"): (
        {"use_fused_block", "fused_interpret", "fused_transpose"}, set(),
        "Pallas switches: the port's route is fixed by device, dtype and mode"),
    ("models/convnext.py", "convnext_features"): (
        {"fused_block", "fused_interpret", "fused_transpose"}, set(),
        "Pallas switches: the port's route is fixed by device, dtype and mode"),
    ("ops/stft.py", "frame_signal"): ({"impl"}, set(), "an XLA lowering choice (A/B only)"),
    ("utils/profiling.py", "trace"): (
        set(), {"all_threads"}, "torch.profiler records the starting thread only unless asked; the fit's "
        "spans run on the prefetch thread too"),
    ("models/layers.py", "dropout"): (
        set(), {"cols"}, "a column block of the draw, for the feed-forward split over model"),
    ("train/augment.py", "spec_augment"): (
        {"row_ids"}, set(), "rows keyed by id in JAX; the port draws whole batches (RowDraws)"),
    ("train/augment.py", "spec_augment_ratio"): (
        {"row_ids"}, set(), "rows keyed by id in JAX; the port draws whole batches (RowDraws)"),
    ("train/objective.py", "training_loss"): (
        set(), {"mesh"}, "torch tensors carry no sharding: the mesh is passed"),
    ("train/objective.py", "label_smoothed_ce"): (
        set(), {"count"}, "the global batch's token count, for a loss split over data"),
    ("train/loop.py", "fit"): (
        {"shard_train_batch"}, {"pin_memory", "mesh"},
        "the port slices its rows by the mesh and copies batches from pinned memory"),
    ("train/step.py", "init_train_state"): ({"tx"}, {"optimizer"}, "a torch.optim optimizer for optax's"),
    ("train/step.py", "make_train_step"): (
        {"tx", "donate"}, {"grad_clip_norm", "accumulate_grad_batches", "loss_fn"},
        "optax's chain and XLA's buffer donation; the port's step clips and accumulates itself"),
    ("train/step.py", "make_sharded_train_step"): (
        {"tx"}, {"optimizer", "grad_clip_norm", "accumulate_grad_batches"},
        "optax's chain; the port's step clips and accumulates itself"),
    ("train/checkpoint.py", "restore_opt_state"): (
        {"template"}, {"optimizer"}, "state loaded into a torch.optim optimizer, not an optax tree"),
    ("train/checkpoint.py", "save_checkpoint"): (
        set(), {"mesh"}, "torch tensors carry no sharding: the mesh is passed"),
    ("train/tune.py", "tune_batch_size_for_model"): (
        set(), {"**search"}, "find_max_batch_size's bounds passed through"),
    ("huggingface/model.py", "CoNeTTEModel.from_pretrained"): (
        set(), {"config"}, "a config in place of the saved one (conette(config_kwds=), ROADMAP)"),
    ("huggingface/preprocessor.py", "CoNeTTEPreprocessor.__init__"): (
        {"verbose"}, {"device"}, "no log switch; the device, as every entry point takes it"),
    ("parallel/distributed.py", "initialize"): (
        set(), {"local_rank", "device", "backend", "timeout_s"},
        "torch.distributed's group: its device, backend and timeout"),
    ("parallel/distributed.py", "gather_to_host0"): (
        set(), {"replicated"}, "a value every process holds whole, gathered once"),
    ("parallel/mesh.py", "make_mesh"): (
        {"devices"}, set(), "a torch mesh spans every process of the group, one card each"),
}
# parameters only the port's functions take, anywhere: the device an entry
# point runs on (the card unless the caller asks for the CPU)
PORT_ONLY_ANYWHERE = {"device"}


def _walk(package: str):
    """(path relative to the package, module tree) of each Python file,
    the config tree (a byte-equal copy) and the TPU kernels (csrc/) left out."""
    root = os.path.join(REPO, package)
    for d, _, files in os.walk(root):
        rel_dir = os.path.relpath(d, root)
        if rel_dir.split(os.sep)[0] == "conf" or rel_dir == os.path.join("ops", "pallas"):
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    yield os.path.normpath(os.path.join(rel_dir, f)), ast.parse(fh.read())


def _parameters(package: str) -> dict[tuple[str, str], list[str]]:
    """(file, function or Class.method) → its parameter names in order."""
    def names(fn) -> list[str]:
        a = fn.args
        return ([p.arg for p in a.posonlyargs + a.args] + ([f"*{a.vararg.arg}"] if a.vararg else [])
                + [p.arg for p in a.kwonlyargs] + ([f"**{a.kwarg.arg}"] if a.kwarg else []))

    out = {}
    for path, tree in _walk(package):
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[(path, node.name)] = names(node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out[(path, f"{node.name}.{sub.name}")] = names(sub)
    return out


def _top_level_names(package: str) -> dict[str, set[str]]:
    out = {}
    for path, tree in _walk(package):
        names = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
        out[path] = {n for n in names if not n.startswith("_")}
    return out


def test_every_top_level_name_has_a_counterpart():
    jax_names, port_names = _top_level_names("conette_tpu"), _top_level_names("conette_torch")
    missing = {(f, n) for f, names in jax_names.items() for n in names - port_names.get(f, set())}
    assert missing == LEFT_OUT


def test_every_shared_function_takes_the_same_parameters():
    """Functions and methods of both packages, file for file: the same
    parameter names in the same order, after ``RENAMES``, apart from
    ``PARAMS_APART`` (each entry must still differ as it says) and the
    port's ``device``."""
    jax_params, port_params = _parameters("conette_tpu"), _parameters("conette_torch")
    assert set(PARAMS_APART) <= set(jax_params) & set(port_params)
    differ = {}
    for fn in sorted(set(jax_params) & set(port_params)):
        jax_only, port_only, _ = PARAMS_APART.get(fn, (set(), set(), ""))
        # a rename where the port takes the new name in place of the old
        want = [RENAMES[p] if p in RENAMES and p not in port_params[fn] else p
                for p in jax_params[fn] if p not in jax_only]
        got = [p for p in port_params[fn] if p not in port_only
               and (p not in PORT_ONLY_ANYWHERE or p in jax_params[fn])]
        if got != want:
            differ[fn] = (jax_params[fn], port_params[fn])
        assert jax_only <= set(jax_params[fn]) and port_only <= set(port_params[fn]), fn
    assert differ == {}


@pytest.mark.parametrize("deterministic", [True, False])
def test_apply_pann_model_takes_deterministic(deterministic):
    """``cnn6`` in either mode equals JAX's: running statistics, or in
    training mode the batch's (the zoo's architectures apply no dropout),
    held as ``test_torch_pann_train`` holds it (1e-5 of the larger of 1 and
    each key's largest value: 3.8e-6 observed, frame_embs at 1.82)."""
    tree = random_batch_norms(to_numpy(pann.build_pann_model("cnn6", torch.Generator().manual_seed(6))[0]),
                              np.random.default_rng(6))
    wav, lens = _wave()
    want = jax_pann.apply_pann_model("cnn6", tree, wav, lens, deterministic=deterministic)
    got = pann.apply_pann_model("cnn6", to_torch(tree), torch.from_numpy(wav), torch.from_numpy(lens),
                                deterministic=deterministic)
    (assert_outputs_close if deterministic else assert_train_close)(got, want)


def test_wavegram_logmel128_cnn14_apply_matches_jax():
    tree = random_batch_norms(
        jax.tree.map(np.asarray, jax_zoo.wavegram_logmel128_cnn14_init(jax.random.PRNGKey(3))),
        np.random.default_rng(3))
    wav, lens = _wave()
    want = jax_zoo.wavegram_logmel128_cnn14_apply(tree, wav, lens)
    got = pann_zoo.wavegram_logmel128_cnn14_apply(to_torch(tree), torch.from_numpy(wav),
                                                  torch.from_numpy(lens))
    assert_outputs_close(got, want)


def test_native_is_available_builds_or_names_a_missing_compiler(monkeypatch):
    assert loader.is_available()
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "CXX", "g++-not-installed")
    assert not loader.is_available()
    # a compiler that fails is not an absent one: it raises
    monkeypatch.setattr(loader, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        loader.is_available()
