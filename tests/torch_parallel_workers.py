"""Process groups for the port's multi-process tests: ``spawn(fn, world,
*args)`` starts ``world`` processes over ``gloo`` on the CPU, each joined
to the group on a free port, runs ``fn(rank, world, *args)`` in each and
returns their results in rank order. A process that raises fails the call
with its traceback, and a group that outlives ``timeout`` is killed and
fails it, so a hang costs one test and not the suite.

The workers import torch and ``conette_torch`` only (no JAX): the
functions they run live in modules that do not import JAX."""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable

GROUP_TIMEOUT_S = 60  # a collective that waits longer raises
WORKER_THREADS = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn: Callable, rank: int, world: int, port: int, args: tuple, out: Any) -> None:
    import torch
    import torch.distributed as dist

    from conette_torch.parallel.distributed import initialize

    torch.set_num_threads(WORKER_THREADS)
    try:
        initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=GROUP_TIMEOUT_S)
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args: Any, timeout: float = 150.0) -> list[Any]:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    failures = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(failures) < world:
            try:
                rank, ok, payload = out.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(f"the group of {world} did not finish in {timeout} s "
                                     f"(finished: {sorted(results)})") from None
            if ok:
                results[rank] = payload
            else:
                failures.append(f"rank {rank}:\n{payload}")
                break
    finally:
        for p in procs:
            p.join(timeout=10 if not failures else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if failures:
        raise AssertionError("\n".join(failures))
    return [results[r] for r in range(world)]


# ------------------------------------------------------------------ the step
VOCAB, PAD, BOS, EOS = 40, 0, 1, 2


def small_config(dropout: float = 0.2):
    from conette_torch.models.conette import ConetteConfig

    return ConetteConfig(vocab_size=VOCAB, proj_in=48, d_model=32, nhead=2, num_decoder_layers=2,
                         dim_feedforward=64, proj_dropout_p=dropout, decoder_dropout_p=dropout,
                         label_smoothing=0.2, mixup_alpha=0.4, bos_id=BOS, eos_id=EOS, pad_id=PAD)


def step_batches(n: int, b: int = 8, t: int = 7, length: int = 9, seed: int = 0) -> list[dict]:
    """``n`` global batches of ``b`` rows (numpy): (B, T, 48) frames, lengths,
    and captions of a task token, words, EOS and PAD."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        caps = np.full((b, length), PAD, np.int64)
        for i in range(b):
            k = rng.integers(2, length - 1)
            caps[i, 0] = 5 + i % 2
            caps[i, 1:k] = rng.integers(7, VOCAB, k - 1)
            caps[i, k] = EOS
        out.append({"audio": rng.standard_normal((b, t, 48)).astype(np.float32),
                    "audio_lens": rng.integers(3, t + 1, b).astype(np.int64), "captions": caps})
    return out


def run_steps(n_steps: int, *, mesh=None, use_mixup: bool = True, dropout: float = 0.2,
              seed: int = 7) -> tuple[list[float], dict]:
    """``n_steps`` AdamW steps (clip 1.0) of the tiny model from one seed;
    with ``mesh``, the sharded step on this process's rows. Returns the
    losses and the whole parameters (numpy, one-process layout)."""
    import torch

    from conette_torch.models.conette import conette_init
    from conette_torch.parallel.mesh import shard_batch
    from conette_torch.train import optim, step
    from conette_torch.weights import to_numpy

    cfg = small_config(dropout)
    params = conette_init(torch.Generator().manual_seed(0), cfg)
    opt, _ = optim.get_optimizer(params, "AdamW", lr=5e-3, weight_decay=2.0, sched_name="none")
    state = step.init_train_state(params, opt)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in step_batches(n_steps)]
    if mesh is None:
        fn = step.make_train_step(cfg, use_mixup=use_mixup, grad_clip_norm=1.0)
    else:
        batches = [shard_batch(b, mesh) for b in batches]
        state, fn = step.make_sharded_train_step(cfg, opt, mesh, state, batches[0],
                                                 use_mixup=use_mixup, grad_clip_norm=1.0)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for b in batches:
        state, metrics = fn(state, b, gen)
        losses.append(float(metrics["train/loss"]))
    return losses, to_numpy(step.gather_params(state.params, mesh))


def sharded_steps(rank: int, world: int, model_parallel: int, n_steps: int, use_mixup: bool,
                  dropout: float):
    from conette_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, model_parallel)
    return run_steps(n_steps, mesh=mesh, use_mixup=use_mixup, dropout=dropout)


# --------------------------------------------------------------- captioning
def serving_at(dtype: str):
    """``conette_torch.serving`` as shipped (``"bfloat16"``), or built from
    its source with its bf16 casts made f32 (``"float32"``)."""
    import inspect
    import sys
    import types

    import conette_torch.serving as serving

    if dtype == "bfloat16":
        return serving
    src = inspect.getsource(serving)
    mod = types.ModuleType(f"{serving.__name__}_at_f32")
    sys.modules[mod.__name__] = mod  # dataclasses look their module up
    exec(compile(src.replace("torch.bfloat16", "torch.float32"), serving.__file__, "exec"),
         mod.__dict__)
    return mod


def captions(model_dir: str, paths: list, tasks: list, batch: dict, batch_size: int,
             beam: int, dtype: str, mesh=None):
    """``caption_corpus`` over ``paths`` and ``make_sharded_caption_fn`` (or,
    without a mesh, ``caption_batch``) over ``batch``; plain values."""
    from conette_torch.huggingface.model import CoNeTTEModel

    serving = serving_at(dtype)
    model = CoNeTTEModel.from_pretrained(model_dir, device="cpu")
    corpus = serving.caption_corpus(model, paths, task=tasks, batch_size=batch_size,
                                    beam_size=beam, mesh=mesh)
    if mesh is None:
        _, preds, lprobs = serving.caption_batch(model, batch["wav"], batch["lens"], batch["bos"], beam)
    else:
        preds, lprobs = serving.make_sharded_caption_fn(model, mesh, beam)(
            batch["wav"], batch["lens"], batch["bos"])
    return ([(r.fname, r.caption, r.lprob, r.task) for r in corpus], preds.numpy(),
            lprobs.numpy())


def sharded_captions(rank: int, world: int, *args):
    from conette_torch.parallel.mesh import make_mesh

    return captions(*args, mesh=make_mesh(world))


# -------------------------------------------------------- placements, gathers
def gathers_and_placements(rank: int, world: int, params: dict):
    """``gather_to_host0`` of this rank's rows and of a replicated value,
    ``param_sharding`` of ``params`` on a (1, world) mesh as {leaf: {dim:
    mesh dim}}, and ``shard_batch``/``local_part``/``full_value`` round trips."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard

    from conette_torch.parallel import mesh as pmesh
    from conette_torch.parallel.distributed import gather_to_host0
    from conette_torch.weights import named_leaves, to_torch

    rows = np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * rank
    tiled = gather_to_host0(torch.from_numpy(rows))
    repl = gather_to_host0(np.full((2,), 7.0 + rank), replicated=True)
    tree = to_torch(params)
    mesh = pmesh.make_mesh(world, model_parallel=world)
    specs = {name: {p.dim: dim_name for dim_name, p in zip(mesh.mesh_dim_names, s.placements)
                    if isinstance(p, Shard)}
             for name, s in named_leaves(pmesh.param_sharding(tree, mesh))}
    w = tree["decoder"]["layers"][0]["linear1"]["weight"]
    sharding = pmesh.param_sharding(tree, mesh)["decoder"]["layers"][0]["linear1"]["weight"]
    block = pmesh.local_part(w, sharding, mesh)
    back = pmesh.full_value(block, sharding, mesh)
    dp_mesh = pmesh.make_mesh(world, model_parallel=1)
    batch = {"x": torch.arange(8).reshape(4, 2)}
    mine = pmesh.shard_batch(batch, dp_mesh)["x"].numpy()
    return (tiled, repl, specs, tuple(block.shape), bool(torch.equal(back, w)), mine,
            dp_mesh.get_coordinate(), mesh.get_coordinate())


def first_loss(rank: int, world: int, params: dict, batch: dict, config: dict):
    """The sharded step's loss on its first batch (DP = ``world``, mixup off)."""
    import torch

    from conette_torch.models.conette import ConetteConfig
    from conette_torch.parallel.mesh import make_mesh, shard_batch
    from conette_torch.train import optim, step
    from conette_torch.weights import to_torch

    cfg = ConetteConfig(**config)
    tree = to_torch(params)
    opt, _ = optim.get_optimizer(tree, "AdamW", lr=1e-3, weight_decay=0.01, sched_name="none")
    state = step.init_train_state(tree, opt)
    mesh = make_mesh(world)
    local = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
    state, fn = step.make_sharded_train_step(cfg, opt, mesh, state, local, use_mixup=False)
    _, metrics = fn(state, local, torch.Generator().manual_seed(3))
    return float(metrics["train/loss"])


# ------------------------------------------------------------- conette-train
def train_args(hdf_dir: str, log_root: str, bsize: int) -> list[str]:
    """``main_train`` at tiny widths with the production hyperparameters of
    ``expt=hp_clotho_v2`` (dropout, mixup, SpecAugmentRatio on), 2 epochs of
    ``trainer=lim2``, checkpoints on the validation loss, and the pad shapes
    fixed so that one and several processes collate alike."""
    return ["expt=hp_clotho_v2", "trainer=lim2", "trainer.max_epochs=2",
            "trainer.log_every_n_steps=1", "ckpts.monitor=val/loss",
            "ckpts.fallback_monitor=val/loss", "ckpts.mode=min", f"dm.hdf_root={hdf_dir}",
            "dm.train_hdfs=[clotho_dev_x.hdf]", "dm.val_hdfs=[clotho_val_x.hdf]", "dm.test_hdfs=[]",
            f"dm.bsize={bsize}", "dm.fixed_shapes=true", "pl.d_model=32", "pl.nhead=2",
            "pl.num_decoder_layers=2", "pl.dim_feedforward=64", "pl.max_pred_size=6",
            "pl.min_pred_size=1", "pl.beam_size=1", f"log_root={log_root}", "device=cpu"]


def train(rank: int, world: int, hdf_dir: str, log_root: str, bsize: int, extra: list):
    """``main_train`` in this process of the group; the model-backed
    metrics held unavailable (no download)."""
    from conette_torch.metrics.functional import bert_score, fense, fluency
    from conette_torch.train.main import main_train

    for cache, key in ((bert_score._CACHE, "embed"), (fense._CACHE, "model"),
                       (fluency._CACHE, "echecker")):
        cache[key] = None
    out = main_train(train_args(hdf_dir, log_root, bsize) + list(extra))
    return out["run_dir"], out["fit"].global_step


# -------------------------------------------------------- sharded checkpoint
def sharded_checkpoint(rank: int, world: int, ckpt_root: str) -> list:
    """One step of the tiny model with its feed-forward split over ``model``
    (TP = ``world``), then its tree saved by every process with
    ``backend="orbax"`` under ``ckpt_root/dcp`` and, gathered, as
    ``params.npz`` under ``ckpt_root/npz`` by rank 0. Returns this
    process's (name, block shape) of the split leaves."""
    import os

    import torch

    from conette_torch.models.conette import conette_init
    from conette_torch.parallel.mesh import make_mesh, shard_batch
    from conette_torch.train import optim, step
    from conette_torch.train.checkpoint import save_checkpoint
    from conette_torch.weights import named_leaves

    mesh = make_mesh(world, model_parallel=world)
    cfg = small_config()
    params = conette_init(torch.Generator().manual_seed(0), cfg)
    whole_shapes = {n: tuple(t.shape) for n, t in named_leaves(params)}
    opt, _ = optim.get_optimizer(params, "AdamW", lr=5e-3, weight_decay=2.0, sched_name="none")
    state = step.init_train_state(params, opt)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in step_batches(1)[0].items()}, mesh)
    state, fn = step.make_sharded_train_step(cfg, opt, mesh, state, batch, grad_clip_norm=1.0)
    state, _ = fn(state, batch, torch.Generator().manual_seed(7))
    save_checkpoint(os.path.join(ckpt_root, "dcp"), state.params, opt_state=opt, step=1,
                    meta={"world": world}, backend="orbax", mesh=mesh)
    whole, opt_flat = step.gather_params(state.params, mesh), step.gather_opt_state(opt, mesh)
    if rank == 0:
        save_checkpoint(os.path.join(ckpt_root, "npz"), whole, opt_state=opt_flat, step=1,
                        meta={"world": world})
    return [(n, tuple(t.shape)) for n, t in named_leaves(state.params)
            if tuple(t.shape) != whole_shapes[n]]
