"""conette-train: the full training pipeline, on one card or several.

Counterpart of ``conette_tpu/train/main.py`` (the reference's
``main_train``, ``src/conette/train.py:359-527``), in the same phases:

1/6 setup (``train/run_setup.py``): seed, run dir, ``RunLogger``,
    ``debug=true`` → ``torch.autograd.set_detect_anomaly``;
2/6 tokenizer and the train-time transform (SpecAugmentRatio on the frame
    embeddings);
3/6 datamodule (HDF), model parameters and optimizer;
4/6 fit (``train/loop.py``): the train step of ``train/step.py``, a
    validation each epoch (multi-reference forced loss and generated
    candidates → the CIDEr-D/FENSE monitors, ``train/eval_run.py``) and
    monitored checkpoints with a ``best`` link;
5/6 test with the best checkpoint: beam generation, ``AllMetrics`` scoring
    and the CSV/DCASE export;
6/6 artifacts (``train/artifacts.py``): config, tokenizer, metrics,
    durations, csums.

Run as ``python -m conette_torch.train.main <overrides>`` (the JAX
package's overrides and ``conf/`` tree). It trains on ``cuda`` unless given
``device=cpu`` (or ``main_train(argv, device="cpu")``), and without a CUDA
device it raises. TF32 is off on the card, so f32 steps compute in f32.
``trainer.profiler.name=jax`` (the conf tree's name) traces the fit loop
with ``torch.profiler`` into ``{run_dir}/profile/trace.json``, the
program's spans (``utils/profiling.py``) in it as ``user_annotation``
ranges. At fit's end the spans' and counters' summary is logged as
``fit_spans``, beside ``fit_batch_wait_s``.

Several cards take one process each: ``torchrun --nproc-per-node N -m
conette_torch.train.main ...`` (or an ``srun`` of N tasks). The processes
form a ``(N / model_parallel, model_parallel)`` mesh (``parallel/mesh.py``)
and train with ``make_sharded_train_step``: each reads its rows of every
global batch of ``dm.bsize × N / model_parallel`` rows from the datamodule,
with the pad shapes fixed so that every process collates alike, and
``trainer.model_parallel`` splits the decoder's feed-forward blocks.
Validation, test, checkpoints, the artifacts and the profiler run on
rank 0, on the whole parameters gathered from the processes' blocks; rank
0 hands the validation metrics to the others. A ``trainer.data_parallel``
larger than the world raises and names the launch it needs.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
from typing import Any, Optional

import torch

from conette_torch.train.run_setup import run_tag, setup_run  # noqa: F401  (re-export)

pylog = logging.getLogger(__name__)

def _spec_aug_fn(cfg) -> Any:
    """The train-time transform of the ``audio_t.train`` group (the
    production SpecAugmentRatio on embeddings), or of the legacy
    ``dm.train_audio_transform`` switch; None for none."""
    aug_cfg = dict(cfg.get("audio_t", {}).get("train") or {})
    target = str(aug_cfg.get("_target_", ""))
    from conette_torch.train import augment

    if target.endswith("SpecAugmentRatio"):
        return functools.partial(
            augment.spec_augment_ratio,
            time_ratios=tuple(float(r) for r in aug_cfg.get("time_ratios", (0.0, 0.1))),
            time_stripes_num=int(aug_cfg.get("time_stripes_num", 2)),
            freq_ratios=tuple(float(r) for r in aug_cfg.get("freq_ratios", (0.0, 0.1))),
            freq_stripes_num=int(aug_cfg.get("freq_stripes_num", 2)),
        )
    if target.endswith("SpecAugment"):
        return functools.partial(
            augment.spec_augment,
            time_drop_width=int(aug_cfg.get("time_max_width", 64)),
            time_stripes_num=int(aug_cfg.get("time_stripes_num", 2)),
            freq_drop_width=int(aug_cfg.get("freq_max_width", 28)),
            freq_stripes_num=int(aug_cfg.get("freq_stripes_num", 2)),
        )
    if cfg.get("dm", {}).get("train_audio_transform", "none") == "spec_augment_ratio":
        return augment.spec_augment_ratio
    return None


def _train_mesh(tr_cfg, world: int) -> Any:
    """The mesh of a launch of ``world`` processes, one a card (None: one
    process trains alone). ``trainer.data_parallel`` (``auto`` or a count)
    and ``trainer.model_parallel`` must fit the world: a count larger than
    it raises and names the launch it needs."""
    dp_cfg = tr_cfg.get("data_parallel", "auto")
    mp_size = int(tr_cfg.get("model_parallel", 1) or 1)
    wanted = max(dp_cfg if isinstance(dp_cfg, int) else 1, mp_size)
    if wanted > world or world % mp_size:
        n = wanted if world < wanted else mp_size * (world // mp_size + 1)
        raise ValueError(
            f"trainer.data_parallel={dp_cfg}, trainer.model_parallel={mp_size}: a launch of "
            f"{world} process(es) cannot hold them; conette_torch trains one process a card, "
            f"so launch {n}: torchrun --nproc-per-node {n} -m conette_torch.train.main ...")
    if world == 1:
        return None
    from conette_torch.parallel.mesh import make_mesh

    return make_mesh(world, mp_size)


def main_train(
    argv: Optional[list[str]] = None, device: torch.device | str | None = None
) -> dict[str, Any]:
    argv = list(sys.argv[1:] if argv is None else argv)

    from conette_torch.config import load_config
    from conette_torch.huggingface.model import resolve_device

    cfg = load_config("train", argv)
    dev = resolve_device(device if device is not None else cfg.get("device") or "cuda")
    tr_cfg = cfg.get("trainer", {})

    # ------------------------------------------------------------ 1/6 setup
    from conette_torch.parallel.distributed import (
        broadcast_from_main,
        is_main_process,
        world_size,
    )

    run_dir, logger, seed, t_start = setup_run(cfg, argv, device=dev)
    mesh = _train_mesh(tr_cfg, world_size())
    data_rank, data_size = 0, 1
    if mesh is not None:
        from conette_torch.parallel.mesh import axis

        data_rank, data_size = axis(mesh, "data").rank, axis(mesh, "data").size
        pylog.info(f"Training over a mesh of {world_size()} processes "
                   f"(data {data_size} × model {world_size() // data_size})")
    pylog.info(f"Training on {dev}")

    # ----------------------------------------------- 2/6 tokenizer + tfms
    from conette_torch.tokenization import AACTokenizer

    tokenizer = AACTokenizer(**dict(cfg.get("tok", {})))

    # -------------------------------------------------- 3/6 dm + model
    from conette_torch.data.datamodule import HDFDataModule
    from conette_torch.models.conette import (
        ConetteConfig,
        add_task_tokens,
        build_forbid_rep_mask,
        conette_init,
    )

    dm_cfg = cfg.get("dm", {})
    hdf_root = dm_cfg.get("hdf_root", "data/HDF")

    def resolve(paths: list[str]) -> list[str]:
        return [p if os.path.isabs(p) else os.path.join(hdf_root, p) for p in paths]

    dm = HDFDataModule(
        tokenizer,
        train_fpaths=resolve(dm_cfg.get("train_hdfs", [])),
        val_fpaths=resolve(dm_cfg.get("val_hdfs", [])),
        test_fpaths=resolve(dm_cfg.get("test_hdfs", [])),
        predict_fpaths=resolve(dm_cfg.get("predict_hdfs", [])),
        bsize=int(dm_cfg.get("bsize", 512)),
        main_hdf_pattern=dm_cfg.get("main_hdf_pattern"),
        balance_mode=dm_cfg.get("balance_mode", "none"),
        main_hdf_duplicate=dm_cfg.get("main_hdf_duplicate"),
        main_hdf_min=dm_cfg.get("main_hdf_min"),
        main_hdf_balanced=dm_cfg.get("main_hdf_balanced"),
        n_added_data=dm_cfg.get("n_added_data"),
        reload_every_n_epochs=int(
            cfg.get_path("trainer.reload_dataloaders_every_n_epochs", 0) or 0
        ),
        caption_quantum=int(dm_cfg.get("caption_quantum", 4)),
        caption_max_len=int(dm_cfg.get("caption_max_len", 64)),
        seed=seed,
        process_rank=data_rank,
        process_count=data_size,
        fixed_shapes=bool(dm_cfg.get("fixed_shapes", False)),
    )
    dm.setup_fit()
    dm.setup_test()

    pl_cfg = cfg.get("pl", {})
    task_mode = pl_cfg.get("task_mode", "ds_src")
    task_names = tuple(pl_cfg.get("task_names", ("clotho",)))
    task_token_ids = add_task_tokens(tokenizer, task_names, task_mode)

    model_cfg = ConetteConfig(
        vocab_size=tokenizer.get_vocab_size(),
        task_mode=task_mode,
        task_names=task_names,
        label_smoothing=float(pl_cfg.get("label_smoothing", 0.2)),
        mixup_alpha=float(pl_cfg.get("mixup_alpha", 0.4)),
        min_pred_size=int(pl_cfg.get("min_pred_size", 3)),
        max_pred_size=int(pl_cfg.get("max_pred_size", 20)),
        beam_size=int(pl_cfg.get("beam_size", 3)),
        nhead=int(pl_cfg.get("nhead", 8)),
        d_model=int(pl_cfg.get("d_model", 256)),
        num_decoder_layers=int(pl_cfg.get("num_decoder_layers", 6)),
        decoder_dropout_p=float(pl_cfg.get("decoder_dropout_p", 0.2)),
        dim_feedforward=int(pl_cfg.get("dim_feedforward", 2048)),
        proj_dropout_p=float(pl_cfg.get("proj_dropout_p", 0.5)),
        bos_id=tokenizer.bos_token_id,
        eos_id=tokenizer.eos_token_id,
        pad_id=tokenizer.pad_token_id,
    )

    def task_token_fn(item: dict) -> int:
        if task_mode == "none":
            return model_cfg.bos_id
        name = item["dataset"]
        if task_mode == "ds_src" and item.get("source"):
            name = f"{item['dataset']}_{item['source']}".lower()
        return task_token_ids.get(name, model_cfg.bos_id)

    dm.task_token_fn = task_token_fn
    spec_aug_fn = _spec_aug_fn(cfg)

    from conette_torch.utils.csum import csum_module
    from conette_torch.weights import map_tree

    params = conette_init(torch.Generator().manual_seed(seed), model_cfg)
    pylog.info(f"Model csum at start: {csum_module(params)}")
    logger.log_hyperparams({"start_csum": csum_module(params)})

    # resume: a weight warm start; the optimizer's moments are restored
    # below, once the optimizer exists
    resumed_opt_flat = None
    loaded: dict[str, Any] = {}
    if cfg.get("resume"):
        from conette_torch.huggingface.convert import flatten_pytree, unflatten_pytree
        from conette_torch.train.checkpoint import load_checkpoint
        from conette_torch.weights import to_numpy, to_torch

        loaded = load_checkpoint(cfg["resume"], cfg.get("ign_weights"))
        flat = flatten_pytree(to_numpy(params))
        loaded_flat = flatten_pytree(to_numpy(loaded["params"]))
        # strict_resume: the checkpoint's keys must cover the model exactly
        # unless ign_weights already dropped some
        if bool(cfg.get("strict_resume", True)) and not cfg.get("ign_weights"):
            missing = sorted(set(flat) - set(loaded_flat))
            unexpected = sorted(set(loaded_flat) - set(flat))
            if missing or unexpected:
                raise ValueError(
                    f"strict resume mismatch: {len(missing)} missing "
                    f"(e.g. {missing[:3]}), {len(unexpected)} unexpected "
                    f"(e.g. {unexpected[:3]}); set strict_resume=false or "
                    "ign_weights to load a partial checkpoint"
                )
        bad_shapes = [k for k in loaded_flat if k in flat and flat[k].shape != loaded_flat[k].shape]
        if bad_shapes:
            raise ValueError(
                f"resume shape mismatch for {bad_shapes[:5]} "
                f"(checkpoint vs model); use ign_weights to drop them"
            )
        flat.update({k: v for k, v in loaded_flat.items() if k in flat})
        params = to_torch(unflatten_pytree(flat))
        if cfg.get("resume_opt_state", True) and not cfg.get("ign_weights"):
            resumed_opt_flat = loaded.get("opt_state_flat")
        pylog.info(f"Resumed weights from {cfg['resume']} (csum {csum_module(params)})")
    params = map_tree(lambda t: t.to(dev), params)

    from conette_torch.train.optim import ReduceLROnPlateau, get_optimizer
    from conette_torch.train.step import (
        gather_params,
        init_train_state,
        make_sharded_train_step,
        make_train_step,
    )

    max_epochs = int(tr_cfg.get("max_epochs", 400))
    base_lr = float(pl_cfg.get("lr", 5e-4))
    sched_name = pl_cfg.get("sched_name", "cos_decay")
    sched_kwargs = dict(pl_cfg.get("sched_kwargs", {}))
    optimizer, lr_schedule = get_optimizer(
        params,
        optim_name=pl_cfg.get("optim_name", "AdamW"),
        lr=base_lr,
        weight_decay=float(pl_cfg.get("weight_decay", 2.0)),
        betas=tuple(pl_cfg.get("betas", (0.9, 0.999))),
        eps=float(pl_cfg.get("eps", 1e-8)),
        use_custom_wd=bool(pl_cfg.get("use_custom_wd", True)),
        sched_name=sched_name,
        sched_n_steps=max_epochs,
        sched_kwargs=sched_kwargs,
    )
    state = init_train_state(params, optimizer)
    if resumed_opt_flat is not None:
        from conette_torch.train.checkpoint import restore_opt_state

        try:
            restore_opt_state(resumed_opt_flat, optimizer)
            state.step = int(loaded["meta"].get("global_step", loaded["meta"].get("step", 0)))
            pylog.info("Restored optimizer state (resume with momentum).")
        except ValueError as err:
            pylog.warning(f"Could not restore optimizer state: {err}")

    # ------------------------------------------------------------ 4/6 fit
    step_kw = dict(
        use_mixup=model_cfg.mixup_alpha > 0,
        grad_clip_norm=tr_cfg.get("grad_clip_norm"),
        accumulate_grad_batches=int(tr_cfg.get("accumulate_grad_batches", 1) or 1),
    )
    if mesh is None:
        train_step = make_train_step(model_cfg, **step_kw)
    else:
        local_rows = {"audio_lens": torch.zeros(dm.bsize)}
        state, train_step = make_sharded_train_step(model_cfg, optimizer, mesh, state, local_rows,
                                                    **step_kw)
    ema_decay = tr_cfg.get("ema_decay")
    swa_start_cfg = tr_cfg.get("swa_start")
    swa_start = None
    if swa_start_cfg is not None:
        swa_start = (
            int(float(swa_start_cfg) * max_epochs)
            if isinstance(swa_start_cfg, float) or float(swa_start_cfg) < 1
            else int(swa_start_cfg)
        )
    plateau = None
    if lr_schedule is None:
        plateau = ReduceLROnPlateau(
            mode=sched_kwargs.get("mode", "min"),
            factor=sched_kwargs.get("factor", 0.1),
            patience=sched_kwargs.get("patience", 10),
        )

    from conette_torch.metrics.functional import fense as fense_mod
    from conette_torch.models.layers import RowDraws
    from conette_torch.train.checkpoint import CheckpointManager
    from conette_torch.train.eval_run import EvalRunner

    ck_cfg = cfg.get("ckpts", {})
    monitor = ck_cfg.get("monitor", "val/fense")
    if "fense" in monitor and not fense_mod.is_available():
        monitor = ck_cfg.get("fallback_monitor", "val/cider_d")
        pylog.info(f"FENSE unavailable; monitoring {monitor} instead")
    ckpt = CheckpointManager(
        os.path.join(run_dir, "checkpoints"),
        monitor=monitor,
        mode=ck_cfg.get("mode", "max"),
        top_k=int(ck_cfg.get("top_k", 1)),
        save_after_epoch=int(ck_cfg.get("save_after_epoch", 0)),
    )

    forbid_np = build_forbid_rep_mask(tokenizer, "content_words")
    eval_runner = EvalRunner(
        dm=dm,
        tokenizer=tokenizer,
        model_cfg=model_cfg,
        run_dir=run_dir,
        logger=logger,
        forbid=None if forbid_np is None else torch.from_numpy(forbid_np).to(dev),
        gen_val=pl_cfg.get("gen_val_cands", "generate"),
        gen_test=pl_cfg.get("gen_test_cands", "generate"),
        lim_val=tr_cfg.get("limit_val_batches"),
        lim_test=tr_cfg.get("limit_test_batches"),
        monitor=monitor,
        device=dev,
    )

    lim_train = tr_cfg.get("limit_train_batches")
    log_every_n_steps = max(int(tr_cfg.get("log_every_n_steps", 50)), 1)
    gen = torch.Generator(dev).manual_seed(seed)
    aug_gen = torch.Generator(dev).manual_seed(seed + 7)
    pinned = dev.type == "cuda"

    def to_train_batch(b: dict, step: int) -> dict:
        # copied as they are from pinned memory, then cast on the device: a
        # cast on the way would stage them in pageable memory (a host wait)
        batch = {k: b[k].to(dev, non_blocking=pinned) for k in ("audio", "audio_lens", "captions")}
        batch["audio_lens"] = batch["audio_lens"].long()
        batch["captions"] = batch["captions"].long()
        if spec_aug_fn is not None:
            # stripes sized and placed within each row's real length, and
            # drawn for the global batch, so that a row's stripes do not
            # depend on the process that holds it
            rows = len(batch["audio"])
            draws = aug_gen if mesh is None else RowDraws(aug_gen, data_rank * rows, data_size * rows)
            batch["audio"] = spec_aug_fn(draws, batch["audio"], time_valid=batch["audio_lens"])
        return batch

    whole = functools.partial(gather_params, mesh=mesh)

    if cfg.get("val_on_start") and dm.num_eval_loaders("val") > 0:
        start_params = whole(state.params)
        start_metrics = broadcast_from_main(
            eval_runner.run_validation(start_params, -1) if is_main_process() else None)
        logger.log_metrics({f"start_{k}": v for k, v in start_metrics.items()})
        pylog.info(f"val_on_start: {start_metrics}")

    if (
        cfg.get("test_on_start")
        and cfg.get("resume")
        and dm.num_eval_loaders("test") > 0
    ):
        start_params = whole(state.params)
        if is_main_process():
            eval_runner.run_test("start", start_params)

    profiler_cfg = dict(tr_cfg.get("profiler") or {})
    tracing = contextlib.nullcontext()
    if profiler_cfg.get("name") == "jax" and is_main_process():
        from conette_torch.utils.profiling import trace

        # the fit's spans run on the prefetch thread too
        tracing = trace(profiler_cfg.get("trace_dir") or os.path.join(run_dir, "profile"), all_threads=True)

    from conette_torch.train.loop import fit
    from conette_torch.utils import profiling

    spans_before = profiling.summary()
    with tracing:
        fit_res = fit(
            state=state,
            gen=gen,
            dm=dm,
            train_step=train_step,
            to_train_batch=to_train_batch,
            eval_runner=eval_runner,
            ckpt=ckpt,
            logger=logger,
            tokenizer=tokenizer,
            model_cfg=model_cfg,
            lr_schedule=lr_schedule,
            plateau=plateau,
            base_lr=base_lr,
            max_epochs=max_epochs,
            max_steps=int(tr_cfg.get("max_steps", -1) or -1),
            lim_train=lim_train,
            val_every_n_epochs=int(tr_cfg.get("val_every_n_epochs", 1)),
            log_every_n_steps=log_every_n_steps,
            ema_decay=ema_decay,
            swa_start=swa_start,
            pin_memory=pinned,
            debug=bool(cfg.get("debug")),
            mesh=mesh,
        )
    state, swa_params = fit_res.state, fit_res.swa_params
    # the test, the artifacts and the returned state hold whole parameters
    state.params = whole(state.params)
    if swa_params is not None:
        swa_params = whole(swa_params)
    # the fit's spans and counters (utils/profiling.py): count, total and
    # self seconds by name
    fit_spans = profiling.summary(since=spans_before)
    pylog.info(f"fit spans and counters: {fit_spans}")
    logger.log_metrics({
        "fit_duration_s": fit_res.fit_duration,
        "fit_batch_wait_s": fit_res.batch_wait_s,
        "fit_global_step": fit_res.global_step,
        "fit_spans": fit_spans,
    })

    # ------------------------------------------------------------ 5/6 test
    test_scores: dict[str, Any] = {}
    test_by_model: dict[str, dict[str, Any]] = {}
    # testing.run ∈ {"none","last","swa","best"}*: one test (and predict)
    # pass per entry, the evaluator named after the weights under test
    testing_run = cfg.get("testing", {}).get("run", ["best"])
    if isinstance(testing_run, str):
        testing_run = [testing_run]
    testing_run = [str(m) for m in testing_run]
    if (
        cfg.get("test_after_fit", True)
        and (dm.num_eval_loaders("test") > 0 or dm.num_eval_loaders("predict") > 0)
        and is_main_process()
        and testing_run != ["none"]
    ):
        # the reference's order (last → swa → best), so best gives `test`
        candidates: list[tuple[str, Any]] = []
        for mode in ("last", "swa", "best"):
            if mode not in testing_run:
                continue
            if mode == "last":
                candidates.append(("last", state.params))
            elif mode == "swa":
                if swa_params is None:
                    pylog.warning(
                        "testing.run includes 'swa' but no SWA snapshots "
                        "were taken (trainer.swa_start unset or past "
                        "max_epochs); skipping"
                    )
                else:
                    candidates.append(("swa", swa_params))
            elif ckpt.best_dir is not None:
                from conette_torch.train.checkpoint import load_checkpoint

                pylog.info(f"Testing with best checkpoint {ckpt.best_dir}")
                best = load_checkpoint(ckpt.best_dir)["params"]
                candidates.append(
                    (f"best_{monitor.rsplit('/', 1)[-1]}", map_tree(lambda t: t.to(dev), best))
                )
            elif "last" not in testing_run:
                pylog.warning("Cannot find best checkpoint; testing with last weights.")
                candidates.append(("last", state.params))
            else:
                pylog.error("Cannot find best checkpoint.")

        for model_name, params_i in candidates:
            test_by_model[model_name] = eval_runner.run_test(model_name, params_i)
        if test_by_model:
            test_scores = next(reversed(test_by_model.values()))
    elif dm.num_eval_loaders("predict") > 0 and is_main_process():
        pylog.warning(
            "dm.predict_hdfs is set but testing is disabled "
            f"(test_after_fit={cfg.get('test_after_fit', True)}, "
            f"testing.run={testing_run}); no predictions exported"
        )

    # ------------------------------------------------------- 6/6 artifacts
    if not is_main_process():
        return {"run_dir": run_dir, "best": None, "test": {}, "test_by_model": {},
                "out": float(cfg.get("out_default", -1.0)), "fit": fit_res}
    from conette_torch.train.artifacts import finalize_run

    out = finalize_run(
        cfg=cfg,
        run_dir=run_dir,
        logger=logger,
        tokenizer=tokenizer,
        params=state.params,
        ckpt=ckpt,
        monitor=monitor,
        t_start=t_start,
    )
    return {
        "run_dir": run_dir,
        "best": ckpt.best_score,
        "test": test_scores,
        "test_by_model": test_by_model,
        "out": out,
        "fit": fit_res,
    }


if __name__ == "__main__":
    main_train()
