"""CoNeTTEModel — the public pretrained-model wrapper.

Counterpart of ``conette_tpu/huggingface/model.py`` (reference
``huggingface/model.py:38-289``):

- ``CoNeTTEModel.from_pretrained(dir)`` restores config + tokenizer +
  weights from a directory holding ``config.json`` and ``params.npz``, as
  either package's ``save_pretrained`` writes it, or ``config.json`` and
  the reference's torch checkpoint (``model.safetensors`` or
  ``pytorch_model.bin``, converted by ``huggingface/convert.py``), or from
  a ``conette-train`` run directory (``checkpoints/best``) of either
  package;
- ``model(x, sr=..., task=..., beam_size=...)`` → ``CoNeTTEOutput`` with
  ``cands / preds / lprobs / mult_* / tasks / tags / tags_probs``:
  preprocess → AudioSet tags at threshold 0.3 → task → beam search (or
  greedy for ``beam_size <= 1``) → detokenize.

The model runs on the card unless the caller asks for the CPU: ``device``
defaults to ``"cuda"``, and without a CUDA device construction raises.
On the card, TF32 is switched off for matmuls and cuDNN convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so the float32 path computes in
float32. With ``compute_dtype=torch.bfloat16`` the encoder runs its log-mel
frontend, blocks and seams through the hand-written CUDA kernels; the
decoder stays f32.

On the card a request runs two captured programs (``conette_torch/graphs.py``),
the counterparts of the JAX package's ``jax.jit``s: the encoder, one CUDA
graph for each padded length (``CoNeTTEPreprocessor``), and the projection
with the beam or greedy search, one graph for each (memory length, dtype,
beam, min, max, forbid mask present) (:meth:`CoNeTTEModel._generate`, as
``_generate_fn``). Both run at ``graphs.REQUEST_BATCH`` rows: a request of fewer
clips is padded to them, a larger one runs in chunks of them. A replay
reads nothing back to the host, and the search's replay stops on the card
once no beam is alive (``graphs.py::conditional_step``). The model
keeps at most ``MAX_MODEL_GRAPHS`` programs of its own (the preprocessor
``MAX_ENCODER_GRAPHS`` encoder graphs) and drops the least recently used.

A request is one root span ``forward`` (``utils/profiling.py``):
``load_resample`` and ``encode`` (the preprocessor's), a ``readback`` of
the clip probabilities, ``_generate``, a ``readback`` of the tokens, which
brings the decode steps each program ran (counted on the card, in the
same read; the span's ``decode_steps``, a mean over the rows), and
``detokenize``.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from typing import Any, Iterable, Optional, Union

import numpy as np
import torch

from conette_torch.decoding.guard import counted
from conette_torch.graphs import GraphCache, conditional_step
from conette_torch.huggingface.audioset import load_audioset_names, probs_to_names
from conette_torch.huggingface.config import CoNeTTEConfig
from conette_torch.huggingface.convert import convert_torch_checkpoint, load_params_npz
from conette_torch.huggingface.preprocessor import BUCKETS_S, AudioInput, CoNeTTEPreprocessor, HostBatches
from conette_torch.models.conette import (
    ConetteConfig,
    add_task_tokens,
    build_forbid_rep_mask,
    conette_init,
    encode_audio,
    forward_generate,
    forward_greedy,
    task_names_to_bos_ids,
)
from conette_torch.models.convnext import convnext_init
from conette_torch.tokenization import AACTokenizer
from conette_torch.utils.profiling import current, span
from conette_torch.weights import save_tree, to_torch

pylog = logging.getLogger(__name__)

# the model's own captured programs: for each bucket, the decode of a
# request at one setting (one memory length a bucket) and the batch of
# serving.caption_corpus at one batch size and beam. Other settings take
# the place of the least recently used.
MAX_MODEL_GRAPHS = 2 * len(BUCKETS_S)
# the host batch buffers of serving.caption_corpus kept on the model: a pair
# for each (rows, bucket length), at most this many (a pair at 32 rows of the
# 30 s bucket holds 246 MB); a corpus of more buckets allocates its buffers
# anew.
MAX_HOST_BATCH_SHAPES = 4


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without CUDA raises: the model
    never drops to the CPU unless asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "conette_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU."
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class CoNeTTEOutput(dict):
    """Dict with attribute access (reference ``CoNeTTEOutput``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as err:
            raise AttributeError(name) from err


class CoNeTTEModel:
    def __init__(
        self,
        config: CoNeTTEConfig,
        *,
        encoder_params: Any | None = None,
        model_params: Any | None = None,
        tokenizer: AACTokenizer | None = None,
        seed: int = 1234,
        compute_dtype: torch.dtype = torch.float32,
        audioset_names: list[str] | None = None,
        device: torch.device | str | None = None,
        verbose: int = 0,
    ) -> None:
        self.config = config
        self.verbose = verbose
        self.device = resolve_device(device)

        if tokenizer is None:
            if config.tokenizer_state is not None:
                tokenizer = AACTokenizer.from_txt_state(config.tokenizer_state)
            else:
                tokenizer = AACTokenizer()
        self.tokenizer = tokenizer

        self.task_token_ids: dict[str, int] = {}
        if self.tokenizer.is_fit():
            self.task_token_ids = add_task_tokens(
                self.tokenizer, tuple(config.task_names), config.task_mode
            )

        fit = self.tokenizer.is_fit()
        self.model_cfg = ConetteConfig(
            vocab_size=max(self.tokenizer.get_vocab_size(), 8),
            task_mode=config.task_mode,
            task_names=tuple(config.task_names),
            label_smoothing=config.label_smoothing,
            mixup_alpha=config.mixup_alpha,
            min_pred_size=config.min_pred_size,
            max_pred_size=config.max_pred_size,
            beam_size=config.beam_size,
            nhead=config.nhead,
            d_model=config.d_model,
            num_decoder_layers=config.num_decoder_layers,
            decoder_dropout_p=config.decoder_dropout_p,
            dim_feedforward=config.dim_feedforward,
            bos_id=self.tokenizer.bos_token_id if fit else 1,
            eos_id=self.tokenizer.eos_token_id if fit else 2,
            pad_id=self.tokenizer.pad_token_id if fit else 0,
        )

        gen = torch.Generator().manual_seed(seed)
        if encoder_params is None:
            encoder_params = convnext_init(gen)
        if model_params is None:
            model_params = conette_init(gen, self.model_cfg)
        self.preprocessor = CoNeTTEPreprocessor(
            encoder_params,
            device=self.device,
            compute_dtype=compute_dtype,
        )
        self.params = to_torch(model_params, self.device)
        self.graphs = GraphCache(MAX_MODEL_GRAPHS)
        self.host_batches = HostBatches(MAX_HOST_BATCH_SHAPES)

        self.forbid_rep_mask = None
        if fit:
            self.forbid_rep_mask = self._mask_tensor(
                build_forbid_rep_mask(self.tokenizer, "content_words")
            )

        self.audioset_names = audioset_names or load_audioset_names()
        self.default_task = list(config.task_names)[0] if config.task_names else "clotho"

    @property
    def tasks(self) -> list[str]:
        """Valid task names."""
        return list(self.config.task_names)

    @property
    def encoder_params(self) -> Any:
        return self.preprocessor.params

    def _mask_tensor(self, mask: np.ndarray | None) -> torch.Tensor | None:
        return None if mask is None else torch.from_numpy(mask).to(self.device)

    def _check_tasks(self, tasks: Iterable[str]) -> None:
        for t in tasks:
            if t not in self.config.task_names:
                raise ValueError(f"Invalid task {t!r}. (not in {list(self.config.task_names)})")

    def __call__(self, *args: Any, **kwargs: Any) -> CoNeTTEOutput:
        return self.forward(*args, **kwargs)

    @torch.inference_mode()
    @span("forward")  # a request's root span
    def forward(
        self,
        x: AudioInput,
        sr: Union[None, int, Iterable[int]] = None,
        x_shapes: Any = None,
        preprocess: bool = True,
        threshold: float = 0.3,
        task: Union[str, list[str], None] = None,
        beam_size: Optional[int] = None,
        min_pred_size: Optional[int] = None,
        max_pred_size: Optional[int] = None,
        forbid_rep_mode: Optional[str] = None,
    ) -> CoNeTTEOutput:
        # validate tasks before the (expensive) preprocessing pass
        if task is not None:
            self._check_tasks([task] if isinstance(task, str) else list(task))

        if preprocess:
            batch = self.preprocessor(x, sr, x_shapes)
            with span("readback"):
                clip_probs = batch.pop("clip_probs").cpu().numpy()
        else:
            batch = {
                "audio": torch.as_tensor(x, dtype=torch.float32, device=self.device),
                "audio_shape": torch.as_tensor(np.asarray(x_shapes), device=self.device),
            }
            clip_probs = None

        bsize = int(batch["audio"].shape[0])
        current().set(rows=bsize, frames=int(batch["audio"].shape[1]))
        if task is None:
            tasks = [self.default_task] * bsize
        elif isinstance(task, str):
            tasks = [task] * bsize
        elif len(list(task)) != bsize:
            raise ValueError(f"Invalid number of tasks ({len(list(task))} vs {bsize} inputs)")
        else:
            tasks = list(task)
        self._check_tasks(tasks)
        bos_np = task_names_to_bos_ids(self.model_cfg, self.task_token_ids, tasks)

        beam = beam_size if beam_size is not None else self.config.beam_size
        min_p = min_pred_size if min_pred_size is not None else self.config.min_pred_size
        max_p = max_pred_size if max_pred_size is not None else self.config.max_pred_size
        if forbid_rep_mode is None:
            forbid = self.forbid_rep_mask
        else:
            forbid = self._mask_tensor(build_forbid_rep_mask(self.tokenizer, forbid_rep_mode))

        lens = batch["audio_shape"][:, -1]
        steps: list[torch.Tensor] = []
        preds, lprobs, mult_preds, mult_lprobs = self._generate(
            batch["audio"].float(), lens, bos_np, forbid, beam, min_p, max_p, steps_out=steps,
        )
        with span("readback") as read:
            # the steps each row's program ran come back in the tokens' read
            both = torch.cat([preds.to(torch.int32), steps[0][:, None].to(torch.int32)], dim=1).cpu().numpy()
            preds_np = np.ascontiguousarray(both[:, :-1])
            mult_np = mult_preds.to(torch.int32).cpu().numpy()
            lprobs_np, mult_lprobs_np = lprobs.cpu().numpy(), mult_lprobs.cpu().numpy()
            read.set(decode_steps=float(both[:, -1].mean()))
        with span("detokenize"):
            out = CoNeTTEOutput(
                cands=[self._decode_pred(row) for row in preds_np],
                preds=preds_np,
                lprobs=lprobs_np,
                mult_cands=[[self._decode_pred(r) for r in rows] for rows in mult_np],
                mult_preds=mult_np,
                mult_lprobs=mult_lprobs_np,
                tasks=tasks,
            )
            if clip_probs is not None:
                out["tags_probs"] = clip_probs
                out["tags"] = probs_to_names(clip_probs, threshold, self.audioset_names)
        return out

    @torch.inference_mode()
    @span("_generate")
    def _generate(self, audio, lens, bos_ids, forbid, beam: int, min_p: int, max_p: int,
                  steps_out: list | None = None):
        """The projection and the beam search (greedy at ``beam <= 1``) of
        (B, T, 768) frame embeddings, their (B,) lengths and (B,) BOS ids
        (a tensor or a numpy array) → (preds, avg lprobs, mult preds, mult
        lprobs). On the card one captured program for each (memory length,
        dtype, beam, min, max, forbid mask present), replayed over chunks of
        ``REQUEST_BATCH`` rows. ``steps_out``, where given, gets the (B,)
        device tensor of the decode steps each row's program ran."""
        audio = torch.as_tensor(audio, device=self.device)
        lens = torch.as_tensor(lens, device=self.device).to(torch.int64)
        bos_ids = torch.as_tensor(bos_ids).to(torch.int64)
        key = ("generate", audio.shape[1], audio.dtype, beam, min_p, max_p, forbid is not None)
        fn = functools.partial(self._generate_eager, beam=beam, min_p=min_p, max_p=max_p)
        inputs = (audio, lens, bos_ids) + ((forbid,) if forbid is not None else ())
        *outs, steps = self.graphs.run_batched(key, fn, inputs, self.device, n_batched=3)
        if steps_out is not None:
            steps_out.append(steps)
        return tuple(outs)

    def _generate_eager(self, audio, lens, bos_ids, forbid=None, *, beam: int, min_p: int,
                        max_p: int):
        """:meth:`_generate`'s program: its four outputs and the steps run,
        (B,) rows of one count."""
        memory, pad_mask = encode_audio(self.params, self.model_cfg, audio, lens)
        steps = torch.zeros((), dtype=torch.int64, device=memory.device)
        guard = counted(conditional_step, steps)
        if beam <= 1:
            g = forward_greedy(
                self.params, self.model_cfg, memory, pad_mask, bos_ids,
                min_pred_size=min_p, max_pred_size=max_p, forbid_rep_mask=forbid, guard=guard,
            )
            lp = torch.log_softmax(g.logits.transpose(1, 2), dim=-1)
            sel = lp.gather(-1, g.preds[..., None])[..., 0]
            valid = g.preds != self.model_cfg.pad_id
            avg = torch.where(valid, sel, 0.0).sum(dim=1) / valid.sum(dim=1).clamp_min(1)
            return g.preds, avg, g.preds[:, None, :], avg[:, None], steps.expand(len(audio))
        res = forward_generate(
            self.params, self.model_cfg, memory, pad_mask, bos_ids,
            beam_size=beam, min_pred_size=min_p, max_pred_size=max_p,
            forbid_rep_mask=forbid, guard=guard,
        )
        return (res.best_preds, res.best_avg_lprobs, res.global_preds, res.global_avg_lprobs,
                steps.expand(len(audio)))

    def _decode_pred(self, ids: np.ndarray) -> str:
        toks = []
        for t in ids.tolist():
            if t == self.model_cfg.eos_id:
                break
            toks.append(t)
        return self.tokenizer.decode_single(toks)

    # --------------------------------------------------------- persistence
    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        self.config.tokenizer_state = self.tokenizer.get_txt_state()
        self.config.save_pretrained(save_directory)
        save_tree(
            os.path.join(save_directory, "params.npz"),
            {"encoder": self.encoder_params, "model": self.params},
        )
        with open(os.path.join(save_directory, "audioset_names.json"), "w") as f:
            json.dump(self.audioset_names, f)

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: str,
        device: torch.device | str | None = None,
        offline: bool = False,
        token: str | None = None,
        verbose: int = 0,
        config: CoNeTTEConfig | None = None,
        **kwargs: Any,
    ) -> "CoNeTTEModel":
        """Load a directory with ``config.json`` and either ``params.npz``
        or the reference's torch checkpoint (``model.safetensors`` /
        ``pytorch_model.bin``); a checkpoint's pickled tokenizer state is
        used when ``config.json`` has none. ``config``, when given, is used
        instead of the directory's ``config.json`` (``conette(path,
        config_kwds=...)`` passes one). ``offline`` and ``token`` are the
        reference's Hub options; a local directory needs neither, and a
        path that is not one raises ``FileNotFoundError`` whatever they are."""
        del offline, token  # no Hub download here: local directories only
        path = pretrained_model_name_or_path
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"Model directory {path!r} not found (conette_torch loads local "
                "directories only; download the snapshot first)."
            )
        best_dir = os.path.join(path, "checkpoints", "best")
        if not os.path.isfile(os.path.join(path, "config.json")) and os.path.isdir(best_dir):
            return cls._from_train_run(best_dir, config, device=device, verbose=verbose, **kwargs)
        if config is None:
            config = CoNeTTEConfig.from_pretrained(path)

        names_file = os.path.join(path, "audioset_names.json")
        if os.path.isfile(names_file):
            with open(names_file) as f:
                audioset_names = json.load(f)
        else:
            audioset_names = load_audioset_names([path])

        encoder_params = model_params = tokenizer = None
        npz = os.path.join(path, "params.npz")
        if os.path.isfile(npz):
            tree = load_params_npz(npz)
            encoder_params, model_params = tree["encoder"], tree["model"]
        else:
            state = _load_torch_state(path)
            if state is not None:
                encoder_params, model_params, extra = convert_torch_checkpoint(state)
                if extra and config.tokenizer_state is None:
                    tok_state = _extract_tokenizer_state(extra)
                    if tok_state is not None:
                        tokenizer = AACTokenizer()
                        tokenizer.set_state(tok_state)
            else:
                pylog.warning(f"No weights found in {path!r}; initializing randomly.")
        return cls(
            config,
            encoder_params=encoder_params,
            model_params=model_params,
            tokenizer=tokenizer,
            audioset_names=audioset_names,
            device=device,
            verbose=verbose,
            **kwargs,
        )

    @classmethod
    def _from_train_run(cls, best_dir: str, config: CoNeTTEConfig | None, **kwargs: Any
                        ) -> "CoNeTTEModel":
        """A ``conette-train`` run directory's best checkpoint (either
        package's): the trained decoder and projection, its tokenizer, and
        the configuration from its ``meta.json``. The ConvNeXt encoder is
        not part of a training run (it trains on precomputed embeddings), so
        it is initialised from the seed, as in the JAX package."""
        from conette_torch.train.checkpoint import load_checkpoint

        loaded = load_checkpoint(best_dir)
        tokenizer = loaded.get("tokenizer")
        if config is None:
            mc = loaded["meta"].get("model_cfg", {})
            config = CoNeTTEConfig(
                tokenizer_state=tokenizer.get_txt_state() if tokenizer else None,
                **{
                    k: mc[k]
                    for k in (
                        "task_mode", "task_names", "label_smoothing",
                        "mixup_alpha", "min_pred_size", "max_pred_size",
                        "beam_size", "nhead", "d_model", "num_decoder_layers",
                        "decoder_dropout_p", "dim_feedforward",
                    )
                    if k in mc
                },
            )
        pylog.warning(
            "Loading a train-run checkpoint: the decoder weights are trained, the "
            "ConvNeXt encoder is initialised from the seed unless converted separately."
        )
        return cls(config, model_params=loaded["params"], tokenizer=tokenizer, **kwargs)


def _load_torch_state(path: str) -> dict[str, Any] | None:
    """The reference checkpoint's state dict from ``model.safetensors``
    (when the ``safetensors`` package is importable) or
    ``pytorch_model.bin`` (``torch.load`` with ``weights_only=True``; the
    ``_extra_state_`` payload is unpickled later through the allowlisted
    ``_RemapUnpickler``); None when the directory holds neither."""
    for fname in ("model.safetensors", "pytorch_model.bin"):
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            continue
        if fname.endswith(".safetensors"):
            try:
                from safetensors.numpy import load_file
            except ImportError:
                pylog.warning(f"safetensors is not installed; skipping {fpath!r}")
                continue
            return dict(load_file(fpath))
        return torch.load(fpath, map_location="cpu", weights_only=True)
    return None


def _extract_tokenizer_state(extra: Any) -> Any:
    """Pull a tokenizer state out of the unpickled ``_extra_state_`` blob
    (layout: {"tokenizers.<name>": state, ...} or nested dicts)."""
    if not isinstance(extra, dict):
        return None
    for key, val in extra.items():
        if "tokenizer" in str(key) and isinstance(val, dict) and "tokenizer" in val:
            return val
    return None


def eval_and_disable_grad(*models: Any) -> None:
    """Put models in inference use (the reference helper of the same name):
    an ``nn.Module`` goes to eval mode with its parameters frozen; the
    weights of a :class:`CoNeTTEModel`, plain tensors that it only runs in
    inference mode, stop requiring gradients."""
    for m in models:
        if isinstance(m, torch.nn.Module):
            m.eval()
            m.requires_grad_(False)
        elif isinstance(m, CoNeTTEModel):
            for t in _tensor_leaves((m.params, m.encoder_params)):
                t.requires_grad_(False)


def _tensor_leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensor_leaves(sub)]
    return [tree] if isinstance(tree, torch.Tensor) else []
