"""Validation, test and predict passes of ``conette-train``.

Counterpart of ``conette_tpu/train/eval_run.py`` (the reference's
``AACValidator`` wiring and ``test_after_fit``, ``src/conette/train.py:283-356``):
each epoch the multi-reference forced loss and generated candidates give
the CIDEr-D/FENSE monitors; the test passes decode with beam search, score
with ``AllMetrics`` and export the CSV/DCASE files.

Decoding runs eagerly on the parameters' device (``encode_audio`` and
``forward_generate`` / ``forward_greedy``, which read nothing back to the
host) and run every step of the search; the captured programs of
``graphs.py``, which leave the search once no beam is alive, serve fixed
8-row requests of a model whose weights do not change, and are not used
here.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

pylog = logging.getLogger(__name__)


def make_gen_fn(model_cfg, method: str = "generate"):
    from conette_torch.models.conette import encode_audio, forward_generate, forward_greedy

    @torch.no_grad()
    def gen(params, audio, lens, bos, forbid):
        """→ (best_preds, best_avg_lprobs, all_beams, all_avg_lprobs), the
        decode surface the reference logs per clip (the CSVs' preds /
        lprobs / mpreds / mlprobs columns); greedy is a 1-beam view."""
        memory, pad_mask = encode_audio(params, model_cfg, audio, lens)
        if method == "greedy":
            g = forward_greedy(params, model_cfg, memory, pad_mask, bos, forbid_rep_mask=forbid)
            lp = torch.log_softmax(g.logits.transpose(1, 2), dim=-1)
            sel = lp.gather(-1, g.preds[..., None])[..., 0]
            valid = g.preds != model_cfg.pad_id
            avg = torch.where(valid, sel, 0.0).sum(dim=1) / valid.sum(dim=1).clamp_min(1)
            return g.preds, avg, g.preds[:, None], avg[:, None]
        res = forward_generate(params, model_cfg, memory, pad_mask, bos, forbid_rep_mask=forbid)
        return res.best_preds, res.best_avg_lprobs, res.global_preds, res.global_avg_lprobs

    return gen


def decode_preds(tokenizer, eos_id: int, preds: np.ndarray) -> list[str]:
    out = []
    for row in preds:
        toks = []
        for t in row.tolist():
            if t == eos_id:
                break
            toks.append(t)
        out.append(tokenizer.decode_single(toks))
    return out


class EvalRunner:
    """Owns the decode and loss functions and the per-run scorer state
    (one ``AllMetrics`` per run: FENSE's model load and the Java setup are
    costly; every ``testing.run`` pass shares it). ``device`` is where the
    parameters live; batches are copied there."""

    def __init__(
        self,
        *,
        dm,
        tokenizer,
        model_cfg,
        run_dir: str,
        logger,
        forbid,
        gen_val: str = "generate",
        gen_test: str = "generate",
        lim_val: Optional[int] = None,
        lim_test: Optional[int] = None,
        monitor: str = "val/fense",
        device: torch.device | str = "cpu",
    ) -> None:
        from conette_torch.train.evaluation import Validator
        from conette_torch.train.objective import per_ref_losses, validation_loss

        self.device = torch.device(device)
        self.dm = dm
        self.tokenizer = tokenizer
        self.model_cfg = model_cfg
        self.run_dir = run_dir
        self.logger = logger
        self.forbid = forbid
        self.lim_val = lim_val
        self.lim_test = lim_test
        self.gen_fn = make_gen_fn(model_cfg, method=gen_val)
        self.gen_fn_test = (
            self.gen_fn
            if gen_test == gen_val
            else make_gen_fn(model_cfg, method=gen_test)
        )
        self.val_loss_fn = torch.no_grad()(lambda p, batch: validation_loss(p, model_cfg, batch))
        self.test_losses_fn = torch.no_grad()(lambda p, batch: per_ref_losses(p, model_cfg, batch))
        self.validator = Validator(monitors=(monitor,))
        self._test_metrics: list[Any] = []

    # ------------------------------------------------------------ validation
    def _tensor(self, a) -> torch.Tensor:
        """A batch array on the device; integers as int64 (token ids index
        and gather)."""
        a = np.asarray(a)
        return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a, device=self.device)

    def run_validation(self, params, epoch: int) -> dict:
        self.validator.reset()
        val_losses = []
        for j, b in enumerate(self.dm.eval_batches("val")):
            if self.lim_val is not None and j >= self.lim_val:
                break
            vb = {k: self._tensor(b[k]) for k in ("audio", "audio_lens", "mult_captions")}
            val_losses.append(float(self.val_loss_fn(params, vb)))
            bos = vb["mult_captions"][:, 0, 0]
            preds, _, _, _ = self.gen_fn(
                params, vb["audio"], vb["audio_lens"], bos, self.forbid
            )
            cands = decode_preds(self.tokenizer, self.model_cfg.eos_id, preds.cpu().numpy())
            self.validator.add_batch(cands, b["mult_references"])
        metrics = self.validator.compute()
        metrics["val/loss"] = float(np.mean(val_losses)) if val_losses else 0.0
        return metrics

    # ------------------------------------------------------------- test/pred
    def _decode_and_score_batch(
        self, evaluator, params, b, default_subset: str, with_losses: bool
    ) -> None:
        audio = self._tensor(b["audio"])
        lens = self._tensor(b["audio_lens"])
        mult_caps = self._tensor(b["mult_captions"])
        preds, lprobs, mpreds, mlprobs = self.gen_fn_test(
            params, audio, lens, mult_caps[:, 0, 0], self.forbid
        )
        preds, lprobs, mlprobs = (t.cpu().numpy() for t in (preds, lprobs, mlprobs))
        cands = decode_preds(self.tokenizer, self.model_cfg.eos_id, preds)
        mp = mpreds.cpu().numpy()
        mcands = [
            decode_preds(self.tokenizer, self.model_cfg.eos_id, mp[i])
            for i in range(mp.shape[0])
        ]
        losses = None
        if with_losses:
            # per-(clip, ref) forced losses — the reference's `losses`
            # CSV column (test_step, conette.py:293-350)
            loss_mat, loss_valid = self.test_losses_fn(
                params, {"audio": audio, "audio_lens": lens, "mult_captions": mult_caps},
            )
            losses = [
                [float(x) for x, ok in zip(row, okr) if ok]
                for row, okr in zip(loss_mat.cpu().numpy(), loss_valid.cpu().numpy())
            ]
        evaluator.add_batch(
            cands,
            b["mult_references"],
            fnames=b.get("fname"),
            dataset=b["dataset"][0] if b.get("dataset") else "unknown",
            subset=b["subset"][0] if b.get("subset") else default_subset,
            lprobs=lprobs,
            preds=preds,
            mpreds=mp,
            mlprobs=mlprobs,
            mcands=mcands,
            losses=losses,
        )

    def run_test(self, model_name: str, params) -> dict[str, Any]:
        from conette_torch.train.evaluation import Evaluator, make_metric_tokenizer

        scores: dict[str, Any] = {}
        if self.dm.num_eval_loaders("test") > 0:
            if not self._test_metrics:
                from conette_torch.metrics import AllMetrics

                self._test_metrics.append(
                    AllMetrics(
                        tokenizer=make_metric_tokenizer(),
                        train_vocab=list(self.tokenizer.get_vocab()),
                    )
                )
            evaluator = Evaluator(
                self.run_dir, model_name=model_name, metrics=self._test_metrics[0]
            )
            for dl_idx in range(self.dm.num_eval_loaders("test")):
                for j, b in enumerate(self.dm.eval_batches("test", dl_idx)):
                    if self.lim_test is not None and j >= self.lim_test:
                        break
                    self._decode_and_score_batch(
                        evaluator, params, b, "test", with_losses=True
                    )
            scores = evaluator.compute_and_export()
            for corpus, corpus_scores in scores.items():
                self.logger.log_metrics(
                    {
                        f"test/{model_name}/{corpus}/{k}": v
                        for k, v in corpus_scores.items()
                    }
                )
        # predict pass: decode-and-export only (the reference calls
        # trainer.predict after every trainer.test, train.py:303-343;
        # predict corpora like clotho_test have no references — the
        # artifacts are the outputs CSV + DCASE submission CSV)
        if self.dm.num_eval_loaders("predict") > 0:
            from conette_torch.train.evaluation import Evaluator as _Evaluator

            pred_eval = _Evaluator(self.run_dir, model_name=model_name, score=False)
            for dl_idx in range(self.dm.num_eval_loaders("predict")):
                for b in self.dm.eval_batches("predict", dl_idx):
                    self._decode_and_score_batch(
                        pred_eval, params, b, "predict", with_losses=False
                    )
            pred_eval.compute_and_export()
        return scores
