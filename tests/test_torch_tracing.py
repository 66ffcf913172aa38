"""The port's span recorder (``conette_torch/utils/profiling.py``) on the CPU:
nesting, parents and roots on one thread, across the prefetch thread and
across the native loader's pool; self time; the ring's bound; counters and
``summary``; spans as ``user_annotation`` ranges in a ``trace``'s Chrome
trace; ``benchmark/harness.py::reduce_trace`` attributing alike with a
program span nested in a wrapper of its name; a tiny ``CoNeTTEModel.forward``
bit for bit with the recorder and a profiler on, its ``decode_steps`` the
steps its loop ran; ``fit``'s ``batch_wait_s`` the sum of its spans; and
``main_train`` logging the fit's summary; a gathered training batch's
``build_batch``, ``read_items`` (its ``route`` and ``rows``), ``collate``
and ``pin`` under the batch's root, and the caption memo's counter."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from conette_torch.data.datamodule import HDFDataModule
from conette_torch.data.datasets import DummyAACDataset
from conette_torch.data.hdf import pack_to_hdf
from conette_torch.data.prefetch import prefetch_iterator
from conette_torch.huggingface import model as hf_model
from conette_torch.huggingface.config import CoNeTTEConfig
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.models.conette import (
    conette_init,
    encode_audio,
    forward_generate,
    forward_greedy,
    tasks_to_bos_ids,
)
from conette_torch.models.convnext import convnext_init
from conette_torch.native import loader
from conette_torch.tokenization import AACTokenizer
from conette_torch.train.loop import fit, pinned_batches
from conette_torch.train.main import main_train
from conette_torch.train.step import TrainState
from conette_torch.utils import profiling
from conette_torch.utils.audio_io import save_wav

CORPUS = ["a bird sings loudly in the trees", "an engine hums near a busy road",
          "people talk while a dog barks", "rain falls on a tin roof and thunder rumbles"]


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def by_name(name: str) -> list[profiling.Span]:
    return [r for r in profiling.records() if r.name == name]


def test_spans_nest_with_parents_and_one_root_on_a_thread():
    with profiling.span("request", rows=8) as req:
        with profiling.span("load") as load:
            with profiling.span("decode"):
                pass
        with profiling.span("issue") as issue:
            issue.set(bucket=10)
            assert profiling.current() is issue
    with profiling.span("next") as nxt:
        pass
    with profiling.span("batch", root=(0, 3)) as batch:
        with profiling.span("step") as step:
            pass
    (dec,) = by_name("decode")
    assert (req.parent, load.parent, dec.parent, issue.parent) == (0, req.id, load.id, req.id)
    assert {req.root, load.root, dec.root, issue.root} == {req.id} and nxt.root == nxt.id != req.id
    assert batch.root == step.root == (0, 3) and step.parent == batch.id
    assert req.attrs == {"rows": 8} and issue.attrs == {"bucket": 10} and dec.attrs == {}
    assert req.start <= load.start <= dec.start <= dec.end <= load.end <= issue.start <= req.end
    assert {r.thread for r in profiling.records()} == {threading.get_ident()}
    assert [r.name for r in profiling.records()] == ["decode", "load", "issue", "request", "next",
                                                     "step", "batch"]
    assert profiling.current() is None


def test_a_span_decorates_a_function():
    @profiling.span("work", kind="toy")
    def work(x):
        assert profiling.current().name == "work"
        return x + 1

    assert [work(1), work(2)] == [2, 3] and work.__name__ == "work"
    spans = by_name("work")
    assert len(spans) == 2 and spans[0].id != spans[1].id and spans[0].attrs == {"kind": "toy"}


def test_the_prefetch_thread_roots_a_batch_at_its_epoch_and_index():
    """``pinned_batches`` runs in ``prefetch_iterator``'s thread: each batch's
    ``pin`` span is rooted at (epoch, index) on that thread; a producer
    that finds the queue full waits inside a ``queue_full`` span."""
    batches = ({"x": np.full((2, 3), i, np.float32)} for i in range(4))
    got = []
    for b in prefetch_iterator(pinned_batches(batches, False, epoch=5), depth=1):
        time.sleep(0.02)  # a slow consumer: the producer meets a full queue
        got.append(int(b["x"][0, 0]))
    assert got == [0, 1, 2, 3]
    pins = by_name("pin")
    assert [p.root for p in pins] == [(5, i) for i in range(4)]
    assert {p.thread for p in pins} != {threading.get_ident()} and len({p.thread for p in pins}) == 1
    waits = by_name("queue_full")
    assert waits and {w.thread for w in waits} == {pins[0].thread} and all(w.seconds > 0 for w in waits)


def test_a_gathered_batch_keeps_its_spans_under_its_root(tmp_path):
    """``train_batches`` gathers a batch inside ``build_batch`` (its
    ``read_items``, with the route and the rows read, then ``collate``), and
    ``pinned_batches`` pins it in ``pin``: all four a batch, rooted at
    (epoch, the batch's index); captions drawn again hit the memo."""
    fpath = str(tmp_path / "clotho_dev_x.hdf")
    pack_to_hdf(DummyAACDataset(size=12, seed=0, dataset_name="clotho"), fpath)
    dm = HDFDataModule(AACTokenizer(), [fpath], bsize=4, seed=0)
    dm.setup_fit()
    for epoch in range(3):
        assert len(list(prefetch_iterator(pinned_batches(dm.train_batches(epoch), False, epoch)))) == 3
    roots = [(e, i) for e in range(3) for i in range(3)]
    builds = by_name("build_batch")
    assert [b.root for b in builds] == roots and [p.root for p in by_name("pin")] == roots
    for name in ("read_items", "collate"):
        inner = by_name(name)
        assert [r.parent for r in inner] == [b.id for b in builds] and [r.root for r in inner] == roots
    assert [r.attrs for r in by_name("read_items")] == [{"route": "gather", "rows": 4}] * 9
    assert profiling.summary()["counters"]["caption_memo_hits"] > 0


def test_the_native_loaders_pool_spans_its_files_under_the_callers_load(tmp_path):
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"clip_{i}.wav"))
        save_wav(paths[-1], (np.random.default_rng(i).standard_normal(4410) * 0.1).astype(np.float32),
                 44100)
    with profiling.span("caption_corpus") as call:
        out = loader.load_batch(paths, 32000, workers=3)
    assert len(out) == 5
    (load,) = by_name("native_load")
    files = by_name("load_file")
    assert load.parent == call.id and load.root == call.id and load.attrs == {"files": 5, "workers": 3}
    assert len(files) == 5 and {f.parent for f in files} == {load.id} and {f.root for f in files} == {call.id}
    assert threading.get_ident() not in {f.thread for f in files}
    assert all(load.start <= f.start <= f.end <= load.end for f in files)
    assert profiling.summary()["spans"]["load_file"]["count"] == 5


def test_self_time_leaves_out_the_same_threads_children():
    def child():
        with profiling.span("inner"):
            time.sleep(0.01)

    with profiling.span("outer"):
        time.sleep(0.005)
        child()
        child()
        worker = threading.Thread(target=child)  # another thread's span is no child here
        worker.start()
        worker.join()
    s = profiling.summary()["spans"]
    (outer,) = by_name("outer")
    inner = by_name("inner")
    own = [i for i in inner if i.thread == outer.thread]
    assert s["inner"]["count"] == 3 and s["outer"]["count"] == 1
    assert s["outer"]["total_s"] == outer.seconds
    assert s["outer"]["self_s"] == pytest.approx(outer.seconds - sum(i.seconds for i in own), abs=1e-12)
    assert s["outer"]["self_s"] > 0.005 + 0.009  # the sleep and the other thread's span
    assert s["inner"]["self_s"] == s["inner"]["total_s"]


def test_the_ring_keeps_the_last_records_and_the_totals_count_all():
    n = profiling.RING_RECORDS + 10
    for i in range(n):
        with profiling.span("tick", i=i):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.RING_RECORDS
    assert recs[0].attrs["i"] == 10 and recs[-1].attrs["i"] == n - 1
    assert profiling.summary()["spans"]["tick"]["count"] == n


def test_counters_and_summary_since_and_clear():
    profiling.count("graph_evictions")
    profiling.count("rows", 20)
    with profiling.span("capture"):
        pass
    before = profiling.summary()
    profiling.count("rows", 7)
    profiling.count("files", 3)
    with profiling.span("replay"):
        pass
    now = profiling.summary()
    assert now["counters"] == {"graph_evictions": 1, "rows": 27, "files": 3}
    assert set(now["spans"]) == {"capture", "replay"}
    assert set(now["spans"]["replay"]) == {"count", "total_s", "self_s"}
    since = profiling.summary(since=before)
    assert since["counters"] == {"rows": 7, "files": 3}
    assert set(since["spans"]) == {"replay"} and since["spans"]["replay"]["count"] == 1
    profiling.clear()
    assert profiling.summary() == {"spans": {}, "counters": {}} and profiling.records() == []


def test_spans_are_user_annotations_of_a_trace_around_their_ops(tmp_path):
    """Inside ``profiling.trace``, a span is a ``user_annotation`` on its
    own thread (a worker's too, with ``all_threads``) holding
    the ``aten::`` ops issued inside it; outside a profiler no range is
    entered."""
    go, done = threading.Event(), threading.Event()
    tid = {}

    def worker():
        go.wait()
        tid["worker"] = threading.get_native_id()
        with profiling.span("worker_span"):
            torch.ones(16).mul(3)
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with profiling.trace(str(tmp_path), all_threads=True):
        with profiling.span("main_span"):
            torch.ones(32).add(2)
        go.set()
        done.wait()
    thread.join()
    with profiling.span("untraced") as s:
        assert s._range is None
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    want = {"main_span": (threading.get_native_id(), "aten::add"), "worker_span": (tid["worker"], "aten::mul")}
    for name, (thread_id, op) in want.items():
        e = spans[name]
        assert e["tid"] == thread_id, (name, e)
        ops = [o for o in events if o.get("cat") == "cpu_op" and o["name"] == op and o["tid"] == thread_id]
        assert any(e["ts"] <= o["ts"] and o["ts"] + o["dur"] <= e["ts"] + e["dur"] for o in ops), name
    assert "untraced" not in spans


def _trace_events(inner: bool) -> list[dict]:
    """A window with two kernels launched inside a wrapper span
    ``load_resample`` (with the program's span of that name nested in it,
    or not), one inside ``encode``, and gaps between them."""
    ev = [{"name": "bench_window", "cat": "user_annotation", "ts": 0, "dur": 1000},
          {"name": "load_resample", "cat": "user_annotation", "ts": 100, "dur": 400},
          {"name": "encode", "cat": "user_annotation", "ts": 600, "dur": 200}]
    if inner:
        ev.append({"name": "load_resample", "cat": "user_annotation", "ts": 110, "dur": 370})
        ev.append({"name": "pad_bucket", "cat": "user_annotation", "ts": 400, "dur": 60})
    for k, (launch, start, dur) in enumerate([(120, 150, 50), (450, 470, 100), (610, 620, 80)]):
        ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": launch, "dur": 5,
                   "args": {"correlation": k}})
        ev.append({"name": f"kernel_{k}", "cat": "kernel", "ts": start, "dur": dur,
                   "args": {"correlation": k}})
    return ev


def test_reduce_trace_attributes_alike_with_a_program_span_nested_in_a_wrapper():
    from benchmark.harness import reduce_trace

    names = ("load_resample", "encode", "_generate")
    plain, nested = reduce_trace(_trace_events(False), names), reduce_trace(_trace_events(True), names)
    assert plain.device_s_by_span == nested.device_s_by_span
    assert plain.idle_s_by_span == nested.idle_s_by_span
    assert (plain.busy_s, plain.window_s) == (nested.busy_s, nested.window_s)
    assert set(plain.device_s_by_span) == {"load_resample", "encode"}


@pytest.fixture(scope="module")
def tiny_model():
    tok = AACTokenizer()
    tok.fit(CORPUS)
    cfg = CoNeTTEConfig(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64, beam_size=3,
                        min_pred_size=1, max_pred_size=6, tokenizer_state=tok.get_txt_state())
    enc = convnext_init(torch.Generator().manual_seed(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    probe = CoNeTTEModel(cfg, encoder_params=enc, device="cpu")
    params = conette_init(torch.Generator().manual_seed(1), probe.model_cfg._replace(proj_in=128))
    model = CoNeTTEModel(cfg, encoder_params=enc, model_params=params, device="cpu")
    rng = np.random.default_rng(0)
    clips = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (32000, 21000)]
    return model, clips


@pytest.mark.parametrize("beam", [3, 1])
def test_forward_is_bit_for_bit_with_the_recorder_and_counts_its_steps(tiny_model, tmp_path,
                                                                      monkeypatch, beam):
    """``forward`` equals the same clips composed from the model's parts
    without a span (the encoder, ``encode_audio`` and the search), plain
    and under a profiler; its ``readback`` span carries the steps the
    eager loop ran."""
    model, clips = tiny_model
    ran = []

    def guard(flag, body):
        ran.append(1)
        body()

    monkeypatch.setattr(hf_model, "conditional_step", guard)
    out = model(clips, sr=32000, task="clotho", beam_size=beam)
    per_call = len(ran)
    assert per_call == model.config.max_pred_size  # the CPU's loop runs every step
    with profiling.trace(str(tmp_path)):
        traced = model(clips, sr=32000, task="clotho", beam_size=beam)
    assert len(ran) == 2 * per_call
    pre = model.preprocessor
    wav, lens = pre._pad_stack.__wrapped__(pre, list(clips))
    with torch.inference_mode():
        frames, n, clip = pre._encode(torch.from_numpy(wav), torch.from_numpy(lens))
        memory, pad = encode_audio(model.params, model.model_cfg, frames, n)
        bos = torch.as_tensor(tasks_to_bos_ids(
            model.model_cfg, model.task_token_ids, ["clotho"] * 2, [None] * 2)).long()
        if beam > 1:
            res = forward_generate(model.params, model.model_cfg, memory, pad, bos, beam_size=beam,
                                   min_pred_size=1, max_pred_size=6,
                                   forbid_rep_mask=model.forbid_rep_mask)
            want_preds, want_lprobs = res.best_preds, res.best_avg_lprobs
        else:
            want_preds = forward_greedy(model.params, model.model_cfg, memory, pad, bos,
                                        min_pred_size=1, max_pred_size=6,
                                        forbid_rep_mask=model.forbid_rep_mask).preds
            want_lprobs = None
    for got in (out, traced):
        assert np.array_equal(got["preds"], want_preds.to(torch.int32).numpy())
        assert got["preds"].dtype == np.int32 and got["preds"].flags.c_contiguous
        if want_lprobs is not None:
            assert np.array_equal(got["lprobs"], want_lprobs.numpy())
        assert np.array_equal(got["tags_probs"], clip.numpy())
        for key in ("lprobs", "mult_preds", "mult_lprobs", "tags_probs"):
            assert np.array_equal(got[key], out[key])
        assert got["cands"] == out["cands"] and got["tags"] == out["tags"]
    roots = by_name("forward")
    assert len(roots) == 2 and roots[0].attrs == {"rows": 2, "frames": frames.shape[1]}
    reads = [r for r in by_name("readback") if "decode_steps" in r.attrs]
    assert [r.attrs for r in reads] == [{"decode_steps": per_call}] * 2
    assert {r.parent for r in reads} == {r.id for r in roots}
    assert sum(r.attrs["decode_steps"] for r in reads) == len(ran)
    names = {r.name for r in profiling.records() if r.root == roots[0].id}
    assert {"forward", "load_resample", "resample", "pad_bucket", "encode", "_generate", "readback",
            "detokenize"} <= names


class _Log:
    def log_metrics(self, metrics, step=None):
        pass


class _Batches:
    def __init__(self, n: int) -> None:
        self.n = n

    def train_batches(self, epoch: int = 0):
        for i in range(self.n):
            time.sleep(0.002)
            yield {"x": np.full((4, 2), i + 10 * epoch, np.float32)}

    def num_eval_loaders(self, split: str = "val") -> int:
        return 0


def test_fit_batch_wait_is_the_sum_of_its_batch_wait_spans():
    w = torch.zeros(2, requires_grad=True)
    state = TrainState({"w": w}, torch.optim.SGD([w], lr=0.1))
    seen = []

    def step(state, batch, gen):
        seen.append(int(batch["x"][0, 0]))
        return state, {"train/loss": torch.zeros(())}

    res = fit(state=state, gen=torch.Generator(), dm=_Batches(3), train_step=step,
              to_train_batch=lambda b, s: b, eval_runner=None, ckpt=None, logger=_Log(),
              tokenizer=None, model_cfg=None, lr_schedule=lambda e: 0.1, max_epochs=2)
    assert seen == [0, 1, 2, 10, 11, 12]
    waits = by_name("batch_wait")
    assert len(waits) == 8  # three batches and the end of each epoch
    assert res.batch_wait_s == sum(w.seconds for w in waits)
    steps = by_name("train_step")
    assert [s.root for s in steps] == [(e, i) for e in range(2) for i in range(3)]
    pins = {p.root: p for p in by_name("pin")}
    for s in steps:  # the batch's pin on the prefetch thread, before its step
        assert pins[s.root].thread != s.thread and pins[s.root].end <= s.start
    assert len(by_name("to_train_batch")) == 6


def test_main_train_logs_its_fit_spans_and_traces_them(tmp_path):
    """``main_train`` logs ``fit_spans`` beside ``fit_batch_wait_s``; under
    ``trainer.profiler.name=jax`` its Chrome trace holds the fit's spans."""
    for subset, size, seed in [("dev", 6, 0), ("val", 3, 1)]:
        pack_to_hdf(DummyAACDataset(size=size, seed=seed, dataset_name="clotho", subset=subset),
                    str(tmp_path / f"clotho_{subset}_x.hdf"))
    out = main_train([
        "trainer=lim2", "ckpts=loss", f"dm.hdf_root={tmp_path}", "dm.train_hdfs=[clotho_dev_x.hdf]",
        "dm.val_hdfs=[clotho_val_x.hdf]", "dm.test_hdfs=[]", "dm.bsize=3", "trainer.max_epochs=1",
        "trainer.profiler.name=jax", f"log_root={tmp_path / 'logs'}", "pl.d_model=32", "pl.nhead=2",
        "pl.num_decoder_layers=2", "pl.dim_feedforward=64", "pl.max_pred_size=6",
        "pl.min_pred_size=1", "pl.beam_size=2", "testing.run=[]", "device=cpu"])
    with open(os.path.join(out["run_dir"], "metrics.yaml")) as f:
        import yaml

        logged = yaml.safe_load(f)
    spans = logged["fit_spans"]["spans"]
    assert spans["train_step"]["count"] == 2 and spans["build_batch"]["count"] == 2
    assert {"loss", "grad", "clip", "optimizer", "read_items", "collate", "pin", "to_train_batch"} <= set(spans)
    assert logged["fit_batch_wait_s"] == pytest.approx(spans["batch_wait"]["total_s"], rel=1e-9)
    with open(os.path.join(out["run_dir"], "profile", profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"batch_wait", "to_train_batch", "train_step", "loss", "grad", "optimizer", "build_batch", "collate",
            "pin"} <= names
