"""The readers of the program's own spans and counters
(``benchmark/program_spans.py``), on synthetic records and traces: which
roots each counts, what it reads from them, and nothing read from a tree
whose program keeps no spans; then the toy cells traced end to end."""

from __future__ import annotations

import os

import pytest

from benchmark import program_spans
from benchmark.harness import Trace, load_module
from benchmark.tests import tiny
from benchmark.tests.test_bench_cells import run

READERS = ("host_issue_ms.caption", "readback_wait_ms.caption", "capture_s.caption",
           "decode_steps.caption", "loader_parallelism.corpus", "batch_build_ms.train",
           "host_issue_ms.train")


def reader(name: str):
    path = os.path.join(tiny.REPO, "benchmark", "layer_metrics", f"{name}.py")
    return load_module(path, f"bench_metric_test_{name.replace('.', '_')}").read


class Rec:
    """A span record as the program's ring holds it."""

    def __init__(self, name, id, parent, root, start, end, attrs) -> None:
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.start, self.end, self.thread, self.attrs = start, end, 1, attrs

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Book:
    """Synthetic span records with given times, ids from 1."""

    def __init__(self) -> None:
        self.recs: list[Rec] = []

    def add(self, name, t0, t1, parent=None, root=None, **attrs) -> Rec:
        sid = len(self.recs) + 1
        if root is None:
            root = parent.root if parent is not None else sid
        self.recs.append(Rec(name, sid, parent.id if parent is not None else 0, root, t0, t1, attrs))
        return self.recs[-1]


@pytest.fixture
def book(monkeypatch):
    b = Book()
    monkeypatch.setattr(program_spans, "records", lambda: sorted(b.recs, key=lambda r: r.end))
    return b


def request(b: Book, t: float, issue: float, steps: int = 20) -> None:
    """A request at ``t``: 0.030 s of load, 0.004 and 0.020 s of reads,
    ``issue`` s of the rest."""
    fwd = b.add("forward", t, t + 0.054 + issue)
    b.add("load_resample", t, t + 0.030, fwd)
    b.add("readback", t + 0.030, t + 0.034, fwd)
    b.add("_generate", t + 0.034, t + 0.034 + issue, fwd)
    b.add("readback", t + 0.034 + issue, t + 0.054 + issue, fwd, decode_steps=steps)


def test_caption_readers_count_the_kept_requests(book):
    request(book, 0.0, 0.5, steps=7)  # set-up: no span of the benchmark's
    request(book, 1.0, 0.010)
    request(book, 2.0, 0.014)
    request(book, 3.0, 0.5, steps=3)  # the profiled part: none kept
    # the benchmark's wrapper spans, kept in the window outside the profiled part
    trace = Trace([("_generate", 1.0339, 1.0441), ("_generate", 2.0339, 2.0481),
                   ("load_resample", 1.0, 1.03)], {}, None)
    assert reader("host_issue_ms.caption")(trace) == pytest.approx(12.0)
    assert reader("readback_wait_ms.caption")(trace) == pytest.approx(24.0)
    assert reader("decode_steps.caption")(trace) == 20.0


def test_capture_seconds_read_every_capture(monkeypatch):
    monkeypatch.setattr(program_spans, "summary", lambda: {
        "spans": {"capture": {"count": 4, "total_s": 10.0, "self_s": 10.0},
                  "warmup": {"count": 4, "total_s": 30.0, "self_s": 30.0}}, "counters": {}})
    assert reader("capture_s.caption")(Trace([], {}, None)) == 2.5
    monkeypatch.setattr(program_spans, "summary", lambda: {"spans": {}, "counters": {}})
    assert reader("capture_s.caption")(Trace([], {}, None)) is None


def test_loader_parallelism_over_the_kept_calls(book):
    for t, files in ((0.0, 1.0), (10.0, 1.0), (20.0, 4.0)):
        call = book.add("caption_corpus", t, t + 5)
        load = book.add("native_load", t + 1, t + 2, call)
        for k in range(4):
            book.add("load_file", t + 1, t + 1 + files / 4, load)  # on the pool's threads
    trace = Trace([("caption_corpus", 9.9, 15.1), ("caption_corpus", 19.9, 25.1)], {}, None)
    assert reader("loader_parallelism.corpus")(trace) == pytest.approx((1.0 + 4.0) / 2)


def test_batch_build_takes_each_kept_steps_last_build(book):
    # set-up's fit, then the window's: the same roots (epoch, index)
    for t0, build in ((0.0, 0.9), (100.0, 0.4)):
        for i in range(3):
            t = t0 + 10 * i
            book.add("build_batch", t, t + build, root=(0, i))
            book.add("pin", t + build, t + build + 0.1, root=(0, i))
            book.add("train_step", t + 5, t + 5.2 + 0.1 * i, root=(0, i))
    trace = Trace([("train_step", 115.01, 115.2), ("train_step", 125.01, 125.3)], {}, None)
    assert reader("batch_build_ms.train")(trace) == pytest.approx(500.0)
    assert reader("host_issue_ms.train")(trace) == pytest.approx(350.0)


def test_a_tree_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    trace = Trace([("_generate", 0.0, 1.0), ("caption_corpus", 0.0, 1.0), ("train_step", 0.0, 1.0)],
                  {}, None)
    assert [reader(name)(trace) for name in READERS] == [None] * len(READERS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,metrics", [
    ("tiny-requests", {"host_issue_ms.caption", "readback_wait_ms.caption", "decode_steps.caption"}),
    ("tiny-files", {"host_issue_ms.caption", "readback_wait_ms.caption", "decode_steps.caption"}),
    ("tiny-corpus", {"loader_parallelism.corpus"}),
    ("tiny-train", {"batch_build_ms.train", "host_issue_ms.train"}),
])
def test_a_traced_toy_cell_reports_the_program_metrics(root, capsys, cell, metrics):
    """On the CPU: no capture (``capture_s.caption`` reads nothing), and
    the eager search runs every step of the toy's 6."""
    line = run(root, cell, 2**31 + 5, trace=1, capsys=capsys)
    assert line["correct"]
    assert metrics <= set(line["metrics"]), line["metrics"]
    assert "capture_s.caption" not in line["metrics"]
    if "decode_steps.caption" in metrics:
        assert line["metrics"]["decode_steps.caption"]["value"] == 6.0
    for name in metrics:
        assert line["metrics"][name]["value"] > 0
