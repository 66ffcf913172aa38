"""The program's spans and counters (``utils/profiling.py``) on the card:

    python3 scripts/_span_check.py trace <cell> <seed>   # a traced run of one cell, kept and read
    python3 scripts/_span_check.py read <cell>           # read what ``trace`` kept, anywhere

``trace`` runs ``benchmark/run.py``'s ``main`` with ``--trace 1 --seconds
51`` in this process (its result line printed as the benchmark prints it)
and keeps, under ``chiprun_out/``, the benchmark's own kept spans, the
profiled part's trace events and the program's ring and summary
(``span_check_<cell>.json.gz``); one cell a process, as the benchmark runs
it (a second profiler session in one process after an all-threads one
misattributed the decode's kernels there). ``read`` prints from those:

- each name the benchmark wraps against the program's span of that name
  (seconds summed over the kept spans, the difference a span);
- the spans by path under the kept roots, in ms a root (median and mean);
- the profiled part's idle and device time by the innermost span, the
  program's included (the benchmark's reduction over every annotation);
- for training, the prefetch thread's spans over the loop's
  ``batch_wait`` spans and over the steps' ``train_step`` spans.
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
# the benchmark's wrapped names each cell reads, and the root and kept span
# that select its requests, calls or steps
WRAPPED = {"caption-8x10s": ("load_resample", "encode", "_generate"),
           "caption-1file": ("load_resample", "encode", "_generate"),
           "corpus-clotho-wav": ("caption_corpus", "load_resample", "wav_info", "caption_batch"),
           "train-clotho-b512": ("train_step", "to_train_batch")}
ROOTS = {"corpus-clotho-wav": ("caption_corpus", "caption_corpus"),
         "train-clotho-b512": ("train_step", "train_step")}
PREFETCH = ("read_items", "collate", "pin", "queue_full")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    except FileNotFoundError:
        return "no card"


class Rec:
    """A span record as kept in the file."""

    def __init__(self, name, start, end, thread, id, parent, root, attrs) -> None:
        self.name, self.start, self.end, self.thread = name, start, end, thread
        self.id, self.parent, self.root, self.attrs = id, parent, root, attrs

    @property
    def seconds(self) -> float:
        return self.end - self.start


def trace(cell: str, seed: str) -> int:
    sys.path.insert(0, ROOT)
    from benchmark import harness, run
    from conette_torch.utils import profiling

    kept: dict = {"spans": [], "events": []}
    close, reduce = harness.Tracer.close, harness.reduce_trace

    def keep_spans(self):
        kept["spans"] = list(self.spans)
        close(self)

    def keep_events(events, names):
        kept["events"] = events
        return reduce(events, names)

    harness.Tracer.close, harness.reduce_trace = keep_spans, keep_events
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", "51", "--trace", "1"])
    recs = [(r.name, r.start, r.end, r.thread, r.id, r.parent, repr(r.root), r.attrs)
            for r in profiling.records()]
    os.makedirs(OUT, exist_ok=True)
    with gzip.open(os.path.join(OUT, f"span_check_{cell}.json.gz"), "wt") as f:
        json.dump({"card": card(), "seed": seed, "spans": kept["spans"], "events": kept["events"],
                   "records": recs, "summary": profiling.summary()}, f, default=str)
    read(cell)
    return rc


def overlap(intervals: list, recs: list) -> float:
    return sum(max(0.0, min(b, r.end) - max(a, r.start)) for a, b in intervals for r in recs)


def read(cell: str) -> int:
    sys.path.insert(0, ROOT)
    from benchmark.harness import WINDOW_SPAN, Trace, reduce_trace
    from benchmark.program_spans import kept_roots

    with gzip.open(os.path.join(OUT, f"span_check_{cell}.json.gz"), "rt") as f:
        kept = json.load(f)
    recs = [Rec(*r) for r in kept["records"]]
    spans = [tuple(s) for s in kept["spans"]]
    out: dict = {"card": kept["card"], "seed": kept["seed"], "counters": kept["summary"]["counters"]}
    by = defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    agree = {}
    for name in WRAPPED.get(cell, ()):
        pairs = []
        for _, t0, t1 in (s for s in spans if s[0] == name):
            best = max(by[name], key=lambda r: min(t1, r.end) - max(t0, r.start), default=None)
            if best is not None and min(t1, best.end) > max(t0, best.start):
                pairs.append((t1 - t0, best.seconds))
        if pairs:
            w, p = sum(a for a, _ in pairs), sum(b for _, b in pairs)
            agree[name] = {"spans": len(pairs), "wrapper_s": w, "program_s": p, "rel_diff": (p - w) / w,
                           "diff_ms_a_span": 1e3 * (p - w) / len(pairs)}
    out["wrapped_vs_program"] = agree
    root_name, mark = ROOTS.get(cell, ("forward", "_generate"))
    roots = kept_roots(recs, Trace(spans, {}, None), root_name, mark)
    ids, byid = {r.root for r in roots}, {r.id: r for r in recs}

    def path(r) -> str:
        names = [r.name]
        while r.parent in byid:
            r = byid[r.parent]
            names.append(r.name)
        return "/".join(reversed(names))

    # a training batch's root (epoch, index) recurs in each fit: take the
    # window's, from a little before its first kept step
    lo = min(r.start for r in roots) - 2.0 if cell.startswith("train") else float("-inf")
    paths = defaultdict(list)
    for r in recs:
        if r.root in ids and r.start >= lo:
            paths[path(r)].append(1e3 * r.seconds)
    # ms a root: each path's spans summed over a root, as median and mean over the roots' sums
    out["kept_roots"] = len(roots)
    out["ms_a_root"] = {p: {"spans_a_root": len(v) / len(roots), "mean": sum(v) / len(roots),
                            "median_span": statistics.median(v)} for p, v in sorted(paths.items())}
    if cell.startswith("train"):
        main = roots[0].thread
        pf = [r for r in recs if r.thread != main and r.name in PREFETCH]
        # each kept step's own wait: its root's last batch_wait before it
        waits = []
        for step in roots:
            wait = max((r for r in by["batch_wait"] if r.root == step.root and r.end <= step.start),
                       key=lambda r: r.end, default=None)
            if wait is not None:
                waits.append((wait.start, wait.end))
        issue = [(r.start, r.end) for r in roots]
        n = len(roots)
        out["train"] = {"batch_wait_ms_a_step": 1e3 * sum(b - a for a, b in waits) / n,
                        "train_step_ms_a_step": 1e3 * sum(b - a for a, b in issue) / n,
                        "prefetch_during_wait_ms": {k: 1e3 * overlap(waits, [r for r in pf if r.name == k]) / n
                                                    for k in PREFETCH},
                        "prefetch_during_issue_ms": {k: 1e3 * overlap(issue, [r for r in pf if r.name == k]) / n
                                                     for k in PREFETCH}}
    events = kept["events"]
    if events:
        names = tuple({e["name"] for e in events if e.get("cat") == "user_annotation"} - {WINDOW_SPAN})
        prof = reduce_trace(events, names)
        out["profiled"] = {"window_s": prof.window_s, "busy_s": prof.busy_s,
                           "idle_s_by_span": dict(sorted(prof.idle_s_by_span.items(), key=lambda kv: -kv[1])),
                           "device_s_by_span": dict(sorted(prof.device_s_by_span.items(), key=lambda kv: -kv[1]))}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "trace" and len(sys.argv) == 4:
        sys.exit(trace(sys.argv[2], sys.argv[3]))
    if mode == "read" and len(sys.argv) == 3:
        sys.exit(read(sys.argv[2]))
    sys.exit(__doc__)
