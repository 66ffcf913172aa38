"""Profiling and debugging hooks.

Counterpart of ``conette_tpu/utils/profiling.py`` (the reference's opt-in
profiler, FLOPs profiler, time callbacks and ``detect_anomaly``):

- ``span`` and ``count``: the program's own spans and counters, always on.
  Each span is a record (name, start and end on ``time.perf_counter``,
  thread, parent, root, a few attributes) in a ring of the last
  ``RING_RECORDS``; ``summary`` gives each name's count, total and self
  seconds and the counters since ``clear``. While a ``torch.profiler`` is
  recording, a span is also a ``record_function`` range, so it shows in
  the Chrome trace as a ``user_annotation`` on the profiler's clock, with
  the kernels launched inside it correlated to it;
- ``trace``: a ``torch.profiler`` trace of a scope (CPU and, on the card,
  CUDA activity), written as a Chrome trace into ``log_dir``; its
  ``profiler`` and ``active_step`` serve a caller that reads the profile
  itself;
- ``flops_profile``: the floating-point operations of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``;
- ``debug_mode``: NaN or Inf inside a scope raises.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Hashable, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.overrides import TorchFunctionMode

pylog = logging.getLogger(__name__)

TRACE_FILE = "trace.json"

# On an H100 host, a trace lost the first kernel records of its active
# window: 6-8 as a rule, now and then over 170, in eager code and CUDA
# graph replays alike (a request lost its log-mel kernel), whatever the
# time between the window's start and the scope. So the window opens with
# this many one-element kernels (``torch.cuda._sleep``'s, named
# ``OPENING_KERNEL_NAME``), lost or kept in the scope's stead (the card's
# runs that found and sized it are in ``CHANGES.md``).
OPENING_KERNELS = 2048
OPENING_KERNEL_NAME = "spin_kernel"


# ------------------------------------------------------------------ spans
# the span records kept: the ring's bound, so that a server or a long fit
# holds at most this many (``summary``'s totals count every span)
RING_RECORDS = 65_536


class Span:
    """A span named ``name`` around a scope (``with span(...) as s``) or
    around every call of a function (as a decorator), and, once entered,
    its record: ``start`` and ``end`` on ``time.perf_counter`` (``end`` is
    0.0 while it is open); the ``thread`` that entered it; its ``id``, its
    ``parent``'s (0 for none) and its ``root``, shared by every span of one
    request, corpus call or training batch; ``attrs``, a few small values,
    which :meth:`set` adds to until the span ends.

    The parent is the innermost span open on this thread, or ``parent`` (a
    :class:`Span`, for work handed to another thread); the root is
    ``root`` where given, else the parent's, else the span's own id."""

    __slots__ = ("name", "start", "end", "thread", "id", "parent", "root", "attrs", "_up", "_inner_s",
                 "_range")

    def __init__(self, name: str, *, parent: "Span | None" = None, root: Hashable | None = None,
                 **attrs: Any) -> None:
        self.name, self._up, self.root, self.attrs = name, parent, root, attrs

    def __enter__(self) -> "Span":
        local = _local.__dict__
        stack = local.get("stack")
        if stack is None:
            stack = local["stack"] = []
            local["thread"] = threading.get_ident()
        up = self._up if self._up is not None else (stack[-1] if stack else None)
        self.id = sid = next(_ids)
        if up is None:
            self.parent = 0
            if self.root is None:
                self.root = sid
        else:
            self.parent = up.id
            if self.root is None:
                self.root = up.root
        self._up = None
        self.thread = local["thread"]
        self.end = self._inner_s = 0.0
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end = end = time.perf_counter()
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        seconds = end - self.start
        if stack:
            stack[-1]._inner_s += seconds
        _lock.acquire()
        _ring.append(self)
        t = _totals.get(self.name)
        if t is None:
            _totals[self.name] = [1, seconds, seconds - self._inner_s]
        else:
            t[0] += 1
            t[1] += seconds
            t[2] += seconds - self._inner_s
        _lock.release()

    def __call__(self, fn: Callable) -> Callable:
        name, parent, root, attrs = self.name, self._up, self.root, self.attrs

        @functools.wraps(fn)
        def spanned(*args: Any, **kwargs: Any) -> Any:
            with Span(name, parent=parent, root=root, **attrs):
                return fn(*args, **kwargs)

        return spanned

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, id={self.id}, parent={self.parent}, "
                f"root={self.root!r}, attrs={self.attrs})")


span = Span
_ring: collections.deque = collections.deque(maxlen=RING_RECORDS)
_totals: dict[str, list] = {}  # name -> [count, total seconds, self seconds]
_counters: dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def current() -> Span | None:
    """The innermost span open on this thread: the ``parent`` to hand to
    work that another thread runs."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _lock.acquire()
    _counters[name] = _counters.get(name, 0) + n
    _lock.release()


def records() -> list[Span]:
    """The ring's spans, in the order they ended: the last
    ``RING_RECORDS``."""
    with _lock:
        return list(_ring)


def summary(since: dict | None = None) -> dict[str, dict]:
    """Since :func:`clear`, or since the summary ``since`` was taken: for
    each span name its ``count``, ``total_s`` and ``self_s`` (its seconds
    less those of the spans nested in it on its thread), under
    ``"spans"``; the counters under ``"counters"``."""
    with _lock:
        spans = {n: {"count": c, "total_s": tot, "self_s": own} for n, (c, tot, own) in _totals.items()}
        counters = dict(_counters)
    if since is not None:
        for name, t in since["spans"].items():
            if name in spans:
                spans[name] = {k: v - t[k] for k, v in spans[name].items()}
        for name, n in since["counters"].items():
            if name in counters:
                counters[name] -= n
        spans = {n: t for n, t in spans.items() if t["count"]}
        counters = {n: c for n, c in counters.items() if c}
    return {"spans": spans, "counters": counters}


def clear() -> None:
    """Empty the ring, the totals and the counters."""
    with _lock:
        _ring.clear()
        _totals.clear()
        _counters.clear()


# ---------------------------------------------------------------- profiler
@contextlib.contextmanager
def active_step(prof: Any) -> Iterator[None]:
    """Inside a started :func:`profiler`: a warm-up step of one small
    kernel, which the profiler discards, then the scope as its one active
    step, opened on the card by ``OPENING_KERNELS`` kernels that a reader of
    the trace leaves out by their name."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    prof.step()
    if cuda:
        for _ in range(OPENING_KERNELS):
            torch.cuda._sleep(10)
        torch.cuda.synchronize()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.step()


def profiler(*, all_threads: bool = False) -> Any:
    """A ``torch.profiler.profile`` of CPU and, where a card is present,
    CUDA activity, on the schedule that :func:`active_step` drives. With
    ``all_threads`` it records every thread's operators and spans (the
    prefetch thread's, the loader pool's), not only those of the thread that
    starts it; on an H100 with torch 2.11 a later profiler session in the
    same process then misattributed kernels, so only ``conette-train``'s
    trace, a process's one session, sets it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kwargs: dict[str, Any] = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    return profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1), **kwargs)


@contextlib.contextmanager
def trace(log_dir: str, *, all_threads: bool = False) -> Iterator[Any]:
    """Trace the scope with ``torch.profiler`` (CUDA activity too where a
    card is present) and write ``{log_dir}/trace.json``, which
    ``chrome://tracing`` and Perfetto open. Yields the profiler, whose
    ``key_averages()`` the caller may read after the scope. The scope is
    the profiler's one active step (:func:`active_step`); ``all_threads``
    as in :func:`profiler`."""
    prof = profiler(all_threads=all_threads)
    prof.start()
    try:
        with active_step(prof):
            yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        pylog.info(f"Profiler trace written to {path}")


def flops_profile(fn: Callable, *example_args: Any) -> dict[str, float]:
    """Run ``fn(*example_args)`` once and count its floating-point
    operations: ``{"flops": n}``, under the key of XLA's cost analysis.
    Products count 2·m·n·k as XLA counts them; the counter knows products,
    convolutions and attention only, so elementwise work, which XLA's
    ``flops`` adds, is not in it. XLA's other keys (``bytes accessed``,
    ``transcendentals``, ``utilization*``) come from its compiled program
    and have no counterpart here."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    out = {"flops": float(counter.get_total_flops())}
    pylog.info(f"flop counter: {out['flops']:.3e} flops")
    return out


class _RaiseOnNonFinite(TorchFunctionMode):
    """Checks the floating-point outputs of every torch call in the scope."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and not bool(t.isfinite().all()):
                raise FloatingPointError(f"NaN or Inf in the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_mode() -> Iterator[None]:
    """NaN or Inf inside the scope raises ``FloatingPointError`` (the
    counterpart of ``jax_debug_nans``). The forward pass is covered by a
    ``TorchFunctionMode`` that checks the output of every torch call (a
    read back to the host after each, so for debugging only); the backward
    pass by ``torch.autograd.detect_anomaly``, which raises a
    ``RuntimeError`` naming the function whose gradient went non-finite."""
    with torch.autograd.detect_anomaly(check_nan=True), _RaiseOnNonFinite():
        yield
