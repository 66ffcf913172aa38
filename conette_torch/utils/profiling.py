"""Profiling and debugging hooks.

Counterpart of ``conette_tpu/utils/profiling.py`` (the reference's opt-in
profiler, FLOPs profiler, time callbacks and ``detect_anomaly``):

- ``trace``: a ``torch.profiler`` trace of a scope (CPU and, on the card,
  CUDA activity), written as a Chrome trace into ``log_dir``; its
  ``profiler`` and ``active_step`` serve a caller that reads the profile
  itself;
- ``flops_profile``: the floating-point operations of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``;
- ``debug_mode``: NaN or Inf inside a scope raises;
- ``TimeTracker``: wall time per named phase.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Iterator

import torch
from torch.overrides import TorchFunctionMode

pylog = logging.getLogger(__name__)

TRACE_FILE = "trace.json"

# On an H100 host, a trace lost the first kernel records of its active
# window: 6-8 as a rule, now and then over 170, in eager code and CUDA
# graph replays alike (a request lost its log-mel kernel), whatever the
# time between the window's start and the scope. So the window opens with
# this many one-element kernels (``torch.cuda._sleep``'s, named
# ``OPENING_KERNEL_NAME``), lost or kept in the scope's stead
# (``scripts/_trace_window.py``).
OPENING_KERNELS = 2048
OPENING_KERNEL_NAME = "spin_kernel"


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


def profiler() -> Any:
    """A ``torch.profiler.profile`` of CPU and, where a card is present,
    CUDA activity, on the schedule that :func:`active_step` drives."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1))


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Trace the scope with ``torch.profiler`` (CUDA activity too where a
    card is present) and write ``{log_dir}/trace.json``, which
    ``chrome://tracing`` and Perfetto open. Yields the profiler, whose
    ``key_averages()`` the caller may read after the scope. The scope is
    the profiler's one active step (:func:`active_step`)."""
    prof = profiler()
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


class TimeTracker:
    """Wall-time tracking per named phase (fit/test/epoch...)."""

    def __init__(self) -> None:
        self._starts: dict[str, float] = {}
        self.durations: dict[str, float] = {}

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self.durations[name] = self.durations.get(name, 0.0) + dt
        return dt

    @contextlib.contextmanager
    def track(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def formatted(self) -> dict[str, str]:
        out = {}
        for name, secs in self.durations.items():
            h, rem = divmod(int(secs), 3600)
            m, s = divmod(rem, 60)
            out[name] = f"{h:02d}:{m:02d}:{s:02d}"
        return out
