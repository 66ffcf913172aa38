"""Guards for the steps of a decode loop: how the port leaves the loop early.

The JAX package runs beam and greedy search as a ``lax.while_loop`` whose
condition, tested on the device before each step, is that some beam (a
row, for greedy search) is still alive. The port unrolls the loop in
Python, so every step is a Python call with its step as an int, and hands
each step to a *guard* with the search's continue flag: a 0-dim bool
tensor that the previous step wrote (true before the first). A guard is a
callable ``guard(flag, body)`` that runs ``body()`` or not:

- :func:`every_step` runs every body and reads nothing: the fixed-step
  loop, for the CPU and for eager CUDA code;
- ``graphs.py::conditional_step`` is the guard of the captured programs:
  under capture it puts the body into a CUDA graph *if* node on the flag,
  so that a replay runs step ``s`` only while step ``s - 1`` left a beam
  alive, as the ``while_loop`` does.

:func:`counted` wraps a guard so that each step it runs adds one to a
counter on the device: the steps a search ran, read back with its tokens
(the ``decode_steps`` of a ``readback`` span, ``utils/profiling.py``).

A skipped step is exact because, once no beam is alive, a step changes no
output of the search (the argument is in ``decoding/beam.py`` and
``decoding/greedy.py``). A body writes its results into buffers allocated
before the first step: a tensor allocated inside a body that a replay skips
holds whatever the pool's memory held.
"""

from __future__ import annotations

from typing import Callable

import torch

Body = Callable[[], None]
Guard = Callable[[torch.Tensor, Body], None]


def every_step(flag: torch.Tensor, body: Body) -> None:
    """Run ``body``, whatever ``flag`` holds, reading nothing back."""
    body()


def counted(guard: Guard, steps: torch.Tensor) -> Guard:
    """``guard`` whose bodies each add one to ``steps`` (an int tensor on the
    search's device) after the step: the steps run, counted on the device
    where they run (inside a captured step's *if* node), for the caller to
    read back with the tokens."""

    def counting(flag: torch.Tensor, body: Body) -> None:
        def step() -> None:
            body()
            steps.add_(1)

        guard(flag, step)

    return counting
