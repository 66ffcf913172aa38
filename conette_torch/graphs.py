"""Programs captured once per key into CUDA graphs and replayed.

The JAX package runs each stage of captioning as one compiled program:
``jax.jit`` of the encoder (``huggingface/preprocessor.py::_encode_fn``),
of projection plus decode (``huggingface/model.py::_generate_fn``) and of
a whole corpus batch (``serving.py::caption_batch``). The port's
counterpart is a ``torch.cuda.CUDAGraph`` per key: the function runs once
on a side stream (the warm-up, which also builds the kernels and fills the
caches of device constants), is then captured, and every later call with
the same key copies its inputs into the graph's static buffers and
replays it. A replay reads nothing back to the host.

- Host inputs (numpy arrays or CPU tensors) are copied into the
  program's pinned staging buffers and from there with
  ``non_blocking=True`` (a copy from pageable memory would wait for the
  stream); an event marks when those copies have run, and the next call
  waits on it (only if they have not) before it writes the staging buffers
  again. Device inputs are copied on the device.
- The outputs are the graph's static tensors: the next replay of the same
  program overwrites them, so a caller copies out what it keeps.
- :func:`run_in_batches` runs a program at a fixed batch: a request is
  cut into chunks of that many rows, a short chunk padded by repeating its
  first row, so that the programs' keys do not grow with the request
  sizes a stream sends.
- The function's tensors that are not inputs (the weights) are read at
  the addresses they had at capture; a program sees in-place updates of
  them, and a tensor that is replaced needs a new program
  (:meth:`GraphCache.clear`).
- On the CPU there is no graph: :meth:`GraphCache.run` calls the function.

A capture that fails raises; nothing falls back to eager execution.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

Inputs = Sequence["np.ndarray | torch.Tensor"]

# the rows of a request's programs (the encoder's and the decode's): a
# request of fewer clips is padded to them, a larger one runs in chunks of
# them, so that a stream of requests of any sizes needs one program for each
# padded length and decode setting
REQUEST_BATCH = 8


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


class CapturedProgram:
    """``fn`` captured at the shapes and dtypes of ``inputs`` on ``device``."""

    def __init__(self, fn: Callable[..., Any], inputs: Inputs, device: torch.device) -> None:
        with torch.inference_mode():
            self.static_inputs = [
                torch.empty(t.shape, dtype=t.dtype, device=device) for t in map(_as_tensor, inputs)
            ]
            self.staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                            for t in self.static_inputs]
            self.copied = torch.cuda.Event()
            self._copy_in(inputs)
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                fn(*self.static_inputs)  # warm-up: builds, caches, first use
            stream.wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()  # as the capture does: what stays reserved is in use
            reserved = torch.cuda.memory_reserved(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.static_inputs)
        # the graph's private pool, and the static inputs beside it (their
        # pinned staging buffers are as large again, in host memory)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.input_bytes = sum(t.numel() * t.element_size() for t in self.static_inputs)

    def _copy_in(self, inputs: Inputs) -> None:
        if len(inputs) != len(self.static_inputs):
            raise ValueError(f"expected {len(self.static_inputs)} inputs, got {len(inputs)}")
        if not self.copied.query():  # the staging buffers' last copies are still queued
            self.copied.synchronize()
        for dst, stage, x in zip(self.static_inputs, self.staging, inputs):
            src = _as_tensor(x)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"input of {tuple(src.shape)} {src.dtype} given to a program "
                                 f"captured at {tuple(dst.shape)} {dst.dtype}")
            if isinstance(x, np.ndarray):
                # numpy's copy into pinned memory runs ~3x faster here than
                # Tensor.copy_ (1.8 against 6.0 ms for 8 x 10 s of audio)
                np.copyto(stage.numpy(), x)
                src = stage
            elif src.device.type == "cpu":
                src = stage.copy_(src)
            dst.copy_(src, non_blocking=True)
        self.copied.record()

    def __call__(self, *inputs: Any) -> Any:
        with torch.inference_mode():
            self.staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                            for t in self.static_inputs]
            self.copied = torch.cuda.Event()
            self._copy_in(inputs)
            self.graph.replay()
        return self.outputs


class GraphCache:
    """At most ``max_graphs`` captured programs by key; the least recently
    used is dropped (with its memory pool) when a new key needs room."""

    def __init__(self, max_graphs: int) -> None:
        self.max_graphs = max_graphs
        self.programs: OrderedDict[Hashable, CapturedProgram] = OrderedDict()
        self.capture_s: dict[Hashable, float] = {}

    def run(self, key: Hashable, fn: Callable[..., Any], inputs: Inputs,
            device: torch.device) -> Any:
        """``fn(*inputs)``: on the CPU called as it is; on CUDA replayed from
        the program of ``key``, captured on first use."""
        if device.type != "cuda":
            return fn(*(_as_tensor(x).to(device) for x in inputs))
        prog = self.programs.get(key)
        if prog is None:
            while len(self.programs) >= self.max_graphs:
                self.programs.popitem(last=False)
            t0 = time.perf_counter()
            prog = self.programs[key] = CapturedProgram(fn, inputs, device)
            torch.cuda.synchronize(device)
            self.capture_s[key] = time.perf_counter() - t0
        else:
            self.programs.move_to_end(key)
        return prog(*inputs)

    def run_batched(self, key: Hashable, fn: Callable[..., Any], inputs: Inputs,
                    device: torch.device, *, n_batched: int) -> tuple[torch.Tensor, ...]:
        """``fn(*inputs)``, whose first ``n_batched`` inputs and whose
        outputs have a leading batch dimension: on the CPU called as it is;
        on CUDA through the programs of ``(REQUEST_BATCH, *key)`` over chunks
        of ``REQUEST_BATCH`` rows (:func:`run_in_batches`)."""
        if device.type != "cuda":
            return tuple(self.run(key, fn, inputs, device))
        return run_in_batches(lambda k, xs: self.run(k, fn, xs, device), key, inputs, n_batched,
                              REQUEST_BATCH)

    def clear(self) -> None:
        self.programs.clear()
        self.capture_s.clear()

    def memory_bytes(self) -> dict[Hashable, int]:
        """Device bytes each program holds: its pool and its static inputs."""
        return {k: p.pool_bytes + p.input_bytes for k, p in self.programs.items()}


def _pad_rows(x: "np.ndarray | torch.Tensor", rows: int) -> "np.ndarray | torch.Tensor":
    """``x`` with its first row repeated up to ``rows`` rows."""
    n = len(x)
    if n == rows:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand(rows - n, *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[:1], rows - n, axis=0)])


def run_in_batches(run: Callable[[Hashable, Inputs], Sequence[torch.Tensor]], key: Hashable,
                   inputs: Inputs, n_batched: int, rows: int) -> tuple[torch.Tensor, ...]:
    """``run((rows, *key), chunk)`` over chunks of ``rows`` rows of the
    first ``n_batched`` inputs (the others are passed whole); a short chunk
    is padded by repeating its first row, whose outputs are dropped.
    Returns each output's rows in order, as copies: the program's own
    outputs are overwritten by its next replay."""
    b = len(inputs[0])
    parts = []
    for start in range(0, b, rows):
        n = min(rows, b - start)
        chunk = [_pad_rows(x[start:start + rows], rows) for x in inputs[:n_batched]]
        parts.append([o[:n].clone() for o in run((rows, *key), (*chunk, *inputs[n_batched:]))])
    return tuple(torch.cat(p) if len(p) > 1 else p[0] for p in zip(*parts))
