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

- Host inputs (numpy arrays or CPU tensors) are copied into pinned
  staging buffers, allocated anew for each call, and from there with
  ``non_blocking=True`` (a copy from pageable memory would wait for the
  stream); the caching host allocator keeps a call's buffers from being
  handed out again until the copies queued from them have run. Device
  inputs are copied on the device.
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
- A captured decode leaves its loop on the device: the model's searches
  hand each step to :func:`conditional_step` (a step guard,
  ``decoding/guard.py``), which captures it into a CUDA graph conditional
  (*if*) node on the continue flag that the step before it wrote, so a
  replay runs only the steps up to the one where the last beam retires, as
  the JAX package's ``while_loop`` does. Each capture runs inside a
  :class:`ConditionalCapture`, which builds those nodes and gives their
  bodies' memory a pool that lives as long as the graph. The nodes are
  built through the CUDA runtime in the port's own C++
  (``csrc/conditional.cu``; torch 2.11, on the card, has no
  ``CUDAGraph.begin_capture_to_if_node``): a body is captured from a stream
  of its own, with the caching allocator pointed at that pool. If the
  runtime, the driver or torch cannot build the nodes, the capture raises:
  a captured search never quietly becomes the fixed-step program.
- On the CPU there is no graph: :meth:`GraphCache.run` calls the function.
- Spans (``utils/profiling.py``): ``warmup`` around a capture's first,
  eager call (which also builds kernels and loads libraries), ``capture``
  around the capture itself (its key and rows), and around a replay
  ``copy_in`` (the staging buffers and the copies) and ``replay`` (the
  graph's launch); the counter ``graph_evictions``.

A capture that fails raises; nothing falls back to eager execution.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

from conette_torch.utils.profiling import count, span

Inputs = Sequence["np.ndarray | torch.Tensor"]

# the rows of a request's programs (the encoder's and the decode's): a
# request of fewer clips is padded to them, a larger one runs in chunks of
# them, so that a stream of requests of any sizes needs one program for each
# padded length and decode setting
REQUEST_BATCH = 8


# conditional nodes need CUDA 12.4 (the runtime, the driver and torch's build)
MIN_CUDA = 12040
_current = threading.local()


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def conditional_step(flag: torch.Tensor, body: Callable[[], None]) -> None:
    """The step guard of the captured searches (``decoding/guard.py``):
    while a CUDA stream captures inside a :class:`ConditionalCapture`,
    capture ``body`` into an *if* node on ``flag``; otherwise run it."""
    if flag.device.type != "cuda":
        body()
        return
    if not torch.cuda.is_current_stream_capturing():
        # eager, as in a capture's warm-up: load what the capture will need
        require_conditional_nodes()
        _body_stream(flag.device.index)
        body()
        return
    capture = getattr(_current, "capture", None)
    if capture is None:
        raise RuntimeError(
            "a guarded decode step is being captured outside a ConditionalCapture: capture "
            "the search through graphs.GraphCache, or pass guard=every_step")
    capture.if_node(flag, body)


def _cuda_number(version: str | None) -> int:
    major, minor = (version or "0.0").split(".")[:2]
    return int(major) * 1000 + int(minor) * 10


def _call(name: str, *pointers) -> None:
    """Call the kernel library's C function ``name`` on pointer arguments;
    raise on the ``cudaError_t`` it returns."""
    from conette_torch.kernels import _build

    fn = getattr(_build.library(), name)
    fn.argtypes = [ctypes.c_void_p] * len(pointers)
    fn.restype = ctypes.c_int
    _build.check(fn(*pointers), name)


@functools.cache
def require_conditional_nodes() -> None:
    """Raise, naming what is missing, unless torch's CUDA build, the
    runtime the kernel library was built against and the driver can all
    build conditional nodes (12.4 or later) and torch can point its
    allocator at a pool for one stream."""
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _call("conette_conditional_versions", ctypes.byref(runtime), ctypes.byref(driver))
    missing = [f"{what} is CUDA {v // 1000}.{v % 1000 // 10}"
               for what, v in (("torch's build", _cuda_number(torch.version.cuda)),
                               ("the kernel library's runtime", runtime.value),
                               ("the driver", driver.value)) if v < MIN_CUDA]
    if not hasattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool"):
        missing.append("torch lacks torch._C._cuda_beginAllocateCurrentStreamToPool")
    if missing:
        raise RuntimeError("CUDA graph conditional nodes need CUDA 12.4 or later: "
                           + "; ".join(missing))


@functools.cache
def _body_stream(index: int) -> torch.cuda.ExternalStream:
    """The stream that captures the bodies on device ``index``: one of the
    library's own for the life of the process."""
    handle = ctypes.c_void_p()
    with torch.cuda.device(index):
        _call("conette_stream_create", ctypes.byref(handle))
    return torch.cuda.ExternalStream(handle.value, device=torch.device("cuda", index))


class ConditionalCapture:
    """The *if* nodes of one captured graph. Entered around the capture of
    ``graph``; the memory that its bodies allocate comes from a pool of its
    own, which is released when ``graph`` is collected."""

    def __init__(self, graph: torch.cuda.CUDAGraph, device: torch.device) -> None:
        self.graph_ref = weakref.ref(graph)
        device = torch.device(device)
        # "cuda" is the current device (a rank's own under torch.distributed)
        self.index = torch.cuda.current_device() if device.index is None else device.index
        self.pool = torch.cuda.graph_pool_handle()
        self.held = False
        self.nodes = 0

    def __enter__(self) -> "ConditionalCapture":
        if getattr(_current, "capture", None) is not None:
            raise RuntimeError("ConditionalCapture entered inside another")
        _current.capture = self
        return self

    def __exit__(self, *exc) -> None:
        _current.capture = None

    def if_node(self, flag: torch.Tensor, body: Callable[[], None]) -> None:
        """Capture ``body()`` into an *if* node on the bool ``flag``."""
        if flag.dtype != torch.bool or flag.numel() != 1:
            raise ValueError(f"a step's flag is one bool, got {flag.dtype} {tuple(flag.shape)}")
        require_conditional_nodes()
        parent = torch.cuda.current_stream(self.index)
        child = _body_stream(self.index)
        _call("conette_graph_if_begin", parent.cuda_stream, child.cuda_stream, flag.data_ptr())
        try:
            with torch.cuda.stream(child):
                torch._C._cuda_beginAllocateCurrentStreamToPool(self.index, self.pool)
                try:
                    body()
                finally:
                    torch._C._cuda_endAllocateToPool(self.index, self.pool)
                    self._hold_or_release()
        finally:
            _call("conette_graph_if_end", child.cuda_stream)
        self.nodes += 1

    def _hold_or_release(self) -> None:
        """Each begin holds the pool once: the first hold lasts as long as
        the graph, every later one is given back at once."""
        graph = self.graph_ref()
        if self.held or graph is None:
            torch._C._cuda_releasePool(self.index, self.pool)
            return
        self.held = True
        weakref.finalize(graph, torch._C._cuda_releasePool, self.index, self.pool).atexit = False


class CapturedProgram:
    """``fn`` captured at the shapes and dtypes of ``inputs`` on ``device``;
    ``key`` names it in its ``capture`` span."""

    def __init__(self, fn: Callable[..., Any], inputs: Inputs, device: torch.device,
                 key: Hashable | None = None) -> None:
        with torch.inference_mode():
            self.static_inputs = [
                torch.empty(t.shape, dtype=t.dtype, device=device) for t in map(_as_tensor, inputs)
            ]
            with span("warmup"):
                self.staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                for t in self.static_inputs]
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
            shape = self.static_inputs[0].shape if self.static_inputs else ()  # a scalar, or nothing
            with span("capture", key=repr(key), rows=shape[0] if shape else 1), \
                    torch.cuda.graph(self.graph), ConditionalCapture(self.graph, device) as cond:
                self.outputs = fn(*self.static_inputs)
        self.conditional_nodes = cond.nodes
        # the graph's private pool, and the static inputs beside it (their
        # pinned staging buffers are as large again, in host memory)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.input_bytes = sum(t.numel() * t.element_size() for t in self.static_inputs)

    def _copy_in(self, inputs: Inputs) -> None:
        if len(inputs) != len(self.static_inputs):
            raise ValueError(f"expected {len(self.static_inputs)} inputs, got {len(inputs)}")
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

    def __call__(self, *inputs: Any) -> Any:
        with torch.inference_mode():
            with span("copy_in"):
                self.staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                for t in self.static_inputs]
                self._copy_in(inputs)
            with span("replay"):
                self.graph.replay()
        return self.outputs


class GraphCache:
    """At most ``max_graphs`` captured programs by key; the least recently
    used is dropped (with its memory pool) when a new key needs room."""

    def __init__(self, max_graphs: int) -> None:
        self.max_graphs = max_graphs
        self.programs: OrderedDict[Hashable, CapturedProgram] = OrderedDict()

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
                count("graph_evictions")
            prog = self.programs[key] = CapturedProgram(fn, inputs, device, key)
            torch.cuda.synchronize(device)
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
