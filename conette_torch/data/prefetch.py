"""Threaded host-side batch prefetching.

The reference overlaps HDF reads with GPU compute through DataLoader
worker processes (``datamodules/aac_dm.py:129-142``). The JAX twin: a
small background thread drains the (h5py-reading, collating) batch
iterator into a bounded queue while the device executes the previous
steps, so host input time hides behind the asynchronously-dispatched
train step. Depth 2 is enough — JAX's dispatch queue provides the rest of
the pipelining.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

from conette_torch.utils.profiling import span

_SENTINEL = object()


def prefetch_iterator(it: Iterable[Any], depth: int = 2) -> Iterator[Any]:
    """Wrap ``it`` so item N+1..N+depth are produced on a background thread
    while item N is being consumed. Exceptions re-raise at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    err: list[BaseException] = []

    def worker() -> None:
        try:
            for i, item in enumerate(it):
                try:
                    q.put_nowait(item)
                except queue.Full:  # the consumer is behind: a span while the producer waits
                    with span("queue_full", item=i):
                        q.put(item)
        except BaseException as exc:  # propagate to the consumer
            err.append(exc)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        yield item
    thread.join()
    if err:
        raise err[0]
