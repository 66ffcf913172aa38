"""Disk-cached function calls keyed by argument checksum
(twin of ``src/conette/utils/disk_cache.py:26-99``)."""

from __future__ import annotations

import functools
import logging
import os
import pickle
from typing import Any, Callable, TypeVar

from conette_torch.utils.csum import csum_any

pylog = logging.getLogger(__name__)

F = TypeVar("F", bound=Callable)

DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/conette_torch/disk_cache")


def disk_cache(fn: F, cache_dir: str | None = None) -> F:
    """Memoize ``fn`` on disk, keyed by a checksum of (qualname, args)."""
    cache_dir = cache_dir or DEFAULT_CACHE_DIR

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        key = csum_any([fn.__qualname__, list(args), kwargs])
        fpath = os.path.join(cache_dir, f"{fn.__name__}_{key:016x}.pkl")
        if os.path.isfile(fpath):
            try:
                with open(fpath, "rb") as f:
                    return pickle.load(f)
            except Exception as err:
                pylog.warning(f"disk_cache read failed ({err}); recomputing")
        result = fn(*args, **kwargs)
        os.makedirs(cache_dir, exist_ok=True)
        tmp = fpath + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, fpath)
        return result

    return wrapper  # type: ignore[return-value]
