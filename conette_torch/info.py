"""conette-info: an install report (reference ``conette-info`` console
script, ``src/conette/info.py``), for the port's stack: the package, torch,
its CUDA and the card.

Run as ``python -m conette_torch.info``.
"""

from __future__ import annotations

import platform
import sys
from pathlib import Path


def get_package_repository_path() -> str:
    """Absolute path of the package's repository root (reference
    ``info.py:17-19``)."""
    return str(Path(__file__).parent.parent)


def get_install_info() -> dict[str, str]:
    """Versions and paths (reference ``info.py:22-34``)."""
    import torch

    import conette_torch
    from conette_torch import get_sample_path

    rows: dict[str, str] = {
        "conette_torch": conette_torch.__version__,
        "python": sys.version.split()[0],
        "os": platform.platform(),
        "architecture": platform.architecture()[0],
    }
    for mod in ("torch", "numpy", "yaml", "triton"):
        try:
            m = __import__(mod)
        except ImportError:
            rows[mod] = "not installed"
        else:
            rows[mod] = str(getattr(m, "__version__", "?"))
    rows["torch.version.cuda"] = str(torch.version.cuda)
    if torch.cuda.is_available():
        rows["cuda.devices"] = ", ".join(
            f"{torch.cuda.get_device_name(i)} (sm_{''.join(map(str, torch.cuda.get_device_capability(i)))})"
            for i in range(torch.cuda.device_count()))
    else:
        rows["cuda.devices"] = "none"
    rows["package_path"] = get_package_repository_path()
    rows["sample_path"] = get_sample_path()
    return rows


def print_install_info() -> int:
    rows = get_install_info()
    width = max(map(len, rows))
    for k, v in rows.items():
        print(f"{k:<{width}} : {v}")
    return 0


if __name__ == "__main__":
    sys.exit(print_install_info())
