"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package registers the kernels' custom ops
(``conette_torch::convnext_block``, ``conette_torch::downsample`` and
``conette_torch::logmel``), which a program exported on the card calls.
"""

from conette_torch.kernels import convnext_block, downsample, logmel  # noqa: F401
