"""conette_torch — CoNeTTE audio captioning in PyTorch, on CUDA.

The PyTorch/CUDA counterpart of ``conette_tpu``: the same public API, the
same weight files (``params.npz``), the same layouts at public functions
(NHWC activations, HWIO conv weights, ``(in, out)`` linear weights). On an
NVIDIA H100 in bf16, the ConvNeXt encoder runs its blocks and downsample
seams through hand-written CUDA kernels (``conette_torch/csrc``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).
"""

from pathlib import Path

__version__ = "0.1.0"

DEFAULT_MODEL_NAME = "Labbeti/conette"


def get_sample_path() -> str:
    """Return the path of a sample audio file, generated deterministically
    on first use (a synthetic 10 s clip at 44.1 kHz)."""
    data_dir = Path(__file__).parent / "data_assets"
    data_dir.mkdir(exist_ok=True)
    fpath = data_dir / "sample.wav"
    if not fpath.exists():
        from conette_torch.utils.audio_io import generate_sample_wav

        generate_sample_wav(str(fpath))
    return str(fpath)


def conette(
    pretrained_model_name_or_path: str | None = DEFAULT_MODEL_NAME,
    config_kwds: dict | None = None,
    model_kwds: dict | None = None,
    **kwargs,
):
    """Build a ``CoNeTTEModel``: loaded from a directory when a path is
    given, freshly initialised from a seed when ``None``. ``config_kwds``
    override the directory's config (the reference's copy of this function
    passes its config to ``__init__`` twice and raises there)."""
    from conette_torch.huggingface.config import CoNeTTEConfig
    from conette_torch.huggingface.model import CoNeTTEModel

    config_kwds = config_kwds or {}
    model_kwds = dict(model_kwds or {}) | kwargs
    if pretrained_model_name_or_path is None:
        return CoNeTTEModel(CoNeTTEConfig(**config_kwds), **model_kwds)
    if config_kwds:
        config = CoNeTTEConfig.from_pretrained(pretrained_model_name_or_path, **config_kwds)
        model_kwds = {"config": config} | model_kwds
    return CoNeTTEModel.from_pretrained(pretrained_model_name_or_path, **model_kwds)


# lazy top-level re-exports (PEP 562): `import conette_torch` stays light
def __getattr__(name: str):
    if name in ("CoNeTTEConfig", "CoNeTTEModel"):
        import importlib

        mod = importlib.import_module(
            f"conette_torch.huggingface.{'config' if name == 'CoNeTTEConfig' else 'model'}"
        )
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DEFAULT_MODEL_NAME",
    "CoNeTTEConfig",
    "CoNeTTEModel",
    "conette",
    "get_sample_path",
    "__version__",
]
