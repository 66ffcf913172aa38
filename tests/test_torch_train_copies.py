"""The modules that the training path copies from conette_tpu under the copy
rule (numpy and stdlib code, file for file at the same path) hold the
original's code, and the ``conf/`` tree is byte for byte the original's.

Code is compared as in ``tests/test_torch_loaders.py``: the AST without
docstrings, the JAX package's name read as the port's. The differences on
purpose: ``data/hdf.py`` reads and writes HDF5 through the port's
``data/hdf5.py`` in place of h5py, so that the port needs no h5py; and
``parity.py`` joins its ``DEFAULT_OUTPUTS_DIR`` from the path's parts."""

import ast
import filecmp
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = (
    ["data/__init__.py", "data/datasets.py", "data/hdf.py", "data/collate.py", "data/prefetch.py",
     "data/datamodule.py", "config/__init__.py", "config/loader.py", "utils/log_utils.py",
     "utils/run_logger.py", "utils/dcase.py", "utils/disk_cache.py", "train/evaluation.py",
     "parity.py"]
    + sorted(os.path.relpath(os.path.join(d, f), os.path.join(REPO, "conette_tpu"))
             for d, _, fs in os.walk(os.path.join(REPO, "conette_tpu", "metrics"))
             for f in fs if f.endswith(".py"))
)

# the reference outputs' directory, which parity.py spells as a literal
_OUTPUTS = os.path.join(os.sep, "root", "reference", "results", "detailed_outputs")

# (text in the original, its replacement in the copy, occurrences)
DIFFERENCES = {
    "data/hdf.py": [("import h5py\n", "from conette_torch.data import hdf5 as h5py\n", 2)],
    # the same value, joined from its parts; its lazy imports read the port's
    # tokenization/ and metrics/functional/ by the package rename alone
    "parity.py": [(f'DEFAULT_OUTPUTS_DIR = "{_OUTPUTS}"',
                   'DEFAULT_OUTPUTS_DIR = os.path.join(os.sep, "root", "reference", "results", '
                   '"detailed_outputs")', 1)],
}


def _code(path: str, differences=()) -> str:
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    for old, new, count in differences:
        assert text.count(old) == count, (path, old)
        text = text.replace(old, new)
    tree = ast.parse(text.replace("conette_tpu", "conette_torch"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIES)
def test_copies_hold_the_original_code(module):
    assert _code(f"conette_torch/{module}") == _code(f"conette_tpu/{module}", DIFFERENCES.get(module, ()))


def test_conf_tree_is_byte_equal():
    """Every file of ``conette_tpu/conf`` is in ``conette_torch/conf`` with
    the same bytes, and nothing else is; ``config/loader.py``'s relative
    ``DEFAULT_CONF_DIR`` then points the port at its own tree."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                      for f in fs if "__pycache__" not in d)

    src, dst = os.path.join(REPO, "conette_tpu", "conf"), os.path.join(REPO, "conette_torch", "conf")
    assert files(src) == files(dst)
    assert len(files(src)) == 69
    for f in files(src):
        assert filecmp.cmp(os.path.join(src, f), os.path.join(dst, f), shallow=False), f
    from conette_torch.config.loader import DEFAULT_CONF_DIR

    assert os.path.samefile(DEFAULT_CONF_DIR, dst)
