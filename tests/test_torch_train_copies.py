"""The modules that the training path copies from conette_tpu under the copy
rule (numpy and stdlib code, file for file at the same path) hold the
original's code, and the ``conf/`` tree is byte for byte the original's
(with two port-only files beside it, the Wavegram_Logmel_Cnn14 pack's
``audio_t`` and ``expt``).

Code is compared as in ``tests/test_torch_loaders.py``: the AST without
docstrings, the JAX package's name read as the port's. The differences on
purpose: ``data/hdf.py`` reads and writes HDF5 through the port's
``data/hdf5.py`` in place of h5py, so that the port needs no h5py;
``data/datamodule.py`` and ``data/prefetch.py`` open the port's spans
around a training batch's build and the prefetch thread's wait;
``data/datamodule.py`` builds a training batch in one pass through the
port's ``data/gather.py`` (the rows read straight into the batch, the
captions' tokens from a memo), the batch that reading each item and
collating the items gave, so it has no ``_train_item``, and takes the
fixed-shape probe's lengths from the packs' columns read once; and
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

# the spans of the port's recorder (utils/profiling.py) around a training
# batch's build, which the copy gathers in one pass (data/gather.py), and
# around the prefetch thread's wait on a full queue
_BUILD = """            items = [self._train_item(self._train, int(i), epoch) for i in idxs]
            batch = collate(items)
            lens = np.asarray([it["audio_lens"] for it in items], np.int32)
            batch["audio_lens"] = lens
            yield self._postprocess(batch)
"""
_BUILD_GATHERED = """            # spans rooted at (epoch, the batch's index), as fit's for it;
            # the rows gathered in one pass (data/gather.py), the batch the
            # items collated would give
            with span("build_batch", root=(epoch, b)):
                with span("read_items") as read:
                    rows = self._gather.read(self._train, idxs, epoch, collate)
                    read.set(route=rows.route, rows=len(idxs))
                with span("collate"):
                    batch = self._postprocess(self._gather.collate(rows, collate))
            yield batch
"""
# the fixed-shape probe's lengths: item by item in the original, from each
# pack's columns read once (the batches' reader) in the copy
_PROBE = """        self._audio_pad_to = 0
        if self.fixed_shapes:
            lens = []
            for ds in datasets:
                for i in range(len(ds)):
                    lens.append(_item_audio_len(ds, i))
            self._audio_pad_to = max(lens, default=0)
"""
_PROBE_GATHERED = """        self._audio_pad_to = 0
        # the training batches' reader: each pack's lengths and small
        # columns read once, in one vectorised read each
        self._gather = BatchGather(self, datasets)
        if self.fixed_shapes:
            lens = [self._gather.leaf(ds).stored_lens() for ds in datasets]
            self._audio_pad_to = max((int(x.max()) for x in lens if len(x)), default=0)
"""
_PUT = """            for item in it:
                q.put(item)
"""
_PUT_SPANNED = """            for i, item in enumerate(it):
                try:
                    q.put_nowait(item)
                except queue.Full:
                    with span("queue_full", item=i):
                        q.put(item)
"""
_SPAN_IMPORT = "from conette_torch.utils.profiling import span\n"


def _method(path: str, name: str, following: str) -> str:
    """The text of the method ``name`` of ``path``, up to the method ``following``."""
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    return text[text.index(f"    def {name}("):text.index(f"    def {following}(")]


# the copy gathers a batch's rows itself (data/gather.py): no item reader
_TRAIN_ITEM = _method("conette_tpu/data/datamodule.py", "_train_item", "_eval_item")

# (text in the original, its replacement in the copy, occurrences)
DIFFERENCES = {
    "data/hdf.py": [("import h5py\n", "from conette_torch.data import hdf5 as h5py\n", 2)],
    "data/datamodule.py": [
        ("from conette_tpu.tokenization import AACTokenizer\n",
         "from conette_tpu.tokenization import AACTokenizer\n" + _SPAN_IMPORT, 1),
        ("from conette_tpu.data.hdf import HDFDataset\n",
         "from conette_tpu.data.gather import BatchGather\nfrom conette_tpu.data.hdf import HDFDataset\n", 1),
        (_PROBE, _PROBE_GATHERED, 1),
        (_TRAIN_ITEM, "", 1),
        (_BUILD, _BUILD_GATHERED, 1)],
    "data/prefetch.py": [
        ("from typing import Any, Iterable, Iterator\n",
         "from typing import Any, Iterable, Iterator\n\n" + _SPAN_IMPORT, 1),
        (_PUT, _PUT_SPANNED, 1)],
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


# conf files only the port has: the packing encoders the JAX package lacks
PORT_ONLY_CONF = (
    "audio_t/resample_mean_wavegram_logmel_cnn14.yaml",
    "expt/clotho_wavegram_logmel_cnn14.yaml",
)


def test_conf_tree_is_byte_equal():
    """Every file of ``conette_tpu/conf`` is in ``conette_torch/conf`` with
    the same bytes, and nothing else is but ``PORT_ONLY_CONF``;
    ``config/loader.py``'s relative ``DEFAULT_CONF_DIR`` then points the
    port at its own tree."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                      for f in fs if "__pycache__" not in d)

    src, dst = os.path.join(REPO, "conette_tpu", "conf"), os.path.join(REPO, "conette_torch", "conf")
    assert files(dst) == sorted(files(src) + list(PORT_ONLY_CONF))
    assert len(files(src)) == 69
    for f in files(src):
        assert filecmp.cmp(os.path.join(src, f), os.path.join(dst, f), shallow=False), f
    from conette_torch.config.loader import DEFAULT_CONF_DIR

    assert os.path.samefile(DEFAULT_CONF_DIR, dst)
