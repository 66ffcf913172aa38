"""The port's ``utils/profiling.py`` on the CPU against conette_tpu's:
``flops_profile`` of a product on the same shapes, ``debug_mode`` raising on
NaN and Inf in the forward and the backward pass, ``trace`` writing its
Chrome trace, also around ``main_train``'s fit loop, and ``TimeTracker``."""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from conette_tpu.utils import profiling as jax_profiling
from conette_torch.data.datasets import DummyAACDataset
from conette_torch.data.hdf import pack_to_hdf
from conette_torch.train.main import main_train
from conette_torch.utils import profiling


@pytest.mark.parametrize("m, k, n", [(64, 128, 32), (8, 256, 2048)])
def test_flops_profile_of_a_product_equals_jax(m, k, n):
    want = jax_profiling.flops_profile(lambda a, b: a @ b, jnp.ones((m, k)), jnp.ones((k, n)))
    got = profiling.flops_profile(lambda a, b: a @ b, torch.ones(m, k), torch.ones(k, n))
    assert got == {"flops": want["flops"]} == {"flops": 2.0 * m * k * n}


def test_debug_mode_raises_on_nan_and_inf_forward_and_backward():
    x = torch.tensor([1.0, 0.0])
    with pytest.raises(FloatingPointError, match="NaN or Inf"), profiling.debug_mode():
        torch.log(x - 1.0)  # log(-1) → NaN
    with pytest.raises(FloatingPointError), profiling.debug_mode():
        torch.div(x, 0.0)  # Inf
    w = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(w).sum()  # finite forward, 1 / (2·sqrt(0)) backward
    with pytest.raises(RuntimeError, match="nan|NaN|inf"), profiling.debug_mode():
        (torch.sqrt(w) * 0.0).sum().backward()
    with profiling.debug_mode():  # finite values pass
        assert torch.equal(torch.exp(torch.zeros(2)), torch.ones(2))
    assert y.item() == 0.0
    assert torch.isnan(torch.log(x - 1.0)).any()  # nothing raises outside the scope


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_active_step_keeps_the_scope_and_drops_the_warm_up():
    """``profiler()`` driven by ``active_step`` keeps the scope's ops as its
    one active step; what runs before the scope is not in it."""
    before = torch.ones(8, 8)
    with profiling.profiler() as prof:
        torch.cumsum(before, 0)
        with profiling.active_step(prof):
            torch.ones(32, 32) @ torch.ones(32, 32)
        torch.cumsum(before, 1)
    keys = {e.key for e in prof.key_averages()}
    assert "aten::mm" in keys and "aten::cumsum" not in keys, keys


def test_main_train_traces_its_fit_loop_through_trace(tmp_path, monkeypatch):
    """``trainer.profiler.name=jax`` wraps the fit loop in ``trace``, which
    writes ``{run_dir}/profile/trace.json`` with the steps' products in it."""
    for subset, size, seed in [("dev", 6, 0), ("val", 3, 1)]:
        pack_to_hdf(DummyAACDataset(size=size, seed=seed, dataset_name="clotho", subset=subset),
                    str(tmp_path / f"clotho_{subset}_x.hdf"))
    scopes = []
    trace = profiling.trace

    def spy(log_dir):
        scopes.append(log_dir)
        return trace(log_dir)

    monkeypatch.setattr(profiling, "trace", spy)
    out = main_train([
        "trainer=lim2", "ckpts=loss", f"dm.hdf_root={tmp_path}", "dm.train_hdfs=[clotho_dev_x.hdf]",
        "dm.val_hdfs=[clotho_val_x.hdf]", "dm.test_hdfs=[]", "dm.bsize=3", "trainer.max_epochs=1",
        "trainer.profiler.name=jax", f"log_root={tmp_path / 'logs'}", "pl.d_model=32", "pl.nhead=2",
        "pl.num_decoder_layers=2", "pl.dim_feedforward=64", "pl.max_pred_size=6",
        "pl.min_pred_size=1", "pl.beam_size=2", "testing.run=[]", "device=cpu"])
    assert scopes == [os.path.join(out["run_dir"], "profile")]
    with open(os.path.join(scopes[0], profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_time_tracker_matches_jax():
    for mod in (profiling, jax_profiling):
        tt = mod.TimeTracker()
        with tt.track("fit"):
            pass
        tt.durations["fit"] = 3725.0
        assert tt.formatted() == {"fit": "01:02:05"}
        with pytest.raises(KeyError):
            tt.stop("never_started")
    assert os.path.basename(profiling.__file__) == os.path.basename(jax_profiling.__file__)
