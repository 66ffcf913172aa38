"""The decode's early exit on the card: beam and greedy search captured by
``graphs.GraphCache`` with each step under a CUDA graph *if* node
(``graphs.py::conditional_step``) against the same search captured
with every step run (``every_step``), at full width (the 6-layer, 256-wide
decoder, vocabulary 4000, 8 clips, 31 frames of memory, f32 and bf16).
Their outputs have the same bits at scripted caption lengths and at full
length, and a counting twin of the guarded program runs exactly the
longest scripted length. A guarded step captured outside a
``ConditionalCapture`` raises.

Conditional nodes are a CUDA graph feature, so these tests skip without an
sm_90 device. This file imports neither JAX nor conette_tpu:
``python -m pytest --noconftest tests/test_torch_decode_guard_card.py``.
"""

import numpy as np
import pytest
import torch

from conette_torch.decoding.beam import beam_search
from conette_torch.decoding.greedy import greedy_search
from conette_torch.decoding.guard import counted, every_step
from conette_torch.graphs import GraphCache, conditional_step
from conette_torch.models import decoder as td
from torch_fixtures import eos_schedule, outputs_same_bits, target_lengths

B, T_MEM, MAX_P, MIN_P = 8, 31, 20, 3
CFG = td.DecoderConfig(vocab_size=4000)


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (H100): conditional nodes are a CUDA graph feature")
    return torch.device("cuda")


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, dev) for v in tree]
    return tree.to(dev)


def _inputs(dev):
    rng = np.random.default_rng(0)
    memory = torch.from_numpy((rng.standard_normal((B, T_MEM, CFG.d_model)) * 0.5)
                              .astype(np.float32)).to(dev)
    pad = torch.zeros((B, T_MEM), dtype=torch.bool, device=dev)
    pad[:, 25:] = torch.from_numpy(rng.random((B, T_MEM - 25)) > 0.5).to(dev)
    bos = torch.from_numpy(rng.integers(1, 8, B)).to(dev)
    return memory, pad, bos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("search", ["beam3", "greedy"])
def test_guarded_program_gives_the_fixed_programs_bits_and_runs_its_steps(h100, search, dtype):
    dev = h100
    params = _on(td.decoder_init(torch.Generator().manual_seed(0), CFG), dev)
    memory, pad, bos = _inputs(dev)
    lengths = target_lengths(B)
    scripted = torch.from_numpy(eos_schedule(lengths, MAX_P)).to(dev)
    full = torch.zeros_like(scripted)
    steps = torch.zeros((), dtype=torch.int64, device=dev)

    def program(guard):
        def fn(memory, pad, bos, sched):
            if search == "greedy":  # no EOS schedule: random weights run every step
                return tuple(greedy_search(params, CFG, memory.to(dtype), pad, bos,
                                           min_pred_size=MIN_P, max_pred_size=MAX_P, guard=guard))
            return tuple(beam_search(params, CFG, memory.to(dtype), pad, bos, beam_size=3,
                                     min_pred_size=MIN_P, max_pred_size=MAX_P,
                                     eos_bias_schedule=sched, guard=guard))
        return fn

    fns = {"fixed": program(every_step), "guarded": program(conditional_step),
           "counted": program(counted(conditional_step, steps))}
    cache = GraphCache(len(fns))
    for kind, fn in fns.items():  # captured on first use
        cache.run((kind,), fn, (memory, pad, bos, full), dev)
    longest = MAX_P if search == "greedy" else int(lengths.max())
    for sched, want_steps in ((scripted, longest), (full, MAX_P), (scripted, longest)):
        steps.zero_()
        got = {kind: [t.clone() for t in cache.run((kind,), fn, (memory, pad, bos, sched), dev)]
               for kind, fn in fns.items()}
        assert outputs_same_bits(got["fixed"], got["guarded"])
        assert outputs_same_bits(got["fixed"], got["counted"])
        assert int(steps) == want_steps
    assert {k: p.conditional_nodes for k, p in cache.programs.items()} == {
        ("fixed",): 0, ("guarded",): MAX_P, ("counted",): MAX_P}


def test_a_guarded_step_captured_outside_a_conditional_capture_raises(h100):
    flag = torch.ones((), dtype=torch.bool, device=h100)
    x = torch.zeros((), device=h100)
    conditional_step(flag, lambda: x.add_(1))  # eager: runs, and loads the library
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside a ConditionalCapture"):
        with torch.cuda.graph(graph):
            conditional_step(flag, lambda: x.add_(1))
