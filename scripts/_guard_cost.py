"""Where the guarded decode's extra device time goes, on the card:

    python3 scripts/_guard_cost.py

Builds ``chip_smoke``'s full-width CoNeTTE from its seeds (random weights,
so every beam runs all 20 steps), takes one request's encoder output (8
clips of 10 s) and captures the projection and beam 3 over f32 memory in
several forms, all on the same inputs:

- ``fixed``: every step in the graph itself (``every_step``);
- ``guarded``: each step under an *if* node (``conditional_step``), as the
  model's programs run it;
- ``one_node``: the whole fixed-step search inside one *if* node on a set
  flag: the steps' kernels in a body, with one node;
- ``empty_nodes``: every step in the graph itself, each followed by an
  *if* node with an empty body on the step's flag: 20 nodes, no kernel in
  a body;
- ``guarded_len4``: ``guarded`` with every caption ended after 4 tokens
  (``chip_smoke.eos_schedule``), so 16 of its nodes skip their bodies.

All are held to ``fixed``'s bits (``guarded_len4`` to a fixed-step twin on
its own schedule) and replayed in ``chip_smoke.GUARD_TURNS`` turns
(``chip_smoke.paired_replays_ms``: each replay behind a spin, timed
alone). Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("_guard_cost: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as c
    import conette_torch
    from conette_torch.decoding.guard import every_step
    from conette_torch.graphs import GraphCache, conditional_step
    from conette_torch.models.conette import encode_audio, forward_generate

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as work:
        model = conette_torch.conette(c.build_model(work), compute_dtype=torch.bfloat16)
        dev, cfg = model.device, model.model_cfg
        rng = np.random.default_rng(3)
        wav, lens = model.preprocessor.load_resample(c.make_clips(rng, c.BATCH, 10.0, 44100),
                                                     44100)
        audio, a_lens, _ = model.preprocessor.encode(wav, lens)
        bos = torch.from_numpy(c.bos_ids(model, ["clotho", "audiocaps"] * 4)).to(dev)
        full = torch.zeros((c.BATCH, cfg.max_pred_size), device=dev)
        len4 = torch.from_numpy(c.eos_schedule(np.full(c.BATCH, 4), cfg.max_pred_size)).to(dev)

        def search(audio, a_lens, bos, sched, guard):
            memory, pad = encode_audio(model.params, cfg, audio, a_lens)
            return tuple(forward_generate(model.params, cfg, memory, pad, bos,
                                          forbid_rep_mask=model.forbid_rep_mask,
                                          eos_bias_schedule=sched, guard=guard))

        def one_node(audio, a_lens, bos, sched):
            out = []
            flag = torch.ones((), dtype=torch.bool, device=dev)
            conditional_step(flag, lambda: out.append(search(audio, a_lens, bos, sched,
                                                             every_step)))
            return out[0]

        def empty_nodes(flag, body):
            body()
            conditional_step(flag, lambda: None)

        fns = {"fixed": functools.partial(search, guard=every_step),
               "guarded": functools.partial(search, guard=conditional_step),
               "one_node": one_node,
               "empty_nodes": functools.partial(search, guard=empty_nodes),
               "guarded_len4": functools.partial(search, guard=conditional_step),
               "fixed_len4": functools.partial(search, guard=every_step)}
        cache = GraphCache(len(fns))
        outs, failed = {}, {}
        for name, fn in fns.items():
            sched = len4 if name.endswith("len4") else full
            try:
                outs[name] = [t.clone() for t in cache.run((name,), fn,
                                                           (audio, a_lens, bos, sched), dev)]
            except RuntimeError as err:  # a form the runtime refuses is reported, not timed
                failed[name] = str(err)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        same = {name: c.outputs_same_bits(outs["fixed_len4" if name.endswith("len4")
                                               else "fixed"], o) for name, o in outs.items()}
        progs = {name: cache.programs[(name,)] for name in outs if name != "fixed_len4"}
        timed = c.paired_replays_ms(progs)
    result = {"card": smi, "torch": torch.__version__, "failed": failed, "same_bits": same,
              "conditional_nodes": {n: p.conditional_nodes for n, p in progs.items()},
              "turns": c.GUARD_TURNS, "min_ms": timed["min"], "median_ms": timed["median"],
              "launch_ms": timed["launch_ms"], "ratio_to_fixed_median": timed["ratio_median"],
              "diff_to_fixed_median_ms": timed["diff_median_ms"]}
    print(json.dumps(result), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
