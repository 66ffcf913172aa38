"""A captioning request and its decode replay on one checkout of the port,
on the card, to compare two checkouts (in turns, in one call):

    python3 scripts/_decode_replay_ab.py [--root DIR] [--parent DIR]

``--root`` is the checkout to import ``conette_torch`` and ``chip_smoke``
from (this one by default; another one unpacked with ``git archive``). It
builds ``chip_smoke``'s full-width CoNeTTE from its seeds (random weights:
every beam runs all 20 steps), loads it with the bf16 encoder, answers
``--requests`` requests of 8 clips of 10 s at 44.1 kHz and prints one JSON
line: the warm requests' host time (the first two, which capture, left
out), and the device time of the model's decode program's replay
(projection and beam 3 at f32, CUDA events, the median of 15 replays in
each of ``--rounds`` rounds), with the card's name and power limit.

``--parent`` (with this checkout as the root) is another checkout whose
``conette_torch/decoding/beam.py`` is loaded as a module of its own (its
imports resolve to this checkout's modules). On the last request's
encoder output, the projection and its beam search, this checkout's with
every step run (``fixed``) and with each step under an *if* node
(``guarded``), are captured beside the same with the parent's beam search
(``parent``), checked for the same bits, and replayed in
``chip_smoke.GUARD_TURNS`` turns of one replay each
(``chip_smoke.paired_replays_ms``): the three compared within one process
and one stretch of the card's speed.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def parent_programs(model, c, audio, a_lens, bos, parent: str) -> dict:
    """The projection and beam 3 of (``audio``, ``a_lens``, ``bos``),
    captured fixed-step, guarded and with the beam search of the checkout
    at ``parent``: the same bits, and their replays in turns."""
    import torch

    from conette_torch.decoding import beam
    from conette_torch.decoding.guard import every_step
    from conette_torch.graphs import GraphCache, conditional_step
    from conette_torch.models.conette import encode_audio

    spec = importlib.util.spec_from_file_location(
        "parent_beam", os.path.join(parent, "conette_torch", "decoding", "beam.py"))
    parent_beam = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_beam)
    cfg = model.model_cfg
    searches = {"fixed": functools.partial(beam.beam_search, guard=every_step),
                "guarded": functools.partial(beam.beam_search, guard=conditional_step),
                "parent": parent_beam.beam_search}

    def fn(search, audio, a_lens, bos):
        memory, pad = encode_audio(model.params, cfg, audio, a_lens)
        res = search(model.params["decoder"], cfg.decoder_config(), memory, pad, bos,
                     beam_size=3, min_pred_size=cfg.min_pred_size,
                     max_pred_size=cfg.max_pred_size, forbid_rep_mask=model.forbid_rep_mask)
        return tuple(res)

    cache = GraphCache(len(searches))
    outs = {name: [t.clone() for t in cache.run((name,), functools.partial(fn, search),
                                                  (audio, a_lens, bos), model.device)]
            for name, search in searches.items()}
    torch.cuda.synchronize()
    timed = c.paired_replays_ms({name: cache.programs[(name,)] for name in searches})
    return {"same_bits": {name: c.outputs_same_bits(outs["fixed"], o) for name, o in outs.items()},
            "conditional_nodes": {name: cache.programs[(name,)].conditional_nodes
                                  for name in searches},
            "turns": c.GUARD_TURNS, "min_ms": timed["min"], "median_ms": timed["median"],
            "ratio_to_fixed_median": timed["ratio_median"],
            "diff_to_fixed_median_ms": timed["diff_median_ms"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--root", default=here)
    parser.add_argument("--parent", default=None)
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("_decode_replay_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as c
    import conette_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as work:
        model = conette_torch.conette(c.build_model(work), compute_dtype=torch.bfloat16)
        rng = np.random.default_rng(3)
        tasks = ["clotho", "audiocaps", "macs", "wavcaps_freesound"] * 2
        request_ms = []
        for _ in range(args.requests):
            clips = c.make_clips(rng, c.BATCH, 10.0, 44100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(clips, sr=44100, task=tasks)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        (decode,) = [p for k, p in model.graphs.programs.items() if k[1] == "generate"]
        replay_ms = []
        for _ in range(args.rounds):
            times = []
            for _ in range(15):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                decode.graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            replay_ms.append(statistics.median(times))
        result = {
            "root": root, "card": smi, "torch": torch.__version__,
            "conditional_nodes": getattr(decode, "conditional_nodes", None),
            "caption_lengths": (out["preds"] != model.model_cfg.pad_id).sum(-1).tolist(),
            "warm_request_ms": request_ms[2:],
            "warm_request_ms_median": statistics.median(request_ms[2:]),
            "decode_replay_ms": replay_ms, "decode_replay_ms_median": statistics.median(replay_ms),
        }
        if args.parent:
            audio, a_lens, bos = (t.clone() for t in decode.static_inputs[:3])
            result["in_turns"] = parent_programs(model, c, audio, a_lens, bos,
                                                 os.path.abspath(args.parent))
    print(json.dumps(result), flush=True)
    if args.parent and not all(result["in_turns"]["same_bits"].values()):
        print("_decode_replay_ab: the searches disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
