"""Back-to-back ``conette-prepare`` packs of a corpus through PANNs'
Wavegram_Logmel_Cnn14, as ``prepare_pack`` runs them through Cnn14: the
same corpus, calls, metric and checks (``benchmark/drivers/prepare_pack.py``),
with this encoder's weights, its least time, its reference
(``benchmark/reference/wavegram.py``) and frame counts, and its ``wavegram``
span among those the profiled call attributes device time to.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from benchmark import gen, roofline_wavegram
from benchmark.drivers import prepare_pack
from benchmark.drivers.common import judged, mono_of_wav, set_f32
from benchmark.harness import Profile, Trace, Tracer, profiled
from benchmark.reference import wavegram as ref_wavegram
from benchmark.reference.precision import rounder

SPANS = prepare_pack.SPANS + ("wavegram",)


def wavegram_tree(cfg: dict) -> dict:
    """Wavegram_Logmel_Cnn14's parameters in the program's layout, drawn as
    ``prepare_pack.cnn14_tree`` draws Cnn14's: He-normal kernels (std
    sqrt(2 / fan_in), the 1-D ones WIO and bias-free as PANNs' are, the
    3×3 ones HWIO with zero biases), batch norms with drawn statistics,
    bn0's fitting log-mel values in dB; the clip head, which a pack does
    not read, at torch's default scales."""
    pre, (g_in, b4), chans, n_mels = cfg["pre_channels"], cfg["pre_block4"], cfg["channels"], cfg["n_mels"]

    def bn(dim):
        return {"weight": gen.normal((dim,), 0.1, 1.0), "bias": gen.normal((dim,), 0.1),
                "running_mean": gen.normal((dim,), 0.1),
                "running_var": gen.Leaf((dim,), "uniform", 0.5, 1.5)}

    def conv1d(k, cin, cout):
        return {"weight": gen.normal((k, cin, cout), math.sqrt(2.0 / (k * cin)))}

    def conv(cin, cout):
        return {"weight": gen.normal((3, 3, cin, cout), math.sqrt(2.0 / (9 * cin))),
                "bias": gen.normal((cout,), 0.0)}

    def block(cin, cout):
        return {"conv1": conv(cin, cout), "bn1": bn(cout), "conv2": conv(cout, cout), "bn2": bn(cout)}

    def lin(cin, cout):
        return {"weight": gen.uniform((cin, cout), 1 / math.sqrt(cin)),
                "bias": gen.uniform((cout,), 1 / math.sqrt(cin))}

    tree = {"pre_conv0": conv1d(11, 1, pre[0]), "pre_bn0": bn(pre[0])}
    for i, (cin, cout) in enumerate(zip(pre[:-1], pre[1:])):
        tree[f"pre_block{i + 1}"] = {"conv1": conv1d(3, cin, cout), "bn1": bn(cout),
                                     "conv2": conv1d(3, cout, cout), "bn2": bn(cout)}
    tree["pre_block4"] = block(g_in, b4)
    ins = [1, chans[0] + b4, *chans[1:-1]]
    return tree | {
        "bn0": {"weight": gen.normal((n_mels,), 0.1, 1.0), "bias": gen.normal((n_mels,), 0.1),
                "running_mean": gen.normal((n_mels,), 10.0, -30.0),
                "running_var": gen.Leaf((n_mels,), "uniform", 50.0, 300.0)},
        "blocks": [block(cin, c) for cin, c in zip(ins, chans)],
        "fc1": lin(chans[-1], chans[-1]),
        "fc_audioset": lin(chans[-1], cfg["num_classes"]),
    }


class Cell(prepare_pack.Cell):
    def weights(self) -> dict:
        g = torch.Generator(self.device).manual_seed(self.seed)
        return gen.materialize(wavegram_tree(self.cfg["encoder"]), g)

    def widths(self) -> tuple:
        enc = self.cfg["encoder"]
        return tuple(enc["pre_channels"]), enc["pre_block4"][1], tuple(enc["channels"])

    def bound_s(self) -> float:
        """A call's least time: each file's frame embeddings at the peaks."""
        return sum(roofline_wavegram.model_bound_s(s, *self.widths()) for s in self.samples)

    def wavegram_bound_s(self) -> float:
        """A call's least time for the wavegram branch alone."""
        pre, b4, _ = self.widths()
        return sum(roofline_wavegram.wavegram_bound_s(s, pre, b4) for s in self.samples)

    def window(self, seconds: float, tracer: Tracer) -> dict:
        n = len(self.paths)
        bound_s = self.bound_s()
        profiles: list[Profile] = []
        calls, clips, failed = 0, 0, 0
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            profile_now = tracer.on and calls == self.wl["profile_at"]
            tracer.keep = not profile_now
            ok = True
            try:
                if profile_now:
                    with profiled(profiles, SPANS), tracer.span("pack_dataset"):
                        self.call()
                else:
                    with tracer.span("pack_dataset"):
                        self.call()
            except Exception as err:  # a call that fails counts; the run is not correct
                print(f"pack_dataset_to_hdf failed: {err!r}", file=sys.stderr, flush=True)
                failed += 1
                ok = False
            end = time.perf_counter()
            calls += 1
            clips += n if ok else 0
        tracer.keep = True
        tracer.close()
        self.failed, self.done = failed, calls - failed
        prof = profiles[0] if profiles else None
        if prof is not None:
            prof.units = {"clips": n, "bound_s": bound_s, "wavegram_bound_s": self.wavegram_bound_s()}
        self.trace = Trace(tracer.spans, {"call_bound_s": bound_s}, prof)
        return {"metrics": {"corpus_clips_per_s": clips / (end - start)},
                "attempted": calls * n, "failed": failed * n}

    def check(self, control: dict | None = None) -> list[tuple[str, float, float]]:
        """``prepare_pack.Cell.check`` against ``reference/wavegram.py``:
        the last call's pack, its rows against the corpus in order, each
        row's frame count, and a sample of rows against the reference.
        ``control`` puts the reference so computed in the program's place:
        ``rnd_fmt``, its products at a lower precision; ``unmasked``, the
        clip zero-padded to its batch's longest and the padding not masked
        (the reference's first T' frames of that)."""
        from conette_torch.data.hdf import HDFDataset

        if self.failed or not self.done or self.pack_path is None:
            return [("failed_calls", float(self.failed or 1), 0.0)]
        pack = HDFDataset(self.pack_path)
        n = len(self.paths)
        rows = abs(len(pack) - n) + sum(
            pack.at(r, "fname") != self.fnames[r] or pack.at(r, "captions") != self.captions[r]
            or pack.at(r, "dataset") != self.wl["dataset"] or pack.at(r, "subset") != self.wl["subset"]
            for r in range(min(len(pack), n)))
        want_lens = [ref_wavegram.frame_count(s) for s in self.samples]
        lens = sum(int(pack.at(r, "audio_lens")) != want_lens[r] for r in range(min(len(pack), n)))
        numbers = {"rows": float(rows), "lens": float(lens)}
        if rows or lens:
            return judged(numbers | {"frames": 0.0}, self.wl["limits"])
        set_f32(self.device)
        params = self.weights()
        worst = 0.0
        with torch.no_grad():
            for r in self.sample_rows():
                mono = mono_of_wav(self.paths[r], self.device)
                ref = ref_wavegram.frames(params, mono[None])[0]
                if control is None:
                    prog = torch.as_tensor(pack.at(r, "audio"), device=self.device)
                elif control.get("unmasked"):
                    padded = torch.zeros((1, self.batch_longest(r)), device=self.device)
                    padded[0, : mono.shape[0]] = mono
                    prog = ref_wavegram.frames(params, padded)[0, : ref.shape[0]]
                else:
                    prog = ref_wavegram.frames(params, mono[None], rounder(control["rnd_fmt"]))[0]
                gap = float((prog - ref).abs().max() / ref.abs().max())
                worst = max(worst, gap if math.isfinite(gap) else math.inf)
        numbers["frames"] = worst
        return judged(numbers, self.wl["limits"])

