"""The ``prepare_pack_wavegram`` driver end to end on the CPU at toy widths,
added as data the way ``tiny.py`` adds its cells: a run is correct and
reports its metrics, a traced run reads the program's spans and counters,
a pack whose padding is not masked fails ``frames``, and the controls read
further from the reference than the program does. Then the plain
reference (``benchmark/reference/wavegram.py``) against the port's forward
of each clip, and ``benchmark/roofline_wavegram.py``'s count against
``torch``'s own count of the reference's products and against a count by
hand of a 30 s clip at the published widths."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import gen, roofline_wavegram
from benchmark.drivers.prepare_pack_wavegram import wavegram_tree
from benchmark.reference import wavegram as ref_wavegram
from benchmark.tests import tiny
from benchmark.tests.test_bench_cells import run

# the published structure at toy widths: pre_block3 keeps its 128 channels,
# so that the wavegram's 4 groups hold the log-mel branch's 32 frequencies
TINY_WAVEGRAM = {"name": "wavegram_logmel_cnn14", "pre_channels": [8, 8, 16, 128], "pre_block4": [4, 8],
                 "channels": [8, 16, 16, 32, 32, 32], "n_mels": 64, "sample_rate": 32000, "n_fft": 1024,
                 "hop_length": 320, "fmin": 50, "fmax": 14000, "num_classes": 527, "dtype": "float32"}
CELL = {"driver": "prepare_pack_wavegram", "audio_t": "resample_mean_wavegram_logmel_cnn14",
        "files_per_call": 5, "lengths": [[1.0, 0.6, 1.4]], "sample_rate": 44100, "captions_per_file": 5,
        "caption_words": [3, 8], "dataset": "clotho", "subset": "dev", "batch_size": 2, "profile_at": 1,
        "check_rows": 3, "controls": {"tf32": {"rnd_fmt": "tf32"}, "unmasked": {"unmasked": True}},
        "limits": {"rows": 0.0, "lens": 0.0, "frames": 1e-5}}


def make(root: str) -> str:
    """``tiny.make``'s copy of the benchmark with a toy Wavegram_Logmel_Cnn14
    configuration and the cell ``tiny-prepare-wavegram`` added as a new
    file and new entries."""
    tiny.make(root, cells=())
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    path = "benchmark/configs/tiny-wavegram.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(tiny.tiny_train_config() | {"encoder": TINY_WAVEGRAM}, f)
    spec["configs"].append({"name": "tiny-wavegram", "source": "https://github.com/qiuqiangkong/audioset_tagging_cnn",
                            "file": path, "reduced": [], "why": "toy widths for the CPU tests"})
    with open(os.path.join(root, "benchmark", "workloads", "tiny-prepare-wavegram.json"), "w") as f:
        json.dump(CELL, f)
    spec["workloads"].append({"name": "tiny-prepare-wavegram", "config": "tiny-wavegram",
                              "traffic": "tiny-prepare-wavegram", "chips": 1, "why": "a toy cell for the CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "prepare-clotho-wavegram" in m.get("workloads", []):
            m["workloads"].append("tiny-prepare-wavegram")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("bench")))


def test_the_wavegram_cell_runs_and_is_correct(root, capsys):
    line = run(root, "tiny-prepare-wavegram", 2**31 + 29, capsys=capsys)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"corpus_clips_per_s", "setup_s"}
    assert set(line["checks"]) == {"rows", "lens", "frames"}


def test_a_traced_run_reads_the_programs_spans_and_counters(root, capsys):
    from conette_torch.utils import profiling

    line = run(root, "tiny-prepare-wavegram", 7, trace=1, capsys=capsys)
    assert line["correct"], line["checks"]
    # the device's metrics (the wavegram's two among them) read nothing without a card
    assert {"pad_share.prepare", "host_load_share.prepare", "mfu.prepare"} <= set(line["metrics"])
    assert not {"wavegram_device_ms_per_clip.prepare", "wavegram_roofline.prepare"} & set(line["metrics"])
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    wavegram = [r for r in recs if r.name == "wavegram"]
    assert wavegram and all(by_id[r.parent].name == "pann_encode" and set(r.attrs) == {"rows", "samples"}
                            for r in wavegram)
    counters = profiling.summary()["counters"]
    assert counters["wavegram_valid_samples"] > 0 and counters["wavegram_pad_samples"] > 0


def test_the_readers_read_the_wavegram_span():
    from benchmark.harness import Profile, Trace, load_module

    prof = Profile(1.0, 0.5, {"wavegram": 0.02, "pann_encode": 0.1}, {}, {},
                   {"clips": 4, "bound_s": 0.05, "wavegram_bound_s": 0.005})
    read = {m: load_module(os.path.join(tiny.REPO, "benchmark", "layer_metrics", f"{m}.py"), m).read
            for m in ("wavegram_device_ms_per_clip.prepare", "wavegram_roofline.prepare")}
    assert read["wavegram_device_ms_per_clip.prepare"](Trace([], {}, prof)) == pytest.approx(5.0)
    assert read["wavegram_roofline.prepare"](Trace([], {}, prof)) == pytest.approx(25.0)
    # a program without the span (the parent's) reads nothing
    bare = Profile(1.0, 0.5, {"pann_encode": 0.1}, {}, {}, {"clips": 4, "wavegram_bound_s": 0.005})
    assert all(r(Trace([], {}, bare)) is None for r in read.values())


def unmasked(params, waveform, waveform_lens, *, logmel_cfg=None):
    """The batch encoded as it is padded, its padding not masked; each row's
    frame count right."""
    from conette_torch.models import pann_zoo

    out = pann_zoo.wavegram_logmel_cnn14_apply(params, waveform)
    lens = torch.tensor([ref_wavegram.frame_count(int(n)) for n in waveform_lens])
    return {"frame_embs": out["frame_embs"], "frame_embs_lens": lens}


def test_a_pack_whose_padding_is_not_masked_fails_frames(root, monkeypatch, capsys):
    from conette_torch.models import pann_zoo

    monkeypatch.setattr(pann_zoo, "wavegram_logmel_cnn14_frames_masked", unmasked)
    line = run(root, "tiny-prepare-wavegram", 24, capsys=capsys)
    assert not line["correct"]
    assert line["checks"]["rows"]["value"] == line["checks"]["lens"]["value"] == 0
    assert line["checks"]["frames"]["value"] > line["checks"]["frames"]["limit"]


def test_the_controls_read_further_than_the_program(root, capsys):
    from benchmark.harness import load_module

    sys.path.insert(0, os.path.join(root, "benchmark"))
    try:
        control = load_module(os.path.join(root, "benchmark", "control.py"), "bench_control_wavegram")
        assert control.main(["--workload", "tiny-prepare-wavegram", "--seeds", "33", "--seconds", "1"],
                            device="cpu") == 0
    finally:
        sys.path.remove(os.path.join(root, "benchmark"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    prog = line["program"]
    assert set(line["controls"]) == {"tf32", "unmasked"}
    for ctrl in line["controls"].values():
        assert ctrl["frames"] >= 3 * max(prog["frames"], 1e-7) and ctrl["frames"] > CELL["limits"]["frames"], line


def test_the_reference_is_the_ports_forward_of_each_clip():
    from conette_torch.models import pann_zoo

    params = gen.materialize(wavegram_tree(TINY_WAVEGRAM), torch.Generator().manual_seed(5))
    clips = gen.clips(torch.Generator().manual_seed(6), 3, 40_000, 32_000)
    for n in (40_000, 36_901, 20_262):  # equal joined lengths; the wavegram one step shorter
        wav = clips[:1, :n]
        want = pann_zoo.wavegram_logmel_cnn14_apply(params, wav)["frame_embs"][0].T
        got = ref_wavegram.frames(params, wav)[0]
        assert got.shape == want.shape and got.shape[0] == ref_wavegram.frame_count(n)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("samples", [40_000 + 777, 36_901])
def test_the_count_is_the_references_products(samples):
    cfg = TINY_WAVEGRAM
    params = gen.materialize(wavegram_tree(cfg), torch.Generator().manual_seed(0))
    widths = (tuple(cfg["pre_channels"]), cfg["pre_block4"][1], tuple(cfg["channels"]))
    with FlopCounterMode(display=False) as counter:
        ref_wavegram.frames(params, torch.randn(1, samples) * 0.1)
    assert counter.get_total_flops() == roofline_wavegram.model_flops_bytes(samples, *widths)[0]
    with FlopCounterMode(display=False) as counter:
        ref_wavegram.wavegram(params, torch.randn(1, samples) * 0.1)
    assert counter.get_total_flops() == roofline_wavegram.wavegram_flops_bytes(samples, *widths[:2])[0]


def test_a_30s_clip_by_hand():
    """Multiply-adds of 960 000 samples at the published widths: pre_conv0
    at 192 000 steps, pre_block1-3 at 192 000 / 48 000 / 12 000,
    pre_block4 at 3 000 × 32; the model adds the log-mel (3 001 frames),
    the log-mel's first block and Cnn14's blocks 2-6 from 1 500 × 32 at
    128 inputs."""
    pre_conv0 = 192_000 * 11 * 64
    pre_blocks = 192_000 * 3 * (64 * 64 * 2) + 48_000 * 3 * (64 * 128 + 128 * 128) + 12_000 * 3 * 128 * 128 * 2
    pre_block4 = 3_000 * 32 * 9 * (4 * 64 + 64 * 64)
    wavegram = pre_conv0 + pre_blocks + pre_block4
    flops, nbytes = roofline_wavegram.wavegram_flops_bytes(960_000)
    assert flops == 2 * wavegram
    assert 13.3e9 < wavegram < 13.4e9  # pre_conv0 0.14, pre_block1 4.72, 2 3.54, 3 1.18, 4 3.76 G
    # its bytes: the samples, then each conv's input, output and weights
    conv1d_maps = (960_000 * 1 + 192_000 * 64 + 4 * 192_000 * 64 + 48_000 * (64 + 128 + 128 + 128)
                   + 12_000 * 128 * 4)
    conv1d_weights = 11 * 64 + 3 * (64 * 64 * 2 + 64 * 128 + 128 * 128 * 3)
    conv2d = 3_000 * 32 * (4 + 64 + 64 + 64) + 9 * (4 * 64 + 64 * 64)
    assert nbytes == 4 * (conv1d_maps + conv1d_weights + conv2d)
    frames, n_freq = 3_001, 513
    logmel = frames * (1024 * 2 * n_freq + n_freq * 64)
    block1 = 3_001 * 64 * 9 * (1 * 64 + 64 * 64)
    tail = 9 * (1_500 * 32 * (128 * 128 + 128 * 128) + 750 * 16 * (128 * 256 + 256 * 256)
                + 375 * 8 * (256 * 512 + 512 * 512) + 187 * 4 * (512 * 1024 + 1024 * 1024)
                + 93 * 2 * (1024 * 2048 + 2048 * 2048))
    assert roofline_wavegram.model_flops_bytes(960_000)[0] == 2 * (wavegram + logmel + block1 + tail)
    assert ref_wavegram.frame_count(960_000) == 93
