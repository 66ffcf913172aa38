"""The ``prepare_pack`` driver end to end on the CPU at toy widths, added
as data the way ``tiny.py`` adds its cells: a run is correct and reports
its metrics, a traced run reads the program's spans and counters, a pack
whose padding is not masked fails ``frames``, and the controls read
further from the reference than the program does. Then
``benchmark/roofline_pann.py``'s count against ``torch``'s own count of
the reference's products."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import gen, roofline_pann
from benchmark.drivers.prepare_pack import cnn14_tree
from benchmark.reference import pann as ref_pann
from benchmark.tests import tiny
from benchmark.tests.test_bench_cells import run

TINY_CNN14 = {"name": "cnn14", "channels": [8, 8, 16, 16, 32, 32], "n_mels": 64, "sample_rate": 32000,
              "n_fft": 1024, "hop_length": 320, "fmin": 50, "fmax": 14000, "num_classes": 527,
              "dtype": "float32"}
CELL = {"driver": "prepare_pack", "audio_t": "resample_mean_cnn14", "files_per_call": 5,
        "lengths": [[1.0, 0.6, 1.4]], "sample_rate": 44100, "captions_per_file": 5, "caption_words": [3, 8],
        "dataset": "clotho", "subset": "dev", "batch_size": 2, "profile_at": 1, "check_rows": 3,
        "controls": {"tf32": {"rnd_fmt": "tf32"}, "unmasked": {"unmasked": True}},
        "limits": {"rows": 0.0, "lens": 0.0, "frames": 1e-5}}


def make(root: str) -> str:
    """``tiny.make``'s copy of the benchmark with a toy Cnn14 configuration
    and the cell ``tiny-prepare`` added as a new file and new entries."""
    tiny.make(root, cells=())
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    path = "benchmark/configs/tiny-cnn14.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(tiny.tiny_train_config() | {"encoder": TINY_CNN14}, f)
    spec["configs"].append({"name": "tiny-cnn14", "source": "https://github.com/qiuqiangkong/audioset_tagging_cnn",
                            "file": path, "reduced": [], "why": "toy widths for the CPU tests"})
    with open(os.path.join(root, "benchmark", "workloads", "tiny-prepare.json"), "w") as f:
        json.dump(CELL, f)
    spec["workloads"].append({"name": "tiny-prepare", "config": "tiny-cnn14", "traffic": "tiny-prepare",
                              "chips": 1, "why": "a toy cell for the CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and (m["name"] == "corpus_clips_per_s" or m["name"].endswith(".prepare")):
            m["workloads"].append("tiny-prepare")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("bench")))


def test_the_prepare_cell_runs_and_is_correct(root, capsys):
    line = run(root, "tiny-prepare", 2**31 + 17, capsys=capsys)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"corpus_clips_per_s", "setup_s"}
    assert set(line["checks"]) == {"rows", "lens", "frames"}


def test_a_traced_run_reads_the_programs_spans_and_counters(root, capsys):
    line = run(root, "tiny-prepare", 3, trace=1, capsys=capsys)
    assert line["correct"], line["checks"]
    # the device's metrics read nothing without a card
    assert {"pad_share.prepare", "host_load_share.prepare", "mfu.prepare"} <= set(line["metrics"])
    assert 0 < line["metrics"]["pad_share.prepare"]["value"] < 100
    assert 0 < line["metrics"]["host_load_share.prepare"]["value"] < 100


def unmasked(params, waveform, waveform_lens, *, logmel_cfg=None):
    """The batch encoded as it is padded, its padding not masked; each row's
    frame count right."""
    from conette_torch.models import pann

    out = pann.pann_apply(params, waveform)
    lens = torch.tensor([ref_pann.frame_count(int(n)) for n in waveform_lens])
    return {"frame_embs": out["frame_embs"], "frame_embs_lens": lens}


def test_a_pack_whose_padding_is_not_masked_fails_frames(root, monkeypatch, capsys):
    from conette_torch.models import pann

    monkeypatch.setattr(pann, "pann_frames_masked", unmasked)
    line = run(root, "tiny-prepare", 24, capsys=capsys)
    assert not line["correct"]
    assert line["checks"]["rows"]["value"] == line["checks"]["lens"]["value"] == 0
    assert line["checks"]["frames"]["value"] > line["checks"]["frames"]["limit"]


def test_the_controls_read_further_than_the_program(root, capsys):
    from benchmark.harness import load_module

    sys.path.insert(0, os.path.join(root, "benchmark"))
    try:
        control = load_module(os.path.join(root, "benchmark", "control.py"), "bench_control_prepare")
        assert control.main(["--workload", "tiny-prepare", "--seeds", "32", "--seconds", "1"], device="cpu") == 0
    finally:
        sys.path.remove(os.path.join(root, "benchmark"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    prog = line["program"]
    assert set(line["controls"]) == {"tf32", "unmasked"}
    for ctrl in line["controls"].values():
        assert ctrl["frames"] >= 3 * max(prog["frames"], 1e-7) and ctrl["frames"] > CELL["limits"]["frames"], line


@pytest.mark.parametrize("channels", [[8, 8, 16, 16, 32, 32], [4, 8, 8, 16]])
def test_cnn14_count_is_the_references_products(channels):
    cfg = TINY_CNN14 | {"channels": channels}
    params = gen.materialize(cnn14_tree(cfg), torch.Generator().manual_seed(0))
    samples = 32_000 + 777
    with FlopCounterMode(display=False) as counter:
        ref_pann.frames(params, torch.randn(1, samples) * 0.1)
    assert counter.get_total_flops() == roofline_pann.cnn14_flops(samples, channels)
