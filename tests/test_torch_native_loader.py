"""The port's native audio loader (``conette_torch/native``) against
``conette_tpu/native/loader.py`` and against the numpy route, on the CPU:
its banded resample (each phase's band holds every non-zero tap of
``ops/resample.py::resample_kernel``; the result that of the JAX package's
dense native loop and of ``resample_numpy``), its build into
``build/conette_torch/``, WAV decode, channel mean and resample, the
thread-pool batch, malformed files, the preprocessor's routes for paths and
for arrays, the ``band_taps`` and ``bank_taps`` of the ``load_file`` and
``resample`` spans, the serving bucket pass, and the device resampler
``ops/resample.py::resample`` against JAX's.

The port's ``audio_loader.cpp`` keeps the C ABI, the flags and the filter
bank's math of ``native/audio_loader.cpp`` (the JAX package's), and runs only
each phase's band of non-zero taps with an f32 accumulator where the JAX
package's loop runs the whole bank in double: the same taps, summed in
another order. Tolerances: the native routes of both packages, and the
native resample against ``resample_numpy`` of one channel, are held equal
to 1e-6 (``-march=native -ffast-math`` may contract differently on another
host); against the numpy route of several channels, which resamples before
the channel mean, 2e-5, as ``tests/test_native_loader.py`` holds JAX's; the
torch resampler against JAX's at f32, 1e-6."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.preprocessor import CoNeTTEPreprocessor as JaxPreprocessor
from conette_tpu.native import loader as jax_loader
from conette_tpu.ops.resample import resample as jax_resample
from conette_torch.huggingface.preprocessor import CoNeTTEPreprocessor
from conette_torch.native import loader
from conette_torch.ops.resample import resample, resample_kernel, resample_numpy, resampled_length
from conette_torch.utils import profiling
from conette_torch.utils.audio_io import load_audio, save_wav
from conette_torch.utils.flac import save_flac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_ATOL = 1e-6
NUMPY_ATOL = 2e-5

# (sample rate, channels): the corpus rates, mono and stereo
CLIPS = [(44_100, 2), (48_000, 1), (32_000, 2), (22_050, 1)]
# (orig, target) pairs whose bands are held to the dense bank
RATE_PAIRS = [(44_100, 32_000), (48_000, 32_000), (22_050, 32_000), (16_000, 32_000),
              (8_000, 32_000), (32_000, 44_100)]


def _clip(sr: int, ch: int, seconds: float = 0.6) -> np.ndarray:
    rng = np.random.default_rng(sr + ch)
    return rng.uniform(-0.8, 0.8, size=(ch, int(sr * seconds))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    paths = []
    for sr, ch in CLIPS:
        p = str(d / f"c_{sr}_{ch}.wav")
        save_wav(p, _clip(sr, ch), sr)
        paths.append(p)
    p = str(d / "c.flac")
    save_flac(p, _clip(44_100, 1)[0], 44_100)
    paths.append(p)
    return paths


def _bank_of_the_resample(orig: int, new: int, klen: int) -> np.ndarray:
    """The bank that ``loader.resample`` runs, read back from its output: an
    impulse at signal index i gives output (f, p) the product 1.0 * tap
    ``i + width - f * orig`` of phase p, and zeros for the rest. One impulse
    for each residue modulo orig, far enough apart to share no frame, gives
    every (phase, tap) once."""
    g = np.gcd(orig, new)
    o, t = orig // g, new // g
    width = resample_kernel(orig, new)[1]
    stride = o * (klen // o + 2)  # apart by more than a frame's reach
    x = np.zeros(stride * (o + 2), np.float32)
    starts = [stride * (1 + r) + r for r in range(o)]
    x[starts] = 1.0
    y = loader.resample(x, orig, new)
    bank = np.full((t, klen), np.nan, np.float32)
    for i in starts:
        for f in range((i + width - klen) // o + 1, (i + width) // o + 1):
            bank[:, i + width - f * o] = y[f * t:(f + 1) * t]
    return bank


@pytest.mark.parametrize("orig,new", RATE_PAIRS)
def test_each_phases_band_holds_every_non_zero_tap_of_the_bank(orig, new):
    """The banded resample's bank, read back through impulses, is
    ``resample_kernel``'s f32 bank bit for bit: no non-zero tap left out of
    a band. The band is the widest phase's non-zero taps, rounded up to 8."""
    kernels, _ = resample_kernel(orig, new)
    band_taps, bank_taps = loader.resample_taps(orig, new)
    assert bank_taps == kernels.shape[1] and band_taps % 8 == 0
    nz = kernels != 0
    extent = (kernels.shape[1] - nz[:, ::-1].argmax(axis=1)) - nz.argmax(axis=1)
    assert extent.max() <= band_taps < extent.max() + 8
    np.testing.assert_array_equal(_bank_of_the_resample(orig, new, bank_taps), kernels)
    assert loader.resample_taps(orig, orig) == (0, 0)


@pytest.mark.parametrize("orig,new", RATE_PAIRS)
def test_banded_resample_matches_the_dense_native_loop_and_numpy(orig, new):
    x = np.random.default_rng(orig + new).uniform(-0.8, 0.8, size=10 * orig).astype(np.float32)
    got = loader.resample(x, orig, new)
    want = jax_loader.resample(x, orig, new)
    assert got.shape == want.shape == (resampled_length(len(x), orig, new),)
    np.testing.assert_allclose(got, want, atol=NATIVE_ATOL)
    np.testing.assert_allclose(got, resample_numpy(x, orig, new), atol=NATIVE_ATOL)


def test_library_is_built_under_build_with_the_makefile_flags():
    path = loader.library_path()
    assert path.parent == loader.BUILD_DIR
    assert os.path.samefile(loader.BUILD_DIR.parents[1], REPO)
    with open(os.path.join(REPO, "native", "Makefile")) as f:
        flags = next(line for line in f if line.startswith("CXXFLAGS")).split("=", 1)[1].split()
    assert list(loader.CXX_FLAGS) == flags
    assert loader.library()._name == str(path) and path.is_file()


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Processes that build at once (the tests run under ``pytest -n``) each
    compile to a temporary file and rename it into place."""
    code = (
        "import sys; from pathlib import Path\n"
        "import conette_torch.native.loader as L\n"
        f"L.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "path = L.library_path(); L.build(path); L.library()\n"
        "assert L.wav_info(sys.argv[1])[0] == 32000\n"
    )
    wav = str(tmp_path / "a.wav")
    save_wav(wav, _clip(32_000, 1), 32_000)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, wav], cwd=REPO, env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], errs
    assert sorted(f.suffix for f in tmp_path.iterdir()) == [".so", ".wav"]


def test_a_failing_compiler_raises_and_says_why(monkeypatch, tmp_path):
    monkeypatch.setattr(loader, "CXX_FLAGS", loader.CXX_FLAGS + ("-fno-such-flag-here",))
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="(?s)failed to build.*no-such-flag"):
        loader.build(tmp_path / "lib.so")
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no-such-compiler-here on PATH"):
        loader.library_path()


def test_loading_the_library_leaves_the_callers_floats_alone():
    """``-ffast-math``'s start-up code sets flush-to-zero on the thread that
    loads the library, and threads started later inherit it. In a process
    that has loaded no other such library, a subnormal still reads non-zero
    after ``library()``, on the caller's thread and on a thread it starts."""
    code = (
        "import threading; import numpy as np\n"
        "from conette_torch.native import loader\n"
        "tiny = lambda: float(np.float32(1e-38) / np.float32(100))\n"
        "assert tiny() > 0\n"
        "loader.library()\n"
        "later = []\n"
        "t = threading.Thread(target=lambda: later.append(tiny())); t.start(); t.join()\n"
        "print(tiny(), later[0])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert [float(v) > 0 for v in proc.stdout.split()] == [True, True], proc.stdout


def test_arrays_need_the_compiler_only_to_resample(monkeypatch):
    """The array route resamples natively: without ``g++`` an array at
    44.1 kHz raises ``CompilerNotFound``; one at 32 kHz needs no library."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "CXX", "g++-not-installed")
    pre = CoNeTTEPreprocessor({}, device="cpu")
    wav, lens = pre.load_resample([np.full((2, 3200), 0.25, np.float32)], sr=32_000)
    assert wav.shape[0] == 1 and lens.tolist() == [3200] and (wav[0, :3200] == 0.25).all()
    with pytest.raises(loader.CompilerNotFound, match="g\\+\\+-not-installed on PATH"):
        pre.load_resample([np.zeros((1, 4410), np.float32)], sr=44_100)


@pytest.mark.parametrize("sr,ch", CLIPS)
def test_wav_decode_and_resample_match_jax_and_numpy(corpus, sr, ch):
    path = corpus[CLIPS.index((sr, ch))]
    assert loader.wav_info(path) == jax_loader.wav_info(path) == (sr, ch, int(sr * 0.6))
    wav, _ = load_audio(path)
    native = loader.load_resample_mono(path, 0)
    np.testing.assert_allclose(native, wav.mean(axis=0), atol=NATIVE_ATOL)
    got = loader.load_resample_mono(path, 32_000)
    np.testing.assert_allclose(got, jax_loader.load_resample_mono(path, 32_000), atol=NATIVE_ATOL)
    assert len(got) == resampled_length(wav.shape[1], sr, 32_000)
    np.testing.assert_allclose(got, resample_numpy(wav, sr, 32_000).mean(axis=0), atol=NUMPY_ATOL)
    np.testing.assert_allclose(loader.resample(wav[0], sr, 32_000),
                               jax_loader.resample(wav[0], sr, 32_000), atol=NATIVE_ATOL)


def test_threads_share_the_banks_while_the_cache_turns_over():
    """78 rate pairs, more than the 64 banks the library keeps, resampled four
    times each by 32 threads at once: every result bit for bit the serial
    one, while banks are built, shared and evicted under the threads."""
    pairs = [(1000 * k, t) for k in range(1, 41) for t in (16_000, 32_000) if 1000 * k != t]
    x = np.random.default_rng(3).uniform(-0.8, 0.8, 3000).astype(np.float32)
    want = {pair: loader.resample(x, *pair) for pair in pairs}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as pool:
            got = list(pool.map(lambda pair: (pair, loader.resample(x, *pair)), pairs * 4, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 4 * len(pairs)
    for pair, y in got:
        np.testing.assert_array_equal(y, want[pair], err_msg=str(pair))


def test_load_batch_keeps_order_and_decodes_flac_as_jax(corpus):
    got = loader.load_batch(corpus, 32_000, workers=3)
    want = jax_loader.load_batch(corpus, 32_000, workers=3)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w, p in zip(got, want, corpus):
        np.testing.assert_allclose(g, w, atol=NATIVE_ATOL, err_msg=p)
        np.testing.assert_array_equal(g, loader.load_resample_mono(p, 32_000))


def test_malformed_wavs_raise(tmp_path):
    """The cases of ``tests/test_native_loader.py``: undersized fmt chunks,
    chunk sizes past the end of the file, zero bits, channels or sample
    rate, and garbage are clean errors, never an over-read or an abort."""
    import struct

    def wav(fmt_chunk, data=b"\x00" * 8):
        body = b"WAVE" + fmt_chunk + b"data" + struct.pack("<I", len(data)) + data
        return b"RIFF" + struct.pack("<I", len(body)) + body

    def fmt16(ch, sr, bits):
        return struct.pack("<HHIIHH", 1, ch, sr, 0, 2, bits)

    cases = {
        "tiny_fmt": wav(b"fmt " + struct.pack("<I", 4) + b"\x01\x00\x01\x00"),
        "huge_data": b"RIFF" + struct.pack("<I", 100) + b"WAVE"
        + b"fmt " + struct.pack("<I", 16) + fmt16(1, 32000, 16)
        + b"data" + struct.pack("<I", 0xFFFFFF00) + b"\x00" * 8,
        "zero_bits": wav(b"fmt " + struct.pack("<I", 16) + fmt16(1, 32000, 0)),
        "zero_channels": wav(b"fmt " + struct.pack("<I", 16) + fmt16(0, 32000, 16)),
        "zero_sr": wav(b"fmt " + struct.pack("<I", 16) + fmt16(1, 0, 16)),
        "empty": b"",
        "garbage": bytes(range(64)),
    }
    for name, blob in cases.items():
        p = tmp_path / f"{name}.wav"
        p.write_bytes(blob)
        with pytest.raises(OSError):
            loader.load_resample_mono(str(p), 32000)
        if blob[:4] == b"RIFF":
            with pytest.raises(OSError):
                loader.wav_info(str(p))


def test_preprocessor_route_for_paths_matches_jax(corpus):
    """Paths go through the native loader in both packages (mean, then
    resample); arrays through numpy (resample, then mean)."""
    got_wav, got_lens = CoNeTTEPreprocessor({}, device="cpu").load_resample(corpus)
    want_wav, want_lens = JaxPreprocessor({}).load_resample(corpus)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got_wav.shape == want_wav.shape == (len(corpus), 32_000)
    np.testing.assert_allclose(got_wav, want_wav, atol=NATIVE_ATOL)
    arrays = [load_audio(p) for p in corpus]
    by_array, _ = CoNeTTEPreprocessor({}, device="cpu").load_resample(
        [w for w, _ in arrays], sr=[s for _, s in arrays])
    np.testing.assert_allclose(got_wav, by_array, atol=NUMPY_ATOL)


@pytest.mark.parametrize("channels", [1, 2])
def test_preprocessor_route_for_arrays_resamples_the_channel_mean_natively(channels):
    """Arrays are averaged, then resampled by the native band on the pool;
    JAX's array route resamples with numpy, then averages."""
    clips = [np.random.default_rng(sr + channels).uniform(-0.8, 0.8, (channels, int(sr * secs)))
             .astype(np.float32) for sr, secs in ((44_100, 1.3), (48_000, 0.7), (32_000, 0.9))]
    rates = [44_100, 48_000, 32_000]
    got, got_lens = CoNeTTEPreprocessor({}, device="cpu").load_resample(clips, sr=rates)
    want, want_lens = JaxPreprocessor({}).load_resample(clips, sr=rates)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 2 * 32_000)
    np.testing.assert_allclose(got, want, atol=NUMPY_ATOL)
    for row, n, clip, sr in zip(got, got_lens, clips, rates):
        np.testing.assert_allclose(row[:n], resample_numpy(clip.mean(axis=0), sr, 32_000),
                                   atol=NATIVE_ATOL)
        assert not row[n:].any()


def test_resample_and_load_file_spans_carry_the_band_and_bank_taps(corpus):
    profiling.clear()
    pre = CoNeTTEPreprocessor({}, device="cpu")
    pre.load_resample(corpus)
    pre.load_resample([np.zeros((1, 4410), np.float32)], sr=44_100)
    pre.load_resample([np.zeros((2, 3200), np.float32)], sr=32_000)
    files = {r.attrs["band_taps"]: r.attrs for r in profiling.records() if r.name == "load_file"}
    rates = [sr for sr, _ in CLIPS] + [44_100]  # the corpus, then its FLAC file
    assert sorted(r.attrs["bank_taps"] for r in profiling.records() if r.name == "load_file") == \
        sorted(0 if sr == 32_000 else resample_kernel(sr, 32_000)[0].shape[1] for sr in rates)
    assert files[0] == {"band_taps": 0, "bank_taps": 0}
    assert all(0 < band <= 24 for band in files if band)
    spans = [r.attrs for r in profiling.records() if r.name == "resample"]
    assert spans[0]["bank_taps"] == 459 and 0 < spans[0]["band_taps"] <= 24
    assert spans[1] == {"clips": 1, "band_taps": 0, "bank_taps": 0}
    profiling.clear()


def test_serving_bucket_pass_raises_on_an_unreadable_wav(tmp_path):
    from conette_torch.huggingface.config import CoNeTTEConfig
    from conette_torch.huggingface.model import CoNeTTEModel
    from conette_torch.models.convnext import convnext_init
    from conette_torch.serving import caption_corpus

    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF" + b"\x00" * 40)
    enc = convnext_init(torch.Generator().manual_seed(0), depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
    model = CoNeTTEModel(CoNeTTEConfig(d_model=16, nhead=2, num_decoder_layers=1,
                                       dim_feedforward=32), encoder_params=enc, device="cpu")
    with pytest.raises(OSError, match="not a RIFF/WAVE file"):
        caption_corpus(model, [str(bad)], batch_size=2)


@pytest.mark.parametrize("orig,new", [(44_100, 32_000), (48_000, 32_000), (22_050, 32_000),
                                      (32_000, 16_000)])
def test_torch_resample_matches_jax(orig, new):
    x = np.random.default_rng(orig).standard_normal((2, 3, 9_000)).astype(np.float32)
    got = resample(torch.from_numpy(x), orig, new).numpy()
    want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    assert got.shape == want.shape == (2, 3, resampled_length(9_000, orig, new))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, resample_numpy(x, orig, new), atol=1e-6)
