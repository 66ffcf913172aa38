"""The bf16 log-mel kernel's host-side layouts and addressing, on the CPU.

``live_range``, ``logmel_layout``, ``pack_basis`` and ``pack_filterbank``
decide what the kernel (``conette_torch/csrc/logmel.cu``) computes and in
which order it reads it; they are plain numpy and PyTorch, so they are held
here to ``dft_basis`` and ``_mel_matrix`` bit for bit. An f32 walk of the
kernel's own addressing (the reflect index map, the skewed span, the
``ldmatrix`` row pointers and fragments, the ring stages of the packed
basis read through ``wgmma``'s descriptor rule, the re/im interleave, the
accumulator-to-A permutation of the power, the banded filterbank and the
band offsets into each warp's mel rows, the rows past the clip) must give the plain composition's log-mel at f64 within 1e-6 dB, and at f32 the
plain version's and the JAX package's Pallas kernel's (interpret mode)
within that kernel's own envelope. The build's library name is held to hash
every kernel source and header.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.ops.pallas.logmel import fused_logmel as pallas_logmel
from conette_torch.kernels import _build
from conette_torch.kernels.logmel import (
    BAND_WIDTHS,
    CHUNK_FREQS,
    TILE_FRAMES,
    band_row_freq,
    band_table,
    live_range,
    log_ref,
    logmel_layout,
    logmel_reference,
    pack_basis,
    pack_filterbank,
)
from conette_torch.ops.frontend import DEFAULT_LOGMEL, LogMelConfig, _mel_matrix
from conette_torch.ops.stft import dft_basis, frame_signal

WIDE = LogMelConfig(fmax=16_000.0)
SKEW = 8          # csrc/logmel.cu kSpanSkew
PAD = 512         # the reflect pad, n_fft / 2
STAGE_ELEMS = 64 * 128  # a ring stage: 64 samples x 128 columns
# the walk at f64 against the plain composition at f64: only the order of
# f64 sums differs. At f32 the plain version itself is up to 1.0e-3 dB off
# an f64 evaluation on these inputs, so f32 results are held to the JAX
# envelope of its kernel (tests/test_pallas_logmel.py:21)
F64_ATOL_DB = 1e-6
F32_TOL = dict(atol=2e-3, rtol=1e-4)


def test_live_range_and_bands_of_the_default_cfg():
    assert live_range(DEFAULT_LOGMEL) == (2, 447)
    lay = logmel_layout(DEFAULT_LOGMEL)
    assert (lay.f0, lay.n_chunks) == (0, 7)
    # bands of 104, 44, 26, 19, 15, 13 and 10 mels from mel 0, 103, 146,
    # 171, 189, 203 and 214; the last one's window ends at mel 224
    assert lay.band_width == (128, 64, 32, 32, 16, 16, 16)
    assert lay.band_start == (0, 103, 146, 171, 189, 203, 208)
    assert lay.band_offset == tuple(64 * sum(lay.band_width[:j]) for j in range(7))
    assert band_table(DEFAULT_LOGMEL).tolist() == [
        list(r) for r in zip(lay.band_offset, lay.band_start, lay.band_width)]


@pytest.mark.parametrize("cfg", [DEFAULT_LOGMEL, WIDE], ids=["fmax14k", "fmax16k"])
def test_layout_is_derived_from_the_filterbank(cfg):
    fb = _mel_matrix(cfg)
    first, last = live_range(cfg)
    nonzero = np.flatnonzero(fb.any(axis=1))
    assert (first, last) == (nonzero[0], nonzero[-1])
    lay = logmel_layout(cfg)
    assert lay.f0 <= first and lay.f0 + CHUNK_FREQS * lay.n_chunks > last
    for j in range(lay.n_chunks):
        rows = fb[lay.f0 + CHUNK_FREQS * j:lay.f0 + CHUNK_FREQS * (j + 1)]
        cols = np.flatnonzero(rows.any(axis=0))
        m0, w = lay.band_start[j], lay.band_width[j]
        assert w in BAND_WIDTHS and 0 <= m0 and m0 + w <= cfg.n_mels
        assert m0 <= cols[0] and cols[-1] < m0 + w  # the band holds every nonzero column
    if cfg is WIDE:  # a higher fmax reads more frequencies, so more chunks
        assert last > live_range(DEFAULT_LOGMEL)[1]
        assert lay.n_chunks == 8 > logmel_layout(DEFAULT_LOGMEL).n_chunks


def test_band_rows_permute_within_each_eight():
    k = np.arange(64)
    f = band_row_freq(k)
    assert sorted(f.tolist()) == k.tolist()
    # k = 16s + 8h + 2c + e holds frequency 4t + c, t = 4s + 2h + e
    s, h, c, e = k // 16, k // 8 % 2, k % 8 // 2, k % 2
    assert np.array_equal(f, 4 * (4 * s + 2 * h + e) + c)


def _unpack_basis(packed: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Undo pack_basis: (1024, n_chunks · 64, 2), re and im of each chunk
    frequency."""
    t = packed.reshape(n_chunks, 64, 16, 2, 8, 8)  # (j, kb, ng, kh, nr, kc)
    return t.permute(1, 3, 5, 0, 2, 4).reshape(1024, n_chunks * 64, 2)


@pytest.mark.parametrize("cfg", [DEFAULT_LOGMEL, WIDE], ids=["fmax14k", "fmax16k"])
def test_basis_packing_undoes_to_the_dft_basis(cfg):
    lay = logmel_layout(cfg)
    packed = pack_basis(cfg)
    assert packed.dtype == torch.bfloat16 and packed.shape == (lay.n_chunks * 16 * STAGE_ELEMS,)
    cols = _unpack_basis(packed, lay.n_chunks)
    basis = torch.from_numpy(dft_basis(1024)).to(torch.bfloat16)
    freqs = lay.f0 + np.arange(lay.n_chunks * 64)
    live = freqs <= 512
    want_re = basis[:, freqs[live]]
    want_im = basis[:, 513 + freqs[live]]
    assert torch.equal(cols[:, live, 0].view(torch.int16), want_re.view(torch.int16))
    assert torch.equal(cols[:, live, 1].view(torch.int16), want_im.view(torch.int16))
    assert not cols[:, ~live].any()


@pytest.mark.parametrize("cfg", [DEFAULT_LOGMEL, WIDE], ids=["fmax14k", "fmax16k"])
def test_filterbank_packing_undoes_to_the_mel_matrix(cfg):
    lay = logmel_layout(cfg)
    packed = pack_filterbank(cfg)
    assert packed.dtype == torch.bfloat16 and packed.shape == (lay.fb_elems,)
    fb = torch.from_numpy(_mel_matrix(cfg)).to(torch.bfloat16)
    rebuilt = torch.zeros((lay.f0 + 64 * lay.n_chunks, cfg.n_mels), dtype=torch.bfloat16)
    for j, (off, m0, w) in enumerate(zip(lay.band_offset, lay.band_start, lay.band_width)):
        block = packed[off:off + 64 * w].reshape(4, w // 8, 2, 8, 8)  # (kb, ng, kh, nr, kc)
        block = block.permute(0, 2, 4, 1, 3).reshape(64, w)            # (k, n)
        rows = lay.f0 + 64 * j + band_row_freq(np.arange(64))
        rebuilt[rows, m0:m0 + w] += block
    n = min(fb.shape[0], rebuilt.shape[0])
    assert torch.equal(rebuilt[:n].view(torch.int16), fb[:n].view(torch.int16))
    assert not rebuilt[n:].any() and not fb[n:].any()  # rows past the chunks are dead


def _read_k16(buf: np.ndarray, base: int, rows: int) -> np.ndarray:
    """What a wgmma descriptor without swizzle reads at element ``base``: a
    (rows, 16) K-major operand of 8×8 core matrices, the next 8 of K 64
    elements on (128 bytes), the next 8 rows 128 elements on (256 bytes)."""
    r = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    return buf[base + (r // 8) * 128 + (k // 8) * 64 + (r % 8) * 8 + k % 8]


def _span_index(hop: int) -> np.ndarray:
    """(64, 1024): the skewed span offset from which the kernel's ldmatrix
    rule puts element (frame, sample) of a tile into a thread's A fragment.
    Lane l of warp w points at row 16w + l % 8 + 8·(l / 8 % 2), k half
    l / 16, plus koff[kb]; thread t receives in register q row t / 4,
    columns 2·(t % 4) and + 1 of the matrix that lanes 8q .. 8q + 7 point
    at; register q of the m16n8k16 A fragment is row t / 4 + 8·(q % 2),
    k 8·(q / 2) + 2·(t % 4) (+ 1)."""
    idx = np.full((64, 1024), -1)
    kb = np.arange(64)
    koff = 16 * kb + SKEW * (16 * kb // hop)
    for w in range(4):
        for t in range(32):
            for q in range(4):
                lane = 8 * q + t // 4  # the lane that gave matrix q's row t / 4
                arow = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8
                base = arow * (hop + SKEW) + 8 * (lane >> 4) + koff
                for e in range(2):
                    row = 16 * w + t // 4 + 8 * (q % 2)
                    k = 16 * kb + 8 * (q // 2) + 2 * (t % 4) + e
                    assert (idx[row, k] == -1).all()
                    idx[row, k] = base + 2 * (t % 4) + e
    assert (idx >= 0).all()
    return idx


def _kernel_order_logmel(x: np.ndarray, cfg: LogMelConfig, scale, shift, dtype=np.float32):
    """The bf16 kernel's walk in ``dtype`` (nothing rounded), CTA by CTA."""
    b_n, s_n = x.shape
    hop = cfg.hop_length
    t_n = 1 + s_n // hop
    lay = logmel_layout(cfg)
    basis = pack_basis(cfg, torch.float32).numpy().astype(dtype)
    fbp = pack_filterbank(cfg, torch.float32).numpy().astype(dtype)
    idx = _span_index(hop)
    span = (TILE_FRAMES - 1) * hop + 1024
    i = np.arange(span)
    out = np.full((b_n, t_n, cfg.n_mels), np.nan, dtype)
    tiles = -(-t_n // TILE_FRAMES)
    lanes = np.arange(32)
    c = lanes % 4
    for b in range(b_n):
        for tile in range(tiles):
            t0 = tile * TILE_FRAMES
            # the reflect index map of the span load: x reflected at both
            # ends, zero past the padded end
            j = t0 * hop + i - PAD
            src = np.where(j < 0, -j, np.where(j >= s_n, 2 * (s_n - 1) - j, j))
            vals = np.where(j >= s_n + PAD, 0.0, x[b, np.clip(src, 0, s_n - 1)])
            buf = np.zeros(span + SKEW * (span // hop + 1), dtype)
            buf[i + SKEW * (i // hop)] = vals
            a = buf[idx]                                   # (64, 1024)
            mel = np.zeros((64, cfg.n_mels + 8), dtype)
            for ch in range(lay.n_chunks):
                # ring stages 16·ch .. 16·ch + 15, 4 k16 steps each
                bmat = np.concatenate([
                    _read_k16(basis, (16 * ch + st) * STAGE_ELEMS + kk * 2048, 128).T
                    for st in range(16) for kk in range(4)])   # (1024, 128)
                acc = a @ bmat                                 # (64, 128)
                m0, w = lay.band_start[ch], lay.band_width[ch]
                bband = np.concatenate([
                    _read_k16(fbp, lay.band_offset[ch] + s * 16 * w, w).T for s in range(4)])
                for warp in range(4):
                    row = 16 * warp + lanes // 4           # (32,)
                    # power of n8 tile t (columns 8t + 2c: re, + 1: im), rows r, r + 8
                    pw = np.zeros((32, 16, 2), dtype)
                    for t in range(16):
                        for r8 in range(2):
                            re = acc[row + 8 * r8, 8 * t + 2 * c]
                            im = acc[row + 8 * r8, 8 * t + 2 * c + 1]
                            pw[:, t, r8] = re * re + im * im
                    # A of the mel product: step s register 2h + r8, halves
                    # e = 0, 1 hold tiles 4s + 2h + e at k 16s + 8h + 2c + e
                    amel = np.zeros((16, 64), dtype)
                    for s in range(4):
                        for h in range(2):
                            for r8 in range(2):
                                for e in range(2):
                                    amel[lanes // 4 + 8 * r8, 16 * s + 8 * h + 2 * c + e] = \
                                        pw[:, 4 * s + 2 * h + e, r8]
                    d = amel @ bband                           # (16, w)
                    # thread (lane) adds n8 tile t at m0 + 8t + 2c (+ 1), rows r, r + 8
                    for t in range(w // 8):
                        for e in range(4):
                            rr = lanes // 4 + 8 * (e // 2)
                            col = m0 + 8 * t + 2 * c + e % 2
                            np.add.at(mel, (16 * warp + rr, col), d[rr, 8 * t + 2 * c + e % 2])
            for r in range(64):
                if t0 + r < t_n:  # rows past the clip write nothing
                    db = 10.0 * np.log(np.maximum(cfg.amin, mel[r, :cfg.n_mels])) / np.log(10.0)
                    out[b, t0 + r] = (db - log_ref(cfg)) * scale + shift
    assert not np.isnan(out).any()
    return out


def _waveform(rng, b, s):
    """Noise and a chirp; the last clip ends in silence."""
    t = np.arange(s) / 32000
    x = 0.05 * rng.standard_normal((b, s)) + 0.3 * np.sin(2 * np.pi * 440 * t * (1 + t))
    x[-1, s - s // 4:] = 0.0
    return x.astype(np.float32)


def _plain_f64(x: np.ndarray, cfg: LogMelConfig, scale, shift) -> np.ndarray:
    """The plain composition in f64 on the same (f32) basis and filterbank."""
    frames = frame_signal(torch.from_numpy(x).double(), cfg.n_fft, cfg.hop_length)
    spec = frames @ torch.from_numpy(dft_basis(cfg.n_fft)).double()
    n = cfg.n_fft // 2 + 1
    power = spec[..., :n] ** 2 + spec[..., n:] ** 2
    mel = power @ torch.from_numpy(_mel_matrix(cfg)).double()
    db = 10.0 * torch.log10(torch.clamp_min(mel, cfg.amin)) - log_ref(cfg)
    return (db * torch.from_numpy(scale).double() + torch.from_numpy(shift).double()).numpy()


@pytest.mark.parametrize("s,cfg", [
    (22_400, DEFAULT_LOGMEL),   # 71 frames: two tiles a clip
    (12_800, DEFAULT_LOGMEL),   # 41 frames: one tile
    (513, DEFAULT_LOGMEL),      # the shortest input: 2 frames, reflected at both ends
    (22_400, WIDE),             # fmax 16 kHz: 8 chunks
], ids=["2tiles", "1tile", "shortest", "fmax16k"])
def test_kernel_order_walk_equals_the_plain_version(s, cfg):
    rng = np.random.default_rng(s)
    x = _waveform(rng, 2, s)
    scale = rng.uniform(0.5, 2.0, 224).astype(np.float32)
    shift = rng.standard_normal(224).astype(np.float32)
    gain = float(np.abs(scale).max())
    got64 = _kernel_order_logmel(x, cfg, scale, shift, np.float64)
    np.testing.assert_allclose(got64, _plain_f64(x, cfg, scale, shift), atol=F64_ATOL_DB * gain,
                               rtol=0)
    got = _kernel_order_logmel(x, cfg, scale, shift)
    want = logmel_reference(torch.from_numpy(x), cfg, torch.from_numpy(scale),
                            torch.from_numpy(shift)).numpy()
    assert got.shape == want.shape == (2, 1 + s // 320, 224)
    np.testing.assert_allclose(got, want, **F32_TOL)
    if cfg is DEFAULT_LOGMEL and s == 22_400:  # and the TPU kernel itself, in interpret mode
        jax_out = np.asarray(pallas_logmel(jnp.asarray(x), bn_scale=jnp.asarray(scale),
                                           bn_shift=jnp.asarray(shift), interpret=True))
        np.testing.assert_allclose(got, jax_out, **F32_TOL)


def test_library_path_hashes_every_source_and_header(tmp_path, monkeypatch):
    """Every csrc/*.cu and csrc/*.cuh is built and hashed: an edit to any of
    them names another library."""
    assert {p.name for p in _build.sources()} >= {"logmel.cu", "convnext_block.cu", "downsample.cu"}
    assert "hopper.cuh" in {p.name for p in _build.headers()}
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "h.cuh").write_text("// h\n")
    first = _build.library_path()
    for name in ("a.cu", "b.cu", "h.cuh"):
        text = (tmp_path / name).read_text()
        (tmp_path / name).write_text(text + "// edited\n")
        assert _build.library_path() != first, name
        (tmp_path / name).write_text(text)
        assert _build.library_path() == first
