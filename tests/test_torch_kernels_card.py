"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at the main path's stage and seam shapes (bf16, batch 2), the
block kernel at two ragged shapes, the seam kernel at batch 8 and 1, at the
1 s corpus bucket's seams and at every slice count, both pack kernels
against their plain layouts, and the log-mel kernel at both compute types
from the shortest input to batch 8 x 10 s (with the same bits over three
launches, and the silent floor at bf16); the block and seam kernels give
the same bits on memory that the caching allocator hands over poisoned
with 0xFF bytes as on zeroed memory; and each kernel's custom op replayed
from a CUDA graph gives the bits of its wrapper.

A CUDA kernel has no CPU mode, so these tests skip without an sm_90
device. This file imports neither JAX nor conette_tpu, so it also runs
where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_kernels_card.py``.
The envelope is the JAX package's own for its kernels: max relative error
< 0.02 (``tests/test_pallas_convnext_block.py:82``).
"""

import numpy as np
import pytest
import torch

from conette_torch.kernels.convnext_block import (
    block_plan,
    convnext_block_reference,
    fused_convnext_block,
    launch_block,
    pack_block_weights,
    prepare_block_operands,
    work_size,
)
from conette_torch.kernels.downsample import (
    downsample_reference,
    fused_downsample,
    launch_seam,
    pack_seam_weights,
    prepare_seam_operands,
    seam_plan,
    slice_counts,
)
from conette_torch.kernels.logmel import (
    _identity_affine,
    _operands,
    fused_logmel,
    launch_logmel,
    logmel_reference,
)
from conette_torch.models.convnext import convnext_apply
from conette_torch.ops.frontend import DEFAULT_LOGMEL, LogMelConfig

EPS = 1e-6
# (T, F, C) of each stage's blocks and seam input for a 10 s clip
STAGES = [(252, 56, 96), (126, 28, 192), (63, 14, 384), (31, 7, 768)]


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (H100); the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, scale, device, dtype=torch.float32, shift=0.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device, dtype)


def rel_err(want, got):
    return float((want.float() - got.float()).abs().max() / want.float().abs().max().clamp_min(1e-6))


# each stage at batch 2 (stages 3 and 4 split the hidden layer over CTAs),
# stage 4 of a 1 s clip at batch 8 (168 pixels: a ragged last tile, split
# 44 ways) and stage 1 at batch 1
BLOCK_SHAPES = [(2, t, f, c) for t, f, c in STAGES] + [(8, 3, 7, 768), (1, 252, 56, 96)]


@pytest.mark.parametrize("b,t,f,c", BLOCK_SHAPES)
def test_block_kernel_matches_plain_on_card(h100, b, t, f, c):
    rng = np.random.default_rng(c + b)
    args = (
        _randn(rng, (7, 7, 1, c), 0.1, h100), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c,), 0.1, h100, shift=1.0), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c, 4 * c), 0.05, h100), _randn(rng, (4 * c,), 0.05, h100),
        _randn(rng, (4 * c, c), 0.05, h100), _randn(rng, (c,), 0.05, h100),
        _randn(rng, (c,), 0.1, h100),  # layer scale N(0, 0.1)
    )
    x = _randn(rng, (b, t, f, c), 0.5, h100, torch.bfloat16)
    n = fused_convnext_block.launches
    got = fused_convnext_block(x, *args, eps=EPS)
    again = fused_convnext_block(x, *args, eps=EPS)
    torch.cuda.synchronize()
    assert fused_convnext_block.launches == n + 2
    assert rel_err(convnext_block_reference(x, *args, eps=EPS), got) < 0.02
    # the split's partial sums are added in a fixed order: the same bits
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("c", [96, 192, 384, 768])
def test_block_pack_kernel_writes_the_plain_layout(h100, c):
    """The launch's pack kernel writes W1 and W2 in ``pack_block_weights``
    order, then the depthwise weights and the layer scale, all as bf16
    rounded like ``Tensor.to(torch.bfloat16)``, bit for bit."""
    rng = np.random.default_rng(c)
    args = [_randn(rng, shape, 0.1, h100) for shape in
            ((7, 7, 1, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,), (c,))]
    x = _randn(rng, (1, 7, 7, c), 0.5, h100, torch.bfloat16)
    ops = prepare_block_operands(*args)
    work = torch.empty(work_size(c), dtype=torch.bfloat16, device=h100)
    launch_block(x, ops, block_plan(49, c), EPS, work=work)
    torch.cuda.synchronize()
    bf16 = torch.bfloat16
    want = torch.cat([pack_block_weights(args[4], args[6]), args[0].reshape(-1).to(bf16),
                      args[8].to(bf16)])
    assert torch.equal(work.view(torch.int16), want.view(torch.int16))


# each seam at batch 2, 8 (10 s clips) and 1, and the 1 s corpus bucket's
# seams at batch 8 (odd T at the first two, ragged last tiles)
SEAM_SHAPES = ([(2, t, f, c) for t, f, c in STAGES[:3]] + [(8, t, f, c) for t, f, c in STAGES[:3]]
               + [(1, t, f, c) for t, f, c in STAGES[:3]]
               + [(8, 27, 56, 96), (8, 13, 28, 192), (8, 6, 14, 384)])


def _seam_args(rng, c, device):
    return (
        _randn(rng, (c,), 0.1, device, shift=1.0), _randn(rng, (c,), 0.05, device),
        _randn(rng, (2, 2, c, 2 * c), 0.05, device), _randn(rng, (2 * c,), 0.05, device),
    )


@pytest.mark.parametrize("b,t,f,c", SEAM_SHAPES)
def test_seam_kernel_matches_plain_on_card(h100, b, t, f, c):
    rng = np.random.default_rng(c + b + t)
    seam = _seam_args(rng, c, h100)
    x = _randn(rng, (b, t, f, c), 0.5, h100, torch.bfloat16)
    n = fused_downsample.launches
    got = fused_downsample(x, *seam, eps=EPS)
    again = fused_downsample(x, *seam, eps=EPS)
    torch.cuda.synchronize()
    assert fused_downsample.launches == n + 2
    want = downsample_reference(x, *seam, eps=EPS)
    assert got.shape == want.shape == (b, t // 2, f // 2, 2 * c)
    assert rel_err(want, got) < 0.02
    # K is never split: the same bits
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("t,f,c", STAGES[:3])
def test_seam_kernel_at_every_slice_count_on_card(h100, t, f, c):
    """Every slice width the kernel takes gives the plain version's result."""
    rng = np.random.default_rng(c)
    ops = prepare_seam_operands(*_seam_args(rng, c, h100))
    x = _randn(rng, (2, t, f, c), 0.5, h100, torch.bfloat16)
    want = downsample_reference(x, *ops, eps=EPS)
    for s in slice_counts(c):
        got = launch_seam(x, ops, seam_plan(2 * (t // 2) * (f // 2), c, slices=s), EPS)
        torch.cuda.synchronize()
        assert rel_err(want, got) < 0.02, s


@pytest.mark.parametrize("c", [96, 192, 384])
def test_seam_pack_kernel_writes_the_plain_layout(h100, c):
    """The launch's pack kernel writes W in ``pack_seam_weights`` order,
    rounded like ``Tensor.to(torch.bfloat16)``, bit for bit."""
    rng = np.random.default_rng(c)
    ops = prepare_seam_operands(*_seam_args(rng, c, h100))
    x = _randn(rng, (1, 2, 2, c), 0.5, h100, torch.bfloat16)
    work = torch.empty(8 * c * c, dtype=torch.bfloat16, device=h100)
    launch_seam(x, ops, seam_plan(1, c), EPS, work=work)
    torch.cuda.synchronize()
    want = pack_seam_weights(ops.w)
    assert torch.equal(work.view(torch.int16), want.view(torch.int16))


def _waveform(rng, b, s, h100):
    """Noise and a tone, with a silent tail in the last clip so the frames
    that straddle its end and the -100 dB floor are both covered."""
    t = np.arange(s) / 32000
    x = 0.05 * rng.standard_normal((b, s)) + 0.3 * np.sin(2 * np.pi * 440 * t * (1 + t))
    x[-1, s - s // 4:] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(h100)


# f32: the JAX envelope of its kernel (tests/test_pallas_logmel.py:21).
# bf16: kernel and plain version round at the same points and differ by f32
# summation order, which can flip one bf16 rounding of a power bin, about
# 0.017 dB on the mel bins that hold it; 0.05 dB (times the affine scale).
# Shapes: batch 2 and 8 at 10 s, the 1 s corpus bucket, 3 tiles a clip (an
# odd count), 1 tile, the shortest input (S = 513, reflected at both ends),
# and a cfg with fmax 16 kHz (8 chunks).
LOGMEL_CASES = [((2, 320_000), DEFAULT_LOGMEL), ((2, 22_400), DEFAULT_LOGMEL),
                ((8, 320_000), DEFAULT_LOGMEL), ((8, 32_000), DEFAULT_LOGMEL),
                ((2, 50_000), DEFAULT_LOGMEL), ((3, 12_800), DEFAULT_LOGMEL),
                ((2, 513), DEFAULT_LOGMEL), ((2, 22_400), LogMelConfig(fmax=16_000.0))]


@pytest.mark.parametrize("shape,cfg", LOGMEL_CASES,
                         ids=["2x10s", "2x22400", "8x10s", "8x1s", "3tiles", "1tile", "shortest",
                              "fmax16k"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine", [False, True])
def test_logmel_kernel_matches_plain_on_card(h100, shape, cfg, dtype, affine):
    rng = np.random.default_rng(shape[1])
    x = _waveform(rng, *shape, h100)
    scale = shift = None
    if affine:
        scale = _randn(rng, (224,), 0.3, h100, shift=1.0)
        shift = _randn(rng, (224,), 1.0, h100)
    n = fused_logmel.launches
    got = fused_logmel(x, cfg, bn_scale=scale, bn_shift=shift, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert fused_logmel.launches == n + 1
    want = logmel_reference(x, cfg, bn_scale=scale, bn_shift=shift, compute_dtype=dtype)
    assert got.shape == want.shape == (shape[0], 1 + shape[1] // 320, 224)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-4)
    else:
        gain = 1.0 if scale is None else float(scale.abs().max())
        assert float((got - want).abs().max()) <= 0.05 * gain
    if not affine and shape[1] >= 16_000:  # the last clip's silent frames sit on the -100 dB floor
        floor = torch.full_like(got[-1, -5:], -100.0)
        torch.testing.assert_close(got[-1, -5:], floor, atol=1e-4, rtol=0)


def test_logmel_kernel_gives_the_same_bits_twice(h100):
    """Every sum has a fixed order: two launches through the wrapper, and
    one on the cached operands, give the same bits."""
    rng = np.random.default_rng(8)
    x = _waveform(rng, 8, 320_000, h100)
    scale = _randn(rng, (224,), 0.3, h100, shift=1.0)
    shift = _randn(rng, (224,), 1.0, h100)
    first = fused_logmel(x, bn_scale=scale, bn_shift=shift, compute_dtype=torch.bfloat16)
    again = fused_logmel(x, bn_scale=scale, bn_shift=shift, compute_dtype=torch.bfloat16)
    ops = _operands(DEFAULT_LOGMEL, h100, torch.bfloat16)
    third = launch_logmel(x, ops, scale, shift)
    torch.cuda.synchronize()
    for other in (again, third):
        assert torch.equal(first.view(torch.int32), other.view(torch.int32))


def test_logmel_silent_tail_sits_on_the_floor_at_bf16(h100):
    """Without the affine, frames that lie wholly in silence sit on the
    -100 dB floor at bf16, as they do at f32: a zero span gives zero power
    in every live frequency."""
    rng = np.random.default_rng(11)
    x = _waveform(rng, 8, 320_000, h100)
    x[:, -64_000:] = 0.0  # the last 2 s of every clip
    for dtype in (torch.bfloat16, torch.float32):
        got = fused_logmel(x, compute_dtype=dtype)
        torch.cuda.synchronize()
        silent = got[:, -190:]  # frames whose 1024 samples are all in the silence
        torch.testing.assert_close(silent, torch.full_like(silent, -100.0), atol=1e-4, rtol=0)
        assert float(got[:, :-210].min()) > -100.0


def test_logmel_operands_are_packed_once(h100):
    """The packed operands are cached per (cfg, device, dtype): a call
    uploads and packs nothing."""
    dev = torch.zeros(1, device=h100).device  # with its index, as the wrapper keys it
    ops = _operands(DEFAULT_LOGMEL, dev, torch.bfloat16)
    assert ops is _operands(DEFAULT_LOGMEL, dev, torch.bfloat16)
    assert ops.basis.device == ops.fb.device == ops.bands.device == dev
    assert ops.n_chunks == 7 and ops.live == (2, 447)
    assert _identity_affine(dev) is _identity_affine(dev)


def test_bf16_card_route_keeps_the_frontend_kernel(h100):
    """Nothing turns the log-mel kernel off for a CUDA waveform at bf16."""
    x = torch.zeros((1, 32_000), device=h100)
    with pytest.raises(ValueError, match="always takes the log-mel kernel"):
        convnext_apply({}, x, compute_dtype=torch.bfloat16, use_fused_frontend=False)


def test_kernels_reject_what_they_do_not_take(h100):
    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=h100)
    w = torch.zeros(64, device=h100)
    with pytest.raises(ValueError, match="C in"):
        fused_convnext_block(x, torch.zeros((7, 7, 1, 64), device=h100), w, w, w,
                             torch.zeros((64, 256), device=h100), torch.zeros(256, device=h100),
                             torch.zeros((256, 64), device=h100), w, w)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_downsample(torch.zeros((1, 8, 8, 96), device=h100), torch.ones(96, device=h100),
                         torch.zeros(96, device=h100), torch.zeros((2, 2, 96, 192), device=h100),
                         torch.zeros(192, device=h100))


def _recycle(device, byte: int) -> None:
    """Fill a large and many small cached blocks of the allocator with
    ``byte`` and free them, so that the next allocations of a call get that
    memory (0xFF is NaN in bf16 and f32)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    blocks = [torch.empty(1 << 30, dtype=torch.uint8, device=device)]
    blocks += [torch.empty(1 << 20, dtype=torch.uint8, device=device) for _ in range(64)]
    for blk in blocks:
        blk.fill_(byte)
    del blocks
    torch.cuda.synchronize(device)


def _same_on_recycled_memory(call):
    outs = []
    for byte in (0x00, 0xFF, 0x00, 0xFF):
        _recycle(torch.device("cuda"), byte)
        outs.append(call().clone())
        torch.cuda.synchronize()
    return all(torch.equal(outs[0].view(torch.int16), o.view(torch.int16)) for o in outs[1:])


def test_block_gives_the_same_bits_on_poisoned_memory(h100):
    """The shape split 44 ways at which one chip run saw two launches differ."""
    rng = np.random.default_rng(7)
    c = 768
    args = (
        _randn(rng, (7, 7, 1, c), 0.1, h100), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c,), 0.1, h100, shift=1.0), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c, 4 * c), 0.05, h100), _randn(rng, (4 * c,), 0.05, h100),
        _randn(rng, (4 * c, c), 0.05, h100), _randn(rng, (c,), 0.05, h100),
        _randn(rng, (c,), 0.1, h100),
    )
    x = _randn(rng, (8, 3, 7, c), 0.5, h100, torch.bfloat16)
    assert _same_on_recycled_memory(lambda: fused_convnext_block(x, *args, eps=EPS))


def test_seam_gives_the_same_bits_on_poisoned_memory(h100):
    """The shape at which one card-test run saw two launches differ."""
    rng = np.random.default_rng(8)
    seam = _seam_args(rng, 192, h100)
    x = _randn(rng, (2, 126, 28, 192), 0.5, h100, torch.bfloat16)
    assert _same_on_recycled_memory(lambda: fused_downsample(x, *seam, eps=EPS))


def _replayed(call):
    """``call`` captured in a CUDA graph (after a warm-up on a side stream)
    and replayed twice; returns the output of the last replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return out


def test_block_op_replayed_from_a_graph_gives_the_wrappers_bits(h100):
    rng = np.random.default_rng(9)
    c = 384
    args = (
        _randn(rng, (7, 7, 1, c), 0.1, h100), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c,), 0.1, h100, shift=1.0), _randn(rng, (c,), 0.1, h100),
        _randn(rng, (c, 4 * c), 0.05, h100), _randn(rng, (4 * c,), 0.05, h100),
        _randn(rng, (4 * c, c), 0.05, h100), _randn(rng, (c,), 0.05, h100),
        _randn(rng, (c,), 0.1, h100),
    )
    x = _randn(rng, (2, 63, 14, c), 0.5, h100, torch.bfloat16)
    want = fused_convnext_block(x, *args, eps=EPS)
    got = _replayed(lambda: torch.ops.conette_torch.convnext_block(x, *args, EPS))
    assert torch.equal(want.view(torch.int16), got.view(torch.int16))


def test_seam_op_replayed_from_a_graph_gives_the_wrappers_bits(h100):
    rng = np.random.default_rng(10)
    seam = _seam_args(rng, 96, h100)
    x = _randn(rng, (2, 252, 56, 96), 0.5, h100, torch.bfloat16)
    want = fused_downsample(x, *seam, eps=EPS)
    got = _replayed(lambda: torch.ops.conette_torch.downsample(x, *seam, EPS))
    assert torch.equal(want.view(torch.int16), got.view(torch.int16))


def test_logmel_op_replayed_from_a_graph_gives_the_wrappers_bits(h100):
    rng = np.random.default_rng(11)
    x = _randn(rng, (2, 320_000), 0.1, h100)
    scale, shift = _randn(rng, (224,), 0.1, h100, shift=1.0), _randn(rng, (224,), 1.0, h100)
    cfg = DEFAULT_LOGMEL
    want = fused_logmel(x, bn_scale=scale, bn_shift=shift, compute_dtype=torch.bfloat16)
    got = _replayed(lambda: torch.ops.conette_torch.logmel(
        x, scale, shift, cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.n_mels, cfg.fmin,
        cfg.fmax, cfg.ref, cfg.amin, torch.bfloat16))
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))
