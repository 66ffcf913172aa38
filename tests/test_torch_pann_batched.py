"""``models/pann.py::pann_frames_masked``, the Cnn family's frame embeddings
of a padded batch of clips of several lengths, on the CPU at f32: each row
equals what the port's ``pann_apply``, JAX's ``pann_apply`` and the
benchmark's plain reference (``benchmark/reference/pann.py``) give that
clip alone, within 1e-6 of the larger of 1 and its largest magnitude; its
frame count exactly; zeros past it. The same batch padded and encoded
without the masks differs, so the masks are what makes it equal.

The encoders run Cnn14's and Cnn10's structure at toy widths with drawn
batch norms, on rows whose lengths make every pool meet odd extents (127
mel frames floor to 63, 31, 15, 7, 3), padded to a bucket longer than the
longest."""

import jax
import numpy as np
import pytest
import torch

from benchmark.reference import pann as ref_pann
from conette_tpu.models import pann as jax_pann
from conette_torch.models import pann
from conette_torch.ops.stft import frame_rows, frame_signal
from conette_torch.weights import to_numpy, to_torch
from torch_fixtures import random_batch_norms

TOL = 1e-6
CHANNELS = {"cnn14": (8, 8, 16, 16, 32, 32), "cnn10": (8, 8, 16, 16), "cnn14_att": (8, 8, 16, 16, 32, 32)}
# mel frames 127, 63, 100, 47 and 32 (the fewest that Cnn14's five pools
# leave a frame of): every pool floors an odd extent of some row
LENS = [126 * 320 + 7, 62 * 320 + 101, 99 * 320 + 319, 46 * 320, 31 * 320 + 250]
PADDED = 48_000


def tree(arch: str) -> dict:
    g = torch.Generator().manual_seed(len(arch))
    params = pann.pann_init(g, CHANNELS[arch], att_head=arch == "cnn14_att")
    return random_batch_norms(to_numpy(params), np.random.default_rng(len(arch)))


def batch(lens=LENS, padded=PADDED, seed=0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lens), padded), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 32_000
        wav[i, :n] = 0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
    return wav, np.asarray(lens)


@pytest.fixture(scope="module", params=sorted(CHANNELS))
def masked(request):
    arch = request.param
    params = tree(arch)
    wav, lens = batch()
    out = pann.pann_frames_masked(to_torch(params), torch.from_numpy(wav), torch.from_numpy(lens))
    return arch, params, wav, lens, out


def assert_row(got: torch.Tensor, want: np.ndarray) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)


def test_each_row_is_the_clip_alone_through_the_ports_forward(masked):
    _, params, wav, lens, out = masked
    embs, n_out = out["frame_embs"], out["frame_embs_lens"]
    assert embs.shape[0] == len(lens) and n_out.dtype == torch.int32
    for i, n in enumerate(lens):
        alone = pann.pann_apply(to_torch(params), torch.from_numpy(wav[i:i + 1, :n]))
        t = alone["frame_embs"].shape[2]
        assert int(n_out[i]) == t == int(alone["frame_embs_lens"][0])
        assert_row(embs[i, :, :t], alone["frame_embs"][0].numpy())
        assert not embs[i, :, t:].any()


def test_each_row_is_the_clip_alone_through_jax(masked):
    _, params, wav, lens, out = masked
    for i, n in enumerate(lens):
        want = np.asarray(jax_pann.pann_apply(params, wav[i:i + 1, :n])["frame_embs"][0])
        assert int(out["frame_embs_lens"][i]) == want.shape[1]
        assert_row(out["frame_embs"][i, :, : want.shape[1]], want)


@pytest.mark.parametrize("arch", ["cnn14", "cnn10"])  # the reference has no attention head
def test_each_row_is_the_plain_reference(arch):
    params = tree(arch)
    wav, lens = batch()
    out = pann.pann_frames_masked(to_torch(params), torch.from_numpy(wav), torch.from_numpy(lens))
    blocks = len(CHANNELS[arch])
    for i, n in enumerate(lens):
        want = ref_pann.frames(to_torch(params), torch.from_numpy(wav[i:i + 1, :n]))[0].T
        assert want.shape[1] == int(out["frame_embs_lens"][i]) == ref_pann.frame_count(int(n), blocks)
        assert_row(out["frame_embs"][i, :, : want.shape[1]], want.numpy())


def test_a_padded_batch_without_the_masks_differs(masked):
    """The same padded batch through ``pann_apply``: every row shorter than
    the padding reads its padding into its last frames."""
    _, params, wav, lens, out = masked
    plain = pann.pann_apply(to_torch(params), torch.from_numpy(wav))["frame_embs"]
    for i in range(len(lens)):
        t = int(out["frame_embs_lens"][i])
        gap = float((plain[i, :, :t] - out["frame_embs"][i, :, :t]).abs().max())
        assert gap > 1e3 * TOL * max(1.0, float(out["frame_embs"][i].abs().max())), i


@pytest.mark.parametrize("n", [31 * 320, 32_000, 32_319, 32_320, 99_999])
def test_frame_count_is_the_floor_chain(n):
    params = to_torch(tree("cnn14"))
    wav, lens = batch([n], padded=n + 1000)
    got = pann.pann_frames_masked(params, torch.from_numpy(wav), torch.from_numpy(lens))
    alone = pann.pann_apply(params, torch.from_numpy(wav[:, :n]), torch.tensor([n]))
    want = 1 + n // 320
    for _ in range(5):
        want //= 2
    assert int(got["frame_embs_lens"][0]) == want == ref_pann.frame_count(n) == alone["frame_embs"].shape[2]
    assert int(alone["frame_embs_lens"][0]) == want  # frame_lens of the clip alone


def test_each_rows_frames_reflect_at_its_own_end():
    wav, lens = batch()
    x = torch.from_numpy(wav)
    rows = frame_rows(x, torch.from_numpy(lens), 1024, 320)
    assert rows.shape == frame_signal(x, 1024, 320).shape
    for i, n in enumerate(lens):
        alone = frame_signal(x[i:i + 1, :n], 1024, 320)[0]
        assert torch.equal(rows[i, : alone.shape[0]], alone)


def test_the_bucket_padding_does_not_move_a_row():
    params = to_torch(tree("cnn14"))
    outs = []
    for padded in (max(LENS), PADDED, 3 * PADDED):
        wav, lens = batch(padded=padded)
        outs.append(pann.pann_frames_masked(params, torch.from_numpy(wav), torch.from_numpy(lens)))
    for o in outs[1:]:
        assert torch.equal(o["frame_embs_lens"], outs[0]["frame_embs_lens"])
        t = outs[0]["frame_embs"].shape[2]
        torch.testing.assert_close(o["frame_embs"][:, :, :t], outs[0]["frame_embs"], rtol=0, atol=TOL)
        assert not o["frame_embs"][:, :, t:].any()


def test_jax_is_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
