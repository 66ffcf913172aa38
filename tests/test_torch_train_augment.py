"""The port's augmentations against conette_tpu's on the CPU: the
deterministic cores (``stripes_mask``, ``apply_stripes``,
``ratio_width_bounds``, ``resample_nearest``, ``pann_mixup``) equal JAX's on
the same stripes and inputs, and the drawn transforms
(``spec_augment_ratio``, ``spec_augment``, ``speed_perturb``,
``cutout_spec``, ``mixup``) hold the ranges of their draws; the two
packages' generators draw different numbers, so the draws are not compared
one by one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.train import augment as jax_aug
from conette_torch.train import augment


def test_stripes_mask_and_apply_stripes_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20, 12)).astype(np.float32)
    starts, widths = np.array([2, 15, 9]), np.array([3, 0, 5])
    np.testing.assert_array_equal(augment.stripes_mask(20, torch.from_numpy(starts), torch.from_numpy(widths)).numpy(),
                                  np.asarray(jax_aug.stripes_mask(20, starts, widths)))
    for axis, fill in ((1, 0.0), (-1, -3.5), (0, 1.0)):
        want = jax_aug.apply_stripes(jnp.asarray(x), starts[:2] % x.shape[axis], widths[:2], axis, fill)
        got = augment.apply_stripes(torch.from_numpy(x), starts[:2] % x.shape[axis], widths[:2], axis, fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # per row: (B, n) stripes give (B, dim) masks, row by row the 1-D mask
    rows_s, rows_w = rng.integers(0, 20, (4, 2)), rng.integers(0, 6, (4, 2))
    got = augment.stripes_mask(20, torch.from_numpy(rows_s), torch.from_numpy(rows_w)).numpy()
    for i in range(4):
        np.testing.assert_array_equal(got[i], np.asarray(jax_aug.stripes_mask(20, rows_s[i], rows_w[i])))


@pytest.mark.parametrize("rate", [0.9, 1.1, 0.5, 1.37])
def test_resample_nearest_equals_jax(rate):
    x = np.random.default_rng(1).standard_normal((2, 3, 31)).astype(np.float32)
    for axis in (-1, 1):
        want = jax_aug.resample_nearest(jnp.asarray(x), rate, axis)
        got = augment.resample_nearest(torch.from_numpy(x), rate, axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ratio_width_bounds_and_pann_mixup_equal_jax():
    dims = np.array([31, 10, 25, 45, 768, 5])  # x.5 cases round half to even
    for ratios in ((0.0, 0.1), (0.1, 0.5), (0.05, 0.3)):
        want = jax_aug.ratio_width_bounds(jnp.asarray(dims), ratios)
        got = augment.ratio_width_bounds(torch.from_numpy(dims), ratios)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = np.random.default_rng(2).standard_normal((6, 4, 3)).astype(np.float32)
    lam = np.linspace(0.2, 0.9, 6).astype(np.float32)
    np.testing.assert_allclose(augment.pann_mixup(torch.from_numpy(x), torch.from_numpy(lam)).numpy(),
                               np.asarray(jax_aug.pann_mixup(jnp.asarray(x), jnp.asarray(lam))), rtol=1e-6)


def _stripes(x, y, axis):
    """Per row, the set of indices along ``axis`` zeroed in ``y`` (x has no
    zeros) and whether each is a whole slice."""
    zero = (y == 0) & (x != 0)
    other = 2 if axis == 1 else 1
    return zero.all(dim=other)


def test_spec_augment_ratio_draws_within_each_rows_bounds():
    """Time stripes lie within each row's real length (``time_valid``), each
    stripe's width within ``ratio_width_bounds`` of that length, at most 2
    stripes a row; frequency stripes likewise over all 768 columns; rows
    differ; the same generator state gives the same output."""
    b, t, f = 64, 31, 768
    x = torch.rand((b, t, f)) + 1.0
    valid = torch.from_numpy(np.random.default_rng(3).integers(5, t + 1, b))
    gen = torch.Generator().manual_seed(0)
    y = augment.spec_augment_ratio(gen, x, time_ratios=(0.1, 0.3), freq_ratios=(0.0, 0.1),
                                   time_valid=valid)
    again = augment.spec_augment_ratio(torch.Generator().manual_seed(0), x, time_ratios=(0.1, 0.3),
                                       freq_ratios=(0.0, 0.1), time_valid=valid)
    assert torch.equal(y, again)
    t_rows, f_rows = _stripes(x, y, 1), _stripes(x, y, 2)
    for i in range(b):
        v = int(valid[i])
        assert not t_rows[i, v:].any(), i
        lo, hi = augment.ratio_width_bounds(v, (0.1, 0.3))
        dropped = int(t_rows[i].sum())
        assert int(lo) <= dropped <= 2 * max(int(hi) - 1, int(lo)), (i, dropped)
        assert int(f_rows[i].sum()) <= 2 * (round(768 * 0.1) - 1)
    assert len({tuple(r.nonzero().flatten().tolist()) for r in t_rows}) > 10
    # without time_valid: the whole padded width is the extent
    z = augment.spec_augment_ratio(gen, x, time_ratios=(0.5, 0.5), freq_ratios=(0.0, 0.0))
    assert (_stripes(x, z, 1).sum(dim=1) >= 16).all()
    assert not _stripes(x, z, 2).any()


def test_spec_augment_and_cutout_hold_their_ranges():
    b, t, f = 32, 40, 64
    x = torch.rand((b, t, f)) + 1.0
    gen = torch.Generator().manual_seed(1)
    y = augment.spec_augment(gen, x, time_drop_width=8, freq_drop_width=6)
    assert (_stripes(x, y, 1).sum(dim=1) <= 2 * 7).all()
    assert (_stripes(x, y, 2).sum(dim=1) <= 2 * 5).all()
    c = augment.cutout_spec(gen, x, (0.25, 0.5), (0.1, 0.2), fill_value=-100.0)
    for i in range(b):
        rows, cols = (c[i] == -100.0).nonzero(as_tuple=True)
        th, fw = int(rows.max() - rows.min() + 1), int(cols.max() - cols.min() + 1)
        assert 10 <= th < 20 and 7 <= fw < 13 and len(rows) == th * fw
    exact = augment.cutout_spec(gen, x, (0.5, 0.5), (0.5, 0.5))
    assert ((exact == -100.0).sum(dim=(1, 2)) == 20 * 32).all()


def test_speed_perturb_and_mixup():
    x = torch.arange(1, 41, dtype=torch.float32).repeat(2, 1)
    gen = torch.Generator().manual_seed(2)
    left = augment.speed_perturb(gen, x, rates=(0.8, 0.8), align="left")
    np.testing.assert_array_equal(left.numpy()[0, :32], np.asarray(jax_aug.resample_nearest(jnp.asarray(x[0].numpy()), 0.8)))
    assert (left[:, 32:] == 0).all()
    for align in ("right", "center", "random"):
        y = augment.speed_perturb(gen, x, rates=(0.9, 1.1), align=align)
        assert y.shape == x.shape
    same = augment.speed_perturb(gen, x, rates=(1.0, 1.0), align="random")
    assert torch.equal(same, x)
    kept = augment.speed_perturb(gen, x, rates=(0.5, 0.5), p=0.0)
    assert torch.equal(kept, x)
    mixed, lbd, perm = augment.mixup(gen, torch.eye(5), alpha=0.4)
    assert 0.5 <= lbd.item() <= 1.0 and (perm != torch.arange(5)).all()
    torch.testing.assert_close(mixed, torch.eye(5) * lbd + torch.eye(5)[perm] * (1 - lbd))
