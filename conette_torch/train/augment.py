"""Data augmentations on the device, drawn from an explicit generator.

Counterpart of ``conette_tpu/train/augment.py`` (the reference's
``transforms/audio/spec_aug.py``, ``speed_perturb.py``, ``resample.py``,
``cutoutspec.py`` and ``mixup.py``):

- ``spec_augment``: fixed-width time/frequency stripes (PANN style);
- ``spec_augment_ratio``: stripe widths drawn from
  ``randint(round(dim*r0), round(dim*r1))`` (the production train
  transform, ``conf/audio_t/spec_aug_ratio_emb.yaml``);
- ``speed_perturb``: a nearest-neighbour resample (round-half-even index
  map), padded or cropped back to the input length;
- ``cutout_spec``: one rectangle a row;
- ``mixup`` / ``pann_mixup``: convex combinations along the batch.

Every draw takes a ``torch.Generator`` on the device of ``x`` and happens
there, and every shape is static, so a transform never reads back to the
host. Stripes and cutouts are drawn per row, all rows at once; with
``time_valid`` the time stripes are sized and placed within each row's real
length, so the augmentation does not depend on how far a batch is padded.
The JAX package's ``row_ids`` (per-row keys, so that several processes draw
the stripes of one global batch) waits for multi-process training.
``speed_perturb`` applies with probability ``p`` (the reference inverts
that test for fractional ``p``), and ``spec_augment_ratio`` guards the
full-width stripe at which the reference's ``randint(0, 0)`` raises.
"""

from __future__ import annotations

import math

import torch

from conette_torch.train.objective import randperm_diff, sample_lambda


# ---------------------------------------------------------------------------
# deterministic cores
# ---------------------------------------------------------------------------


def stripes_mask(dim_size: int, starts: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Bool mask over the last axis, True inside any stripe
    ``[start, start + width)``. ``starts``/``widths`` are (n_stripes,)
    → (dim_size,), or (B, n_stripes) → (B, dim_size)."""
    starts, widths = torch.as_tensor(starts), torch.as_tensor(widths)
    idx = torch.arange(dim_size, device=starts.device)
    s, w = starts[..., None], widths[..., None]
    return ((idx >= s) & (idx < s + w)).any(dim=-2)


def apply_stripes(
    x: torch.Tensor,
    starts: torch.Tensor,
    widths: torch.Tensor,
    axis: int,
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Fill ``[start, start + width)`` slices along ``axis`` with
    ``fill_value`` (the reference ``DropStripes.forward`` given its draws)."""
    axis = axis % x.ndim
    mask = stripes_mask(x.shape[axis], torch.as_tensor(starts, device=x.device),
                        torch.as_tensor(widths, device=x.device))
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return torch.where(mask.reshape(shape), fill_value, x)


def ratio_width_bounds(
    dim: torch.Tensor | int, ratios: tuple[float, float]
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(imin, imax)`` stripe-width bounds of ``DropStripesRatio``:
    ``round(dim * r)``, half to even, as Python's ``round``."""
    d = torch.as_tensor(dim, dtype=torch.float32)
    return torch.round(d * ratios[0]).long(), torch.round(d * ratios[1]).long()


def resample_nearest(x: torch.Tensor, rate: float, time_axis: int = -1) -> torch.Tensor:
    """``ResampleNearest._resample_nearest`` for a Python ``rate``: output
    length ``ceil(t * rate)``, ``out[i] = x[min(round_half_even(i / rate), t - 1)]``."""
    t = x.shape[time_axis]
    t_out = math.ceil(t * rate)
    src = torch.round(torch.arange(t_out, dtype=torch.float32, device=x.device) / rate)
    src = src.long().clamp(0, t - 1)
    return torch.index_select(x, time_axis % x.ndim, src)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def _randint(gen: torch.Generator, low: torch.Tensor, high: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) integers, uniform in ``[low, high)`` of each row (``high >
    low``): ``low + floor(u * (high - low))`` with u uniform in [0, 1)."""
    u = torch.rand((low.shape[0], n), generator=gen, device=low.device, dtype=torch.float64)
    span = (high - low)[:, None]
    return low[:, None] + torch.minimum((u * span).floor().long(), span - 1)


def _draw_stripes(gen, max_width, n_stripes: int, valid: torch.Tensor):
    """Fixed-width draws (``DropStripes.forward``): ``max_width`` clipped to
    the extent, ``width ~ randint(0, max_width)``, ``start ~ randint(0,
    extent - width)``; ``valid`` is (B,)."""
    v = valid.long()
    mw = torch.clamp(torch.minimum(torch.as_tensor(max_width, device=v.device).long().expand_as(v), v),
                     min=1)
    widths = _randint(gen, torch.zeros_like(v), mw, n_stripes)
    starts = _randint(gen, torch.zeros_like(widths).reshape(-1),
                      torch.clamp((v[:, None] - widths).reshape(-1), min=1), 1)
    return starts.reshape(widths.shape), widths


def _draw_stripes_ratio(gen, ratios: tuple[float, float], n_stripes: int, valid: torch.Tensor):
    """Ratio draws (``DropStripesRatio.forward``): ``width ~
    randint(round(v*r0), round(v*r1))``, exactly ``imin`` when the bounds
    are equal, at most the extent."""
    v = valid.long()
    imin, imax = ratio_width_bounds(v, ratios)
    drawn = _randint(gen, imin, torch.maximum(imax, imin + 1), n_stripes)
    w = torch.where((imin >= imax)[:, None], imin[:, None], drawn)
    w = torch.where((imin > imax)[:, None], 0, w)
    w = torch.minimum(w, v[:, None])
    starts = _randint(gen, torch.zeros_like(w).reshape(-1),
                      torch.clamp((v[:, None] - w).reshape(-1), min=1), 1)
    return starts.reshape(w.shape), w


def _valid(x: torch.Tensor, time_valid: torch.Tensor | None) -> torch.Tensor:
    b, t = x.shape[:2]
    if time_valid is None:
        return torch.full((b,), t, dtype=torch.long, device=x.device)
    return torch.as_tensor(time_valid, device=x.device).long()


def _drop(x, t_starts, t_widths, f_starts, f_widths, fill_value):
    b, t, f = x.shape
    drop = stripes_mask(t, t_starts, t_widths)[:, :, None] | stripes_mask(f, f_starts, f_widths)[:, None, :]
    return torch.where(drop, fill_value, x)


# ---------------------------------------------------------------------------
# public transforms
# ---------------------------------------------------------------------------


def spec_augment(
    gen: torch.Generator,
    x: torch.Tensor,
    time_drop_width: torch.Tensor | int = 64,
    time_stripes_num: int = 2,
    freq_drop_width: int = 28,
    freq_stripes_num: int = 2,
    time_valid: torch.Tensor | None = None,
    fill_value: float = 0.0,
) -> torch.Tensor:
    """(B, T, F) SpecAugment with fixed maximum widths (the reference
    ConvNeXt defaults). ``time_valid`` (B,): each row's real time length."""
    b, t, f = x.shape
    tv = _valid(x, time_valid)
    ts, tw = _draw_stripes(gen, time_drop_width, time_stripes_num, tv)
    fs, fw = _draw_stripes(gen, freq_drop_width, freq_stripes_num, torch.full_like(tv, f))
    return _drop(x, ts, tw, fs, fw, fill_value)


def spec_augment_ratio(
    gen: torch.Generator,
    x: torch.Tensor,
    time_ratios: tuple[float, float] = (0.0, 0.1),
    time_stripes_num: int = 2,
    freq_ratios: tuple[float, float] = (0.0, 0.1),
    freq_stripes_num: int = 2,
    time_valid: torch.Tensor | None = None,
    fill_value: float = 0.0,
) -> torch.Tensor:
    """SpecAugment with stripe widths drawn from ratio bounds of the extent
    (the production train transform on frame embeddings): width ~
    ``randint(round(dim*r0), round(dim*r1))``. With ``time_valid`` the time
    bounds apply to each row's real length."""
    b, t, f = x.shape
    tv = _valid(x, time_valid)
    ts, tw = _draw_stripes_ratio(gen, time_ratios, time_stripes_num, tv)
    fs, fw = _draw_stripes_ratio(gen, freq_ratios, freq_stripes_num, torch.full_like(tv, f))
    return _drop(x, ts, tw, fs, fw, fill_value)


def speed_perturb(
    gen: torch.Generator,
    x: torch.Tensor,
    rates: tuple[float, float] = (0.9, 1.1),
    p: float = 1.0,
    align: str = "random",
    fill_value: float = 0.0,
    time_axis: int = -1,
) -> torch.Tensor:
    """``SpeedPerturbation`` with static shapes: a nearest-neighbour
    resample by ``rate ~ U(rates)`` (length ``L = ceil(t*rate)``), then pad
    or crop back to the input length with ``align`` placement, computed as
    one gather ``y[j] = x[round((j - off) / rate)]`` masked to the
    resampled extent."""
    if align not in ("left", "right", "center", "random"):
        raise ValueError(f"invalid {align=}")
    dev = x.device
    t = x.shape[time_axis]
    u = torch.rand((3,), generator=gen, device=dev)
    if rates[0] == rates[1]:
        rate = torch.tensor(rates[0], dtype=torch.float32, device=dev)
    else:
        rate = rates[0] + u[0] * (rates[1] - rates[0])
    length = torch.ceil(t * rate).long()
    if align == "left":
        off = torch.zeros((), dtype=torch.long, device=dev)
    elif align == "right":
        off = t - length
    elif align == "center":
        off = torch.where(length >= t, -((length - t) // 2), (t - length) // 2)
    else:
        span = (length - t).abs() + 1
        shift = torch.minimum((u[1].double() * span).floor().long(), span - 1)
        off = torch.where(length >= t, -shift, shift)
    rel = torch.arange(t, device=dev) - off
    src = torch.round(rel.float() / rate).long().clamp(0, t - 1)
    axis = time_axis % x.ndim
    perturbed = torch.index_select(x, axis, src)
    shape = [1] * x.ndim
    shape[axis] = t
    perturbed = torch.where(((rel >= 0) & (rel < length)).reshape(shape), perturbed, fill_value)
    if p >= 1.0:
        return perturbed
    return torch.where(u[2] < p, perturbed, x)


def cutout_spec(
    gen: torch.Generator,
    x: torch.Tensor,
    time_size_range: tuple[float, float] = (0.1, 0.5),
    freq_size_range: tuple[float, float] = (0.1, 0.5),
    fill_value: float = -100.0,
) -> torch.Tensor:
    """One rectangle a row of (B, T, F) filled with ``fill_value``
    (``CutOutSpec``): each side ``size ~ randint(ceil(dim*s0),
    max(ceil(dim*s1), min+1))``, ``start ~ randint(0, max(dim - size + 1, 1))``."""
    b, t, f = x.shape
    dev = x.device

    def side(n: int, scales: tuple[float, float]):
        smin = math.ceil(scales[0] * n)
        smax = max(math.ceil(scales[1] * n), smin + 1)
        size = _randint(gen, torch.full((b,), smin, device=dev), torch.full((b,), smax, device=dev), 1)[:, 0]
        start = _randint(gen, torch.zeros_like(size), torch.clamp(n - size + 1, min=1), 1)[:, 0]
        return start, size

    f0, fw = side(f, freq_size_range)
    t0, tw = side(t, time_size_range)
    ti = torch.arange(t, device=dev)[None, :, None]
    fi = torch.arange(f, device=dev)[None, None, :]
    inside = ((ti >= t0[:, None, None]) & (ti < (t0 + tw)[:, None, None])
              & (fi >= f0[:, None, None]) & (fi < (f0 + fw)[:, None, None]))
    return torch.where(inside, fill_value, x)


def mixup(
    gen: torch.Generator,
    x: torch.Tensor,
    alpha: float = 0.4,
    asymmetric: bool = True,
    allow_self_pairing: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch mixup with a random pairing; returns (mixed, λ, permutation).
    ``allow_self_pairing=True`` is the reference ``Mixup`` module's plain
    ``randperm``; the default pairs with no fixed point, as the training
    step does."""
    if allow_self_pairing:
        idx = torch.randperm(x.shape[0], generator=gen, device=gen.device)
    else:
        idx = randperm_diff(gen, x.shape[0])
    lbd = sample_lambda(gen, alpha, asymmetric)
    return x * lbd + x[idx] * (1.0 - lbd), lbd, idx


def pann_mixup(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """PANN-style mixup of adjacent pairs: (2N, ...) → (N, ...) with
    per-pair weights ``lam``."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    lam = lam.reshape(-1)
    return x[0::2] * lam[0::2].reshape(shape) + x[1::2] * lam[1::2].reshape(shape)
