"""The ConvNeXt encoder's training mode (``convnext_apply(deterministic=
False)``) against conette_tpu's at float32 on the CPU, at dims (8, 16, 32,
64) and depths (1, 1, 2, 1), layer scales N(0, 0.1) and bn0's running
statistics drawn from a seed: bn0 from the batch's statistics and its
updated running statistics (``bn0_stats``), a SpecAugment hook (one numpy
stripe mask, applied in both packages), drop-path with the same Bernoulli
masks injected into both in call order (``jax.random.bernoulli`` and the
port's ``layers._keep_mask`` patched), which also holds the per-block rate
schedule ``drop_path_rate · idx / (total − 1)``; the ``return_*`` flags;
a stem stride and padding of ``convnext_features`` other than the
defaults; and the gradients of a fixed scalar of the outputs.

Tolerances: every output within ``TRAIN_REL`` = 1e-5 of its key's largest
absolute value (frame_embs 2.9e-6 observed, clipwise_output 1.0e-6,
running_var 2.4e-6: batch statistics sum in another order than XLA's);
every gradient leaf within ``GRAD_REL`` = 1e-4 of its largest absolute
value (2.5e-6 observed at worst).

And the route: a training-mode call that computes in bf16 takes the plain
ops, where a deterministic one takes the three kernels' wrappers; with
``KERNEL_DEVICE`` set to the CPU, spies on the wrappers show it here. And
the port's train step over the encoder hands the optimizer gradients laid
out as their parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conette_tpu.models import convnext as jax_cx
from conette_torch.models import convnext, layers
from conette_torch.weights import to_torch

TRAIN_REL = 1e-5
GRAD_REL = 1e-4
B, SAMPLES = 3, 32_000


@pytest.fixture(scope="module")
def params():
    p = jax.tree.map(np.asarray, jax_cx.convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 2, 1),
                                                      dims=(8, 16, 32, 64)))
    rng = np.random.default_rng(0)
    for stage in p["stages"]:
        for block in stage:
            block["scale"] = (rng.standard_normal(block["scale"].shape) * 0.1).astype(np.float32)
    p["bn0"]["running_mean"] = (rng.standard_normal(224) * 3 - 20).astype(np.float32)
    p["bn0"]["running_var"] = (np.abs(rng.standard_normal(224)) * 50 + 10).astype(np.float32)
    return p


def _wave() -> np.ndarray:
    return (np.random.default_rng(1).standard_normal((B, SAMPLES)) * 0.1).astype(np.float32)


def spec_augment(mel):
    """Zeroes frames 20-29 and mel bins 100-139 of every row: one numpy
    mask, for either package's (B, T, n_mels) array."""
    mask = np.ones(mel.shape[1:], np.float32)
    mask[20:30] = 0.0
    mask[:, 100:140] = 0.0
    return mel * (torch.from_numpy(mask) if isinstance(mel, torch.Tensor) else jnp.asarray(mask))


def inject(monkeypatch, masks: list[np.ndarray]) -> tuple[list, list]:
    """Both packages draw ``masks`` in order; returns the keep probabilities
    each asked for (JAX's, the port's)."""
    jax_keeps, port_keeps = [], []
    jax_masks, port_masks = iter(masks), iter(masks)

    def jax_bernoulli(key, p, shape):
        jax_keeps.append(float(p))
        m = next(jax_masks)
        assert m.shape == tuple(shape)
        return jnp.asarray(m)

    def port_keep_mask(gen, shape, keep, device, cols=None):
        port_keeps.append(keep)
        m = next(port_masks)
        assert m.shape == tuple(shape)
        return torch.from_numpy(m)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(layers, "_keep_mask", port_keep_mask)
    return jax_keeps, port_keeps


def drop_masks(n: int, rows: int = B) -> list[np.ndarray]:
    rng = np.random.default_rng(n)
    return [rng.random((rows, 1, 1, 1)) < 0.6 for _ in range(n)]


def assert_close(got, want, rel: float = TRAIN_REL) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            assert_close(got[k], w, rel)
            continue
        w, g = np.asarray(w), got[k].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("drop_path_rate", [0.0, 0.4])
def test_training_forward_matches_jax(params, monkeypatch, drop_path_rate):
    wav = _wave()
    lens = np.array([SAMPLES, SAMPLES * 3 // 5, SAMPLES // 2], np.int32)
    jax_keeps, port_keeps = inject(monkeypatch, drop_masks(4))
    want = jax_cx.convnext_apply(params, jnp.asarray(wav), jnp.asarray(lens), deterministic=False,
                                 drop_path_rate=drop_path_rate, rng=jax.random.PRNGKey(1),
                                 spec_augment_fn=spec_augment)
    got = convnext.convnext_apply(to_torch(params), torch.from_numpy(wav), torch.from_numpy(lens),
                                  deterministic=False, drop_path_rate=drop_path_rate,
                                  spec_augment_fn=spec_augment)
    assert_close(got, want)
    assert set(got) == {"frame_embs", "frame_embs_lens", "clipwise_output", "bn0_stats"}
    # block 0 draws nothing; blocks 1-4 of 5 keep 1 - rate · idx / 4
    want_keeps = [1.0 - drop_path_rate * i / 4 for i in range(1, 5)] if drop_path_rate else []
    np.testing.assert_allclose(port_keeps, want_keeps, rtol=1e-6)
    np.testing.assert_allclose(jax_keeps, want_keeps, rtol=1e-6)


@pytest.mark.parametrize("frames, clip", [(True, False), (False, True)])
def test_return_flags_match_jax(params, monkeypatch, frames, clip):
    wav = _wave()
    inject(monkeypatch, drop_masks(4))
    kw = dict(return_frame_outputs=frames, return_clip_outputs=clip, deterministic=False,
              drop_path_rate=0.2)
    want = jax_cx.convnext_apply(params, jnp.asarray(wav), rng=jax.random.PRNGKey(1), **kw)
    got = convnext.convnext_apply(to_torch(params), torch.from_numpy(wav), **kw)
    assert_close(got, want)
    assert ("frame_embs" in got) == frames and ("clipwise_output" in got) == clip


def test_stem_stride_and_padding_match_jax(params, monkeypatch):
    x = np.random.default_rng(2).standard_normal((B, 61, 48, 1)).astype(np.float32)
    inject(monkeypatch, drop_masks(4))
    kw = dict(stem_stride=(2, 4), stem_padding=((2, 2), (1, 1)), deterministic=False,
              drop_path_rate=0.3)
    want = jax_cx.convnext_features(params, jnp.asarray(x), rng=jax.random.PRNGKey(1), **kw)
    got = convnext.convnext_features(to_torch(params), torch.from_numpy(x), **kw)
    assert_close({"features": got}, {"features": want})
    assert convnext.convnext_init(torch.Generator().manual_seed(0), depths=(1, 1, 1, 1),
                                  dims=(8, 16, 32, 64), stem_stride=(2, 4))["stem"]["conv"][
        "weight"].shape == (4, 4, 1, 8)


def test_gradients_match_jax(params, monkeypatch):
    wav = _wave()
    rng = np.random.default_rng(3)
    w_frames = rng.standard_normal((B, 64, 3)).astype(np.float32)  # (B, C, T')
    w_clip = rng.standard_normal((B, 527)).astype(np.float32)
    masks = drop_masks(4)

    def scalar(out, lib):
        return (out["frame_embs"] * lib(w_frames)).sum() + (out["clipwise_output"] * lib(w_clip)).sum()

    inject(monkeypatch, masks)
    kw = dict(deterministic=False, drop_path_rate=0.4, spec_augment_fn=spec_augment)
    want = jax.grad(lambda p: scalar(jax_cx.convnext_apply(p, jnp.asarray(wav), rng=jax.random.PRNGKey(1),
                                                            **kw), jnp.asarray))(params)
    inject(monkeypatch, masks)
    tree = to_torch(params)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tree)]
    scalar(convnext.convnext_apply(tree, torch.from_numpy(wav), **kw), torch.from_numpy).backward()
    for t, w in zip(leaves, jax.tree.leaves(want)):
        w = np.asarray(w)
        g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()))


@pytest.fixture
def wrapper_spies(monkeypatch):
    """The CPU as the kernel device, and the calls of the three kernels'
    wrappers as ``convnext`` makes them (each runs its plain version here)."""
    calls = {"logmel": 0, "convnext_block": 0, "downsample": 0}
    monkeypatch.setattr(convnext, "KERNEL_DEVICE", "cpu")
    for name, attr in (("logmel", "fused_logmel"), ("convnext_block", "fused_convnext_block"),
                       ("downsample", "fused_downsample")):
        def spy(*args, _name=name, _fn=getattr(convnext, attr), **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(convnext, attr, spy)
    return calls


def test_training_mode_at_bf16_takes_the_plain_route(params, monkeypatch, wrapper_spies):
    tree, wav = to_torch(params), torch.from_numpy(_wave())
    for t in jax.tree.leaves(tree):
        t.requires_grad_()
    with torch.no_grad():
        convnext.convnext_apply(tree, wav, compute_dtype=torch.bfloat16)
    assert wrapper_spies == {"logmel": 1, "convnext_block": 5, "downsample": 3}
    with pytest.raises(ValueError, match="always takes the log-mel kernel"):
        convnext.convnext_apply(tree, wav, compute_dtype=torch.bfloat16, use_fused_frontend=False)
    inject(monkeypatch, drop_masks(4))
    for fused_frontend in (None, True, False):
        out = convnext.convnext_apply(tree, wav, compute_dtype=torch.bfloat16, deterministic=False,
                                      drop_path_rate=0.4, use_fused_frontend=fused_frontend,
                                      spec_augment_fn=spec_augment)
        assert torch.isfinite(out["frame_embs"]).all() and "bn0_stats" in out
        out["clipwise_output"].sum().backward()
        inject(monkeypatch, drop_masks(4))
    assert wrapper_spies == {"logmel": 1, "convnext_block": 5, "downsample": 3}


def test_the_train_step_hands_the_optimizer_gradients_laid_out_as_their_parameters(params):
    """``autograd.grad`` gives a conv weight's gradient permuted (the NHWC
    conv runs on an OIHW view); the fused AdamW on the card refuses a
    gradient whose strides are not its parameter's, so the step lays each
    out as its parameter before the update."""
    from conette_torch.train import optim, step

    tree = to_torch(params)
    opt, _ = optim.get_optimizer(tree, lr=1e-4, weight_decay=0.05, sched_name="none")
    state = step.init_train_state(tree, opt)
    seen = []
    opt_step = opt.step

    def checked_step(*args, **kwargs):
        seen.extend(t.grad.stride() == t.stride() for g in opt.param_groups for t in g["params"])
        return opt_step(*args, **kwargs)

    opt.step = checked_step
    wav = torch.from_numpy(_wave())

    def loss_fn(p, batch, gen):
        return convnext.convnext_apply(p, wav, deterministic=False)["clipwise_output"].sum()

    step.make_train_step(None, grad_clip_norm=1.0, loss_fn=loss_fn)(state, {}, None)
    assert len(seen) == len(jax.tree.leaves(tree)) and all(seen)
    # without the layout, the stem's weight gradient is a permuted view
    g = torch.autograd.grad(loss_fn(tree, None, None), tree["stem"]["conv"]["weight"])[0]
    assert g.stride() != tree["stem"]["conv"]["weight"].stride()


def test_drop_path_without_a_generator_raises_as_jax_does(params):
    wav = _wave()
    with pytest.raises(TypeError):
        jax_cx.convnext_apply(params, jnp.asarray(wav), deterministic=False, drop_path_rate=0.1)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        convnext.convnext_apply(to_torch(params), torch.from_numpy(wav), deterministic=False,
                                drop_path_rate=0.1)
