"""One training step of the port on the card against the same step on the
CPU, at a small width: from the same weights and batch, with dropout 0, a
fixed mixup (λ, pairing) and no augmentation, the loss within 1e-5
relative, every gradient within 1e-4 of the largest gradient, and the
parameters after the AdamW step within 1e-4 of the largest parameter.
Adam's first step moves an element by about ``lr·sign(g)``; where the two
devices' gradients differ by as much as the gradient itself (its sign is
rounding, as for the attention key biases, zero in exact arithmetic), the
step is not determined at f32, and those elements are held to 2·lr apart
instead. TF32 is off on the card, as ``resolve_device`` sets it for
training.

It needs an sm_90 device and skips without one. This file imports neither
JAX nor conette_tpu: ``python -m pytest --noconftest tests/test_torch_train_card.py``."""

import numpy as np
import pytest
import torch

from conette_torch.huggingface.model import resolve_device
from conette_torch.models.conette import ConetteConfig, conette_init
from conette_torch.train import optim, step
from conette_torch.train.objective import training_loss
from conette_torch.weights import named_leaves, to_torch

LR = 5e-4


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (H100)")
    return resolve_device("cuda")


def _batch(cfg, b=16, t=9, length=12, seed=0):
    rng = np.random.default_rng(seed)
    caps = np.full((b, length), cfg.pad_id, np.int64)
    for i in range(b):
        n = int(rng.integers(2, length - 2))
        caps[i, 0] = 5
        caps[i, 1:n + 1] = rng.integers(7, cfg.vocab_size, n)
        caps[i, n + 1] = cfg.eos_id
    return {"audio": rng.standard_normal((b, t, cfg.proj_in)).astype(np.float32),
            "audio_lens": rng.integers(3, t + 1, b).astype(np.int64), "captions": caps}


def _step(cfg, init, batch, perm, device):
    params = to_torch(init, device)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    override = (0.7, torch.from_numpy(perm).to(device))

    def loss_fn(p, b, gen):
        return training_loss(p, cfg, b, gen, mixup_override=override)

    opt, _ = optim.get_optimizer(params, lr=LR, weight_decay=2.0, sched_name="none")
    state = step.init_train_state(params, opt)
    grads = torch.autograd.grad(loss_fn(params, tb, None), [t for _, t in named_leaves(params)])
    state, metrics = step.make_train_step(cfg, grad_clip_norm=1.0, loss_fn=loss_fn)(state, tb, None)
    return (metrics["train/loss"].item(),
            {k: g.cpu() for (k, _), g in zip(named_leaves(params), grads)},
            {k: t.detach().cpu() for k, t in named_leaves(state.params)})


def test_one_training_step_on_card_matches_cpu(h100):
    cfg = ConetteConfig(vocab_size=60, proj_in=64, d_model=32, nhead=2, num_decoder_layers=2,
                        dim_feedforward=64, proj_dropout_p=0.0, decoder_dropout_p=0.0)
    init = conette_init(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg)
    perm = np.roll(np.arange(16), 3)
    card = _step(cfg, init, batch, perm, h100)
    cpu = _step(cfg, init, batch, perm, torch.device("cpu"))
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    g_scale = max(float(g.abs().max()) for g in cpu[1].values())
    assert max(float((card[1][k] - cpu[1][k]).abs().max()) for k in cpu[1]) <= 1e-4 * g_scale
    p_scale = max(float(p.abs().max()) for p in cpu[2].values())
    for k in cpu[2]:
        gdiff = (card[1][k] - cpu[1][k]).abs()
        rounding = (gdiff > 0) & (gdiff >= cpu[1][k].abs())
        diff = (card[2][k] - cpu[2][k]).abs()
        assert float(torch.where(rounding, 0.0, diff).max()) <= 1e-4 * p_scale, k
        assert float(diff.max()) <= 2 * LR, k


def test_a_training_step_reads_nothing_back_to_the_host(h100):
    """After a first step (which creates the optimizer's state), a step with
    dropout, drawn mixup, SpecAugmentRatio and clipping, its batch copied
    from pinned memory as ``main_train`` copies it, runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync."""
    from conette_torch.train.augment import spec_augment_ratio

    cfg = ConetteConfig(vocab_size=60, proj_in=64, d_model=32, nhead=2, num_decoder_layers=2,
                        dim_feedforward=64)
    params = to_torch(conette_init(torch.Generator().manual_seed(1), cfg), h100)
    opt, _ = optim.get_optimizer(params, lr=LR, weight_decay=2.0, sched_name="cos_decay", sched_n_steps=4)
    state = step.init_train_state(params, opt)
    fn = step.make_train_step(cfg, grad_clip_norm=1.0)
    gen, aug = torch.Generator(h100).manual_seed(2), torch.Generator(h100).manual_seed(3)
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in _batch(cfg).items()}

    def one():
        b = {k: v.to(h100, non_blocking=True) for k, v in pinned.items()}
        b["audio"] = spec_augment_ratio(aug, b["audio"], time_valid=b["audio_lens"])
        return fn(state, b, gen)[1]

    one()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = one()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["train/loss"]))


def test_pinned_batches_copy_each_array_into_pinned_memory(h100):
    """``train/loop.py::pinned_batches`` with ``pin``: each numeric array,
    contiguous or not, in pinned memory bit for bit; other values as they
    were."""
    from conette_torch.train.loop import pinned_batches

    rng = np.random.default_rng(0)
    audio = rng.standard_normal((4, 9, 6)).astype(np.float32)
    batch = {"audio": audio, "lens": np.arange(4, dtype=np.int32), "caps": np.arange(24).reshape(4, 6).T,
             "mask": audio[..., 0] > 0, "names": ["a", "b", "c", "d"]}
    (got,) = list(pinned_batches(iter([batch]), True))
    for k in ("audio", "lens", "caps", "mask"):
        assert got[k].is_pinned() and got[k].dtype == torch.from_numpy(np.ascontiguousarray(batch[k])).dtype
        assert np.array_equal(got[k].numpy(), batch[k]), k
    assert got["names"] is batch["names"]


def test_gathered_batches_are_new_pinned_tensors(h100, tmp_path):
    """The datamodule gathers each batch into new pinned tensors, which
    ``pinned_batches`` hands on as they are: the audio, captions and lengths
    pinned, each batch's tensors their own while the batches before are
    held, a batch held across the next two builds unchanged, and each equal
    to the batch gathered into plain numpy arrays. Copies to the card from
    batches dropped at once hold their values while later batches are built
    (the blocks wait for the copies before the allocator hands them out)."""
    from conette_torch.data.datamodule import HDFDataModule
    from conette_torch.data.datasets import DummyAACDataset
    from conette_torch.data.hdf import pack_to_hdf
    from conette_torch.tokenization import AACTokenizer
    from conette_torch.train.loop import pinned_batches

    keys = ("audio", "captions", "audio_lens")
    fpath = str(tmp_path / "clotho_dev_x.hdf")
    pack_to_hdf(DummyAACDataset(size=40, seed=0, audio_frames=31, feat=64), fpath)
    dm = HDFDataModule(AACTokenizer(), [fpath], bsize=8, seed=1)
    dm.setup_fit()
    held = []
    for b in pinned_batches(dm.train_batches(0), True):
        for k in keys:
            assert b[k].is_pinned(), k
            assert all(b[k].data_ptr() != h[k].data_ptr() for h, _ in held), k
        held.append((b, {k: b[k].clone() for k in keys}))
        if len(held) >= 3:  # held across the next two builds
            assert all(torch.equal(held[-3][0][k], held[-3][1][k]) for k in keys)
    assert len(held) == 5
    dm._gather.pin = False
    plain = list(pinned_batches(dm.train_batches(0), False))
    for (b, _), p in zip(held, plain):
        assert not p["audio"].is_pinned()
        assert all(torch.equal(b[k], p[k]) for k in keys)
    dm._gather.pin = True
    on_card = [{k: b[k].to(h100, non_blocking=True) for k in keys}
               for b in pinned_batches(dm.train_batches(0), True)]
    for _ in pinned_batches(dm.train_batches(1), True):
        pass
    torch.cuda.synchronize()
    for d, p in zip(on_card, plain):
        assert all(torch.equal(d[k].cpu(), p[k]) for k in keys)
