"""The port's PANN encoders, their checkpoint conversion and the frontend
factories against conette_tpu's, on the CPU at f32.

The encoders run at narrow widths (the architecture is read from the
parameter tree), on 1 s clips: outputs within 1e-6 of JAX's (f32, the
same operations summed in another order). The conversion runs on
full-width state dicts, since its shape check builds the full model, and
is held bit for bit. The frontends: encoder features within 1e-5, the
dB features of the spectrogram and gammatonegram within 1e-3 dB (values
up to ~60 dB, f32 DFT sums in another order)."""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.convert_pann import convert_pann as jax_convert_pann
from conette_tpu.models import pann as jax_pann
from conette_tpu.models import pann_zoo as jax_zoo
from conette_tpu.models.convnext import convnext_init as jax_convnext_init
from conette_tpu.ops.frontend_factories import get_frontend as jax_get_frontend
from conette_torch.huggingface import convert_pann
from conette_torch.huggingface.convert import flatten_pytree
from conette_torch.models import pann, pann_zoo
from conette_torch.ops.frontend_factories import FRONTENDS, get_frontend
from conette_torch.weights import to_numpy, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC_ATOL = 1e-6
FRONTEND_ATOL = 1e-5
DB_ATOL = 1e-3
NARROW = {"cnn10": (8, 16, 32, 64), "cnn14": (8, 16, 32, 64, 96, 128)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def narrow_tree(name: str) -> dict:
    """A narrow JAX tree with the structure the name's forward reads."""
    key = jax.random.PRNGKey(len(name))
    n_mels = {"cnn14_mel32": 32, "cnn14_mel128": 128}.get(name, 64)
    chans = NARROW["cnn10" if name == "cnn10" else "cnn14"]
    tree = _np(jax_pann.pann_init(key, chans, n_mels=n_mels, att_head=name in (
        "cnn14_att", "cnn14_decisionlevelatt")))
    if name.startswith("cnn14_emb"):
        emb = int(name.removeprefix("cnn14_emb"))
        k1, k2 = jax.random.split(key)
        tree["fc1"] = _np(jax_pann.linear_init(k1, chans[-1], emb, init="torch"))
        tree["fc_audioset"] = _np(jax_pann.linear_init(k2, emb, 527, init="torch"))
    return tree


def _wave(n: int = 32_000, b: int = 2) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(n)
    return (0.1 * rng.standard_normal((b, n))).astype(np.float32), np.array([n, n * 3 // 5][:b])


#: the names whose forward is ``pann_apply`` (the zoo's architectures and
#: decision-level heads: test_torch_pann_zoo.py)
CNN_NAMES = sorted({"cnn10", "cnn14", "cnn14_16k", "cnn14_8k", "cnn14_mel32", "cnn14_mel128",
                    "cnn14_no_specaug", "cnn14_no_dropout", "cnn14_mixup_time_domain",
                    "cnn14_emb512", "cnn14_emb128", "cnn14_emb32", "cnn14_decisionlevelatt"})


@pytest.mark.parametrize("name", CNN_NAMES)
def test_apply_pann_model_matches_jax(name):
    tree = narrow_tree(name)
    wav, lens = _wave()
    want = jax_pann.apply_pann_model(name, tree, wav, lens)
    got = pann.apply_pann_model(name, to_torch(tree), torch.from_numpy(wav), torch.from_numpy(lens))
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=ENC_ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["cnn10", "cnn14", "cnn14_att"])
def test_pann_apply_on_log_mel_input_matches_jax(name):
    tree = narrow_tree(name)
    mel = np.random.default_rng(3).standard_normal((2, 101, 64)).astype(np.float32)
    want = jax_pann.pann_apply(tree, mel, waveform_input=False)
    got = pann.pann_apply(to_torch(tree), torch.from_numpy(mel), waveform_input=False)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ENC_ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool1d_same_matches_jax(kind):
    x = np.random.default_rng(4).standard_normal((2, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(pann_zoo._pool1d_same(torch.from_numpy(x), kind).numpy(),
                               np.asarray(jax_zoo._pool1d_same(x, kind)), atol=1e-7)


def test_zoo_names_and_frontend_configs_are_jax_s():
    assert pann.PANN_ZOO_NAMES == jax_pann.PANN_ZOO_NAMES
    for cfg in ("PANN_LOGMEL32", "PANN_LOGMEL128", "PANN_LOGMEL_16K", "PANN_LOGMEL_8K"):
        assert vars(getattr(pann_zoo, cfg)) == vars(getattr(jax_zoo, cfg)), cfg
    assert vars(pann.PANN_LOGMEL) == vars(jax_pann.PANN_LOGMEL)


@pytest.mark.parametrize("name", ["cnn10", "cnn14_decisionlevelatt", "cnn14_emb32", "cnn14_mel128"])
def test_build_pann_model_gives_jax_s_structure(name):
    got, width = pann.build_pann_model(name, torch.Generator().manual_seed(0))
    want, jax_width = jax_pann.build_pann_model(name, jax.random.PRNGKey(0))
    assert width == jax_width
    assert {k: v.shape for k, v in flatten_pytree(to_numpy(got)).items()} == {
        k: v.shape for k, v in flatten_pytree(_np(want)).items()}


def _oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def reference_pann_state(tree: dict) -> dict[str, np.ndarray]:
    """The reference's state-dict layout of a Cnn-family tree (the
    converter's inverse), with the buffers the converter skips."""
    s = {f"bn0.{k}": v for k, v in tree["bn0"].items()}
    s["bn0.num_batches_tracked"] = np.zeros((), np.int64)
    s["spectrogram_extractor.stft.conv_real.weight"] = np.zeros((513, 1, 1024), np.float32)
    for i, blk in enumerate(tree["blocks"], 1):
        for c in ("conv1", "conv2"):
            s[f"conv_block{i}.{c}.weight"] = _oihw(blk[c]["weight"])  # bias-free in the reference
            blk[c]["bias"] = np.zeros_like(blk[c]["bias"])
        for b in ("bn1", "bn2"):
            for k, v in blk[b].items():
                s[f"conv_block{i}.{b}.{k}"] = v
    s["fc1.weight"] = np.ascontiguousarray(tree["fc1"]["weight"].T)
    s["fc1.bias"] = tree["fc1"]["bias"]
    if "att" in tree:
        for k in ("att", "cla"):
            s[f"att_block.{k}.weight"] = np.ascontiguousarray(tree["att"][k]["weight"].T)[:, :, None]
            s[f"att_block.{k}.bias"] = tree["att"][k]["bias"]
        s["att_block.bn_att.weight"] = np.ones(527, np.float32)
    else:
        s["fc_audioset.weight"] = np.ascontiguousarray(tree["fc_audioset"]["weight"].T)
        s["fc_audioset.bias"] = tree["fc_audioset"]["bias"]
    return s


@pytest.fixture(scope="module", params=["Cnn10", "Cnn14_DecisionLevelAtt"])
def pann_checkpoint(request):
    tree, _ = jax_pann.build_pann_model(request.param, jax.random.PRNGKey(1))
    tree = _np(tree)
    state = reference_pann_state(tree)
    return request.param, tree, state


def test_convert_pann_matches_jax(pann_checkpoint):
    arch, tree, state = pann_checkpoint
    got = flatten_pytree(convert_pann.convert_pann({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, arch))
    want = flatten_pytree(jax_convert_pann(state, arch))
    assert got.keys() == want.keys() == flatten_pytree(tree).keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes() == flatten_pytree(tree)[k].tobytes(), k


def test_convert_pann_rejects_a_drifted_state_dict():
    state = reference_pann_state(narrow_tree("cnn10"))
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_pann.convert_pann(state, "Cnn10")
    with pytest.raises(ValueError, match="No PANN converter"):
        convert_pann.convert_pann(state, "NotAPann")


def test_load_registry_pann_from_ckpt_dir(tmp_path, monkeypatch, pann_checkpoint):
    from conette_torch.models.registries import PANN_REGISTRY

    arch, tree, state = pann_checkpoint
    entry = PANN_REGISTRY[arch]
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state.items()}},
               tmp_path / entry.fname)
    monkeypatch.setenv("CONETTE_CKPT_DIR", str(tmp_path))
    got = flatten_pytree(convert_pann.load_registry_pann(arch))
    for k, v in flatten_pytree(tree).items():
        assert got[k].tobytes() == v.tobytes(), k


def test_gammatone_is_a_byte_equal_copy():
    assert filecmp.cmp(os.path.join(REPO, "conette_torch", "ops", "gammatone.py"),
                       os.path.join(REPO, "conette_tpu", "ops", "gammatone.py"), shallow=False)


@pytest.mark.parametrize("name", FRONTENDS)
def test_get_frontend_matches_jax(name):
    params = None
    if name == "resample_mean_convnext":
        params = _np(jax_convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1),
                                       dims=(16, 32, 64, 128)))
    elif name.startswith("resample_mean_cnn"):
        params = narrow_tree({"resample_mean_cnn10": "cnn10", "resample_mean_cnn14": "cnn14",
                              "resample_mean_cnn14_att": "cnn14_att"}[name])
    wav = (0.1 * np.random.default_rng(5).standard_normal((2, 44_100))).astype(np.float32)
    want_fn, want_width = jax_get_frontend(name, params)
    got_fn, got_width = get_frontend(name, params, device="cpu")
    want, got = want_fn(wav, 44_100), got_fn(wav, 44_100)
    assert got_width == want_width and got.shape == want.shape and got.dtype == np.float32
    atol = DB_ATOL if name.endswith(("spectrogram", "gammatonegram")) else FRONTEND_ATOL
    np.testing.assert_allclose(got, want, atol=atol)


def test_get_frontend_names_a_device_and_rejects_unknown_names():
    with pytest.raises(TypeError):
        get_frontend("resample_mean_spectrogram")  # the device is explicit
    with pytest.raises(ValueError, match="Unknown frontend"):
        get_frontend("resample_mean_mfcc", device="cpu")
