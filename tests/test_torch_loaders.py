"""The port's loaders against conette_tpu's, on the CPU: the copied FLAC,
mp3/Ogg and checkpoint-conversion modules, the container dispatch of
``load_audio``, ``wav_info``, and ``from_pretrained`` on a directory that
holds the reference's torch checkpoint instead of ``params.npz``."""

import ast
import os
import pickle
import struct
import wave

import jax
import numpy as np
import pytest
import torch

from conette_tpu.huggingface.convert import convert_torch_checkpoint as jax_convert
from conette_tpu.huggingface.model import CoNeTTEModel as JaxModel
from conette_tpu.models.conette import ConetteConfig as JaxConetteConfig
from conette_tpu.models.conette import conette_init as jax_conette_init
from conette_tpu.models.convnext import convnext_init as jax_convnext_init
from conette_tpu.tokenization import AACTokenizer as JaxTokenizer
from conette_tpu.utils import flac as jax_flac
from conette_tpu.utils import lossy as jax_lossy
from conette_tpu.utils.audio_io import load_audio as jax_load_audio
from conette_torch.huggingface.config import CoNeTTEConfig
from conette_torch.huggingface.convert import (
    convert_torch_checkpoint,
    extract_extra_state,
    flatten_pytree,
    loads_remapped,
)
from conette_torch.huggingface.model import CoNeTTEModel
from conette_torch.utils import flac, lossy
from conette_torch.utils.audio_io import load_audio, load_wav, save_wav, wav_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the one place where a copy differs from its original on purpose: the
# port's unpickler allows no torch global, because torch.storage's
# _load_from_bytes unpickles file bytes with weights_only=False
DIFFERENCES = {
    "huggingface/convert.py": [
        ('        ("torch._utils", "_rebuild_tensor_v2"),\n'
         '        ("torch.storage", "_load_from_bytes"),\n', ""),
        ('in self._ALLOWED or module.startswith("torch.storage"):', "in self._ALLOWED:"),
    ],
}


def _code(path: str, differences=()) -> str:
    """The module's code without docstrings or comments, with the JAX
    package's name replaced by the port's and each named difference
    applied (each must be found)."""
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    for old, new in differences:
        assert text.count(old) == 1, (path, old)
        text = text.replace(old, new)
    tree = ast.parse(text.replace("conette_tpu", "conette_torch"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["utils/flac.py", "utils/lossy.py", "huggingface/convert.py"])
def test_copies_hold_the_original_code(module):
    want = _code(f"conette_tpu/{module}", DIFFERENCES.get(module, ()))
    assert _code(f"conette_torch/{module}") == want


@pytest.mark.parametrize("bits,channels,mode", [(16, 1, "indep"), (24, 2, "ms"), (8, 2, "ls")])
def test_flac_crosses_between_packages(tmp_path, bits, channels, mode):
    rng = np.random.default_rng(bits)
    t = np.arange(7_000) / 32000
    x = 0.4 * np.sin(2 * np.pi * 330 * t)[None] + 0.05 * rng.standard_normal((channels, t.size))
    x = x.astype(np.float32)
    jax_flac.save_flac(str(tmp_path / "jax.flac"), x, 32000, bits, stereo_mode=mode)
    flac.save_flac(str(tmp_path / "port.flac"), x, 32000, bits, stereo_mode=mode)
    assert (tmp_path / "jax.flac").read_bytes() == (tmp_path / "port.flac").read_bytes()
    got, sr = load_audio(str(tmp_path / "jax.flac"))  # dispatch on "fLaC"
    want, want_sr = jax_load_audio(str(tmp_path / "jax.flac"))
    assert sr == want_sr == 32000 and got.shape == (channels, t.size)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).max() <= 1.0 / 2 ** (bits - 1)


def _mp3_bytes() -> bytes:
    # ID3v2 tag of 10 padding bytes, then an MPEG-1 layer III frame header:
    # 128 kbit/s, 44.1 kHz, joint stereo
    return b"ID3\x03\x00\x00\x00\x00\x00\x0a" + bytes(10) + b"\xff\xfb\x90\x44" + bytes(64)


def _ogg_bytes(codec: bytes) -> bytes:
    ident = codec + bytes([0, 0, 0, 0, 2]) + struct.pack("<I", 22050) + bytes(16)
    return b"OggS" + bytes(22) + bytes([1, len(ident)]) + ident


def test_lossy_headers_parse_as_in_jax():
    assert lossy.parse_mp3_info(_mp3_bytes()) == jax_lossy.parse_mp3_info(_mp3_bytes()) == (44100, 2)
    vorbis = _ogg_bytes(b"\x01vorbis")
    assert lossy.parse_ogg_info(vorbis) == jax_lossy.parse_ogg_info(vorbis) == (22050, 2)
    for mod in (lossy, jax_lossy):
        with pytest.raises(ValueError, match="not Vorbis"):
            mod.parse_ogg_info(_ogg_bytes(b"OpusHead"))
        with pytest.raises(ValueError, match="no valid MPEG"):
            mod.parse_mp3_info(b"\xff\xff\xff\xff" + bytes(8))


@pytest.mark.parametrize("name,data,match", [
    ("a.mp3", b"ID3\x03\x00\x00\x00\x00\x00\x00" + bytes(32), "no valid MPEG"),
    ("a.ogg", _ogg_bytes(b"OpusHead"), "not Vorbis"),
    ("a.bin", b"JUNK" + bytes(32), "Unsupported audio container"),
])
def test_load_audio_dispatches_as_in_jax(tmp_path, name, data, match):
    """mp3 and Ogg reach the lossy loaders, which parse the header before
    any decoder is asked; other containers raise."""
    path = tmp_path / name
    path.write_bytes(data)
    for load in (load_audio, jax_load_audio):
        with pytest.raises(ValueError, match=match):
            load(str(path))


def _write_pcm(path, x: np.ndarray, sr: int, width: int) -> None:
    pcm = np.clip(np.rint(x.T * 2 ** (8 * width - 1)), -(2 ** (8 * width - 1)), 2 ** (8 * width - 1) - 1)
    raw = np.ascontiguousarray(pcm, "<i4").view(np.uint8).reshape(-1, 4)[:, :width].tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


@pytest.mark.parametrize("channels,sr,width", [(1, 44_100, 2), (2, 32_000, 3)])
def test_wav_info_reads_the_header(tmp_path, channels, sr, width):
    x = (0.3 * np.random.default_rng(sr).standard_normal((channels, 12_345))).astype(np.float32)
    path = tmp_path / "a.wav"
    _write_pcm(path, x, sr, width)
    assert wav_info(str(path)) == (sr, channels, 12_345)
    audio, got_sr = load_wav(str(path))
    assert got_sr == sr and audio.shape == (channels, 12_345)
    from conette_tpu.native import loader as native

    if native.is_available():
        assert native.wav_info(str(path)) == wav_info(str(path))
    flac.save_flac(str(tmp_path / "a.flac"), x, sr)
    with pytest.raises(ValueError, match="RIFF"):
        wav_info(str(tmp_path / "a.flac"))


# ------------------------------------------------- reference torch checkpoint
CORPUS = ["a bird sings loudly", "an engine hums near a road", "people talk and a dog barks"]


def _oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def reference_state(enc, model, extra) -> dict[str, np.ndarray]:
    """The reference's state-dict layout of numpy trees (the converter's
    inverse), with the legacy ``gamma`` name for the layer scales."""
    s = {}
    e = "preprocessor.encoder."
    for k, v in enc["bn0"].items():
        s[f"{e}bn0.{k}"] = v
    s[e + "downsample_layers.0.0.weight"] = _oihw(enc["stem"]["conv"]["weight"])
    s[e + "downsample_layers.0.0.bias"] = enc["stem"]["conv"]["bias"]
    s[e + "downsample_layers.0.1.weight"] = enc["stem"]["norm"]["weight"]
    s[e + "downsample_layers.0.1.bias"] = enc["stem"]["norm"]["bias"]
    for i, ds in enumerate(enc["downsample"], 1):
        s[f"{e}downsample_layers.{i}.0.weight"] = ds["norm"]["weight"]
        s[f"{e}downsample_layers.{i}.0.bias"] = ds["norm"]["bias"]
        s[f"{e}downsample_layers.{i}.1.weight"] = _oihw(ds["conv"]["weight"])
        s[f"{e}downsample_layers.{i}.1.bias"] = ds["conv"]["bias"]
    for i, stage in enumerate(enc["stages"]):
        for j, blk in enumerate(stage):
            p = f"{e}stages.{i}.{j}."
            s[p + "dwconv.weight"] = _oihw(blk["dwconv"]["weight"])
            s[p + "dwconv.bias"] = blk["dwconv"]["bias"]
            s[p + "norm.weight"] = blk["norm"]["weight"]
            s[p + "norm.bias"] = blk["norm"]["bias"]
            for name in ("pwconv1", "pwconv2"):
                s[p + name + ".weight"] = np.ascontiguousarray(blk[name]["weight"].T)
                s[p + name + ".bias"] = blk[name]["bias"]
            s[p + "gamma"] = blk["scale"]
    s[e + "norm.weight"] = enc["norm"]["weight"]
    s[e + "norm.bias"] = enc["norm"]["bias"]
    s[e + "head_audioset.weight"] = np.ascontiguousarray(enc["head_audioset"]["weight"].T)
    s[e + "head_audioset.bias"] = enc["head_audioset"]["bias"]
    s["model.projection.2.weight"] = np.ascontiguousarray(model["projection"]["weight"].T)
    s["model.projection.2.bias"] = model["projection"]["bias"]
    d = "model.decoder."
    s[d + "emb_layer.weight"] = model["decoder"]["emb"]["weight"]
    s[d + "classifier.weight"] = np.ascontiguousarray(model["decoder"]["classifier"]["weight"].T)
    s[d + "classifier.bias"] = model["decoder"]["classifier"]["bias"]
    for i, layer in enumerate(model["decoder"]["layers"]):
        p = f"{d}layers.{i}."
        for tname, key in (("self_attn", "self_attn"), ("multihead_attn", "cross_attn")):
            a = layer[key]
            s[p + tname + ".in_proj_weight"] = np.concatenate([a[n]["weight"].T for n in "qkv"])
            s[p + tname + ".in_proj_bias"] = np.concatenate([a[n]["bias"] for n in "qkv"])
            s[p + tname + ".out_proj.weight"] = np.ascontiguousarray(a["out"]["weight"].T)
            s[p + tname + ".out_proj.bias"] = a["out"]["bias"]
        for name in ("linear1", "linear2"):
            s[p + name + ".weight"] = np.ascontiguousarray(layer[name]["weight"].T)
            s[p + name + ".bias"] = layer[name]["bias"]
        for name in ("norm1", "norm2", "norm3"):
            s[p + name + ".weight"] = layer[name]["weight"]
            s[p + name + ".bias"] = layer[name]["bias"]
    s["_extra_state_"] = np.frombuffer(pickle.dumps(extra), np.uint8).copy()
    return {k: np.asarray(v) for k, v in s.items()}


@pytest.fixture(scope="module")
def checkpoint():
    """A narrow random JAX model as a reference-layout state dict whose
    ``_extra_state_`` carries the fitted tokenizer's state."""
    tok = JaxTokenizer()
    tok.fit(CORPUS)
    for name in ("clotho", "audiocaps", "macs", "wavcaps_audioset_sl", "wavcaps_bbc_sound_effects",
                 "wavcaps_freesound", "wavcaps_soundbible"):
        tok.add_special_token(f"<bos_{name}>")
    enc = jax_convnext_init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    rng = np.random.default_rng(0)
    for stage in enc["stages"]:
        for block in stage:
            block["scale"] = (rng.standard_normal(block["scale"].shape) * 0.1).astype(np.float32)
    cfg = JaxConetteConfig(vocab_size=tok.get_vocab_size(), proj_in=128, d_model=32, nhead=2,
                           num_decoder_layers=2, dim_feedforward=64)
    model = jax_conette_init(jax.random.PRNGKey(1), cfg)
    enc, model = jax.tree.map(np.asarray, (enc, model))
    return reference_state(enc, model, {"tokenizers.tokenizer": tok.get_txt_state()})


def test_convert_torch_checkpoint_matches_jax(checkpoint):
    state = {k: torch.from_numpy(v.copy()) for k, v in checkpoint.items()}
    got_enc, got_model, got_extra = convert_torch_checkpoint(state)
    want_enc, want_model, want_extra = jax_convert(state)
    for got, want in ((got_enc, want_enc), (got_model, want_model)):
        fg, fw = flatten_pytree(got), flatten_pytree(want)
        assert fg.keys() == fw.keys()
        for k in fg:
            assert fg[k].dtype == fw[k].dtype and fg[k].tobytes() == fw[k].tobytes(), k
    assert got_extra == want_extra
    assert got_enc["stages"][0][0]["scale"].tobytes() == checkpoint[
        "preprocessor.encoder.stages.0.0.gamma"].tobytes()


def test_remap_unpickler_blocks_arbitrary_globals():
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(pickle.UnpicklingError, match="Blocked unpickling"):
        loads_remapped(pickle.dumps({"x": Evil()}))


def test_remap_unpickler_blocks_a_pickle_nested_in_torch_storage(tmp_path):
    """``torch.storage._load_from_bytes`` unpickles the bytes it is given
    with ``weights_only=False``: an ``_extra_state_`` that hides an
    ``os.system`` pickle in it must be refused before anything runs, both
    alone and through ``convert_torch_checkpoint``."""
    marker = tmp_path / "ran"

    class Inner:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    class Outer:
        def __reduce__(self):
            return (torch.storage._load_from_bytes, (pickle.dumps(Inner()),))

    payload = pickle.dumps({"tokenizers.tokenizer": Outer()})
    assert b"_load_from_bytes" in payload
    with pytest.raises(pickle.UnpicklingError, match="torch.storage._load_from_bytes"):
        loads_remapped(payload)
    assert extract_extra_state({"_extra_state_": np.frombuffer(payload, np.uint8)}) is None
    assert not marker.exists()


@pytest.mark.parametrize("fname", ["pytorch_model.bin", "model.safetensors"])
def test_from_pretrained_torch_checkpoint_captions_like_jax(tmp_path, checkpoint, fname):
    CoNeTTEConfig(d_model=32, nhead=2, num_decoder_layers=2, dim_feedforward=64, beam_size=3,
                  min_pred_size=1, max_pred_size=8).save_pretrained(str(tmp_path))
    if fname.endswith(".bin"):
        torch.save({k: torch.from_numpy(v.copy()) for k, v in checkpoint.items()}, tmp_path / fname)
    else:
        from safetensors.numpy import save_file

        save_file(checkpoint, str(tmp_path / fname))
    jax_model = JaxModel.from_pretrained(str(tmp_path))
    port = CoNeTTEModel.from_pretrained(str(tmp_path), device="cpu")
    assert port.tokenizer.get_vocab() == jax_model.tokenizer.get_vocab()
    assert port.tokenizer.is_fit() and port.forbid_rep_mask is not None
    rng = np.random.default_rng(4)
    clips = [(rng.standard_normal(32000) * 0.1).astype(np.float32),
             (rng.standard_normal(21000) * 0.1).astype(np.float32)]
    tasks = ["clotho", "audiocaps"]
    want = jax_model(clips, sr=32000, task=tasks)
    got = port(clips, sr=32000, task=tasks)
    assert got["cands"] == want["cands"]
    np.testing.assert_array_equal(got["preds"], np.asarray(want["preds"]))
    np.testing.assert_allclose(got["lprobs"], np.asarray(want["lprobs"]), atol=1e-5)


def test_load_audio_reads_wav_as_in_jax(tmp_path):
    x = (0.2 * np.random.default_rng(1).standard_normal(5000)).astype(np.float32)
    save_wav(str(tmp_path / "a.wav"), x, 16000)
    got, sr = load_audio(str(tmp_path / "a.wav"))
    want, want_sr = jax_load_audio(str(tmp_path / "a.wav"))
    assert sr == want_sr == 16000
    np.testing.assert_array_equal(got, want)
