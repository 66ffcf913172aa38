"""AACTokenizer — the caption tokenizer facade.

Behavioral parity with the reference ``AACTokenizer``
(``src/conette/tokenization/aac_tokenizer.py:34-963``): normalizer pipeline →
word tokenizer → stoi/itos vocabulary, with ``<pad>=0, <bos>=1, <eos>=2,
<unk>=3`` fit-order ids, task special tokens appended via
``add_special_token``, padding modes (None | int | "batch" | "corpus"), and
txt/bin state (de)serialization including migration of reference states
(version 1.0.0 → 2.2.0, ``<sos>``→``<bos>`` rename; ``aac_tokenizer.py:755-817``).

Host-side pure Python: encode outputs are numpy int32 arrays, converted to
tensors by the caller.
"""

from __future__ import annotations

import json
import logging
import pickle
import sys
from typing import Any, Iterable, Mapping, Sequence, Union

import numpy as np

from conette_torch.tokenization.normalizers import (
    CleanSpecialTokens,
    get_post_decoding_normalizers,
    get_pre_encoding_normalizers,
)
from conette_torch.tokenization.word_tokenizers import (
    StrTokenizer,
    word_tokenizer_factory,
)

pylog = logging.getLogger(__name__)

PaddingMode = Union[None, int, str]


class AACTokenizer:
    PUNCTUATION_MODES = ("remove", "keep_comma", "keep", "keep_hyphen")
    OUT_TYPES: tuple[str, ...] = ("str", "int", "np", "Tensor", "pt")
    VERSION = "2.2.0"

    def __init__(
        self,
        level: str = "word",
        lowercase: bool = True,
        punctuation_mode: str = "remove",
        normalize: bool = True,
        **kwargs: Any,
    ) -> None:
        hparams = {
            "level": level,
            "lowercase": lowercase,
            "punctuation_mode": punctuation_mode,
            "normalize": normalize,
        } | kwargs

        self._hparams = hparams
        self._pre_encoding_normalizers = get_pre_encoding_normalizers(
            lowercase, punctuation_mode
        )
        self._post_decoding_normalizers = get_post_decoding_normalizers(lowercase)
        self._tokenizer: StrTokenizer = word_tokenizer_factory(level=level, **kwargs)
        self._normalize = normalize

        self._added_special_tokens: list[str] = []
        self._max_sentence_size = -1
        self._min_sentence_size = sys.maxsize
        self._n_sentences_fit = 0
        self._itos: dict[int, str] = {}
        self._stoi: dict[str, int] = {}
        self._vocab: dict[str, int] = {}

    # --- Properties
    @property
    def bos_token(self) -> str:
        return self._tokenizer.bos_token

    @property
    def eos_token(self) -> str:
        return self._tokenizer.eos_token

    @property
    def pad_token(self) -> str:
        return self._tokenizer.pad_token

    @property
    def unk_token(self) -> str:
        return self._tokenizer.unk_token

    @property
    def bos_token_id(self) -> int:
        return self.token_to_id(self.bos_token)

    @property
    def eos_token_id(self) -> int:
        return self.token_to_id(self.eos_token)

    @property
    def pad_token_id(self) -> int:
        return self.token_to_id(self.pad_token)

    @property
    def unk_token_id(self) -> int:
        return self.token_to_id(self.unk_token)

    @property
    def special_tokens(self) -> list[str]:
        return self._tokenizer.special_tokens

    @property
    def special_tokens_ids(self) -> list[int]:
        return [self.token_to_id(t) for t in self.special_tokens]

    @property
    def added_special_tokens(self) -> list[str]:
        return self._added_special_tokens

    @property
    def separator(self) -> str:
        return self._tokenizer.separator

    # --- Fit & vocab
    def fit(self, sentences: Iterable[str]) -> tuple[list, dict, dict, dict]:
        if self._n_sentences_fit > 0:
            raise RuntimeError(
                f"Cannot fit {self.__class__.__name__} twice. "
                f"(found n_sentences_fit={self._n_sentences_fit} > 0)"
            )
        if self.is_normalization_enabled():
            for normalizer in self._pre_encoding_normalizers:
                sentences = normalizer.normalize_batch(sentences)

        encoded, itos, stoi, vocab = self._tokenizer.fit(sentences)

        self._itos |= itos
        self._stoi |= stoi
        self._vocab |= vocab

        if len(encoded) > 0:
            lens = [len(s) for s in encoded]
            self._max_sentence_size = max(self._max_sentence_size, max(lens))
            self._min_sentence_size = min(self._min_sentence_size, min(lens))
            self._n_sentences_fit += len(encoded)
        return encoded, itos, stoi, vocab

    def add_special_token(self, token: str, count: int = 0) -> int:
        """Appends a new special token (used for ``<bos_{task}>`` ids).
        Parity: ``aac_tokenizer.py:302-316``."""
        if token in self._vocab:
            raise ValueError(f"Invalid argument {token=}. (already in vocab)")
        idx_max = max(max(self._itos.keys()), max(self._stoi.values()))
        new_token_id = idx_max + 1
        self._itos[new_token_id] = token
        self._stoi[token] = new_token_id
        self._vocab[token] = count
        self._added_special_tokens.append(token)
        return new_token_id

    def clear(self) -> None:
        self._max_sentence_size = -1
        self._min_sentence_size = sys.maxsize
        self._n_sentences_fit = 0
        self._itos = {}
        self._stoi = {}
        self._vocab = {}

    def get_vocab(self) -> dict[str, int]:
        return self._vocab

    def get_counts(self) -> dict[str, int]:
        return self._vocab

    def get_vocab_size(self) -> int:
        return len(self._vocab)

    def get_hparams(self) -> dict[str, Any]:
        return self._hparams

    def get_max_sentence_size(self) -> int:
        return self._max_sentence_size

    def get_min_sentence_size(self) -> int:
        return self._min_sentence_size

    def get_backend(self) -> str:
        return self._tokenizer.get_backend()

    def get_level(self) -> str:
        return self._tokenizer.get_level()

    def has(self, token: str) -> bool:
        return token in self._vocab

    def is_fit(self) -> bool:
        return self._n_sentences_fit > 0

    def is_normalization_enabled(self) -> bool:
        return self._normalize

    def id_to_token(self, index: int) -> str:
        index = int(index)
        return self._itos[index]

    def token_to_id(self, token: str, default: None | str | int = None) -> int:
        if default is ...:
            default = self.unk_token_id
        if default is None:
            return self._stoi[token]
        if isinstance(default, str):
            if default in self._stoi:
                return self._stoi.get(token, self._stoi[default])
            raise KeyError(
                f"Invalid default value {default=}. (not found in stoi map with "
                f"vocab_size={self.get_vocab_size()})"
            )
        if isinstance(default, int):
            return self._stoi.get(token, default)
        raise TypeError(
            f"Invalid argument type {type(default)=}. (expected None, str or int)"
        )

    # --- Tokenize / encode
    def tokenize_batch(
        self,
        sentences: Iterable[str],
        add_bos_eos: bool = False,
        padding: PaddingMode = None,
    ) -> list[list[str]]:
        if self.is_normalization_enabled():
            for normalizer in self._pre_encoding_normalizers:
                sentences = normalizer.normalize_batch(sentences)

        tokenized = self._tokenizer.tokenize_batch(sentences)

        if add_bos_eos:
            tokenized = [[self.bos_token] + s + [self.eos_token] for s in tokenized]

        if isinstance(padding, str):
            if padding == "batch":
                padding = max(map(len, tokenized)) if len(tokenized) > 0 else 0
            elif padding == "corpus":
                padding = self._max_sentence_size + (2 if add_bos_eos else 0)
            else:
                raise ValueError(
                    f"Invalid argument {padding=}. "
                    "(expected one of (None, 'batch', 'corpus', int))"
                )
        elif padding is None:
            padding = 0

        if padding > 0:
            tokenized = [s + [self.pad_token] * (padding - len(s)) for s in tokenized]
        return tokenized

    def tokenize_single(
        self, sentence: str, add_bos_eos: bool = False, padding: PaddingMode = None
    ) -> list[str]:
        return self.tokenize_batch([sentence], add_bos_eos, padding)[0]

    def encode_batch(
        self,
        sentences: Iterable[str],
        add_bos_eos: bool = True,
        out_type: str = "np",
        default: None | str | int = None,
        padding: PaddingMode = None,
        dtype: Any = np.int32,
    ) -> Union[np.ndarray, list]:
        """Encode sentences to token-id arrays.

        ``out_type``: "str" (tokens), "int" (python ids) or "np"/"Tensor"/"pt"
        (numpy array when lengths are uniform, else list of arrays).
        ``default``: id for out-of-vocabulary tokens — ``None`` (the
        reference's ACTUAL signature default, ``aac_tokenizer.py:395`` —
        its docstring claims ``...`` but the code raises) raises;
        ``...`` maps OOV to ``<unk>``. The reference's callers pass unk
        explicitly on the eval paths (``hdf.py:339-349``) and leave the
        raising default on the train path.
        Parity contract: ``aac_tokenizer.py:390-472``.
        """
        tokenized = self.tokenize_batch(sentences, add_bos_eos, padding)
        if out_type == "str":
            return tokenized
        if out_type not in ("int", "np", "Tensor", "pt"):
            raise ValueError(
                f"Invalid argument {out_type=}. (expected one of {self.OUT_TYPES})"
            )
        if default is None:
            invalid = [
                tok for sent in tokenized for tok in sent if tok not in self._stoi
            ]
            if len(invalid) > 0:
                raise ValueError(
                    f"Invalid sentence tokens (found tokens {invalid} not in "
                    f"vocabulary, {add_bos_eos=}, {out_type=}, {default=})."
                )
        ids = [[self.token_to_id(tok, default) for tok in sent] for sent in tokenized]
        if out_type == "int":
            return ids
        if len(ids) == 0 or all(len(s) == len(ids[0]) for s in ids):
            return np.asarray(ids, dtype=dtype).reshape(len(ids), -1)
        return [np.asarray(s, dtype=dtype) for s in ids]

    def encode_single(
        self,
        sentence: str,
        add_bos_eos: bool = True,
        out_type: str = "np",
        default: None | str | int = None,
        padding: PaddingMode = None,
        dtype: Any = np.int32,
    ) -> np.ndarray:
        return self.encode_batch(
            [sentence], add_bos_eos, out_type, default, padding, dtype
        )[0]

    def encode_rec(
        self,
        nested_sentences: Union[str, Iterable],
        add_bos_eos: bool = True,
        out_type: str = "np",
        default: None | str | int = None,
        padding: PaddingMode = None,
        dtype: Any = np.int32,
    ) -> Any:
        """Encode arbitrarily nested lists of sentences
        (parity: ``aac_tokenizer.py:474-539``)."""
        kwds: dict[str, Any] = dict(
            add_bos_eos=add_bos_eos,
            out_type=out_type,
            default=default,
            padding=padding,
            dtype=dtype,
        )
        if isinstance(nested_sentences, str):
            return self.encode_single(nested_sentences, **kwds)
        nested_sentences = list(nested_sentences)
        if all(isinstance(s, str) for s in nested_sentences):
            return self.encode_batch(nested_sentences, **kwds)
        out = [self.encode_rec(s, **kwds) for s in nested_sentences]
        if out_type in ("np", "Tensor", "pt"):
            if len(out) > 0 and all(
                isinstance(o, np.ndarray) and o.shape == out[0].shape for o in out
            ):
                return np.stack(out)
        return out

    # --- Decode
    def detokenize_batch(
        self,
        sentences: Iterable[Iterable[str]],
        skip_special_tokens: bool = True,
    ) -> list[str]:
        out = self._tokenizer.detokenize_batch(sentences)
        if self.is_normalization_enabled():
            for normalizer in self._post_decoding_normalizers:
                if skip_special_tokens or not isinstance(
                    normalizer, CleanSpecialTokens
                ):
                    out = normalizer.normalize_batch(out)
        return out

    def decode_batch(self, sentences: Union[np.ndarray, Iterable]) -> list[str]:
        if isinstance(sentences, np.ndarray):
            sentences = sentences.tolist()
        sentences = [list(s) for s in sentences]
        if len(sentences) == 0:
            return []
        if all(isinstance(tok, str) for sent in sentences for tok in sent):
            return self.detokenize_batch(sentences)
        if all(
            isinstance(tok, (int, np.integer)) for sent in sentences for tok in sent
        ):
            str_sentences = [
                [self.id_to_token(tok) for tok in sent] for sent in sentences
            ]
            return self.decode_batch(str_sentences)
        raise TypeError(
            "Invalid sentence type in decode_batch (expected 2d int array, "
            "list[list[str]] or list[list[int]])."
        )

    def decode_single(self, sentence: Union[np.ndarray, Sequence]) -> str:
        return self.decode_batch([sentence])[0]

    def decode_rec(self, nested: Union[np.ndarray, Iterable]) -> Union[str, list]:
        if isinstance(nested, np.ndarray):
            return self.decode_rec(nested.tolist())
        nested = list(nested)
        if _is_encoded_sentence(nested):
            return self.decode_single(nested)
        if all(_is_encoded_sentence(s) for s in nested):
            return self.decode_batch(nested)
        return [self.decode_rec(s) for s in nested]

    # --- Serialization
    def get_state(self, type_: str = "txt") -> dict[str, Any]:
        if type_ == "txt":
            return self.get_txt_state()
        if type_ == "bin":
            return self.get_bin_state()
        raise ValueError(f"Invalid argument {type_=}.")

    def set_state(self, state: Mapping[str, Any]) -> None:
        type_ = state.get("_type_", "bin")
        if type_ == "txt":
            return self.set_txt_state(state)
        if type_ == "bin":
            return self.set_bin_state(state)
        raise ValueError(f"Invalid argument {type_=}.")

    def get_txt_state(self) -> dict[str, Any]:
        tokenizer_data = {
            "hparams": self._hparams,
            "normalize": self._normalize,
            "added_special_tokens": self._added_special_tokens,
            "max_sentence_size": self._max_sentence_size,
            "min_sentence_size": self._min_sentence_size,
            "n_sentences_fit": self._n_sentences_fit,
            "itos": self._itos,
            "stoi": self._stoi,
            "vocab": self._vocab,
        }
        return {
            "_target_": f"{self.__class__.__module__}.{self.__class__.__qualname__}",
            "_version_": AACTokenizer.VERSION,
            "_type_": "txt",
            "tokenizer": tokenizer_data,
        }

    def set_txt_state(self, state: Mapping[str, Any]) -> None:
        data = state["tokenizer"]
        hparams = dict(data["hparams"])
        # Reference states carry spacy-specific hparams (model_name); the
        # word_tokenizer_factory routes/ignores them appropriately.
        hparams.pop("level", None)
        level = data["hparams"].get("level", "word")
        AACTokenizer.__init__(self, level=level, **hparams)
        self._hparams = dict(data["hparams"])
        self._normalize = data["normalize"]
        self._added_special_tokens = list(data["added_special_tokens"])
        self._max_sentence_size = data["max_sentence_size"]
        self._min_sentence_size = data["min_sentence_size"]
        self._n_sentences_fit = data["n_sentences_fit"]
        # JSON round-trips turn int keys into str: coerce back.
        self._itos = {int(k): v for k, v in data["itos"].items()}
        self._stoi = {k: int(v) for k, v in data["stoi"].items()}
        self._vocab = {k: int(v) for k, v in data["vocab"].items()}

    @classmethod
    def from_txt_state(cls, state: Mapping[str, Any]) -> "AACTokenizer":
        tokenizer = cls.__new__(cls)
        tokenizer.set_txt_state(state)
        return tokenizer

    def get_bin_state(self) -> dict[str, Any]:
        return self.get_txt_state() | {"_type_": "bin"}

    def set_bin_state(self, state: Mapping[str, Any]) -> None:
        """Accepts both this package's states and migrated reference states
        (version 1.0.0→2.2.0 key renames + ``<sos>``→``<bos>``;
        parity: ``aac_tokenizer.py:755-817``)."""
        if not isinstance(state, Mapping) or "tokenizer" not in state:
            raise TypeError(
                f"Incompatible state type {type(state)}. "
                "(expected mapping with key 'tokenizer')"
            )
        state = {k: v for k, v in state.items()}
        tok_data = dict(state["tokenizer"])
        version = state.get("_version_", "1.0.0")

        if version == "1.0.0":
            tok_data = {
                k.removeprefix("_AACTokenizer_"): v for k, v in tok_data.items()
            }
            version = "2.0.0"
        if version == "2.0.0":
            hparams = dict(tok_data.get("_hparams", tok_data.get("hparams", {})))
            if "punctuation_mode" not in hparams:
                clean_punctuation = hparams.pop("clean_punctuation", None)
                if clean_punctuation is True:
                    hparams["punctuation_mode"] = "remove"
                elif clean_punctuation is False:
                    hparams["punctuation_mode"] = "keep"
                else:
                    raise ValueError(f"Invalid value {clean_punctuation=}.")
            if "_hparams" in tok_data:
                tok_data["_hparams"] = hparams
            else:
                tok_data["hparams"] = hparams
            version = "2.1.0"
        if version == "2.1.0":
            tok_data.setdefault("_normalize", tok_data.get("normalize", True))
            tok_data.setdefault(
                "_added_special_tokens", tok_data.get("added_special_tokens", [])
            )
            version = "2.2.0"

        # Normalize reference private-attr keys ("_itos") to plain keys.
        plain = {k.lstrip("_"): v for k, v in tok_data.items()}
        stoi = dict(plain["stoi"])
        itos = {int(k): v for k, v in dict(plain["itos"]).items()}
        vocab = dict(plain["vocab"])
        if "<sos>" in stoi:
            idx = stoi.pop("<sos>")
            stoi["<bos>"] = idx
            itos[idx] = "<bos>"
            vocab["<bos>"] = vocab.pop("<sos>")

        self.set_txt_state(
            {
                "_type_": "txt",
                "_version_": version,
                "tokenizer": {
                    "hparams": dict(plain.get("hparams", {"level": "word"})),
                    "normalize": plain.get("normalize", True),
                    "added_special_tokens": plain.get("added_special_tokens", []),
                    "max_sentence_size": plain["max_sentence_size"],
                    "min_sentence_size": plain["min_sentence_size"],
                    "n_sentences_fit": plain["n_sentences_fit"],
                    "itos": itos,
                    "stoi": stoi,
                    "vocab": vocab,
                },
            }
        )

    def save_file(self, fpath: str) -> None:
        if fpath.endswith((".pkl", ".pickle")):
            with open(fpath, "wb") as file:
                pickle.dump(self, file)
        elif fpath.endswith(".json"):
            with open(fpath, "w") as file:
                json.dump(self.get_txt_state(), file)
        elif fpath.endswith(".yaml"):
            import yaml

            with open(fpath, "w") as file:
                yaml.safe_dump(self.get_txt_state(), file)
        else:
            raise ValueError(
                f"Invalid extension for {fpath=}. (expected pickle, yaml or json)"
            )

    @classmethod
    def from_file(cls, fpath: str) -> "AACTokenizer":
        if fpath.endswith((".pkl", ".pickle")):
            with open(fpath, "rb") as file:
                return pickle.load(file)
        if fpath.endswith(".json"):
            with open(fpath) as file:
                state = json.load(file)
        elif fpath.endswith(".yaml"):
            import yaml

            with open(fpath) as file:
                state = yaml.safe_load(file)
        else:
            raise ValueError(
                f"Invalid extension for {fpath=}. (expected pickle, yaml or json)"
            )
        tokenizer = cls.__new__(cls)
        tokenizer.set_txt_state(state)
        return tokenizer

    # --- Magic
    def __contains__(self, item: object) -> bool:
        return isinstance(item, str) and self.has(item)

    def __getitem__(self, token: str) -> int:
        return self.token_to_id(token)

    def __len__(self) -> int:
        return self.get_vocab_size()

    def __getstate__(self) -> dict[str, Any]:
        return self.get_state("txt")

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.set_state(state)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, AACTokenizer)
            and self.get_txt_state() == other.get_txt_state()
        )


def _is_encoded_sentence(inputs: Any) -> bool:
    return isinstance(inputs, list) and all(
        isinstance(x, (int, str, np.integer)) for x in inputs
    )
