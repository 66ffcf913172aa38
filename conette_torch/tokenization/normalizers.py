"""Sentence normalizers applied before encoding and after decoding.

Behavioral parity with the reference normalizer pipeline
(``src/conette/tokenization/normalizers.py:13-213``): each normalizer is a
pure string→string transform; pipelines are ordered lists. The concrete
pre-encode pipeline is CleanSpecialTokens → ReplaceRarePuncChars →
[Lowercase] → CleanPunctuation → CleanDoubleSpaces → Strip, and the
post-decode pipeline is CleanSpecialTokens → CleanSpacesBeforePunctuation →
Strip → CleanDoubleSpaces → CleanHyphenSpaces → [Lowercase]
(``aac_tokenizer.py:908-963``).
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Mapping

from conette_torch.tokenization.constants import EOS_TOKEN, SPECIAL_TOKENS

__all__ = [
    "Normalizer",
    "NormalizerList",
    "Lowercase",
    "Replace",
    "Strip",
    "CleanDoubleSpaces",
    "ReplaceRarePuncChars",
    "CleanPunctuation",
    "CleanSpacesBeforePunctuation",
    "CleanSpecialTokens",
    "CleanHyphenSpaces",
    "TruncAtEos",
    "get_pre_encoding_normalizers",
    "get_post_decoding_normalizers",
]


class Normalizer:
    """Base class: normalizes batches of sentences."""

    def normalize_batch(self, sentences: Iterable[str]) -> list[str]:
        raise NotImplementedError

    def normalize_single(self, sentence: str) -> str:
        return self.normalize_batch([sentence])[0]

    def get_config(self) -> dict[str, Any]:
        return {"type": self.__class__.__name__}

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "Normalizer":
        return cls()

    def __call__(self, sentences: Iterable[str]) -> list[str]:
        return self.normalize_batch(sentences)


class NormalizerList(Normalizer, list):
    """Applies a list of normalizers sequentially."""

    def __init__(self, *normalizers: Normalizer) -> None:
        Normalizer.__init__(self)
        list.__init__(self, normalizers)

    def normalize_batch(self, sentences: Iterable[str]) -> list[str]:
        out = list(sentences)
        for normalizer in self:
            out = normalizer.normalize_batch(out)
        return out

    def get_config(self) -> dict[str, Any]:
        return {
            "type": self.__class__.__name__,
            "normalizers": [n.get_config() for n in self],
        }


class Lowercase(Normalizer):
    def normalize_batch(self, sentences: Iterable[str]) -> list[str]:
        return [s.lower() for s in sentences]


class Replace(Normalizer):
    def __init__(self, pattern: str, repl: str) -> None:
        super().__init__()
        self._pattern = re.compile(pattern)
        self._repl = repl

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "Replace":
        return Replace(config["pattern"], config["repl"])

    def get_config(self) -> dict[str, Any]:
        return {
            "type": self.__class__.__name__,
            "pattern": self._pattern.pattern,
            "repl": self._repl,
        }

    def normalize_batch(self, sentences: Iterable[str]) -> list[str]:
        return [self._pattern.sub(self._repl, s) for s in sentences]


class Strip(Normalizer):
    def normalize_batch(self, sentences: Iterable[str]) -> list[str]:
        return [s.strip() for s in sentences]


class CleanDoubleSpaces(Replace):
    def __init__(self) -> None:
        super().__init__(" +", " ")

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "CleanDoubleSpaces":
        return CleanDoubleSpaces()

    def get_config(self) -> dict[str, Any]:
        return {"type": self.__class__.__name__}


class ReplaceRarePuncChars(NormalizerList):
    """Maps typographic quote/punctuation variants onto ASCII equivalents."""

    def __init__(self) -> None:
        super().__init__(
            Replace(r"“", '"'),
            Replace(r"”", '"'),
            Replace(r"`", "'"),
            Replace(r"’", "'"),
            Replace(r";", ","),
            Replace(r"…", "..."),
            Replace(r"&", " & "),
        )


class CleanPunctuation(Replace):
    # Same character class as the reference (normalizers.py:127).
    PUNC_PATTERN: str = r"[,.!?;:\"“”’`\(\)\{\}\[\]\*\×\-#/+_~ʘ\\/]"

    def __init__(self, pattern: str | None = None) -> None:
        if pattern is None:
            pattern = CleanPunctuation.PUNC_PATTERN
        super().__init__(pattern, " ")

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "CleanPunctuation":
        return CleanPunctuation(config.get("pattern"))

    def get_config(self) -> dict[str, Any]:
        return {
            "type": self.__class__.__name__,
            "pattern": self._pattern.pattern,
        }


class CleanSpacesBeforePunctuation(Replace):
    def __init__(self) -> None:
        super().__init__(r'\s+([,.!?;:"\'])', r"\1")

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "CleanSpacesBeforePunctuation":
        return CleanSpacesBeforePunctuation()

    def get_config(self) -> dict[str, Any]:
        return {"type": self.__class__.__name__}


class CleanSpecialTokens(Replace):
    """Removes <bos>, <eos>, <pad>, <unk> substrings."""

    def __init__(self, special_tokens: Iterable[str] = SPECIAL_TOKENS) -> None:
        super().__init__(f"({'|'.join(special_tokens)})", "")

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "CleanSpecialTokens":
        return CleanSpecialTokens()

    def get_config(self) -> dict[str, Any]:
        return {"type": self.__class__.__name__}


class CleanHyphenSpaces(Replace):
    def __init__(self) -> None:
        super().__init__(r"(\s*)(\-)(\s*)", r"\2")

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "CleanHyphenSpaces":
        return CleanHyphenSpaces()

    def get_config(self) -> dict[str, Any]:
        return {"type": self.__class__.__name__}


class TruncAtEos(Normalizer):
    def __init__(self, eos: str = EOS_TOKEN) -> None:
        super().__init__()
        self._eos = eos

    def normalize_batch(self, sentences: Iterable[str]) -> list[str]:
        out = []
        for s in sentences:
            if self._eos in s:
                s = s[: s.index(self._eos)]
            out.append(s)
        return out

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "TruncAtEos":
        return TruncAtEos(config["eos"])

    def get_config(self) -> dict[str, Any]:
        return {"type": self.__class__.__name__, "eos": self._eos}


def get_pre_encoding_normalizers(
    lowercase: bool, punctuation_mode: str
) -> list[Normalizer]:
    """Pre-encode pipeline (parity: ``aac_tokenizer.py:908-950``)."""
    normalizers: list[Normalizer] = [CleanSpecialTokens(), ReplaceRarePuncChars()]
    if lowercase:
        normalizers.append(Lowercase())

    if punctuation_mode == "remove":
        normalizers.append(CleanPunctuation())
    elif punctuation_mode == "keep_comma":
        pattern = CleanPunctuation.PUNC_PATTERN.replace(",", "")
        normalizers.append(CleanPunctuation(pattern))
        normalizers.append(CleanSpacesBeforePunctuation())
    elif punctuation_mode == "keep_comma_dot":
        pattern = CleanPunctuation.PUNC_PATTERN.replace(",", "").replace(".", "")
        normalizers.append(CleanPunctuation(pattern))
        normalizers.append(CleanSpacesBeforePunctuation())
    elif punctuation_mode == "keep_hyphen":
        pattern = CleanPunctuation.PUNC_PATTERN.replace(r"\-", "")
        normalizers.append(CleanPunctuation(pattern))
    elif punctuation_mode == "keep":
        normalizers.append(CleanSpacesBeforePunctuation())
    else:
        raise ValueError(
            f"Invalid argument {punctuation_mode=}. "
            "(expected one of ('remove', 'keep_comma', 'keep', 'keep_hyphen'))"
        )

    normalizers += [CleanDoubleSpaces(), Strip()]
    return normalizers


def get_post_decoding_normalizers(lowercase: bool) -> list[Normalizer]:
    """Post-decode pipeline (parity: ``aac_tokenizer.py:953-963``)."""
    normalizers: list[Normalizer] = [
        CleanSpecialTokens(),
        CleanSpacesBeforePunctuation(),
        Strip(),
        CleanDoubleSpaces(),
        CleanHyphenSpaces(),
    ]
    if lowercase:
        normalizers.append(Lowercase())
    return normalizers
