"""Word-level string tokenizers (host-side, pure Python).

The reference wires several word backends — spacy, nltk, PTB (Java), plain
python split (``src/conette/tokenization/tokenizers/``). This rebuild keeps
the same pluggable-backend design with a dependency-free default:

- ``"regex"``   — an English word tokenizer reproducing spacy
  ``en_core_web_sm``'s behavior on normalized caption text (whitespace split
  + contraction/punctuation splitting). Captions are already lowercased and
  punctuation-stripped by the normalizers, so this matches spacy on the
  domain the model actually sees.
- ``"spacy"``   — used when spacy + its model are importable; otherwise
  falls back to ``"regex"``.
- ``"python"``  — ``str.split`` on a separator.

``fit`` builds the (itos, stoi, vocab) maps with the special tokens first,
preserving the reference id assignment order
(``tokenizers/common.py:8-19``).
"""

from __future__ import annotations

import logging
import os
import re
from collections import Counter
from typing import Any, Callable, Iterable

from conette_torch.tokenization.constants import (
    BOS_TOKEN,
    EOS_TOKEN,
    PAD_TOKEN,
    SPECIAL_TOKENS,
    UNK_TOKEN,
)

pylog = logging.getLogger(__name__)


def build_mappings_and_vocab(
    encoded_sentences: list[list[str]],
    special_tokens: Iterable[str],
) -> tuple[dict[int, str], dict[str, int], dict[str, int]]:
    """Returns (itos, stoi, vocab) with special tokens first, then tokens in
    first-appearance order (insertion-ordered Counter), matching the
    reference id assignment (``tokenizers/common.py:8-19``)."""
    counts: dict[str, int] = {token: 0 for token in special_tokens}
    counts |= dict(
        Counter(token for sentence in encoded_sentences for token in sentence)
    )
    itos = {i: token for i, token in enumerate(counts.keys())}
    stoi = {token: i for i, token in enumerate(counts.keys())}
    return itos, stoi, counts


class StrTokenizer:
    """Tokenize/detokenize sentence strings. Abstract base."""

    def tokenize_batch(self, sentences: Iterable[str]) -> list[list[str]]:
        raise NotImplementedError

    def detokenize_batch(self, sentences: Iterable[Iterable[str]]) -> list[str]:
        return [" ".join(sentence) for sentence in sentences]

    def fit(self, sentences: Iterable[str]) -> tuple[list, dict, dict, dict]:
        encoded = self.tokenize_batch(sentences)
        itos, stoi, vocab = build_mappings_and_vocab(encoded, self.special_tokens)
        return encoded, itos, stoi, vocab

    def get_backend(self) -> str:
        raise NotImplementedError

    def get_level(self) -> str:
        return "word"

    def tokenize_single(self, sentence: str) -> list[str]:
        return self.tokenize_batch([sentence])[0]

    def detokenize_single(self, sentence: Iterable[str]) -> str:
        return self.detokenize_batch([sentence])[0]

    @property
    def bos_token(self) -> str:
        return BOS_TOKEN

    @property
    def eos_token(self) -> str:
        return EOS_TOKEN

    @property
    def pad_token(self) -> str:
        return PAD_TOKEN

    @property
    def unk_token(self) -> str:
        return UNK_TOKEN

    @property
    def separator(self) -> str:
        return " "

    @property
    def special_tokens(self) -> list[str]:
        return [self.pad_token, self.bos_token, self.eos_token, self.unk_token]


# English contractions split off as separate tokens, like spacy's
# tokenizer-exception table (e.g. "man's" -> ["man", "'s"]).
_CONTRACTION_RE = re.compile(
    r"(?i)(n't|'s|'re|'ve|'ll|'d|'m)$",
)
# spacy en tokenizer-exception table entries plausible in caption text
# (spacy.lang.en.tokenizer_exceptions): fused forms split at fixed points,
# "o'clock" kept whole (the suffix rule would otherwise split at the
# apostrophe). Keys lowercase — the pipeline lowercases pre-tokenization.
_EXCEPTIONS: dict[str, list[str]] = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "gotta": ["got", "ta"],
    "wanna": ["wan", "na"],
    "lemme": ["lem", "me"],
    "gimme": ["gim", "me"],
    "outta": ["out", "ta"],
    "kinda": ["kind", "a"],
    "sorta": ["sort", "a"],
    "o'clock": ["o'clock"],
}
# Punctuation characters treated as standalone tokens when attached to a word.
_EDGE_PUNCT = ",.!?;:\"'()[]{}<>…"


class RegexWordTokenizer(StrTokenizer):
    """spacy-``en_core_web_sm``-compatible word tokenizer for normalized
    caption text (whitespace split + suffix contraction + edge punctuation).
    Dependency-free replacement for ``SpacyWordTokenizer``
    (``tokenizers/spacy.py:13-58``)."""

    def __init__(self, special_tokens: Iterable[str] = SPECIAL_TOKENS) -> None:
        super().__init__()
        self._special_tokens = list(special_tokens)

    @property
    def special_tokens(self) -> list[str]:
        return list(self._special_tokens)

    def get_backend(self) -> str:
        return "regex"

    def tokenize_batch(self, sentences: Iterable[str]) -> list[list[str]]:
        return [self._tokenize(s) for s in sentences]

    def _tokenize(self, sentence: str) -> list[str]:
        tokens: list[str] = []
        for chunk in sentence.split():
            tokens.extend(self._split_chunk(chunk))
        return tokens

    def _split_chunk(self, chunk: str) -> list[str]:
        # Special tokens like <bos_clotho> pass through whole.
        if chunk.startswith("<") and chunk.endswith(">"):
            return [chunk]
        prefix: list[str] = []
        suffix: list[str] = []
        # Peel punctuation from the edges.
        while len(chunk) > 1 and chunk[0] in _EDGE_PUNCT:
            prefix.append(chunk[0])
            chunk = chunk[1:]
        while len(chunk) > 1 and chunk[-1] in _EDGE_PUNCT:
            suffix.insert(0, chunk[-1])
            chunk = chunk[:-1]
        parts: list[str] = []
        exc = _EXCEPTIONS.get(chunk)
        if exc is not None:
            parts = list(exc)
        else:
            m = _CONTRACTION_RE.search(chunk)
            if m is not None and m.start() > 0:
                parts = [chunk[: m.start()], chunk[m.start() :]]
            else:
                parts = [chunk] if chunk else []
        return prefix + parts + suffix


class SpacyWordTokenizer(StrTokenizer):
    """Uses spacy when available; behavior-parity target of the regex backend
    (reference ``tokenizers/spacy.py:13-58``)."""

    def __init__(
        self,
        model_name: str = "en_core_web_sm",
        special_tokens: Iterable[str] = SPECIAL_TOKENS,
    ) -> None:
        super().__init__()
        self._model_name = model_name
        self._special_tokens = list(special_tokens)
        import spacy  # gated import; not a baked-in dependency

        self._model = spacy.load(model_name)

    @property
    def special_tokens(self) -> list[str]:
        return list(self._special_tokens)

    def get_backend(self) -> str:
        return "spacy"

    def tokenize_batch(self, sentences: Iterable[str]) -> list[list[str]]:
        return [
            [word.text for word in self._model.tokenizer(sentence)]
            for sentence in sentences
        ]


class PythonWordTokenizer(StrTokenizer):
    """Plain separator split (reference ``LambdaTokenizer`` with str.split)."""

    def __init__(
        self,
        separator: str | None = None,
        special_tokens: Iterable[str] = SPECIAL_TOKENS,
    ) -> None:
        super().__init__()
        self._separator = separator
        self._special_tokens = list(special_tokens)

    @property
    def special_tokens(self) -> list[str]:
        return list(self._special_tokens)

    @property
    def separator(self) -> str:
        return self._separator if self._separator is not None else " "

    def get_backend(self) -> str:
        return "python"

    def tokenize_batch(self, sentences: Iterable[str]) -> list[list[str]]:
        return [s.split(self._separator) for s in sentences]


class LambdaTokenizer(StrTokenizer):
    """Wraps arbitrary tokenize/detokenize callables."""

    def __init__(
        self,
        level: str = "word",
        tokenizer: Callable[[str], list[str]] = str.split,
        detokenizer: Callable[[Iterable[str]], str] = " ".join,
        backend: str = "python",
    ) -> None:
        super().__init__()
        self._level = level
        self._tokenizer = tokenizer
        self._detokenizer = detokenizer
        self._backend = backend

    def get_backend(self) -> str:
        return self._backend

    def get_level(self) -> str:
        return self._level

    def tokenize_batch(self, sentences: Iterable[str]) -> list[list[str]]:
        return [self._tokenizer(s) for s in sentences]

    def detokenize_batch(self, sentences: Iterable[Iterable[str]]) -> list[str]:
        return [self._detokenizer(s) for s in sentences]


def word_tokenizer_factory(
    level: str = "word", backend: str = "auto", **kwargs: Any
) -> StrTokenizer:
    """Build a word tokenizer. ``backend="auto"`` prefers spacy when
    importable and falls back to the regex twin otherwise."""
    if level != "word":
        raise ValueError(f"Unsupported tokenizer {level=}. (only 'word' is wired)")

    if backend in ("auto", "spacy"):
        try:
            return SpacyWordTokenizer(**kwargs)
        except Exception as err:  # spacy or its model missing
            if backend == "spacy":
                pylog.warning(
                    f"spacy backend unavailable ({err}); falling back to 'regex'."
                )
            return RegexWordTokenizer(
                special_tokens=kwargs.get("special_tokens", SPECIAL_TOKENS)
            )
    if backend == "regex":
        return RegexWordTokenizer(
            special_tokens=kwargs.get("special_tokens", SPECIAL_TOKENS)
        )
    if backend == "python":
        return PythonWordTokenizer(**kwargs)
    if backend == "ptb":
        return PTBWordTokenizer(**kwargs)
    raise ValueError(
        f"Invalid {backend=}. "
        "(expected one of 'auto', 'spacy', 'regex', 'python', 'ptb')"
    )


class PTBWordTokenizer(StrTokenizer):
    """Stanford PTB tokenizer via the coco-caption Java jar — the reference's
    *test/metric* tokenizer (``tokenizers/ptb.py:14-51``). Gated on java +
    the jar (``CONETTE_PTB_JAR`` or the shared metrics cache); callers fall
    back to the regex backend when unavailable."""

    def __init__(self, special_tokens: Iterable[str] = SPECIAL_TOKENS) -> None:
        super().__init__()
        import shutil

        self._special_tokens = list(special_tokens)
        jar = os.environ.get("CONETTE_PTB_JAR") or os.path.expanduser(
            "~/.cache/conette_torch/aac-metrics/stanford-corenlp-3.4.1.jar"
        )
        if shutil.which("java") is None or not os.path.isfile(jar):
            raise RuntimeError(
                "PTB tokenizer requires java + stanford-corenlp jar "
                "(set CONETTE_PTB_JAR)."
            )
        self._jar = jar

    @property
    def special_tokens(self) -> list[str]:
        return list(self._special_tokens)

    def get_backend(self) -> str:
        return "ptb"

    def tokenize_batch(self, sentences: Iterable[str]) -> list[list[str]]:
        import subprocess
        import tempfile

        sentences = list(sentences)
        with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
            f.write("\n".join(s.replace("\n", " ") for s in sentences))
            tmp = f.name
        try:
            out = subprocess.run(
                [
                    "java", "-cp", self._jar,
                    "edu.stanford.nlp.process.PTBTokenizer",
                    "-preserveLines", "-lowerCase", tmp,
                ],
                capture_output=True, text=True, check=True,
            ).stdout
        finally:
            os.unlink(tmp)
        return [line.split() for line in out.splitlines()]
