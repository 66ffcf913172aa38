from conette_torch.tokenization.aac_tokenizer import AACTokenizer
from conette_torch.tokenization.constants import (
    BOS_TOKEN,
    EOS_TOKEN,
    PAD_TOKEN,
    SPECIAL_TOKENS,
    UNK_TOKEN,
)

__all__ = [
    "AACTokenizer",
    "BOS_TOKEN",
    "EOS_TOKEN",
    "PAD_TOKEN",
    "UNK_TOKEN",
    "SPECIAL_TOKENS",
]
