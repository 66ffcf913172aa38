"""Special-token constants.

Semantics match the reference (``src/conette/tokenization/constants.py:6-15``):
the order of ``SPECIAL_TOKENS`` defines the ids assigned on ``fit``:
``<pad>=0, <bos>=1, <eos>=2, <unk>=3``.
"""

BOS_TOKEN = "<bos>"
EOS_TOKEN = "<eos>"
PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"

# Order matters: ids of the special tokens in trainable tokenizers.
SPECIAL_TOKENS = (PAD_TOKEN, BOS_TOKEN, EOS_TOKEN, UNK_TOKEN)
