from conette_torch.metrics.all_metrics import AllMetrics
from conette_torch.metrics.cross_referencing import compute_cross_referencing
from conette_torch.metrics.functional.bleu import bleu
from conette_torch.metrics.functional.cider_d import cider_d
from conette_torch.metrics.functional.diversity import (
    diversity,
    new_words,
    text_stats,
    vocab_size,
)
from conette_torch.metrics.functional.rouge_l import rouge_l

__all__ = [
    "AllMetrics",
    "bleu",
    "cider_d",
    "rouge_l",
    "diversity",
    "text_stats",
    "new_words",
    "vocab_size",
    "compute_cross_referencing",
]
