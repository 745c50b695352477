from .base import Criterion
from .ctc import CTCCriterion, CTCMultiLoss
from .label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    label_smoothed_nll_from_logits,
    label_smoothed_nll_loss,
)

CRITERIONS = {
    "label_smoothed_cross_entropy": LabelSmoothedCrossEntropyCriterion,
    "ctc_loss": CTCCriterion,
    "ctc_multi_loss": CTCMultiLoss,
}

__all__ = [
    "CRITERIONS",
    "CTCCriterion",
    "CTCMultiLoss",
    "Criterion",
    "LabelSmoothedCrossEntropyCriterion",
    "label_smoothed_nll_from_logits",
    "label_smoothed_nll_loss",
]
