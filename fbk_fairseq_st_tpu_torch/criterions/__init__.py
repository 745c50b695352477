from .base import Criterion
from .label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    label_smoothed_nll_from_logits,
    label_smoothed_nll_loss,
)

CRITERIONS = {"label_smoothed_cross_entropy": LabelSmoothedCrossEntropyCriterion}

# Criterions of the JAX registry that later slices port.
NOT_YET = {
    "ctc_multi_loss": "ops/ctc.py and criterions/ctc.py (ROADMAP Queue A6)",
    "ctc_loss": "ops/ctc.py and criterions/ctc.py (ROADMAP Queue A6)",
}

__all__ = [
    "CRITERIONS",
    "Criterion",
    "LabelSmoothedCrossEntropyCriterion",
    "label_smoothed_nll_from_logits",
    "label_smoothed_nll_loss",
]
