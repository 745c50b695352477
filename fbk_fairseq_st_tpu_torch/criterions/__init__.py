from .base import Criterion
from .cross_entropy_dualdecoder import CrossEntropyDualDecoder
from .cross_entropy_multi_task import CrossEntropyMultitask
from .ctc import CTCCriterion, CTCMultiLoss
from .knowledge_distillation import CrossEntropyKnowledgeDistillationCriterion
from .label_smoothed_cross_entropy import (
    CrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterion,
    label_smoothed_nll_from_logits,
    label_smoothed_nll_loss,
)

CRITERIONS = {
    "cross_entropy": CrossEntropyCriterion,
    "label_smoothed_cross_entropy": LabelSmoothedCrossEntropyCriterion,
    "ctc_loss": CTCCriterion,
    "ctc_multi_loss": CTCMultiLoss,
    "cross_entropy_dualdecoder": CrossEntropyDualDecoder,
    "cross_entropy_multi_task": CrossEntropyMultitask,
    "knowledge_distillation": CrossEntropyKnowledgeDistillationCriterion,
}

__all__ = [
    "CRITERIONS",
    "CrossEntropyCriterion",
    "CrossEntropyDualDecoder",
    "CrossEntropyKnowledgeDistillationCriterion",
    "CrossEntropyMultitask",
    "CTCCriterion",
    "CTCMultiLoss",
    "Criterion",
    "LabelSmoothedCrossEntropyCriterion",
    "label_smoothed_nll_from_logits",
    "label_smoothed_nll_loss",
]
