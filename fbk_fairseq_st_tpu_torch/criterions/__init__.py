from .base import Criterion
from .cross_entropy_acc import CrossEntropyWithAccCriterion
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
from .label_smoothed_cross_entropy_ctx_reg import LabelSmoothedCrossEntropyCtxRegCriterion

CRITERIONS = {
    "cross_entropy": CrossEntropyCriterion,
    "cross_entropy_acc": CrossEntropyWithAccCriterion,
    "label_smoothed_cross_entropy": LabelSmoothedCrossEntropyCriterion,
    "label_smoothed_cross_entropy_ctxreg": LabelSmoothedCrossEntropyCtxRegCriterion,
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
    "CrossEntropyWithAccCriterion",
    "CTCCriterion",
    "CTCMultiLoss",
    "Criterion",
    "LabelSmoothedCrossEntropyCriterion",
    "LabelSmoothedCrossEntropyCtxRegCriterion",
    "label_smoothed_nll_from_logits",
    "label_smoothed_nll_loss",
]
