from .adaptive_loss import AdaptiveLoss
from .asg import ASGCriterion
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
from .label_smoothed_cross_entropy_with_alignment import LabelSmoothedCrossEntropyCriterionWithAlignment
from .vocab_parallel_cross_entropy import VocabParallelCrossEntropyCriterion

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
    "asg_loss": ASGCriterion,
    "vocab_parallel_cross_entropy": VocabParallelCrossEntropyCriterion,
    "adaptive_loss": AdaptiveLoss,
    "label_smoothed_cross_entropy_with_alignment": LabelSmoothedCrossEntropyCriterionWithAlignment,
}

# the ROADMAP Queue A item of each JAX criterion the port has not, where it
# is not item 9's (with its model family)
_NOT_PORTED_ITEMS = {}


def roadmap_item(name: str) -> str:
    """Where the ROADMAP queues the criterion ``name``, which the port lacks."""
    return f"ROADMAP Queue A item {_NOT_PORTED_ITEMS.get(name, '9')}"

__all__ = [
    "ASGCriterion",
    "AdaptiveLoss",
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
    "LabelSmoothedCrossEntropyCriterionWithAlignment",
    "LabelSmoothedCrossEntropyCtxRegCriterion",
    "label_smoothed_nll_from_logits",
    "label_smoothed_nll_loss",
    "roadmap_item",
    "VocabParallelCrossEntropyCriterion",
]
