"""``latency_augmented_label_smoothed_cross_entropy``.

Counterpart of ``fbk_fairseq_st_tpu/criterions/latency_augmented.py``
(reference examples/simultaneous_translation/criterions/
label_smoothed_cross_entropy_latency_augmented.py:16-76): label-smoothed
CE plus the latency penalty of the monotonic attention's expected
alignments (``ops/latency.py::latency_training_loss``): each layer's
``alpha`` from ``extra["attn_list"]``, the target pad mask of the batch's
``target`` and the source pad mask the model returns.
"""

from __future__ import annotations

from ..ops.latency import latency_training_loss
from .label_smoothed_cross_entropy import LabelSmoothedCrossEntropyCriterion


class LatencyAugmentedLabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self.latency_weight_avg = getattr(args, "latency_weight_avg", 0.0)
        self.latency_weight_var = getattr(args, "latency_weight_var", 0.0)
        self.latency_weight_avg_type = getattr(args, "latency_weight_avg_type", "differentiable_average_lagging")
        self.latency_weight_var_type = getattr(args, "latency_weight_var_type", "variance_delay")
        self.mass_preservation = getattr(args, "mass_preservation", True)
        self.average_method = getattr(args, "average_method", "weighted_average")

    @classmethod
    def add_args(cls, parser):
        LabelSmoothedCrossEntropyCriterion.add_args(parser)
        parser.add_argument("--latency-weight-avg", default=0.0, type=float, metavar="D",
                            help="Average loss weight")
        parser.add_argument("--latency-weight-var", default=0.0, type=float, metavar="D",
                            help="Variance loss weight")
        parser.add_argument("--latency-weight-avg-type", default="differentiable_average_lagging",
                            help="Statistics for Average loss type")
        parser.add_argument("--latency-weight-var-type", default="variance_delay",
                            help="Statistics for variance loss type")
        parser.add_argument("--average-method", default="weighted_average", help="Average loss type")

    def compute_loss(self, model, net_output, batch):
        loss, nll_loss = super().compute_loss(model, net_output, batch)
        extra = net_output[1]
        latency_loss = latency_training_loss(
            [item["alpha"] for item in extra["attn_list"]],
            source_padding_mask=extra.get("encoder_padding_mask"),
            target_padding_mask=batch["target"] == self.padding_idx,
            avg_weight=self.latency_weight_avg, var_weight=self.latency_weight_var,
            avg_type=self.latency_weight_avg_type, var_type=self.latency_weight_var_type,
            stay_on_last_token=self.mass_preservation, average_method=self.average_method)
        return loss + latency_loss, nll_loss
