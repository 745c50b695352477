"""Label-smoothed cross-entropy plus the supervised alignment loss
(``transformer_align``).

Counterpart of
``fbk_fairseq_st_tpu/criterions/label_smoothed_cross_entropy_with_alignment.py``:
the label-smoothed loss, plus ``--alignment-lambda`` (0.05) times
``-sum(W * log(max(attn, 1e-9)))`` of the model's alignment attention
``extra["attn"]`` (B, T, S) against the batch's dense ``align_weights``
(1/count per target position, ``data/language_pair_dataset.py``), when the
batch has both; ``reduce_metrics`` adds ``alignment_loss`` per sample-size
unit in base 2.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .base import get_perplexity, log_scalars, sum_logs
from .label_smoothed_cross_entropy import LabelSmoothedCrossEntropyCriterion


class LabelSmoothedCrossEntropyCriterionWithAlignment(LabelSmoothedCrossEntropyCriterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self.alignment_lambda = getattr(args, "alignment_lambda", 0.05)

    @classmethod
    def add_args(cls, parser):
        LabelSmoothedCrossEntropyCriterion.add_args(parser)
        parser.add_argument("--alignment-lambda", default=0.05, type=float, metavar="D",
                            help="weight for the alignment loss")

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        net_output = model(batch, generator)
        loss, nll_loss = self.compute_loss(model, net_output, batch)
        target = batch["target"]
        ntokens = (target != self.padding_idx).sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        sample_size = nsentences if self.sentence_avg else ntokens
        logging_output = {"loss": loss.detach(), "nll_loss": nll_loss.detach(), "ntokens": ntokens,
                          "nsentences": nsentences, "sample_size": sample_size}
        attn = net_output[1].get("attn")
        weights = batch.get("align_weights")
        if attn is not None and weights is not None:
            attn = attn.float()
            if attn.dim() == 4:  # (B, H, T, S): the heads' mean
                attn = attn.mean(dim=1)
            align_loss = -(weights.float() * torch.log(attn.clamp_min(1e-9))).sum()
            loss = loss + self.alignment_lambda * align_loss
            logging_output["alignment_loss"] = align_loss.detach()
            logging_output["loss"] = loss.detach()
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """JAX :63-84."""
        loss_sum, nll_loss_sum = sum_logs(logging_outputs, "loss"), sum_logs(logging_outputs, "nll_loss")
        align_sum = sum_logs(logging_outputs, "alignment_loss")
        ntokens, sample_size = sum_logs(logging_outputs, "ntokens"), sum_logs(logging_outputs, "sample_size")
        out = {"loss": loss_sum / sample_size / math.log(2), "nll_loss": nll_loss_sum / ntokens / math.log(2),
               "alignment_loss": align_sum / sample_size / math.log(2)}
        log_scalars(metrics, [("loss", out["loss"], sample_size, 3), ("nll_loss", out["nll_loss"], ntokens, 3),
                              ("alignment_loss", out["alignment_loss"], sample_size, 3)])
        if metrics is not None:
            metrics.log_derived("ppl", lambda meters: get_perplexity(meters["nll_loss"].avg))
        out["ppl"] = get_perplexity(out["nll_loss"])
        return out
