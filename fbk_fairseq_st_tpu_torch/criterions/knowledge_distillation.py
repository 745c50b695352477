"""knowledge_distillation: the student's NLL of the reference mixed with
its cross-entropy against the teacher's top-k distribution (CliC-IT 2020).

Counterpart of ``fbk_fairseq_st_tpu/criterions/knowledge_distillation.py``
(reference fairseq/criterions/knowledge_distillation.py:17-110): per
target token that is not a pad,

    loss = (1 - lambda) * NLL(target) + lambda * CE(teacher || student)

where the teacher's distribution is the softmax of its top-k logits
(``teacher_probs``, at ``teacher_idxs``) divided by ``--kd-temperature``,
and the student's log-probabilities at those k indices come from its
logits divided by the same temperature. ``nll_loss`` logs the truth part,
or the loss itself at lambda 1 (JAX :75). The sample size is the target
token count (nsentences with ``sentence_avg``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .base import Criterion, get_perplexity, log_scalars, sum_logs


class CrossEntropyKnowledgeDistillationCriterion(Criterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self._lambda = getattr(args, "kd_lambda", 0.0)
        self.temperature = getattr(args, "kd_temperature", 1.0)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--kd-lambda", default=0.0, type=float, metavar="D",
                            help="Value for lambda in Knowledge Distillation (ie. the weight of teacher output vs "
                                 "ground truth)")
        parser.add_argument("--kd-temperature", default=1.0, type=float, metavar="D",
                            help="Temperature to be used. Temperature is used to soften the nets output in order to "
                                 "increase the dark knowledge effect.")

    def compute_loss(self, model, net_output, batch):
        """(loss, the nll_loss it logs) of ``net_output = (logits, extra)``,
        summed, in fp32."""
        logits = net_output[0]
        target = batch["target"].reshape(-1)
        mask = (target != self.padding_idx).float()
        teacher_loss = truth_loss = 0.0
        if self._lambda > 0.0:
            lprobs_t = F.log_softmax((logits / self.temperature).float(), dim=-1)
            lprobs_t = lprobs_t.reshape(-1, lprobs_t.shape[-1])
            k = batch["teacher_idxs"].shape[-1]
            teacher_idxs = batch["teacher_idxs"].reshape(-1, k).long()
            teacher_probs = F.softmax(batch["teacher_probs"].reshape(-1, k).float() / self.temperature, dim=-1)
            teacher_loss = -(lprobs_t.gather(-1, teacher_idxs) * teacher_probs).sum(dim=-1) * mask
        if self._lambda < 1.0:
            lf = logits.float().reshape(-1, logits.shape[-1])
            truth_loss = (torch.logsumexp(lf, dim=-1) - lf.gather(-1, target[:, None].long())[:, 0]) * mask
        loss = ((1.0 - self._lambda) * truth_loss + self._lambda * teacher_loss).sum()
        return loss, (truth_loss.sum() if self._lambda < 1.0 else loss)

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        net_output = model(batch, generator)
        loss, nll_loss = self.compute_loss(model, net_output, batch)
        target = batch["target"]
        ntokens = (target != self.padding_idx).sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        sample_size = nsentences if self.sentence_avg else ntokens
        logging_output = {
            "loss": loss.detach(),
            "nll_loss": nll_loss.detach(),
            "ntokens": ntokens,
            "nsentences": nsentences,
            "sample_size": sample_size,
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """loss per sample-size unit and nll_loss per token, base 2 (JAX :91-104)."""
        loss_sum, nll_sum = sum_logs(logging_outputs, "loss"), sum_logs(logging_outputs, "nll_loss")
        ntokens, sample_size = sum_logs(logging_outputs, "ntokens"), sum_logs(logging_outputs, "sample_size")
        out = {"loss": loss_sum / sample_size / math.log(2), "nll_loss": nll_sum / ntokens / math.log(2)}
        log_scalars(metrics, [("loss", out["loss"], sample_size, 3), ("nll_loss", out["nll_loss"], ntokens, 3)])
        if metrics is not None:
            metrics.log_derived("ppl", lambda meters: get_perplexity(meters["nll_loss"].avg))
        out["ppl"] = get_perplexity(out["nll_loss"])
        return out
