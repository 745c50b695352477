"""cross_entropy_multi_task: label-smoothed CE on the translation plus the
weighted NLL of the utterance classifier.

Counterpart of ``fbk_fairseq_st_tpu/criterions/cross_entropy_multi_task.py``
(reference examples/speech_recognition/criterions/
cross_entropy_multi_task.py:12-100): over the model's ``((logits, extra),
aux_logits)``,

    loss = LS-CE(target) + auxiliary_loss_weight * sum_i w[y_i] * nll_i

with ``nll_i`` the classifier's negative log-probability of utterance i's
``auxiliary_target`` y_i and ``w`` the ``--auxiliary-loss-class-weights``
(1 when none are given). The sample size is the target token count
(nsentences with ``sentence_avg``); ``auxiliary_loss`` is logged beside
the loss and ``nll_loss`` and reduced per sentence.

With one output (a sigmoid classifier, as ``cli/generate_multitask_classifier``
reads it: the probability of class 1) ``nll_i`` is the binary one,
-log sigmoid(z) for y 1 and -log sigmoid(-z) for y 0. JAX gathers index y
from its one-wide log-sigmoid there, which gives NaN for y 1 (ROADMAP
Queue C, JAX side); at two or more outputs the two agree.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .base import Criterion, get_perplexity, log_scalars, sum_logs
from .label_smoothed_cross_entropy import label_smoothed_nll_from_logits


class CrossEntropyMultitask(Criterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self.eps = getattr(args, "label_smoothing", 0.0)
        self.auxiliary_loss_weight = getattr(args, "auxiliary_loss_weight", 1.0)
        w = getattr(args, "auxiliary_loss_class_weights", None)
        self.auxiliary_loss_class_weights = None if w is None else torch.tensor(w, dtype=torch.float32)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--auxiliary-loss-weight", default=1.0, type=float, metavar="W",
                            help="The weight to apply to the auxiliary loss function when summing losses")
        parser.add_argument("--auxiliary-loss-class-weights", default=None, type=float, nargs="+", metavar="Ws",
                            help="Individual class weights for balancing uneven classes")
        parser.add_argument("--label-smoothing", default=0.0, type=float, metavar="D",
                            help="epsilon for label smoothing, 0 means no label smoothing")

    def auxiliary_nll(self, model, aux_logits, aux_target) -> torch.Tensor:
        """Each utterance's classifier NLL, times its class weight (fp32)."""
        aux_target = aux_target.reshape(-1).long()
        if aux_logits.shape[-1] == 1:
            z = aux_logits.float().reshape(-1)
            per = -F.logsigmoid(torch.where(aux_target == 1, z, -z))
        else:
            aux_lprobs = model.auxiliary_decoder.get_normalized_probs(aux_logits, log_probs=True)
            per = -aux_lprobs.gather(-1, aux_target[:, None])[:, 0]
        if self.auxiliary_loss_class_weights is not None:
            per = per * self.auxiliary_loss_class_weights.to(per.device)[aux_target]
        return per

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        decoder_out, aux_logits = model(batch, generator)
        target = batch["target"]
        loss, nll_loss = label_smoothed_nll_from_logits(decoder_out[0], target, self.eps, self.padding_idx)
        aux_target = model.get_auxiliary_target(batch, aux_logits)
        auxiliary_loss = self.auxiliary_nll(model, aux_logits, aux_target).sum()
        loss = loss + self.auxiliary_loss_weight * auxiliary_loss
        ntokens = (target != self.padding_idx).sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        sample_size = nsentences if self.sentence_avg else ntokens
        logging_output = {
            "loss": loss.detach(),
            "nll_loss": nll_loss.detach(),
            "auxiliary_loss": auxiliary_loss.detach(),
            "ntokens": ntokens,
            "nsentences": nsentences,
            "sample_size": sample_size,
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """loss per sample-size unit, nll_loss per token and auxiliary_loss
        per sentence, base 2 (JAX :76-103)."""
        total = {k: sum_logs(logging_outputs, k) for k in (
            "loss", "nll_loss", "auxiliary_loss", "ntokens", "nsentences", "sample_size")}
        ln2 = math.log(2)
        out = {"loss": total["loss"] / total["sample_size"] / ln2,
               "nll_loss": total["nll_loss"] / total["ntokens"] / ln2}
        entries = [("loss", out["loss"], total["sample_size"], 3), ("nll_loss", out["nll_loss"], total["ntokens"], 3)]
        if total["nsentences"] > 0:
            out["auxiliary_loss"] = total["auxiliary_loss"] / total["nsentences"] / ln2
            entries.append(("auxiliary_loss", out["auxiliary_loss"], total["nsentences"], 3))
        log_scalars(metrics, entries)
        if metrics is not None:
            metrics.log_derived("ppl", lambda meters: get_perplexity(meters["nll_loss"].avg))
        out["ppl"] = get_perplexity(out["nll_loss"])
        return out
