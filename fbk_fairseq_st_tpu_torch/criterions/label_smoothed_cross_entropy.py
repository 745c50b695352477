"""Label-smoothed cross-entropy.

Counterpart of ``fbk_fairseq_st_tpu/criterions/label_smoothed_cross_entropy.py``:
per token ``nll = -lprob[target]`` and ``smooth = -sum(lprobs)``, pads
zeroed, ``loss = (1 - eps) * sum(nll) + (eps / V) * sum(smooth)``;
sample_size = ntokens (nsentences with ``sentence_avg``). The criterion
computes it from the logits with per-row reductions only
(``label_smoothed_nll_from_logits``); ``label_smoothed_nll_loss`` is the
log-softmax form, kept as its plain twin.

``cross_entropy`` (JAX ``CrossEntropyCriterion`` :131-176, the parser's
default criterion) is the plain NLL over the non-pad targets, from the
logits in the same way; its ``reduce_metrics`` logs ``nll_loss`` only when
the sample size is not the token count, and ``ppl`` from whichever of the
two is per token.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .base import Criterion, get_perplexity, log_scalars, sum_logs


def label_smoothed_nll_loss(lprobs, target, epsilon: float, ignore_index=None):
    """lprobs: (N, V) log-probs; target: (N,) int. Returns summed (loss, nll)."""
    nll = -lprobs.gather(-1, target[:, None].long())[:, 0]
    smooth = -lprobs.sum(dim=-1)
    if ignore_index is not None:
        keep = (target != ignore_index).to(lprobs.dtype)
        nll = nll * keep
        smooth = smooth * keep
    nll_sum = nll.sum()
    eps_i = epsilon / lprobs.shape[-1]
    return (1.0 - epsilon) * nll_sum + eps_i * smooth.sum(), nll_sum


def label_smoothed_nll_from_logits(logits, target, epsilon: float, ignore_index=None):
    """The same loss from raw (..., V) logits, in fp32, with reductions only:

        nll_i    = lse_i - logit_i[target_i]
        smooth_i = V * lse_i - sum_v logit_i[v]
    """
    v = logits.shape[-1]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt_logit = lf.gather(-1, target[..., None].long())[..., 0]
    nll = lse - tgt_logit
    smooth = v * lse - lf.sum(dim=-1)
    if ignore_index is not None:
        keep = (target != ignore_index).to(nll.dtype)
        nll = nll * keep
        smooth = smooth * keep
    nll_sum = nll.sum()
    return (1.0 - epsilon) * nll_sum + (epsilon / v) * smooth.sum(), nll_sum


class LabelSmoothedCrossEntropyCriterion(Criterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self.eps = getattr(args, "label_smoothing", 0.0)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--label-smoothing", default=0.0, type=float, metavar="D",
                            help="epsilon for label smoothing, 0 means no label smoothing")

    def __call__(self, model, batch, generator=None, training: bool = False):
        """Sets the model's train/eval mode from ``training`` (the JAX
        ``training`` flag), runs it teacher-forced and returns the summed
        loss, the sample size and the logging dict of JAX :85-91."""
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

    def compute_loss(self, model, net_output, batch):
        """(loss, nll_loss) of ``net_output = (logits, extra)``, summed
        (JAX ``compute_loss``; also the underlying loss of
        ``ctc_multi_loss``)."""
        return label_smoothed_nll_from_logits(net_output[0], batch["target"], self.eps, self.padding_idx)

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """loss per sample-size unit and nll_loss per token, base 2 (JAX :115-128)."""
        loss_sum, nll_loss_sum = sum_logs(logging_outputs, "loss"), sum_logs(logging_outputs, "nll_loss")
        ntokens, sample_size = sum_logs(logging_outputs, "ntokens"), sum_logs(logging_outputs, "sample_size")
        out = {"loss": loss_sum / sample_size / math.log(2), "nll_loss": nll_loss_sum / ntokens / math.log(2)}
        log_scalars(metrics, [("loss", out["loss"], sample_size, 3), ("nll_loss", out["nll_loss"], ntokens, 3)])
        if metrics is not None:
            metrics.log_derived("ppl", lambda meters: get_perplexity(meters["nll_loss"].avg))
        out["ppl"] = get_perplexity(out["nll_loss"])
        return out


class CrossEntropyCriterion(Criterion):
    """Plain NLL (JAX :131-176; fairseq/criterions/cross_entropy.py)."""

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        net_output = model(batch, generator)
        loss, _ = self.compute_loss(model, net_output, batch)
        target = batch["target"]
        ntokens = (target != self.padding_idx).sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        sample_size = nsentences if self.sentence_avg else ntokens
        logging_output = {"loss": loss.detach(), "ntokens": ntokens, "nsentences": nsentences,
                          "sample_size": sample_size}
        return loss, sample_size, logging_output

    def compute_loss(self, model, net_output, batch):
        """(loss, loss): the summed NLL of ``net_output = (logits, extra)``
        (the underlying loss of ``ctc_multi_loss`` too)."""
        _, loss = label_smoothed_nll_from_logits(net_output[0], batch["target"], 0.0, self.padding_idx)
        return loss, loss

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """loss per sample-size unit in base 2; nll_loss per token when the
        sample size counts sentences (JAX :158-176)."""
        loss_sum, ntokens = sum_logs(logging_outputs, "loss"), sum_logs(logging_outputs, "ntokens")
        sample_size = sum_logs(logging_outputs, "sample_size")
        out = {"loss": loss_sum / sample_size / math.log(2)}
        entries = [("loss", out["loss"], sample_size, 3)]
        per_token = "loss"
        if sample_size != ntokens:
            out["nll_loss"] = loss_sum / ntokens / math.log(2)
            entries.append(("nll_loss", out["nll_loss"], ntokens, 3))
            per_token = "nll_loss"
        log_scalars(metrics, entries)
        if metrics is not None:
            metrics.log_derived("ppl", lambda meters: get_perplexity(meters[per_token].avg))
        out["ppl"] = get_perplexity(out[per_token])
        return out
