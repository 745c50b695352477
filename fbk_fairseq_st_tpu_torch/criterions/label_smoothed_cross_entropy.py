"""Label-smoothed cross-entropy.

Counterpart of ``fbk_fairseq_st_tpu/criterions/label_smoothed_cross_entropy.py``:
per token ``nll = -lprob[target]`` and ``smooth = -sum(lprobs)``, pads
zeroed, ``loss = (1 - eps) * sum(nll) + (eps / V) * sum(smooth)``;
sample_size = ntokens (nsentences with ``sentence_avg``). The criterion
computes it from the logits with per-row reductions only
(``label_smoothed_nll_from_logits``); ``label_smoothed_nll_loss`` is the
log-softmax form, kept as its plain twin.
"""

from __future__ import annotations

import torch

from .base import Criterion


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
