"""The adaptive-softmax loss.

Counterpart of ``fbk_fairseq_st_tpu/criterions/adaptive_loss.py``: the
model's output under the adaptive softmax is already the full
log-probability tensor (``ops/adaptive_softmax.py``), so the loss is the
NLL of the non-pad targets over it, in fp32; ``reduce_metrics`` logs the
loss in base 2, ``nll_loss`` per token when the sample size counts
sentences, and ``ppl``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .base import Criterion, get_perplexity, log_scalars, sum_logs


class AdaptiveLoss(Criterion):
    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        lprobs, _ = model(batch, generator)
        target = batch["target"]
        nll = -lprobs.float().gather(-1, target[..., None].long())[..., 0]
        keep = target != self.padding_idx
        loss = (nll * keep.to(nll.dtype)).sum()
        ntokens = keep.sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        sample_size = nsentences if self.sentence_avg else ntokens
        logging_output = {"loss": loss.detach(), "ntokens": ntokens, "nsentences": nsentences,
                          "sample_size": sample_size}
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """JAX :41-58."""
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
