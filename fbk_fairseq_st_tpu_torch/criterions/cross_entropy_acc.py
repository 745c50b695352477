"""cross_entropy_acc: cross-entropy with token accuracy logging.

Counterpart of ``fbk_fairseq_st_tpu/criterions/cross_entropy_acc.py``
(reference examples/speech_recognition/criterions/cross_entropy_acc.py,
the upstream ASR recipe's criterion): the summed NLL of the non-pad
targets from the fp32 log-softmax, the sample size the target token count
(nsentences with ``sentence_avg``), and beside the loss ``correct`` (the
non-pad targets the log-softmax's argmax hits) and ``total`` (the non-pad
targets); ``reduce_metrics`` gives ``accuracy`` = 100 correct / total.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .base import Criterion, log_scalars, sum_logs


class CrossEntropyWithAccCriterion(Criterion):
    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        net_output = model(batch, generator)
        logits = net_output[0] if isinstance(net_output, tuple) else net_output
        lprobs = torch.log_softmax(logits.float(), dim=-1)
        lprobs = lprobs.reshape(-1, lprobs.shape[-1])
        target = batch["target"].reshape(-1)
        mask = target != self.padding_idx
        nll = -lprobs.gather(-1, target[:, None].long())[:, 0]
        loss = (nll * mask).sum()
        correct = ((lprobs.argmax(dim=-1) == target) & mask).sum()
        total = mask.sum()
        nsentences = torch.full((), batch["target"].shape[0], dtype=torch.int64, device=target.device)
        logging_output = {
            "loss": loss.detach(),
            "ntokens": total,
            "nsentences": nsentences,
            "sample_size": nsentences if self.sentence_avg else total,
            "correct": correct,
            "total": total,
        }
        return loss, logging_output["sample_size"], logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """loss per sample-size unit in base 2 and, over any target,
        ``accuracy`` in percent (JAX :42-52)."""
        loss_sum, sample_size = sum_logs(logging_outputs, "loss"), sum_logs(logging_outputs, "sample_size")
        correct, total = sum_logs(logging_outputs, "correct"), sum_logs(logging_outputs, "total")
        out = {"loss": loss_sum / sample_size / math.log(2)}
        entries = [("loss", out["loss"], sample_size, 3)]
        if total > 0:
            out["accuracy"] = 100.0 * correct / total
            entries.append(("accuracy", out["accuracy"], total, 3))
        log_scalars(metrics, entries)
        return out
