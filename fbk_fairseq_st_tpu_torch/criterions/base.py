"""Criterion base class.

Counterpart of ``fbk_fairseq_st_tpu/criterions/base.py``. The call keeps
the JAX signature without the variables (the port's model holds its
weights, and its BatchNorm buffers update in place):

    loss, sample_size, logging_output = criterion(model, batch, generator, training)

``loss`` is an un-normalized sum; the trainer divides the gradients by the
summed ``sample_size``. ``reduce_metrics(logging_outputs, metrics)`` returns
the values the JAX criterion logs and, given the metrics module, logs them
as it does (the same keys, weights and rounding). ``logging_output`` is a flat dict of scalar
tensors on the batch's device (no value is brought to the host here).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch


class Criterion:
    def __init__(self, task, args):
        self.task = task
        self.args = args
        tgt = getattr(task, "target_dictionary", None)
        self.padding_idx = tgt.pad() if tgt is not None else -100
        self.sentence_avg = getattr(args, "sentence_avg", False)

    @classmethod
    def add_args(cls, parser) -> None:
        pass

    @classmethod
    def build_criterion(cls, args, task) -> "Criterion":
        return cls(task, args)

    def __call__(self, model, batch, generator=None, training: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        raise NotImplementedError

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """The loss per sample-size unit in base 2 (JAX ``Criterion.reduce_metrics``)."""
        loss_sum, sample_size = sum_logs(logging_outputs, "loss"), sum_logs(logging_outputs, "sample_size")
        out = {}
        if sample_size > 0:
            out["loss"] = loss_sum / sample_size / math.log(2)
            log_scalars(metrics, [("loss", out["loss"], sample_size, 3)])
        return out


def sum_logs(logging_outputs: List[dict], key: str) -> float:
    """``key`` summed over the logging outputs, on the host."""
    return float(sum(float(log.get(key, 0)) for log in logging_outputs))


def log_scalars(metrics, entries) -> None:
    """``metrics.log_scalar(key, value, weight, round=...)`` for each entry
    (key, value, weight, round), when a metrics module is given."""
    if metrics is None:
        return
    for key, value, weight, rnd in entries:
        metrics.log_scalar(key, value, weight, round=rnd)


def get_perplexity(loss_base2) -> float:
    if loss_base2 is None:
        return 0.0
    try:
        return float(round(2 ** loss_base2, 2))
    except OverflowError:
        return float("inf")
