"""Criterion base class.

Counterpart of ``fbk_fairseq_st_tpu/criterions/base.py``. The call keeps
the JAX signature without the variables (the port's model holds its
weights, and its BatchNorm buffers update in place):

    loss, sample_size, logging_output = criterion(model, batch, generator, training)

``loss`` is an un-normalized sum; the trainer divides the gradients by the
summed ``sample_size``. ``logging_output`` is a flat dict of scalar
tensors on the batch's device (no value is brought to the host here).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


class Criterion:
    def __init__(self, task, args):
        self.task = task
        self.args = args
        tgt = getattr(task, "target_dictionary", None)
        self.padding_idx = tgt.pad() if tgt is not None else -100
        self.sentence_avg = getattr(args, "sentence_avg", False)

    @classmethod
    def build_criterion(cls, args, task) -> "Criterion":
        return cls(task, args)

    def __call__(self, model, batch, generator=None, training: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        raise NotImplementedError
