"""Cross entropy for tensor-parallel training over logits split on the
vocabulary.

Counterpart of ``fbk_fairseq_st_tpu/criterions/vocab_parallel_cross_entropy.py``
(reference fairseq/model_parallel/criterions/vocab_parallel_cross_entropy.py):
the summed NLL of the non-pad targets, ``sample_size`` the token count (the
sentence count with ``--sentence-avg``), logged as ``cross_entropy`` logs.
Under tensor parallelism the trainer keeps the decoder's logits split
(``takes_split_logits``) and the loss is
``parallel.vocab_parallel.vocab_parallel_cross_entropy_sharded`` over the
model group; on one rank it is the plain form."""

from __future__ import annotations

import torch

from ..parallel.vocab_parallel import vocab_parallel_cross_entropy, vocab_parallel_cross_entropy_sharded
from .label_smoothed_cross_entropy import CrossEntropyCriterion


class VocabParallelCrossEntropyCriterion(CrossEntropyCriterion):
    takes_split_logits = True

    def compute_loss(self, model, net_output, batch):
        logits, target = net_output[0], batch["target"]
        vp = getattr(getattr(model, "decoder", None), "vocab_parallel", None)
        if vp is not None and vp.keep_logits_sharded:
            per_tok = vocab_parallel_cross_entropy_sharded(logits, target, vp.group)
        else:
            per_tok = vocab_parallel_cross_entropy(logits, target)
        loss = torch.sum(per_tok * (target != self.padding_idx).to(per_tok.dtype))
        return loss, loss
