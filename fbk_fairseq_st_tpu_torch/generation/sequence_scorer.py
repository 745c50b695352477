"""Teacher-forced scoring of the reference targets (``--score-reference``).

Counterpart of ``fbk_fairseq_st_tpu/generation/sequence_scorer.py``
(reference fairseq/sequence_scorer.py): one teacher-forced forward a model
on the batch's ``src_tokens``, ``src_lengths`` and ``prev_output_tokens``,
the log-softmax in fp32, and per sentence one hypothesis: the target's
non-pad tokens, their log-probabilities and their mean as the score; the
alignment is None. An ensemble sums its models' probabilities as JAX does,
``np.logaddexp`` over the models, then ``- log(n)``. Each model's
log-probabilities are gathered at the targets on the device, so only
(B, T) values a model reach the host (the sum is elementwise, so it is the
same as JAX's sum over the whole vocabulary followed by the gather). A
language model's batch has no ``prev_output_tokens`` (its input is
``src_tokens``): the keys the batch has are passed (``cli/eval_lm``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import module_device
from .sequence_generator import EnsembleModel


class SequenceScorer:
    def __init__(self, tgt_dict):
        self.pad = tgt_dict.pad()

    @torch.no_grad()
    def generate(self, models, sample, prefix_tokens=None) -> List[List[dict]]:
        """models: a list of models (or an EnsembleModel) in eval mode, all
        on one device; sample: a collated batch with ``net_input``
        (``src_tokens``, ``src_lengths``, ``prev_output_tokens``) and
        ``target``, as tensors or numpy arrays."""
        models = models.models if isinstance(models, EnsembleModel) else list(models)
        if any(m.training for m in models):
            raise ValueError("SequenceScorer needs models in eval mode (call model.eval())")
        device = module_device(models[0])
        net_input = sample["net_input"]
        batch = {k: torch.as_tensor(net_input[k], device=device)
                 for k in ("src_tokens", "src_lengths", "prev_output_tokens") if k in net_input}
        target = torch.as_tensor(sample["target"], device=device)

        avg_probs = None
        for model in models:
            logits, _ = model(batch)
            lprobs = torch.log_softmax(logits.float(), dim=-1)
            probs = lprobs.gather(-1, target[:, :, None])[:, :, 0].cpu().numpy()
            avg_probs = probs if avg_probs is None else np.logaddexp(avg_probs, probs)
        if len(models) > 1:
            avg_probs = avg_probs - np.log(len(models))

        target = target.cpu().numpy()
        hypos = []
        for i in range(target.shape[0]):
            keep = target[i] != self.pad
            toks = target[i][keep]
            pos_scores = avg_probs[i][keep]
            hypos.append([{
                "tokens": toks,
                "score": float(pos_scores.sum() / max(len(toks), 1)),
                "positional_scores": pos_scores.astype(np.float32),
                "alignment": None,
                "attention": None,
            }])
        return hypos
