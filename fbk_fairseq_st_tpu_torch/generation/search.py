"""Beam search step (reference fairseq/search.py:50-84).

Counterpart of ``fbk_fairseq_st_tpu/generation/search.py::BeamSearch``:
returns 2*beam candidates (cumulative scores, token ids, source beams) per
sentence, sorted by score descending.

``top_k`` picks the same elements in the same order as ``jax.lax.top_k``:
the k largest values, and among equal values the lower index first. A
stable descending sort gives exactly that, whatever the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.core import NEG_INF


class SearchOutput(NamedTuple):
    scores: torch.Tensor  # (B, 2K) cumulative candidate scores
    indices: torch.Tensor  # (B, 2K) token ids
    beams: torch.Tensor  # (B, 2K) source beam per candidate


def top_k(x, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, ties
    broken towards the lower index (the ``jax.lax.top_k`` order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class BeamSearch:
    def __init__(self, tgt_dict):
        self.pad = tgt_dict.pad()
        self.eos = tgt_dict.eos()
        self.vocab_size = len(tgt_dict)

    def step(self, step: int, lprobs, scores) -> SearchOutput:
        """lprobs: (B, K, V) this step's log-probs; scores: (B, K) cumulative
        scores up to the previous step."""
        b, k, v = lprobs.shape
        if step == 0:
            # all beams are identical at step 0: search beam 0 only
            first = torch.arange(k, device=lprobs.device)[None, :, None] == 0
            cum = torch.where(first, lprobs, NEG_INF)
        else:
            cum = lprobs + scores[:, :, None]
        top_scores, top_idx = top_k(cum.reshape(b, k * v), 2 * k)
        return SearchOutput(scores=top_scores, indices=top_idx % v, beams=top_idx // v)
