"""Search strategies: one step over (step, lprobs, scores).

Counterpart of ``fbk_fairseq_st_tpu/generation/search.py`` (reference
fairseq/search.py). Each ``step`` returns 2*beam candidates per sentence:
(cumulative scores, token ids, source beams). ``step`` is the loop's
Python int; ``generator`` is the sequence generator's ``torch.Generator``
on the scores' device, read by ``Sampling`` only.

``top_k`` picks the same elements in the same order as ``jax.lax.top_k``:
the k largest values, and among equal values the lower index first. A
stable descending sort gives exactly that, whatever the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    """fairseq/search.py:50-84; candidates sorted by score, descending."""

    needs_rng = False

    def __init__(self, tgt_dict):
        self.pad = tgt_dict.pad()
        self.eos = tgt_dict.eos()
        self.vocab_size = len(tgt_dict)

    def step(self, step: int, lprobs, scores, generator: Optional[torch.Generator] = None) -> SearchOutput:
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


class LengthConstrainedBeamSearch(BeamSearch):
    """fairseq/search.py:86-101: eos is banned before min_len_a * src + b
    and forced (at log-prob 0) from max_len_a * src + b, per sentence; the
    generator sets ``src_lengths`` (B,) per batch."""

    def __init__(self, tgt_dict, min_len_a, min_len_b, max_len_a, max_len_b):
        super().__init__(tgt_dict)
        self.min_len_a, self.min_len_b = min_len_a, min_len_b
        self.max_len_a, self.max_len_b = max_len_a, max_len_b
        self.src_lengths: Optional[torch.Tensor] = None

    def step(self, step: int, lprobs, scores, generator=None) -> SearchOutput:
        below = (step < self.min_len_a * self.src_lengths + self.min_len_b)[:, None, None]
        above = (step >= self.max_len_a * self.src_lengths + self.max_len_b)[:, None, None]
        is_eos = (torch.arange(lprobs.shape[-1], device=lprobs.device) == self.eos)[None, None, :]
        lprobs = torch.where(below & is_eos, NEG_INF, lprobs)
        lprobs = torch.where(above & ~is_eos, NEG_INF, lprobs)
        lprobs = torch.where(above & is_eos, 0.0, lprobs)
        return super().step(step, lprobs, scores)


class DiverseBeamSearch:
    """fairseq/search.py:103-162 (Vijayakumar et al. 2016): the beams in G
    interleaved groups, each group's log-probs lowered by the strength
    times the count of each token the earlier groups chose this step."""

    needs_rng = False

    def __init__(self, tgt_dict, num_groups: int, diversity_strength: float):
        self.pad = tgt_dict.pad()
        self.eos = tgt_dict.eos()
        self.num_groups = num_groups
        self.diversity_strength = -diversity_strength
        self.beam = BeamSearch(tgt_dict)

    def step(self, step: int, lprobs, scores, generator=None) -> SearchOutput:
        b, k, v = lprobs.shape
        g = self.num_groups
        if k % g != 0:
            raise ValueError("DiverseBeamSearch requires --beam to be divisible by the number of groups")
        diversity_buf = torch.zeros((b, v), dtype=torch.float32, device=lprobs.device)
        outs = []
        for grp in range(g):
            lprobs_g, scores_g = lprobs[:, grp::g, :], scores[:, grp::g]
            if grp > 0:
                lprobs_g = lprobs_g + self.diversity_strength * diversity_buf[:, None, :]
            res = self.beam.step(step, lprobs_g, scores_g)
            diversity_buf = diversity_buf.scatter_add(1, res.indices, torch.ones_like(res.scores))
            outs.append((res.scores, res.indices, res.beams * g + grp))
        # interleave the groups (the reference stacks, then views)
        return SearchOutput(*(torch.stack(parts, dim=2).reshape(b, -1) for parts in zip(*outs)))


class Sampling:
    """fairseq/search.py:164-279: ancestral sampling, optionally from the
    top k tokens (``sampling_topk``) or from the smallest set whose mass
    exceeds p (``sampling_topp``), renormalised. Two draws a beam make the
    2K candidates (with replacement, as the reference). The draws come from
    ``generator``, so they match JAX's in distribution, not draw for draw."""

    needs_rng = True

    def __init__(self, tgt_dict, sampling_topk: int = -1, sampling_topp: float = -1.0):
        self.pad = tgt_dict.pad()
        self.eos = tgt_dict.eos()
        self.sampling_topk = sampling_topk
        self.sampling_topp = sampling_topp

    def probs(self, lprobs):
        """The renormalised (B, K, V) sampling distribution of ``lprobs``."""
        probs = torch.exp(lprobs.float())
        if self.sampling_topk > 0:
            kth = top_k(probs, self.sampling_topk)[0][..., -1:]
            probs = torch.where(probs < kth, 0.0, probs)
        if self.sampling_topp > 0:
            sorted_p = torch.sort(probs, dim=-1, descending=True).values
            exclusive = torch.cumsum(sorted_p, dim=-1) - sorted_p
            thresh = torch.where(exclusive < self.sampling_topp, sorted_p, torch.inf).amin(dim=-1, keepdim=True)
            probs = torch.where(probs >= thresh, probs, 0.0)
        return probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-20)

    def step(self, step: int, lprobs, scores, generator: Optional[torch.Generator] = None) -> SearchOutput:
        b, k, v = lprobs.shape
        base = lprobs[:, :1, :].expand(b, k, v) if step == 0 else lprobs  # step 0: beam 0 only
        draws = torch.multinomial(self.probs(base).reshape(b * k, v), 2, replacement=True, generator=generator)
        draws = draws.reshape(b, k, 2)
        toks = torch.cat([draws[..., 0], draws[..., 1]], dim=1)  # (B, 2K)
        beams = torch.arange(k, device=lprobs.device).repeat(2)[None, :].expand(b, 2 * k)
        gathered = torch.cat([base, base], dim=1).gather(2, toks[:, :, None])[..., 0]
        prev = torch.zeros_like(gathered) if step == 0 else torch.cat([scores, scores], dim=1)
        return SearchOutput(prev + gathered, toks, beams)


class DiverseSiblingsSearch:
    """fairseq/search.py:281-343 (Li & Jurafsky 2016): each beam's top 2K
    continuations lowered by rank * ``diversity_rate``; step 0 is a plain
    beam step (search.py:315-316)."""

    needs_rng = False

    def __init__(self, tgt_dict, diversity_rate: float):
        self.eos = tgt_dict.eos()
        self.diversity_rate = diversity_rate
        self.beam = BeamSearch(tgt_dict)

    def step(self, step: int, lprobs, scores, generator=None) -> SearchOutput:
        if step == 0:
            return self.beam.step(step, lprobs, scores)
        b, k, v = lprobs.shape
        kk = 2 * k
        sib_scores, sib_indices = top_k(lprobs, kk)  # (B, K, 2K)
        penalty = (torch.arange(kk, dtype=torch.float32, device=lprobs.device) + 1) * self.diversity_rate
        cum = sib_scores - penalty[None, None, :] + scores[:, :, None]
        top_scores, top_pos = top_k(cum.reshape(b, k * kk), kk)
        return SearchOutput(top_scores, sib_indices.reshape(b, k * kk).gather(1, top_pos), top_pos // kk)
