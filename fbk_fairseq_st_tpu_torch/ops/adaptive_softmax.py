"""Adaptive input embeddings and the adaptive softmax (Baevski & Auli
2018; Grave et al. 2017).

Counterpart of ``fbk_fairseq_st_tpu/ops/adaptive_softmax.py``
(``_parse_cutoff`` :22, ``init_adaptive_softmax`` :34,
``adaptive_log_probs`` :62, ``init_adaptive_input`` :80,
``adaptive_embed`` :107, ``init_tied_adaptive_softmax`` :130,
``tied_adaptive_log_probs`` :160), under the fork's module names
(fairseq/modules/adaptive_input.py, adaptive_softmax.py):

  * ``AdaptiveInput``: ``embeddings.{i}`` = (``nn.Embedding`` of band
    i's words at ``initial_dim / factor^i``, a bias-free projection to
    the output dim), so the fork's ``embeddings.{i}.0.weight`` /
    ``.1.weight``. Every band is looked up at clamped ids and the token's
    own band selected by mask, as JAX does.
  * ``AdaptiveSoftmax``: ``head`` (the first band's words and one logit a
    tail cluster) and ``tail.{i}`` = (projection to ``D / factor^(i+1)``,
    dropout slot, output over band i+1), so ``tail.{i}.0.weight`` /
    ``.2.weight``. Tied to an ``AdaptiveInput`` (``--tie-adaptive-weights``)
    the head is ``word_proj`` (band 0's table) + ``class_proj``, each
    tail's output is its band's table, and with ``tie_proj`` its
    projection is the band's input projection, transposed: the modules
    hold the input's own ``Parameter``s, so one gradient reaches both
    uses.

The output is the composed full ``(..., V)`` log-probability tensor, log
p(w) = log p(cluster) + log p(w | cluster), in fp32 whatever the compute
type (JAX casts it back to the activations' type; the port keeps fp32,
which also feeds ``log_softmax`` unchanged). The products run in the
activations' type; each log-softmax in fp32. ``--adaptive-softmax-dropout``
is parsed and never applied, as in JAX.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .core import Linear, normal_


def _parse_cutoff(cutoff, vocab_size: int) -> Tuple[int, ...]:
    """The band ends, the last one the vocabulary size (JAX :22)."""
    if isinstance(cutoff, str):
        cutoff = [int(x) for x in cutoff.split(",")]
    cutoff = list(cutoff)
    if cutoff[-1] > vocab_size:
        cutoff = [c for c in cutoff if c < vocab_size]
    if not cutoff or cutoff[-1] != vocab_size:
        cutoff = cutoff + [vocab_size]
    if not all(a < b for a, b in zip(cutoff, cutoff[1:])):
        raise ValueError(f"adaptive cutoffs must increase: {cutoff}")
    return tuple(cutoff)


def band_dim(dim: int, factor: float, i: int) -> int:
    return max(int(dim // (factor ** i)), 1)


class TiedLinear(nn.Module):
    """A bias-free linear over another module's ``weight`` (the fork's
    ``TiedLinear``): ``transpose`` uses it as (in, out)."""

    def __init__(self, weight: nn.Parameter, transpose: bool):
        super().__init__()
        self.weight = weight
        self.transpose = transpose

    def forward(self, x):
        w = self.weight.to(x.dtype)
        return torch.matmul(x, w) if self.transpose else F.linear(x, w)


class AdaptiveInput(nn.Module):
    def __init__(self, vocab_size: int, padding_idx: int, initial_dim: int, factor: float, output_dim: int,
                 cutoff: Sequence[int]):
        super().__init__()
        self.cutoff = _parse_cutoff(cutoff, vocab_size)
        self.padding_idx = padding_idx
        self.embeddings = nn.ModuleList()
        prev = 0
        for i, c in enumerate(self.cutoff):
            dim = band_dim(initial_dim, factor, i)
            self.embeddings.append(nn.Sequential(nn.Embedding(c - prev, dim), Linear(dim, output_dim, bias=False)))
            prev = c

    def init(self, generator: torch.Generator) -> None:
        prev = 0
        for c, band in zip(self.cutoff, self.embeddings):
            emb, proj = band
            normal_(emb.weight, generator, emb.weight.shape[1] ** -0.5)
            if prev <= self.padding_idx < c:
                with torch.no_grad():
                    emb.weight[self.padding_idx - prev] = 0.0
            proj.init(generator)
            prev = c

    def forward(self, ids, dtype=torch.float32):
        """ids (...) -> (..., output_dim) in ``dtype``."""
        out = None
        prev = 0
        for c, (emb, proj) in zip(self.cutoff, self.embeddings):
            local = (ids - prev).clamp(0, c - prev - 1)
            x = proj(F.embedding(local, emb.weight.to(dtype)))
            mask = ((ids >= prev) & (ids < c))[..., None]
            out = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device) if out is None else out)
            prev = c
        return out


class TiedHead(nn.Module):
    """The tied head: band 0's words through band 0's table, the clusters
    through ``class_proj``."""

    def __init__(self, word_weight: nn.Parameter, input_dim: int, n_tails: int):
        super().__init__()
        self.word_proj = TiedLinear(word_weight, transpose=False)
        self.class_proj = Linear(input_dim, n_tails, bias=False)

    def forward(self, x):
        return torch.cat([self.word_proj(x), self.class_proj(x)], dim=-1)


class AdaptiveSoftmax(nn.Module):
    def __init__(self, vocab_size: int, input_dim: int, cutoff: Sequence[int], factor: float = 4.0,
                 tied_to: "AdaptiveInput" = None, tie_proj: bool = False):
        super().__init__()
        self.cutoff = _parse_cutoff(cutoff, vocab_size)
        n_tails = len(self.cutoff) - 1
        self.tied = tied_to is not None
        if self.tied:
            emb0 = tied_to.embeddings[0][0].weight
            if emb0.shape[1] != input_dim:
                raise NotImplementedError(
                    "tied adaptive softmax requires band-0 embedding dim == "
                    f"decoder dim ({emb0.shape[1]} != {input_dim})")
            self.head = TiedHead(emb0, input_dim, n_tails)
        else:
            self.head = Linear(input_dim, self.cutoff[0] + n_tails, bias=False)
        self.tail = nn.ModuleList()
        for i in range(n_tails):
            dim = band_dim(input_dim, factor, i + 1)
            if self.tied:
                band = tied_to.embeddings[i + 1]
                proj = TiedLinear(band[1].weight, transpose=True) if tie_proj else Linear(input_dim, dim, bias=False)
                out = TiedLinear(band[0].weight, transpose=False)
            else:
                proj = Linear(input_dim, dim, bias=False)
                out = Linear(dim, self.cutoff[i + 1] - self.cutoff[i], bias=False)
            self.tail.append(nn.Sequential(proj, nn.Identity(), out))

    def init(self, generator: torch.Generator) -> None:
        """The free weights only (JAX's tied init draws nothing for the
        shared ones)."""
        for m in [self.head] + [layer for t in self.tail for layer in t]:
            if isinstance(m, Linear):
                m.init(generator)
            elif isinstance(m, TiedHead):
                m.class_proj.init(generator)

    def log_probs(self, x):
        """x (..., D) -> (..., V) fp32 log-probabilities."""
        head_lp = torch.log_softmax(self.head(x), dim=-1, dtype=torch.float32)
        c0 = self.cutoff[0]
        pieces: List[torch.Tensor] = [head_lp[..., :c0]]
        for i, tail in enumerate(self.tail):
            tail_lp = torch.log_softmax(tail(x), dim=-1, dtype=torch.float32)
            pieces.append(tail_lp + head_lp[..., c0 + i:c0 + i + 1])
        return torch.cat(pieces, dim=-1)


