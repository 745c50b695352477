"""Positional embeddings, numerically matching the reference.

Counterpart of ``fbk_fairseq_st_tpu/ops/positional.py``:

* Sinusoidal: the tensor2tensor variant ``cat([sin, cos], dim=1)`` with the
  padding row zeroed; real tokens start at ``padding_idx + 1``.
* Learned: an embedding indexed by the same positions.
* Audio: positions from lengths, ``padding_idx + 1 + t`` for ``t < L``.

The sinusoidal table is a non-persistent buffer: it is rebuilt, never
checkpointed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .core import normal_


def sinusoidal_table(num_embeddings: int, dim: int, padding_idx: Optional[int] = None):
    half_dim = dim // 2
    emb = math.log(10000.0) / (half_dim - 1)
    inv_freq = torch.exp(torch.arange(half_dim, dtype=torch.float32) * -emb)
    pos = torch.arange(num_embeddings, dtype=torch.float32)[:, None] * inv_freq[None, :]
    table = torch.cat([torch.sin(pos), torch.cos(pos)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, torch.zeros(num_embeddings, 1)], dim=1)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table


def make_positions(ids, padding_idx: int):
    """Non-pad tokens get padding_idx + 1, + 2, ...; pads keep padding_idx."""
    mask = (ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def token_positions_from_lengths(lengths, max_len: int, padding_idx: int):
    """Audio variant: positions from a length vector."""
    t = torch.arange(max_len, device=lengths.device)[None, :]
    return torch.where(t < lengths[:, None], t + padding_idx + 1, padding_idx)


class PositionalEmbedding(nn.Module):
    """Sinusoidal (a rebuilt buffer) or learned (``weight``) positions."""

    def __init__(self, max_positions: int, dim: int, padding_idx: int, learned: bool):
        super().__init__()
        self.max_positions = max_positions
        self.dim = dim
        self.padding_idx = padding_idx
        self.learned = learned
        # reference init_size = num_embeddings + padding_idx + 1
        n = max_positions + padding_idx + 1
        if learned:
            self.weight = nn.Parameter(torch.zeros(n, dim))
        else:
            self.register_buffer(
                "table", sinusoidal_table(n, dim, padding_idx), persistent=False
            )

    def init(self, generator: torch.Generator) -> None:
        if self.learned:
            normal_(self.weight, generator, self.dim ** -0.5)
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, positions, dtype=torch.float32):
        """positions: (B, T) absolute positions (pads at padding_idx)."""
        table = self.weight if self.learned else self.table
        return table.to(dtype)[positions]

    def from_ids(self, ids, dtype=torch.float32, step: Optional[int] = None):
        """Positions from token ids; with ``step`` (incremental decoding)
        every token gets position ``padding_idx + 1 + step``."""
        if step is not None:
            positions = torch.full_like(ids, self.padding_idx + 1 + int(step))
        else:
            positions = make_positions(ids, self.padding_idx)
        return self(positions, dtype)

    def from_lengths(self, lengths, max_len: int, dtype=torch.float32):
        return self(token_positions_from_lengths(lengths, max_len, self.padding_idx), dtype)
