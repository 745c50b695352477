"""Philox4x32-10 and the attention-dropout keep mask, in plain PyTorch.

The TPU kernels drew their dropout bits from the TPU's hardware PRNG,
seeded per tile (``attention_kernel.py::_dropout_keep``). The port's
kernels use Philox4x32-10 (Salmon et al., SC'11; the Random123 and cuRAND
``philox4x32_10``), keyed per element, so that the forward, both
backwards and this plain version draw the same bit for element
(bh, i, j) whatever the tiling:

    key     = (seed & 0xffffffff, seed >> 32)      the 64-bit call seed
    counter = (j // 4, i, bh, 0)                   j key, i query, bh batch*head
    bits    = philox4x32_10(counter, key)[j % 4]
    keep    = bits >= min(int(rate * 2**32), 2**32 - 1)

The threshold test is ``_dropout_keep``'s. The CUDA sources
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) write the same ten rounds.

The arithmetic is uint32 carried in int64 tensors: a 32x32-bit product
is split into 16-bit halves so that no intermediate leaves int64's range.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, with m a
    uint32 constant and x uint32 values in an int64 tensor."""
    p_lo = m * (x & 0xFFFF)   # < 2**48
    p_hi = m * (x >> 16)      # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox rounds on counters (c0..c3, broadcastable int64 tensors of
    uint32 values) under the key (k0, k1). Returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """The uint32 threshold below which an element is dropped."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return min(int(rate * 4294967296.0), MASK32)


def random_bits(seed: int, bh: int, t: int, s: int, device=None) -> torch.Tensor:
    """(bh, t, s) uint32 Philox words (in int64) of the mapping above."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed & MASK32, seed >> 32
    n4 = -(-s // 4)
    c0 = torch.arange(n4, dtype=torch.int64, device=device)[None, None, :]
    c1 = torch.arange(t, dtype=torch.int64, device=device)[None, :, None]
    c2 = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None]
    c3 = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(c0, c1, c2, c3, k0, k1)
    words = [w.expand(bh, t, n4) for w in words]
    return torch.stack(words, dim=-1).reshape(bh, t, 4 * n4)[..., :s]


def keep_mask(seed: int, bh: int, t: int, s: int, rate: float, device=None) -> torch.Tensor:
    """(bh, t, s) bool keep mask of attention dropout at ``rate``."""
    thresh = keep_threshold(rate)
    return random_bits(seed, bh, t, s, device) >= thresh
