"""Token-budget batch packing and size filtering, numpy only.

The port's own copy of ``fbk_fairseq_st_tpu/data/batching.py``
(``batch_by_size`` :80, ``filter_by_size_vec`` :145, ``filter_by_size``
:183): the reference algorithm (fairseq/data/data_utils_fast.pyx:27-68)
grows a batch while (len + 1) * max_len <= max_tokens and len <
max_sentences, and when it is full emits its largest multiple of
``required_batch_size_multiple`` (or its remainder, when that is larger).
JAX runs the packing in a C++ core when one builds and this loop
otherwise; the two give the same batches, and so does this copy.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import numpy as np


def _is_batch_full(batch_len: int, num_tokens: int, max_tokens: int, max_sentences: int) -> bool:
    if batch_len == 0:
        return False
    if max_sentences > 0 and batch_len == max_sentences:
        return True
    return max_tokens > 0 and num_tokens > max_tokens


def batch_by_size(indices: Sequence[int], num_tokens_fn: Union[Callable[[int], int], np.ndarray],
                  max_tokens: Optional[int] = None, max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    """``indices`` packed into batches, in order. ``num_tokens_fn``: a
    function of the dataset index, or an array of sizes aligned with
    ``indices``."""
    max_tokens = max_tokens if max_tokens is not None else -1
    max_sentences = max_sentences if max_sentences is not None else -1
    bsz_mult = required_batch_size_multiple
    indices = np.asarray(indices, dtype=np.int64)
    if callable(num_tokens_fn):
        sizes = np.fromiter((num_tokens_fn(int(i)) for i in indices), dtype=np.int64, count=len(indices))
    else:
        sizes = np.asarray(num_tokens_fn, dtype=np.int64)
        if sizes.shape != (len(indices),):
            raise ValueError("vectorized num_tokens must align with indices")

    batches: List[List[int]] = []
    start, sample_len = 0, 0
    for pos in range(len(indices)):
        sample_len = max(sample_len, int(sizes[pos]))
        if max_tokens > 0 and sample_len > max_tokens:
            raise AssertionError(f"sentence at index {int(indices[pos])} of size {sample_len} exceeds "
                                 f"max_tokens limit of {max_tokens}!")
        batch_len = pos - start
        if _is_batch_full(batch_len, (batch_len + 1) * sample_len, max_tokens, max_sentences):
            mod_len = max(bsz_mult * (batch_len // bsz_mult), batch_len % bsz_mult)
            batches.append(indices[start:start + mod_len].tolist())
            start += mod_len
            sample_len = int(sizes[start:pos + 1].max())
    if start < len(indices):
        batches.append(indices[start:].tolist())
    return batches


def _raise_invalid_size(idx, size, max_positions):
    raise Exception(f"Size of sample #{idx} is invalid (={size}) since max_positions={max_positions}, "
                    f"skip this example with --skip-invalid-size-inputs-valid-test")


def filter_by_size_vec(indices: np.ndarray, src_sizes: np.ndarray, tgt_sizes: Optional[np.ndarray],
                       max_positions, raise_exception: bool = False):
    """The indices whose source (and target) sizes are within
    ``max_positions``, for datasets with size arrays. Returns (kept,
    ignored)."""
    if isinstance(max_positions, (int, float)):
        max_src = max_tgt = max_positions
    else:
        max_src = max_positions[0]
        max_tgt = max_positions[1] if len(max_positions) > 1 else None
    indices = np.asarray(indices, dtype=np.int64)
    src_sizes = np.asarray(src_sizes)
    keep = np.ones(len(indices), dtype=bool)
    if max_src is not None:
        keep &= src_sizes[indices] <= max_src
    if tgt_sizes is not None and max_tgt is not None:
        keep &= np.asarray(tgt_sizes)[indices] <= max_tgt
    ignored = indices[~keep].tolist()
    if ignored and raise_exception:
        first = ignored[0]
        size = (int(src_sizes[first]) if tgt_sizes is None
                else (int(src_sizes[first]), int(np.asarray(tgt_sizes)[first])))
        _raise_invalid_size(first, size, max_positions)
    return indices[keep], ignored


def filter_by_size(indices: np.ndarray, size_fn: Callable[[int], object], max_positions,
                   raise_exception: bool = False):
    """The indices whose size is within ``max_positions`` (component-wise
    for tuple sizes; reference fairseq/data/data_utils.py:163-198). Returns
    (kept, ignored)."""

    def check(idx) -> bool:
        size = size_fn(idx)
        if isinstance(size, (int, float, np.integer, np.floating)):
            mp = max_positions if isinstance(max_positions, (int, float)) else max_positions[0]
            return size <= mp
        if isinstance(max_positions, (int, float)):
            return all(s <= max_positions for s in size)
        return all(s <= mp for s, mp in zip(size, max_positions) if mp is not None)

    keep, ignored = [], []
    for idx in indices:
        (keep if check(int(idx)) else ignored).append(int(idx))
    if ignored and raise_exception:
        _raise_invalid_size(ignored[0], size_fn(ignored[0]), max_positions)
    return np.array(keep, dtype=np.int64), ignored


class ShapeBucketer:
    """Lengths rounded up to a closed geometric grid of pad targets
    (``fbk_fairseq_st_tpu/data/batching.py::ShapeBucketer`` :211): the
    sizes ``min_size * growth^k`` below ``max_size``, then ``max_size``.
    The JAX package pads every training and validation batch to these
    buckets; the port's ``cli/train`` does the same, so its batches are the
    JAX trainer's."""

    def __init__(self, min_size: int = 8, max_size: int = 4096, growth: float = 2 ** 0.5):
        sizes = []
        s = float(min_size)
        while s < max_size:
            sizes.append(int(math.ceil(s)))
            s *= growth
        sizes.append(int(max_size))
        self.sizes = sorted(set(sizes))

    def bucket(self, n: int) -> int:
        for s in self.sizes:
            if n <= s:
                return s
        return self.sizes[-1]
