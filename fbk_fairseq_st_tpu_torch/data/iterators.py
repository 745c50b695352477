"""Epoch batch iterators: a seeded shuffle, rank shards, counting.

The port's own copy of ``fbk_fairseq_st_tpu/data/iterators.py``
(``CountingIterator`` :24, ``ShardedIterator``, ``EpochBatchIterator``
:178; reference fairseq/data/iterators.py), without JAX's background
threads: the batches are collated on the caller's thread, when taken.
The mid-epoch resume (``state_dict`` / ``load_state_dict``) comes with
``cli/train``, its only user.
An epoch's batch order is a permutation drawn from seed + epoch; shards
take every ``num_shards``-th batch and fill a short shard with empty
batches, so every rank runs the same number of steps.
"""

from __future__ import annotations

import itertools
from typing import Callable, List, Optional

import numpy as np


class CountingIterator:
    """An iterator that counts what it has given (reference iterators.py:26-68)."""

    def __init__(self, iterable, start: int = 0, total: Optional[int] = None):
        self.iterable = iterable
        self.n = start
        self.total = total if total is not None else start + len(iterable)
        self._itr = iter(iterable)

    def __len__(self) -> int:
        return self.total

    def __iter__(self):
        return self

    def __next__(self):
        if self.n >= self.total:
            raise StopIteration
        x = next(self._itr)
        self.n += 1
        return x

    def has_next(self) -> bool:
        return self.n < self.total



class ShardedIterator(CountingIterator):
    """Every ``num_shards``-th element from ``shard_id``, a short shard
    filled with ``fill_value``."""

    def __init__(self, iterable, num_shards: int, shard_id: int, fill_value=None):
        if shard_id < 0 or shard_id >= num_shards:
            raise ValueError("shard_id must be between 0 and num_shards-1")
        sharded_len = int(np.ceil(len(iterable) / float(num_shards)))
        itr = (x for _, x in itertools.zip_longest(
            range(sharded_len), itertools.islice(iterable, shard_id, len(iterable), num_shards),
            fillvalue=fill_value))
        super().__init__(itr, start=0, total=sharded_len)


class EpochBatchIterator:
    """A reusable multi-epoch batch iterator (reference iterators.py:170-330)
    over ``batch_sampler``, lists of dataset indices; ``collate_pad_fn``
    gives a batch's pad targets (fixed shapes), or None."""

    def __init__(self, dataset, batch_sampler: List[List[int]], seed: int = 1, num_shards: int = 1,
                 shard_id: int = 0, epoch: int = 0,
                 collate_pad_fn: Optional[Callable[[List[int]], dict]] = None):
        self.dataset = dataset
        self.frozen_batches = tuple(tuple(b) for b in batch_sampler)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.collate_pad_fn = collate_pad_fn
        self.epoch = epoch
        self._cur_epoch_itr: Optional[CountingIterator] = None

    def __len__(self) -> int:
        return int(np.ceil(len(self.frozen_batches) / float(self.num_shards)))

    def next_epoch_itr(self, shuffle: bool = True) -> CountingIterator:
        self.epoch += 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        self._cur_epoch_itr = self._get_iterator_for_epoch(self.epoch, shuffle)
        return self._cur_epoch_itr

    def _get_iterator_for_epoch(self, epoch: int, shuffle: bool) -> CountingIterator:
        batches = self.frozen_batches
        if shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(len(batches))
            batches = [batches[i] for i in order]
        sharded = ShardedIterator(batches, self.num_shards, self.shard_id, fill_value=())

        def collate_gen():
            for batch_indices in sharded:
                if len(batch_indices) == 0:
                    yield {}
                    continue
                samples = [self.dataset[i] for i in batch_indices]
                pad_kwargs = self.collate_pad_fn(list(batch_indices)) if self.collate_pad_fn is not None else {}
                yield self.dataset.collater(samples, **pad_kwargs)

        return CountingIterator(collate_gen(), start=0, total=len(sharded))
