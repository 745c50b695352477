"""Epoch batch iterators: a seeded shuffle, rank shards, counting, and
the mid-epoch resume.

The port's own copy of ``fbk_fairseq_st_tpu/data/iterators.py`` (reference
fairseq/data/iterators.py): ``EpochBatchIterator`` shuffles the batch list
with seed + epoch, shards it (a short shard filled with empty batches, so
every rank runs the same number of steps), counts what it has given for
``state_dict`` / ``load_state_dict``, and collates on a background thread
when ``buffer_size`` > 0 (``BufferedIterator``). ``GroupedIterator`` gives
the ``--update-freq`` microbatches of an update, and
``DevicePrefetchIterator`` stages batches on the card ahead of their step
with the trainer's ``stage_sample`` (pinned memory, a copy with
``non_blocking=True`` on a side stream; the step waits on its event).
A background iterator advances its source's count when it hands an item
over, not when it prefetches it, so a checkpoint never counts a batch
that was prefetched and not trained on.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np


class CountingIterator:
    """Iterator wrapper that counts elements (reference iterators.py:26-68)."""

    def __init__(self, iterable, start: int = 0, total: Optional[int] = None):
        self.iterable = iterable
        self.n = start
        self.total = (
            total if total is not None else start + len(iterable)  # type: ignore
        )
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

    def skip(self, num_to_skip: int) -> "CountingIterator":
        next(itertools.islice(self._itr, num_to_skip, num_to_skip), None)
        self.n += num_to_skip
        return self

    def take(self, n: int) -> None:
        self.total = min(self.total, n)


class GroupedIterator(CountingIterator):
    """Groups chunk_size elements per step (--update-freq microbatches;
    reference iterators.py GroupedIterator)."""

    def __init__(self, iterable, chunk_size: int):
        itr = _chunks(iterable, chunk_size)
        total = int(np.ceil(len(iterable) / float(chunk_size)))
        start = int(np.ceil(getattr(iterable, "n", 0) / float(chunk_size)))
        super().__init__(itr, start=start, total=total)
        self.chunk_size = chunk_size


def _chunks(itr, n):
    chunk = []
    for x in itr:
        chunk.append(x)
        if len(chunk) == n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


class _BackgroundIterator(CountingIterator):
    """Queue-fed background prefetch over a (Counting)iterator, optionally
    transforming items on the worker thread.

    The wrapped iterator's position is advanced on DELIVERY (when the
    consumer takes an item), not on production: the worker consumes the
    RAW underlying stream, and ``__next__`` syncs the wrapped counter to
    the consumed count. Mid-epoch resume state and ``end_of_epoch`` read
    that counter, so prefetched-but-untrained batches are never recorded
    as consumed (they would otherwise be silently skipped on resume)."""

    def __init__(self, iterable, size: int, transform=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._source = iterable
        start = getattr(iterable, "n", 0)
        total = len(iterable)
        raw = getattr(iterable, "_itr", None)
        src = (
            itertools.islice(raw, max(total - start, 0))
            if raw is not None
            else iter(iterable)
        )

        def worker():
            try:
                for item in src:
                    self._q.put(transform(item) if transform else item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

        def gen():
            while True:
                item = self._q.get()
                if item is self._sentinel:
                    if self._err is not None:
                        raise self._err
                    return
                yield item

        super().__init__(gen(), start=start, total=total)

    def __next__(self):
        x = super().__next__()
        if hasattr(self._source, "n"):
            self._source.n = self.n  # delivery-time position sync
        return x


class DevicePrefetchIterator(_BackgroundIterator):
    """Stages collated batches on the device ``lookahead`` batches ahead
    of their step, on a background thread (``stage_fn``, the trainer's
    ``stage_sample``), so the host-to-device copy overlaps the running
    step (the reference's pin_memory + non_blocking copies)."""

    def __init__(self, iterable, stage_fn, lookahead: int = 2):
        super().__init__(iterable, lookahead, transform=stage_fn)


class ShardedIterator(CountingIterator):
    """Pick every num_shards-th element, filling short shards with a fill
    value so all ranks run the same step count (reference iterators.py)."""

    def __init__(self, iterable, num_shards: int, shard_id: int, fill_value=None):
        if shard_id < 0 or shard_id >= num_shards:
            raise ValueError("shard_id must be between 0 and num_shards-1")
        sharded_len = int(np.ceil(len(iterable) / float(num_shards)))
        itr = map(
            lambda x: x[1],
            itertools.zip_longest(
                range(sharded_len),
                itertools.islice(iterable, shard_id, len(iterable), num_shards),
                fillvalue=fill_value,
            ),
        )
        super().__init__(itr, start=0, total=sharded_len)


class BufferedIterator(_BackgroundIterator):
    """Background-thread prefetch of host-side batch collation."""

    def __init__(self, size: int, iterable):
        super().__init__(iterable, size)


class EpochBatchIterator:
    """Reusable multi-epoch batch iterator (reference iterators.py:170-330).

    Args:
      dataset: Dataset with ``collater(samples, **pad_kwargs)``.
      batch_sampler: list of lists of dataset indices (from batch_by_size).
      collate_pad_fn: optional fn(batch_indices) -> dict of pad targets
        (the shape bucketizer hook).
    """

    def __init__(
        self,
        dataset,
        batch_sampler: List[List[int]],
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
        buffer_size: int = 0,
        epoch: int = 0,
        collate_pad_fn: Optional[Callable[[List[int]], dict]] = None,
    ):
        self.dataset = dataset
        self.frozen_batches = tuple(tuple(b) for b in batch_sampler)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.buffer_size = buffer_size
        self.collate_pad_fn = collate_pad_fn
        self.epoch = epoch
        self.shuffle = True
        self._cur_epoch_itr: Optional[CountingIterator] = None
        self._next_epoch_itr: Optional[CountingIterator] = None

    def __len__(self) -> int:
        return int(np.ceil(len(self.frozen_batches) / float(self.num_shards)))

    @property
    def iterations_in_epoch(self) -> int:
        if self._cur_epoch_itr is not None:
            return self._cur_epoch_itr.n
        if self._next_epoch_itr is not None:
            return self._next_epoch_itr.n
        return 0

    @property
    def next_epoch_idx(self) -> int:
        """The epoch the next ``next_epoch_itr`` gives: the current one
        when a restored iterator stands mid-way through it (reference
        iterators.py ``next_epoch_idx``)."""
        return self.epoch if self._next_epoch_itr is not None else self.epoch + 1

    def next_epoch_itr(self, shuffle: bool = True, fix_batches_to_gpus: bool = False):
        if self._next_epoch_itr is not None:
            self._cur_epoch_itr = self._next_epoch_itr
            self._next_epoch_itr = None
        else:
            self.epoch += 1
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(self.epoch)
            self._cur_epoch_itr = self._get_iterator_for_epoch(self.epoch, shuffle)
        self.shuffle = shuffle
        return self._cur_epoch_itr

    def end_of_epoch(self) -> bool:
        return not self._cur_epoch_itr.has_next()

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "iterations_in_epoch": self.iterations_in_epoch,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state_dict: dict) -> None:
        self.epoch = state_dict["epoch"]
        itr_pos = state_dict.get("iterations_in_epoch", 0)
        if itr_pos > 0:
            itr = self._get_iterator_for_epoch(
                self.epoch, shuffle=state_dict.get("shuffle", True)
            )
            if itr_pos < len(itr):
                self._next_epoch_itr = itr.skip(itr_pos)

    def _get_iterator_for_epoch(self, epoch: int, shuffle: bool):
        batches = self.frozen_batches
        if shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        sharded = ShardedIterator(
            batches, self.num_shards, self.shard_id, fill_value=()
        )

        def collate_gen():
            for batch_indices in sharded:
                if len(batch_indices) == 0:
                    yield {}
                    continue
                samples = [self.dataset[i] for i in batch_indices]
                pad_kwargs = (
                    self.collate_pad_fn(list(batch_indices))
                    if self.collate_pad_fn is not None
                    else {}
                )
                yield self.dataset.collater(samples, **pad_kwargs)

        itr = CountingIterator(collate_gen(), start=0, total=len(sharded))
        if self.buffer_size > 0:
            itr = BufferedIterator(self.buffer_size, itr)
        return itr
