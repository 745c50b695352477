"""Token dataset wrappers, numpy only.

The port's own copy of the wrappers of ``fbk_fairseq_st_tpu/data/wrappers.py``
that the text tasks use (``AppendTokenDataset`` :66, ``TruncateDataset``
:88, ``StripTokenDataset`` :113; reference fairseq/data/*_dataset.py):
the translation task's ``--truncate-source`` and the language-modeling
task's ``--truncate-sequence``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .datasets import Dataset


class BaseWrapperDataset(Dataset):
    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, index):
        return self.dataset[index]

    def __len__(self):
        return len(self.dataset)

    def num_tokens(self, index):
        return self.dataset.num_tokens(index)

    def size(self, index):
        return self.dataset.size(index)

    @property
    def sizes(self):
        return self.dataset.sizes

    def ordered_indices(self):
        return self.dataset.ordered_indices()


class AppendTokenDataset(BaseWrapperDataset):
    def __init__(self, dataset, token: Optional[int] = None):
        super().__init__(dataset)
        self.token = token

    def __getitem__(self, index):
        item = np.asarray(self.dataset[index])
        return item if self.token is None else np.concatenate([item, [self.token]])

    def num_tokens(self, index):
        return self.dataset.num_tokens(index) + int(self.token is not None)

    def size(self, index):
        return self.dataset.size(index) + int(self.token is not None)

    @property
    def sizes(self):
        return self.dataset.sizes + int(self.token is not None)


class TruncateDataset(BaseWrapperDataset):
    """Items cut to ``truncation_length`` tokens."""

    def __init__(self, dataset, truncation_length: int):
        super().__init__(dataset)
        self.truncation_length = truncation_length

    def __getitem__(self, index):
        return np.asarray(self.dataset[index])[:self.truncation_length]

    @property
    def sizes(self):
        return np.minimum(self.dataset.sizes, self.truncation_length)

    def num_tokens(self, index):
        return min(self.dataset.num_tokens(index), self.truncation_length)

    def size(self, index):
        return min(self.dataset.size(index), self.truncation_length)


class StripTokenDataset(BaseWrapperDataset):
    """Items with ``id_to_strip`` taken off both ends (the sizes stay the
    wrapped dataset's, as in JAX)."""

    def __init__(self, dataset, id_to_strip: int):
        super().__init__(dataset)
        self.id_to_strip = id_to_strip

    def __getitem__(self, index):
        item = np.asarray(self.dataset[index])
        while len(item) > 0 and item[-1] == self.id_to_strip:
            item = item[:-1]
        while len(item) > 0 and item[0] == self.id_to_strip:
            item = item[1:]
        return item
