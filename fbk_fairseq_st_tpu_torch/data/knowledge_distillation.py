"""Knowledge-distillation data: a teacher's top-k outputs as indexed
datasets, and the wrapper that puts them in each batch.

The port's own copy of ``fbk_fairseq_st_tpu/data/knowledge_distillation.py``
(reference fairseq/data/knowledge_distillation.py): each utterance's
top-k teacher (index, logit) pairs, one (T, k) item per target, in the TNT
format of ``indexed_dataset`` but written without the Lua shift
(``TeacherOutputDatasetBuilder``: values stored as they are, :16-24);
``DatasetWithTeacherOutput`` pads each utterance's (T, k) items to the
batch's target length at collation (``teacher_idxs`` with the target
dictionary's pad, ``teacher_probs`` with 0) and puts them in the batch's
rows (:57-152).
"""

from __future__ import annotations

import numpy as np

from .datasets import Dataset
from .indexed_dataset import IndexedDataset, IndexedDatasetBuilder


class TeacherOutputDatasetBuilder(IndexedDatasetBuilder):
    """The TNT writer of (T, k) items, values stored as they are."""

    lua_compat_shift = 0


class TeacherOutputDataset(IndexedDataset):
    """The reader of (T, k) items: integer items as int64, float ones as
    float32 (the file's type decides), neither shifted."""

    def __getitem__(self, i: int) -> np.ndarray:
        a = self._read(i)
        return a.astype(np.int64) if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)

    @staticmethod
    def save_bin(prefix: str, data_list, dtype=np.float32) -> None:
        """Write ``data_list``'s items as ``prefix.bin`` / ``prefix.idx``."""
        builder = TeacherOutputDatasetBuilder(prefix + ".bin", dtype)
        for d in data_list:
            builder.add_item(np.asarray(d, dtype=dtype))
        builder.finalize(prefix + ".idx")


class DatasetWithTeacherOutput(Dataset):
    """``src``'s items with ``teacher_output = (idxs, logits)``; batches
    with ``teacher_idxs`` and ``teacher_probs`` (B, T_tgt, k)."""

    def __init__(self, src, teacher_probs, teacher_idxs, tgt_dict, distill_k: int):
        self.src = src
        self.teacher_probs = teacher_probs
        self.teacher_idxs = teacher_idxs
        self.tgt_dict = tgt_dict
        self.distill_k = distill_k

    def __getitem__(self, index):
        item = self.src[index]
        item["teacher_output"] = (self.teacher_idxs[index], self.teacher_probs[index])
        return item

    def __len__(self):
        return len(self.src)

    def num_tokens(self, index):
        return self.src.num_tokens(index)

    def size(self, index):
        return self.src.size(index)

    @property
    def sizes(self):
        return self.src.sizes

    def ordered_indices(self):
        return self.src.ordered_indices()

    def collater(self, samples, **pad_kwargs):
        batch = self.src.collater(samples, **pad_kwargs)
        if not batch or batch.get("target") is None:
            return batch
        n_rows, tgt_len = batch["target"].shape
        k = self.distill_k
        teacher_idxs = np.full((n_rows, tgt_len, k), self.tgt_dict.pad(), np.int64)
        teacher_probs = np.zeros((n_rows, tgt_len, k), np.float32)
        by_id = {s["id"]: s["teacher_output"] for s in samples}
        for row, s_id in enumerate(batch["id"].tolist()):
            if s_id in by_id:
                idxs, probs = by_id[s_id]
                t = min(idxs.shape[0], tgt_len)
                teacher_idxs[row, :t] = idxs[:t, :k]
                teacher_probs[row, :t] = probs[:t, :k]
        batch["teacher_idxs"] = teacher_idxs
        batch["teacher_probs"] = teacher_probs
        return batch
