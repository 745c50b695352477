"""Text translation pairs and their collater, numpy only.

The port's own copy of ``fbk_fairseq_st_tpu/data/language_pair_dataset.py``
(``__getitem__`` :57, ``collater`` :72-142) and of
``data/datasets.py::collate_tokens`` (:71), as the serving and training
paths of a text model need them (reference fairseq/data/
language_pair_dataset.py:17-110):

  * sources padded on the left by default, targets on the right;
  * rows sorted by descending source length (a stable sort);
  * ``prev_output_tokens`` is the target with its last token (eos) moved
    to the front;
  * ``pad_to_src_len`` / ``pad_to_tgt_len`` / ``pad_to_bsz`` pad to fixed
    shapes (extra rows get id -1, pads and length 0).

The size methods (``num_tokens``, ``num_tokens_vec``,
``filter_indices_by_size``, ``size``, ``ordered_indices``: sorted by
target, then source length, from a seeded permutation with ``shuffle``)
feed the task's batch iterator. With an ``align_dataset`` (one (n, 2)
array of (source, target) positions a pair, ``--load-alignments``) each
item carries its ``alignment`` and the collater a dense ``align_weights``
(B, T_tgt, T_src): 1/count of the target position's links at each link,
the source positions shifted by the left padding (JAX :143-165), links
past the source's length dropped (JAX indexes past the row there). The
options no port caller sets (``input_feeding``, ``append_eos_to_target``,
an ``eos`` other than </s>) are not ported.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def collate_tokens(values: List[np.ndarray], pad_idx: int, eos_idx: Optional[int] = None,
                   left_pad: bool = False, move_eos_to_beginning: bool = False,
                   pad_to_length: Optional[int] = None) -> np.ndarray:
    """Pad a list of 1-D token arrays into a (B, T) int64 batch. With
    ``move_eos_to_beginning`` each row's last token (its terminator) moves
    to the front."""
    size = max(len(v) for v in values)
    if pad_to_length is not None:
        size = max(size, pad_to_length)
    res = np.full((len(values), size), pad_idx, dtype=np.int64)
    for i, v in enumerate(values):
        v = np.asarray(v)
        if move_eos_to_beginning:
            v = np.concatenate([v[-1:], v[:-1]])
        if left_pad:
            res[i, size - len(v):] = v
        else:
            res[i, :len(v)] = v
    return res


class LanguagePairDataset:
    """``src`` / ``tgt``: sequences of 1-D token-id arrays (each ending in
    eos), with their sizes, as the JAX constructor takes them."""

    def __init__(self, src, src_sizes, src_dict, tgt=None, tgt_sizes=None, tgt_dict=None,
                 left_pad_source: bool = True, left_pad_target: bool = False, shuffle: bool = True,
                 align_dataset=None):
        self.shuffle = shuffle
        self.align_dataset = align_dataset
        self.src = src
        self.tgt = tgt
        self.src_sizes = np.array(src_sizes)
        self.tgt_sizes = np.array(tgt_sizes) if tgt_sizes is not None else None
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict if tgt_dict is not None else src_dict
        self.left_pad_source = left_pad_source
        self.left_pad_target = left_pad_target

    def __getitem__(self, index: int):
        tgt_item = np.asarray(self.tgt[index]) if self.tgt is not None else None
        item = {"id": index, "source": np.asarray(self.src[index]), "target": tgt_item}
        if self.align_dataset is not None:
            item["alignment"] = np.asarray(self.align_dataset[index])
        return item

    def __len__(self) -> int:
        return len(self.src)

    def collater(self, samples, pad_to_src_len: Optional[int] = None,
                 pad_to_tgt_len: Optional[int] = None, pad_to_bsz: Optional[int] = None):
        """A list of ``__getitem__`` items -> {id, nsentences, ntokens,
        net_input: {src_tokens, src_lengths, prev_output_tokens}, target}
        as numpy arrays."""
        if len(samples) == 0:
            return {}
        pad_idx = self.src_dict.pad()
        ids = np.array([s["id"] for s in samples], dtype=np.int64)
        src_tokens = collate_tokens([s["source"] for s in samples], pad_idx, self.src_dict.eos(),
                                    left_pad=self.left_pad_source, pad_to_length=pad_to_src_len)
        src_lengths = np.array([len(s["source"]) for s in samples], np.int64)
        sort_order = np.argsort(-src_lengths, kind="stable")
        ids, src_tokens, src_lengths = ids[sort_order], src_tokens[sort_order], src_lengths[sort_order]

        target = prev_output_tokens = None
        ntokens = int(src_lengths.sum())
        if samples[0].get("target") is not None:
            tgt_pad, tgt_eos = self.tgt_dict.pad(), self.tgt_dict.eos()
            targets = [s["target"] for s in samples]
            target = collate_tokens(targets, tgt_pad, tgt_eos, left_pad=self.left_pad_target,
                                    pad_to_length=pad_to_tgt_len)[sort_order]
            ntokens = int(sum(len(t) for t in targets))
            prev_output_tokens = collate_tokens(
                targets, tgt_pad, tgt_eos, left_pad=self.left_pad_target, move_eos_to_beginning=True,
                pad_to_length=pad_to_tgt_len)[sort_order]

        nsentences = len(samples)
        if pad_to_bsz is not None and pad_to_bsz > nsentences:
            extra = pad_to_bsz - nsentences

            def pad_rows(a, fill):
                if a is None:
                    return None
                return np.concatenate([a, np.full((extra,) + a.shape[1:], fill, a.dtype)])

            ids = pad_rows(ids, -1)
            src_tokens = pad_rows(src_tokens, pad_idx)
            src_lengths = pad_rows(src_lengths, 0)
            target = pad_rows(target, self.tgt_dict.pad())
            prev_output_tokens = pad_rows(prev_output_tokens, self.tgt_dict.pad())

        batch = {
            "id": ids,
            "nsentences": nsentences,
            "ntokens": ntokens,
            "net_input": {"src_tokens": src_tokens, "src_lengths": src_lengths},
            "target": target,
        }
        if prev_output_tokens is not None:
            batch["net_input"]["prev_output_tokens"] = prev_output_tokens
        if self.align_dataset is not None and target is not None:
            batch["align_weights"] = self._align_weights([samples[i] for i in sort_order], target.shape,
                                                         src_tokens.shape[1], src_lengths)
        return batch

    def _align_weights(self, ordered, tgt_shape, t_src: int, src_lengths) -> np.ndarray:
        rows, t_tgt = tgt_shape
        weights = np.zeros((rows, t_tgt, t_src), np.float32)
        for row, s in enumerate(ordered):
            align = s.get("alignment")
            if align is None or len(align) == 0:
                continue
            # links past the source's own length (a source cut by
            # --truncate-source) are dropped: JAX keeps those below the
            # padded length and indexes past the row (ROADMAP Queue C)
            align = align[(align[:, 0] < min(t_src, src_lengths[row])) & (align[:, 1] < t_tgt)]
            if self.left_pad_source:  # source positions count from the right-aligned sentence
                align = align.copy()
                align[:, 0] += t_src - src_lengths[row]
            counts = np.bincount(align[:, 1], minlength=t_tgt)
            weights[row, align[:, 1], align[:, 0]] = 1.0 / np.maximum(counts[align[:, 1]], 1)
        return weights

    def num_tokens(self, index):
        return max(self.src_sizes[index], self.tgt_sizes[index] if self.tgt_sizes is not None else 0)

    def num_tokens_vec(self, indices):
        toks = self.src_sizes[indices]
        if self.tgt_sizes is not None:
            toks = np.maximum(toks, self.tgt_sizes[indices])
        return toks.astype(np.int64)

    def filter_indices_by_size(self, indices, max_positions, raise_exception=False):
        from .batching import filter_by_size_vec

        return filter_by_size_vec(indices, self.src_sizes, self.tgt_sizes, max_positions,
                                  raise_exception=raise_exception)

    def size(self, index):
        return (self.src_sizes[index], self.tgt_sizes[index] if self.tgt_sizes is not None else 0)

    @property
    def sizes(self):
        return self.src_sizes

    def ordered_indices(self):
        """By target, then source length (stable), from a permutation of
        numpy's global generator with ``shuffle`` (the task seeds it)."""
        if self.shuffle:
            indices = np.random.permutation(len(self)).astype(np.int64)
        else:
            indices = np.arange(len(self), dtype=np.int64)
        if self.tgt_sizes is not None:
            indices = indices[np.argsort(self.tgt_sizes[indices], kind="mergesort")]
        return indices[np.argsort(self.src_sizes[indices], kind="mergesort")]
