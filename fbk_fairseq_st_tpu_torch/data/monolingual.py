"""Monolingual language-model data, numpy only.

The port's own copy of ``fbk_fairseq_st_tpu/data/monolingual.py``
(reference fairseq/data/token_block_dataset.py, monolingual_dataset.py,
lm_context_window_dataset.py):

  * ``TokenBlockDataset``: a token stream cut into blocks by
    ``--sample-break-mode`` (``none``: fixed blocks across sentences;
    ``complete``: whole sentences up to the block size; ``complete_doc``:
    the same within documents, an empty line between them; ``eos``: a
    sentence a block), with the shifted source and past-target streams;
  * ``MonolingualDataset``: the ``self`` / ``future`` / ``past`` targets,
    ``--add-bos-token`` and the truncated output dictionary's unk;
  * ``LMContextWindowDataset``: evaluation rows prefixed with up to
    ``context_window`` tokens carried over from the rows before, whose
    targets are pad (a stateful collater: evaluate in order).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .datasets import Dataset
from .language_pair_dataset import collate_tokens


def _complete_blocks(sizes: np.ndarray, block_size: int) -> np.ndarray:
    """Greedy whole-sentence packing into <=block_size blocks (the loop
    the reference compiles with Cython, token_block_utils_fast.pyx; JAX's
    C++ twin and its Python fallback give the same blocks)."""
    out = []
    tok_idx = 0
    sz_idx = 0
    curr_size = 0
    while sz_idx < len(sizes):
        if curr_size + sizes[sz_idx] <= block_size or curr_size == 0:
            curr_size += int(sizes[sz_idx])
            sz_idx += 1
        else:
            out.append((tok_idx, tok_idx + curr_size))
            tok_idx += curr_size
            curr_size = 0
    if curr_size > 0:
        out.append((tok_idx, tok_idx + curr_size))
    return np.array(out, dtype=np.int64)


def _complete_doc_blocks(sizes: np.ndarray, block_size: int,
                         document_sep_len: int) -> np.ndarray:
    """'complete_doc': like 'complete' but a sentence of exactly
    document_sep_len tokens (an empty line, binarized to a lone eos) is a
    document boundary no block may cross (reference
    token_block_utils_fast.pyx:75-95)."""
    out = []
    tok_idx = 0
    sz_idx = 0
    curr_size = 0
    while sz_idx < len(sizes):
        if (
            curr_size + sizes[sz_idx] <= block_size or curr_size == 0
        ) and sizes[sz_idx] != document_sep_len:
            curr_size += int(sizes[sz_idx])
            sz_idx += 1
        else:
            if curr_size > 1:  # only keep non-empty documents
                out.append((tok_idx, tok_idx + curr_size))
            tok_idx += curr_size
            curr_size = 0
            if sizes[sz_idx] == document_sep_len:
                tok_idx += int(sizes[sz_idx])
                sz_idx += 1
    if curr_size > 1:
        out.append((tok_idx, tok_idx + curr_size))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


class TokenBlockDataset(Dataset):
    """Chunk a stream of items into blocks.

    break_mode:
      * 'none': concatenate everything, fixed block_size chunks;
      * 'complete': blocks of whole sentences up to block_size;
      * 'complete_doc': 'complete' within document boundaries;
      * 'eos': one sentence per block.

    include_targets: items become (source, target, past_target) where
    target is the block, source is it shifted right by 1 (crossing block
    boundaries; eos-padded at the stream start) and past_target shifted
    right by 2 (reference token_block_dataset.py:120-146).
    """

    def __init__(self, dataset, sizes, block_size: Optional[int],
                 pad: int, eos: int, break_mode: str = "none",
                 include_targets: bool = False, document_sep_len: int = 1):
        self.dataset = dataset
        self.pad = pad
        self.eos = eos
        self.include_targets = include_targets
        sizes = np.asarray(sizes, dtype=np.int64)

        if break_mode is None:
            break_mode = "none"
        if break_mode == "none":
            total = int(sizes.sum())
            length = max(block_size, 1)
            starts = np.arange(0, total, length, dtype=np.int64)
            ends = np.minimum(starts + length, total)
            slice_indices = np.stack([starts, ends], axis=1)
        elif break_mode == "complete":
            slice_indices = _complete_blocks(sizes, int(block_size))
        elif break_mode == "complete_doc":
            slice_indices = _complete_doc_blocks(
                sizes, int(block_size), document_sep_len
            )
        elif break_mode == "eos":
            cum = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
            slice_indices = np.stack([cum[:-1], cum[1:]], axis=1)
        else:
            raise ValueError(f"invalid break_mode: {break_mode}")

        self.slice_indices = slice_indices.reshape(-1, 2)
        self._sizes = self.slice_indices[:, 1] - self.slice_indices[:, 0]
        # item -> (first dataset idx, offset) map for lazy reads
        self._ds_sizes = sizes
        self._cum = np.concatenate([[0], np.cumsum(sizes)])

    def _read_range(self, start: int, end: int) -> np.ndarray:
        first = int(np.searchsorted(self._cum, start, side="right") - 1)
        out = []
        pos = self._cum[first]
        i = first
        while pos < end and i < len(self._ds_sizes):
            item = np.asarray(self.dataset[i])
            s = max(start - pos, 0)
            e = min(end - pos, len(item))
            out.append(item[int(s): int(e)])
            pos += len(item)
            i += 1
        return np.concatenate(out) if out else np.array([], np.int64)

    def __getitem__(self, index):
        start, end = (int(x) for x in self.slice_indices[index])
        item = self._read_range(start, end)
        if not self.include_targets:
            return item
        # reference token_block_dataset.py:128-146: shifts read PREVIOUS
        # stream tokens across block boundaries; only the stream start is
        # eos- (and pad-)padded
        dt = item.dtype
        if start == 0:
            source = np.concatenate(
                [np.array([self.eos], dt), self._read_range(0, end - 1)]
            )
            past_target = np.concatenate(
                [np.array([self.pad, self.eos], dt),
                 self._read_range(0, end - 2)]
            )
        else:
            source = self._read_range(start - 1, end - 1)
            if start == 1:
                past_target = np.concatenate(
                    [np.array([self.eos], dt), self._read_range(0, end - 2)]
                )
            else:
                past_target = self._read_range(start - 2, end - 2)
        return source, item, past_target

    def __len__(self):
        return len(self.slice_indices)

    @property
    def sizes(self):
        return self._sizes

    def num_tokens(self, index):
        return int(self._sizes[index])

    def size(self, index):
        return int(self._sizes[index])


class MonolingualDataset(Dataset):
    """LM dataset (reference monolingual_dataset.py:50-200): wraps a token
    stream (plain items, or the (source, future, past) triples of an
    include_targets TokenBlockDataset) into net_input/target samples.

    targets: subset of {'self', 'future', 'past'} — 'future' is the block
    itself (standard LM), 'self' the eos-shifted source (MLM-style scoring),
    'past' the twice-shifted stream. More than one target collates
    ``target`` as a list in that order. None (or a plain wrapped dataset)
    keeps the single-future fast path.
    """

    def __init__(self, dataset, sizes, vocab, tgt_vocab=None,
                 add_eos_for_other_targets: bool = False,
                 shuffle: bool = False, targets=None,
                 add_bos_token: bool = False):
        self.dataset = dataset
        self._sizes = np.asarray(sizes)
        self.vocab = vocab
        self.tgt_vocab = tgt_vocab if tgt_vocab is not None else vocab
        self.add_eos_for_other_targets = add_eos_for_other_targets
        self.shuffle = shuffle
        self.add_bos_token = add_bos_token
        assert targets is None or all(
            t in {"self", "future", "past"} for t in targets
        ), "targets must be none or one of 'self', 'future', 'past'"
        if targets is not None and len(targets) == 0:
            targets = None
        self.targets = targets

    def __getitem__(self, index):
        item = self.dataset[index]
        if isinstance(item, tuple):
            source, future_target, past_target = (
                np.asarray(x) for x in item
            )
            source, target = self._make_source_target(
                source, future_target, past_target
            )
        else:
            tokens = np.asarray(item)
            source = np.concatenate([[self.vocab.eos()], tokens[:-1]])
            target = self._filter_vocab(tokens)
        source, target = self._maybe_add_bos(source, target)
        return {"id": index, "source": source, "target": target}

    def __len__(self):
        return len(self.dataset)

    def _make_source_target(self, source, future_target, past_target):
        """reference monolingual_dataset.py:103-131."""
        if self.targets is None:
            return source, self._filter_vocab(future_target)
        target = []
        if (
            self.add_eos_for_other_targets
            and (("self" in self.targets) or ("past" in self.targets))
            and source[-1] != self.vocab.eos()
        ):
            # append eos at the end of source
            source = np.concatenate([source, [self.vocab.eos()]])
            if "future" in self.targets:
                future_target = np.concatenate(
                    [future_target, [self.vocab.pad()]]
                )
            if "past" in self.targets:
                past_target = np.concatenate(
                    [[self.vocab.pad()], past_target[1:], source[-2:-1]]
                )
        for t in self.targets:
            if t == "self":
                target.append(source)
            elif t == "future":
                target.append(future_target)
            else:
                target.append(past_target)
        if len(target) == 1:
            target = target[0]
        return source, self._filter_vocab(target)

    def _maybe_add_bos(self, source, target):
        if self.add_bos_token:
            source = np.concatenate([[self.vocab.bos()], source])
            if isinstance(target, list):
                target = [
                    np.concatenate([[self.tgt_vocab.bos()], t])
                    for t in target
                ]
            elif target is not None:
                target = np.concatenate([[self.tgt_vocab.bos()], target])
        return source, target

    def _filter_vocab(self, target):
        """--output-dictionary-size: ids past the truncated output vocab
        become unk (reference :139-150)."""
        if len(self.tgt_vocab) == len(self.vocab):
            return target

        def _filter(t):
            return np.where(t >= len(self.tgt_vocab), self.tgt_vocab.unk(), t)

        if isinstance(target, list):
            return [_filter(t) for t in target]
        return _filter(target)

    def collater(self, samples, pad_to_src_len=None, pad_to_tgt_len=None,
                 pad_to_bsz=None):
        if len(samples) == 0:
            return {}
        pad = self.vocab.pad()
        eos = self.vocab.eos()
        ids = np.array([s["id"] for s in samples], np.int64)
        src = collate_tokens(
            [s["source"] for s in samples], pad, eos,
            pad_to_length=pad_to_tgt_len,
        )

        def merge_target(i=None):
            return collate_tokens(
                [(s["target"] if i is None else s["target"][i])
                 for s in samples],
                pad, eos, pad_to_length=pad_to_tgt_len,
            )

        is_list = isinstance(samples[0]["target"], list)
        tgt = (
            [merge_target(i) for i in range(len(samples[0]["target"]))]
            if is_list else merge_target()
        )
        lengths = np.array([len(s["source"]) for s in samples], np.int64)
        nsentences = len(samples)
        if pad_to_bsz is not None and pad_to_bsz > nsentences:
            extra = pad_to_bsz - nsentences
            ids = np.concatenate([ids, np.full(extra, -1, np.int64)])
            src = np.concatenate([src, np.full((extra, src.shape[1]), pad, src.dtype)])

            def pad_rows(t):
                return np.concatenate(
                    [t, np.full((extra, t.shape[1]), pad, t.dtype)]
                )

            tgt = [pad_rows(t) for t in tgt] if is_list else pad_rows(tgt)
            lengths = np.concatenate([lengths, np.zeros(extra, np.int64)])
        return {
            "id": ids,
            "nsentences": nsentences,
            "ntokens": int(sum(len(s["source"]) for s in samples)),
            "net_input": {
                "src_tokens": src,
                "src_lengths": lengths,
            },
            "target": tgt,
        }

    def num_tokens(self, index):
        return int(self._sizes[index])

    def size(self, index):
        return int(self._sizes[index])

    @property
    def sizes(self):
        return self._sizes

    def ordered_indices(self):
        if self.shuffle:
            order = np.random.permutation(len(self)).astype(np.int64)
        else:
            order = np.arange(len(self), dtype=np.int64)
        return order[np.argsort(self._sizes[order], kind="mergesort")]


class LMContextWindowDataset(Dataset):
    """Sliding-window LM evaluation (reference
    data/lm_context_window_dataset.py): each collated batch row is prefixed
    with up to ``context_window`` tokens of trailing context carried over
    from previously collated rows; context positions receive pad targets so
    the NLL is scored only over the fresh window. The collater is stateful
    across calls — evaluate in order, single process."""

    def __init__(self, dataset, tokens_per_sample: int, context_window: int,
                 pad_idx: int):
        assert context_window > 0
        self.dataset = dataset
        self.tokens_per_sample = tokens_per_sample
        self.context_window = context_window
        self.pad_idx = pad_idx
        self._carry = np.empty(0, np.int64)

    def __getitem__(self, index):
        return self.dataset[index]

    def __len__(self):
        return len(self.dataset)

    def collater(self, samples, **unused):
        base = self.dataset.collater(samples)
        if not base:
            return base
        pad = self.pad_idx
        cw = self.context_window
        budget = self.tokens_per_sample + cw

        toks = np.asarray(base["net_input"]["src_tokens"])
        tgt = np.asarray(base["target"])
        lengths = np.asarray(base["net_input"]["src_lengths"]).copy()
        bsz, tsz = toks.shape
        out_toks = np.full((bsz, tsz + cw), pad, np.int64)
        out_tgt = np.full((bsz, tsz + cw), pad, np.int64)
        starts = np.zeros(bsz, np.int64)
        for i in range(bsz):
            row_len = int((toks[i] != pad).sum())
            # trim carried context so context + sample fits the budget
            overflow = len(self._carry) + row_len - budget
            if overflow > 0:
                self._carry = self._carry[overflow:]
            c = len(self._carry)
            out_toks[i, :c] = self._carry
            out_toks[i, c:c + tsz] = toks[i]
            out_tgt[i, c:c + tsz] = tgt[i]
            starts[i] = c
            lengths[i] += c
            row = out_toks[i]
            self._carry = row[row != pad][-cw:].astype(np.int64)
        base["net_input"]["src_tokens"] = out_toks
        base["net_input"]["src_lengths"] = lengths
        base["target"] = out_tgt
        base["start_indices"] = starts
        return base

    def num_tokens(self, index):
        return self.dataset.num_tokens(index)

    def size(self, index):
        return self.dataset.size(index)

    @property
    def sizes(self):
        return self.dataset.sizes

    def ordered_indices(self):
        return self.dataset.ordered_indices()
