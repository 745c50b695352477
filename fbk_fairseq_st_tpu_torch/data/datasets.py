"""Speech-to-text datasets, their collation and concatenation, numpy only.

The port's own copy of ``fbk_fairseq_st_tpu/data/datasets.py``
(``collate_frames`` :104, ``apply_mv_norm`` :118, ``Seq2SeqCollater``
:131, ``FilterBankToTextDataset`` :223, ``TranscriptionWrapperDataset``
:279, ``ContextAwareDataset`` :357, ``MultiTaskDataset`` :428, ``LangtokFilterBanksToTextDataset`` :473,
``RoundRobinZipDatasets`` :520, ``ConcatDataset`` :589;
``collate_tokens`` :71 is
``language_pair_dataset.collate_tokens``), the reference contracts:

  * per-utterance CMVN (examples/speech_recognition/data/data_utils.py:
    9-24), in numpy with JAX's arithmetic types: the mean and the ddof=1
    variance of float32 frames in float32, the result cast back, so the
    last bits of every frame match;
  * the Seq2SeqCollater batch layout (examples/speech_recognition/data/
    collaters.py): {id, ntokens, nsentences, net_input: {src_tokens,
    src_lengths, prev_output_tokens}, target, target_lengths}, the
    samples sorted by descending frame count (a stable sort);
  * ``pad_to_src_len`` / ``pad_to_tgt_len`` / ``pad_to_bsz`` pad to fixed
    shapes (extra rows get id -1, zeros and pads).
"""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np

from .language_pair_dataset import collate_tokens


class Dataset:
    """Base dataset (reference FairseqDataset)."""

    def num_tokens_vec(self, indices) -> np.ndarray:
        return np.fromiter((self.num_tokens(int(i)) for i in indices), dtype=np.int64, count=len(indices))

    def ordered_indices(self) -> np.ndarray:
        return np.arange(len(self), dtype=np.int64)

    def set_epoch(self, epoch: int) -> None:
        pass


def collate_frames(frames: List[np.ndarray], pad_to_length: Optional[int] = None) -> np.ndarray:
    """Pad (T_i, F) float arrays into a zero-filled (B, T_max, F)."""
    len_max = max(f.shape[0] for f in frames)
    if pad_to_length is not None:
        len_max = max(len_max, pad_to_length)
    res = np.zeros((len(frames), len_max, frames[0].shape[1]), dtype=frames[0].dtype)
    for i, v in enumerate(frames):
        res[i, : v.shape[0]] = v
    return res


def apply_mv_norm(features: np.ndarray) -> np.ndarray:
    """Per-utterance CMVN with the ddof=1 variance, eps 1e-8 only where a
    variance is under it."""
    mean = features.mean(0)
    var = features.var(0, ddof=1)
    eps = 1e-8
    if (var < eps).any():
        inv = 1.0 / (np.sqrt(var) + eps)
    else:
        inv = 1.0 / np.sqrt(var)
    return ((features - mean) * inv).astype(features.dtype)


class Seq2SeqCollater:
    """Speech -> text batch assembly (reference collaters.py:21-140)."""

    def __init__(self, pad_index: int = 1, eos_index: int = 2, move_eos_to_beginning: bool = True):
        self.pad_index = pad_index
        self.eos_index = eos_index
        self.move_eos_to_beginning = move_eos_to_beginning

    def collate(self, samples, pad_to_src_len: Optional[int] = None, pad_to_tgt_len: Optional[int] = None,
                pad_to_bsz: Optional[int] = None):
        samples = [s for s in samples if s.get("source") is not None]
        if not samples:
            return {}
        ids = np.array([s["id"] for s in samples], dtype=np.int64)
        frames = collate_frames([s["source"] for s in samples], pad_to_src_len)
        frames_lengths = np.array([s["source"].shape[0] for s in samples], dtype=np.int64)
        sort_order = np.argsort(-frames_lengths, kind="stable")
        ids, frames, frames_lengths = ids[sort_order], frames[sort_order], frames_lengths[sort_order]

        target = target_lengths = prev_output_tokens = None
        if samples[0].get("target") is not None:
            targets = [s["target"] for s in samples]
            ntokens = sum(len(t) for t in targets)
            target = collate_tokens(targets, self.pad_index, self.eos_index, pad_to_length=pad_to_tgt_len)[sort_order]
            target_lengths = np.array([len(t) for t in targets], dtype=np.int64)[sort_order]
            prev_output_tokens = collate_tokens(targets, self.pad_index, self.eos_index,
                                                move_eos_to_beginning=self.move_eos_to_beginning,
                                                pad_to_length=pad_to_tgt_len)[sort_order]
        else:
            ntokens = sum(s["source"].shape[0] for s in samples)

        nsentences = len(samples)
        if pad_to_bsz is not None and pad_to_bsz > nsentences:
            extra = pad_to_bsz - nsentences

            def pad_rows(a, fill):
                if a is None:
                    return None
                return np.concatenate([a, np.full((extra,) + a.shape[1:], fill, dtype=a.dtype)], axis=0)

            ids, frames, frames_lengths = pad_rows(ids, -1), pad_rows(frames, 0.0), pad_rows(frames_lengths, 0)
            target, target_lengths = pad_rows(target, self.pad_index), pad_rows(target_lengths, 0)
            prev_output_tokens = pad_rows(prev_output_tokens, self.pad_index)

        batch = {"id": ids, "ntokens": ntokens, "nsentences": nsentences,
                 "net_input": {"src_tokens": frames, "src_lengths": frames_lengths},
                 "target": target, "target_lengths": target_lengths}
        if prev_output_tokens is not None:
            batch["net_input"]["prev_output_tokens"] = prev_output_tokens
        return batch


class FilterBankToTextDataset(Dataset):
    """Precomputed filterbanks and their target text (reference
    fbank_dataset.py:17-152)."""

    def __init__(self, src_dataset, tgt_dataset, tgt_dict, skip_normalization: bool = False):
        if tgt_dataset is not None and len(src_dataset) != len(tgt_dataset):
            raise ValueError("source and target datasets differ in length")
        self.src_dataset = src_dataset
        self.tgt_dataset = tgt_dataset
        self.tgt_dict = tgt_dict
        self.skip_normalization = skip_normalization
        self.s2s_collater = Seq2SeqCollater(pad_index=tgt_dict.pad(), eos_index=tgt_dict.eos())

    def __getitem__(self, index):
        src_item = np.asarray(self.src_dataset[index])
        if not self.skip_normalization:
            src_item = apply_mv_norm(src_item)
        tgt_item = np.asarray(self.tgt_dataset[index]) if self.tgt_dataset is not None else None
        return {"id": index, "source": src_item, "target": tgt_item}

    def __len__(self):
        return len(self.src_dataset)

    def collater(self, samples, **pad_kwargs):
        return self.s2s_collater.collate(samples, **pad_kwargs)

    def num_tokens(self, index):
        return self.src_dataset.size(index)

    def size(self, index):
        return (self.src_dataset.size(index),
                self.tgt_dataset.size(index) if self.tgt_dataset is not None else 0)

    @property
    def sizes(self):
        return self.tgt_dataset.sizes if self.tgt_dataset is not None else None


class TranscriptionWrapperDataset(Dataset):
    """Adds the transcripts to each batch (reference examples/
    speech_recognition/data/transcription_dataset.py): ``transcript_target``,
    ``transcript_target_lengths`` and
    ``net_input.transcript_prev_output_tokens``, in the row order of the
    wrapped collater."""

    def __init__(self, tgt_dataset, transcription_dataset, transcription_dict):
        self.tgt_dataset = tgt_dataset
        self.transcription_dataset = transcription_dataset
        self.transcription_dict = transcription_dict

    def __getitem__(self, index):
        item = self.tgt_dataset[index]
        item["transcript_target"] = np.asarray(self.transcription_dataset[index])
        return item

    def __len__(self):
        return len(self.tgt_dataset)

    def collater(self, samples, pad_to_src_len=None, pad_to_tgt_len=None, pad_to_bsz=None):
        batch = self.tgt_dataset.collater(samples, pad_to_src_len=pad_to_src_len, pad_to_tgt_len=pad_to_tgt_len,
                                          pad_to_bsz=pad_to_bsz)
        if not batch:
            return {}
        id_to_pos = {s["id"]: i for i, s in enumerate(samples)}
        order = [id_to_pos[int(i)] for i in batch["id"] if int(i) in id_to_pos]
        transcripts = [samples[i]["transcript_target"] for i in order]
        pad, eos = self.transcription_dict.pad(), self.transcription_dict.eos()
        lens = np.array([len(t) for t in transcripts], dtype=np.int64)
        tt = collate_tokens(transcripts, pad, eos, pad_to_length=pad_to_tgt_len)
        prev = collate_tokens(transcripts, pad, eos, move_eos_to_beginning=True, pad_to_length=pad_to_tgt_len)
        n_rows = batch["target"].shape[0] if batch.get("target") is not None else len(order)
        if n_rows > len(order):  # the fixed-shape batch's padding rows
            extra = n_rows - len(order)
            tt = np.concatenate([tt, np.full((extra, tt.shape[1]), pad, tt.dtype)])
            prev = np.concatenate([prev, np.full((extra, prev.shape[1]), pad, prev.dtype)])
            lens = np.concatenate([lens, np.zeros(extra, lens.dtype)])
        batch["transcript_target"] = tt
        batch["transcript_target_lengths"] = lens
        batch["net_input"]["transcript_prev_output_tokens"] = prev
        return batch

    def num_tokens(self, index):
        return self.tgt_dataset.num_tokens(index)

    def size(self, index):
        return self.tgt_dataset.size(index)

    @property
    def sizes(self):
        return self.tgt_dataset.sizes

    def ordered_indices(self):
        return self.tgt_dataset.ordered_indices()


class ContextAwareDataset(Dataset):
    """Adds each utterance's context, the previous audio or the previous
    target text, to each batch (reference examples/speech_recognition/
    data/context_dataset.py): ``net_input.context_tokens`` and
    ``net_input.context_lengths`` in the row order of the wrapped
    collater; audio collated as frames (zeros, ``pad_to_src_len``), text as
    tokens (pad, ``pad_to_tgt_len``); a fixed-shape batch's padding rows
    get a fill row and length 0."""

    def __init__(self, dataset, context_dataset, context_dict, audio_context: bool):
        self.dataset = dataset
        self.context_dataset = context_dataset
        self.context_dict = context_dict
        self.audio_context = audio_context

    def __getitem__(self, index):
        item = self.dataset[index]
        item["context"] = np.asarray(self.context_dataset[index])
        return item

    def __len__(self):
        return len(self.dataset)

    def collater(self, samples, pad_to_src_len=None, pad_to_tgt_len=None, pad_to_bsz=None):
        batch = self.dataset.collater(samples, pad_to_src_len=pad_to_src_len, pad_to_tgt_len=pad_to_tgt_len,
                                      pad_to_bsz=pad_to_bsz)
        if not batch:
            return {}
        id_to_pos = {s["id"]: i for i, s in enumerate(samples)}
        order = [id_to_pos[int(i)] for i in batch["id"] if int(i) in id_to_pos]
        contexts = [samples[i]["context"] for i in order]
        lens = np.array([c.shape[0] for c in contexts], dtype=np.int64)
        if self.audio_context:
            context = collate_frames(contexts, pad_to_src_len)
        else:
            context = collate_tokens(contexts, self.context_dict.pad(), self.context_dict.eos(),
                                     pad_to_length=pad_to_tgt_len)
        n_rows = batch["net_input"]["src_tokens"].shape[0]
        if n_rows > len(order):
            extra = n_rows - len(order)
            fill = 0.0 if self.audio_context else self.context_dict.pad()
            context = np.concatenate([context, np.full((extra,) + context.shape[1:], fill, context.dtype)])
            lens = np.concatenate([lens, np.zeros(extra, lens.dtype)])
        batch["net_input"]["context_tokens"] = context
        batch["net_input"]["context_lengths"] = lens
        return batch

    def num_tokens(self, index):
        return self.dataset.num_tokens(index)

    def size(self, index):
        return self.dataset.size(index)

    @property
    def sizes(self):
        return self.dataset.sizes

    def ordered_indices(self):
        return self.dataset.ordered_indices()


class MultiTaskDataset(Dataset):
    """Adds a per-utterance auxiliary classification target to each batch
    (reference examples/speech_recognition/data/multitask_dataset.py):
    ``auxiliary_target`` (B, ...) in the row order of the wrapped collater,
    zeros on a fixed-shape batch's padding rows."""

    def __init__(self, base_dataset, auxiliary_targets):
        self.base_dataset = base_dataset
        self.auxiliary_targets = auxiliary_targets

    def __getitem__(self, index):
        item = self.base_dataset[index]
        item["auxiliary_target"] = np.asarray(self.auxiliary_targets[index])
        return item

    def __len__(self):
        return len(self.base_dataset)

    def collater(self, samples, **pad_kwargs):
        batch = self.base_dataset.collater(samples, **pad_kwargs)
        if not batch:
            return {}
        id_to_pos = {s["id"]: i for i, s in enumerate(samples)}
        order = [id_to_pos[int(i)] for i in batch["id"] if int(i) in id_to_pos]
        aux = np.stack([samples[i]["auxiliary_target"] for i in order])
        n_rows = batch["net_input"]["src_tokens"].shape[0]
        if n_rows > len(order):
            aux = np.concatenate([aux, np.zeros((n_rows - len(order),) + aux.shape[1:], aux.dtype)])
        batch["auxiliary_target"] = aux
        return batch

    def num_tokens(self, index):
        return self.base_dataset.num_tokens(index)

    def size(self, index):
        return self.base_dataset.size(index)

    @property
    def sizes(self):
        return self.base_dataset.sizes

    def ordered_indices(self):
        return self.base_dataset.ordered_indices()


class LangtokFilterBanksToTextDataset(Dataset):
    """The language-token wrapper of multilingual ST (reference
    examples/speech_recognition/data/langtok_fbank_dataset.py): tags each
    batch with the encoder's language (``net_input["langtok"]``, a name,
    which the device batch drops) and rewrites the first previous-output
    token of each real row from ``tgt_bos`` to ``tgt_langtok``. A
    fixed-shape batch's padding rows keep the pad there."""

    def __init__(self, wrapped_ds, lang_for_token=None, tgt_bos=None, tgt_langtok=None):
        self.wrapped_ds = wrapped_ds
        self.lang_for_token = lang_for_token
        self.tgt_bos = tgt_bos
        self.tgt_langtok = tgt_langtok

    def __getitem__(self, index):
        return self.wrapped_ds[index]

    def __len__(self):
        return len(self.wrapped_ds)

    def collater(self, samples, **pad_kwargs):
        batch = self.wrapped_ds.collater(samples, **pad_kwargs)
        if not batch:
            return {}
        batch["net_input"]["langtok"] = self.lang_for_token
        prev = batch["net_input"].get("prev_output_tokens")
        if self.tgt_langtok is not None and prev is not None:
            is_real = prev[:, 0] == self.tgt_bos
            if not (is_real | (prev[:, 0] == 1)).all():  # 1: the pad of the padding rows
                raise ValueError(f"a first previous-output token is neither bos {self.tgt_bos} nor pad")
            prev[is_real, 0] = self.tgt_langtok
        return batch

    def num_tokens(self, index):
        return self.wrapped_ds.num_tokens(index)

    def size(self, index):
        return self.wrapped_ds.size(index)

    @property
    def sizes(self):
        return self.wrapped_ds.sizes

    def ordered_indices(self):
        return self.wrapped_ds.ordered_indices()


class RoundRobinZipDatasets(Dataset):
    """Zips datasets, going round over the shorter ones (reference
    fairseq/data/round_robin_zip_datasets.py): item i is {key:
    datasets[key][i % len(datasets[key])]} and the collater gives a dict of
    per-key batches (each padded with the same keywords); an item's token
    count is the largest of its parts', ``max_component_size`` the largest
    of each size field, and the order the item order."""

    def __init__(self, datasets):
        if not isinstance(datasets, dict) or not datasets:
            raise ValueError("RoundRobinZipDatasets needs a non-empty dict of datasets")
        self.datasets = datasets

    def _map_index(self, key, index):
        return index % len(self.datasets[key])

    def __getitem__(self, index):
        return {key: ds[self._map_index(key, index)] for key, ds in self.datasets.items()}

    def __len__(self):
        return max(len(ds) for ds in self.datasets.values())

    def collater(self, samples, **pad_kwargs):
        if not samples:
            return {}
        return {key: ds.collater([s[key] for s in samples], **pad_kwargs) for key, ds in self.datasets.items()}

    def num_tokens(self, index):
        return max(ds.num_tokens(self._map_index(key, index)) for key, ds in self.datasets.items())

    def size(self, index):
        return {key: ds.size(self._map_index(key, index)) for key, ds in self.datasets.items()}

    def max_component_size(self, index):
        sizes = [ds.size(self._map_index(key, index)) for key, ds in self.datasets.items()]
        if isinstance(sizes[0], tuple):
            return tuple(max(s[i] for s in sizes) for i in range(len(sizes[0])))
        return max(sizes)

    def ordered_indices(self):
        return np.arange(len(self), dtype=np.int64)


class ConcatDataset(Dataset):
    """Concatenated datasets (reference fairseq/data/concat_dataset.py, all
    sample ratios 1)."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])

    def _index(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        offset = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return ds_idx, idx - offset

    def __getitem__(self, idx):
        ds_idx, sample_idx = self._index(idx)
        return self.datasets[ds_idx][sample_idx]

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def collater(self, samples, **kwargs):
        return self.datasets[0].collater(samples, **kwargs)

    def num_tokens(self, index):
        ds_idx, sample_idx = self._index(index)
        return self.datasets[ds_idx].num_tokens(sample_idx)

    def size(self, index):
        ds_idx, sample_idx = self._index(index)
        return self.datasets[ds_idx].size(sample_idx)

    @property
    def sizes(self):
        return np.concatenate([d.sizes if hasattr(d, "sizes") else np.array([d.size(i) for i in range(len(d))])
                               for d in self.datasets])
