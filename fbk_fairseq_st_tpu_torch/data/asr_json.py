"""JSON speech data route: datasets built from ``asr_prep_json``-style files.

Counterpart of the reference get_asr_dataset_from_json + AsrDataset
(examples/speech_recognition/tasks/speech_recognition.py:23-70,
data/asr_dataset.py:14-120): each utterance names an audio path, its
duration, and pre-tokenized target ids; features are extracted on the fly.
Unlike the reference (torchaudio/Kaldi at runtime) this uses the built-in
NumPy frontend (``data/audio.py``); paths ending in .npy are loaded as
precomputed features directly.

The port's copy of ``fbk_fairseq_st_tpu/data/asr_json.py``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from .audio import apply_mv_norm, logmel_fbank, read_wav
from .datasets import Dataset, Seq2SeqCollater


def get_asr_dataset_from_json(data_json_path, tgt_dict, skip_norm,
                              num_mel_bins: int = 80):
    """Parse an ``{"utts": {id: {"input": {...}, "output": {...}}}}`` JSON
    (reference tasks/speech_recognition.py:23-70). Utterances are sorted by
    descending duration; targets get EOS appended."""
    if not os.path.isfile(data_json_path):
        raise FileNotFoundError("Dataset not found: {}".format(data_json_path))
    with open(data_json_path, "rb") as f:
        data_samples = json.load(f)["utts"]
    assert len(data_samples) != 0
    sorted_samples = sorted(
        data_samples.items(),
        key=lambda sample: int(sample[1]["input"]["length_ms"]),
        reverse=True,
    )
    aud_paths = [s[1]["input"]["path"] for s in sorted_samples]
    ids = [s[0] for s in sorted_samples]
    speakers = []
    for s in sorted_samples:
        m = re.search("(.+?)-(.+?)-(.+?)", s[0])
        speakers.append(m.group(1) + "_" + m.group(2) if m else s[0])
    durations_ms = [int(s[1]["input"]["length_ms"]) for s in sorted_samples]
    tgt = [
        [int(i) for i in s[1]["output"]["tokenid"].split(", ")]
        + [tgt_dict.eos()]
        for s in sorted_samples
    ]
    return AsrJsonDataset(
        aud_paths, durations_ms, tgt, tgt_dict, ids, speakers,
        num_mel_bins=num_mel_bins, skip_normalization=skip_norm,
    )


class AsrJsonDataset(Dataset):
    """Speech + transcription with on-the-fly feature extraction."""

    def __init__(self, aud_paths, aud_durations_ms, tgt, tgt_dict, ids,
                 speakers, num_mel_bins=80, frame_length=25.0,
                 frame_shift=10.0, skip_normalization=False):
        assert frame_length > 0 and frame_shift > 0
        assert all(d > frame_length for d in aud_durations_ms)
        assert len(aud_paths) == len(aud_durations_ms) == len(tgt)
        assert len(aud_paths) == len(ids) == len(speakers)
        self.frame_sizes = np.array(
            [int(1 + (d - frame_length) / frame_shift) for d in aud_durations_ms],
            dtype=np.int64,
        )
        self.aud_paths = aud_paths
        self.tgt_dict = tgt_dict
        self.tgt = tgt
        self.ids = ids
        self.speakers = speakers
        self.num_mel_bins = num_mel_bins
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.skip_normalization = skip_normalization
        self.s2s_collater = Seq2SeqCollater(
            pad_index=tgt_dict.pad(), eos_index=tgt_dict.eos(),
            move_eos_to_beginning=True,
        )

    def _features(self, path: str) -> np.ndarray:
        if not os.path.exists(path):
            raise FileNotFoundError("Audio file not found: {}".format(path))
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32)
        sound, rate = read_wav(path)
        return logmel_fbank(
            sound, rate, num_mel_bins=self.num_mel_bins,
            frame_length=self.frame_length, frame_shift=self.frame_shift,
        )

    def __getitem__(self, index):
        feats = self._features(self.aud_paths[index])
        if not self.skip_normalization:
            feats = apply_mv_norm(feats)
        tgt_item = (
            np.asarray(self.tgt[index], dtype=np.int64)
            if self.tgt is not None else None
        )
        return {"id": index, "source": feats, "target": tgt_item}

    def __len__(self):
        return len(self.aud_paths)

    def collater(self, samples, **kwargs):
        return self.s2s_collater.collate(samples, **kwargs)

    def num_tokens(self, index):
        return int(self.frame_sizes[index])

    def size(self, index):
        return (
            int(self.frame_sizes[index]),
            len(self.tgt[index]) if self.tgt is not None else 0,
        )

    @property
    def sizes(self):
        return self.frame_sizes

    def ordered_indices(self):
        return np.arange(len(self))
