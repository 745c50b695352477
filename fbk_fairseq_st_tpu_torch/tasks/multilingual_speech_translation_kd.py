"""multilingual_speech_translation_with_transcr_kd: multilingual ST with
transcripts and a teacher's top-k outputs for each pair.

Counterpart of ``fbk_fairseq_st_tpu/tasks/multilingual_speech_translation_kd.py``
(reference examples/speech_recognition/tasks/
multilingual_speech_translation_kd.py:25-131): each pair's data of
``multilingual_speech_translation_with_transcr`` is wrapped in
``DatasetWithTeacherOutput`` over ``<split>.<tgt>.top{K}_idx`` and
``<split>.<tgt>.top{K}_out`` (K = ``--distill-topk``, as
``cli/generate_topk`` writes them), then zipped round-robin across pairs;
without those files it fails with JAX's message.
"""

from __future__ import annotations

import os

from ..data.datasets import ConcatDataset
from ..data.indexed_dataset import IndexedDataset
from ..data.knowledge_distillation import DatasetWithTeacherOutput, TeacherOutputDataset
from .multilingual_speech_translation import MultilingualSpeechTranslationWithTranscriptionTask


class MultilingualSpeechTranslationWithTranscriptionKDTask(MultilingualSpeechTranslationWithTranscriptionTask):
    @staticmethod
    def add_args(parser):
        MultilingualSpeechTranslationWithTranscriptionTask.add_args(parser)
        parser.add_argument("--distill-topk", default=None, type=int, required=True, metavar="K",
                            help="number of teacher outputs to distill from")

    def _load_pair_dataset(self, split, lang_pair):
        _, tgt = lang_pair.split("-")
        ds = super()._load_pair_dataset(split, lang_pair)
        k = self.args.distill_topk
        probs, idxs = [], []
        for path in self.paths:
            prefix = os.path.join(path, split) + "." + tgt
            idx_name, out_name = prefix + f".top{k}_idx", prefix + f".top{k}_out"
            if IndexedDataset.exists(idx_name) and IndexedDataset.exists(out_name):
                probs.append(TeacherOutputDataset(out_name))
                idxs.append(TeacherOutputDataset(idx_name))
        if not idxs:
            raise FileNotFoundError("Teacher datasets not found for pair {} split {}".format(lang_pair, split))
        teacher_idxs = ConcatDataset(idxs) if len(idxs) > 1 else idxs[0]
        teacher_probs = ConcatDataset(probs) if len(probs) > 1 else probs[0]
        if len(ds) != len(teacher_idxs):
            raise ValueError(f"{lang_pair} {split}: {len(ds)} utterances, {len(teacher_idxs)} teacher outputs")
        return DatasetWithTeacherOutput(ds, teacher_probs, teacher_idxs, self.dicts[tgt], k)
