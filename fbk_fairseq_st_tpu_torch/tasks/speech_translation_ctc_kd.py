"""speech_translation_with_transcription_kd: the data of
``speech_translation_with_transcription`` with a teacher's top-k outputs.

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_translation_ctc_kd.py``
(reference tasks/speech_translation_ctc_kd.py): each split is further
wrapped with the teacher's ``<split>.<tgt>.top{K}_idx`` (int32) and
``<split>.<tgt>.top{K}_out`` (float32), K = ``--distill-topk``, as
``cli/generate_topk`` writes them (``DatasetWithTeacherOutput``), so that
batches carry ``teacher_idxs`` and ``teacher_probs`` for the
``knowledge_distillation`` criterion.
"""

from __future__ import annotations

import os

from ..data.datasets import ConcatDataset
from ..data.indexed_dataset import IndexedDataset
from ..data.knowledge_distillation import DatasetWithTeacherOutput, TeacherOutputDataset
from .speech_translation_ctc import SpeechTranslationCTCTask


class SpeechTranslationCTCWithKDTask(SpeechTranslationCTCTask):
    @staticmethod
    def add_args(parser):
        SpeechTranslationCTCTask.add_args(parser)
        parser.add_argument("--distill-topk", default=None, type=int, required=True, metavar="K",
                            help="number of teacher outputs to distill from")

    def load_dataset(self, split, combine=False, **kwargs):
        super().load_dataset(split, combine=combine, **kwargs)
        k = self.args.distill_topk
        probs, idxs = [], []
        for path in self.paths:
            prefix = os.path.join(path, split) + "." + self.args.target_lang
            idx_name, out_name = prefix + f".top{k}_idx", prefix + f".top{k}_out"
            if IndexedDataset.exists(idx_name) and IndexedDataset.exists(out_name):
                probs.append(TeacherOutputDataset(out_name))
                idxs.append(TeacherOutputDataset(idx_name))
        if not idxs:
            raise FileNotFoundError(f"no teacher top-{k} outputs found for {split}")
        teacher_idxs = ConcatDataset(idxs) if len(idxs) > 1 else idxs[0]
        teacher_probs = ConcatDataset(probs) if len(probs) > 1 else probs[0]
        if len(self.datasets[split]) != len(teacher_idxs):
            raise ValueError(f"{split}: {len(self.datasets[split])} utterances, {len(teacher_idxs)} teacher outputs")
        self.datasets[split] = DatasetWithTeacherOutput(self.datasets[split], teacher_probs, teacher_idxs,
                                                        self.tgt_dict, k)
