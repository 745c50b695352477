"""speech_translation_multitask: speech translation data with a
per-utterance class.

Counterpart of ``fbk_fairseq_st_tpu/tasks/multitask_speech_translation.py``
(reference tasks/multitask_speech_translation.py:18-60): the data of
``speech_recognition`` and, from ``<split>.<tgt>.<--auxiliary-suffix>``
(an indexed dataset of one label an utterance, read with the port's
``indexed_dataset``), each utterance's ``auxiliary_target``
(``MultiTaskDataset``), for ``multitask_conv_transformer`` and
``cross_entropy_multi_task``.
"""

from __future__ import annotations

import os

from ..data.datasets import ConcatDataset, MultiTaskDataset
from ..data.indexed_dataset import load_indexed_dataset
from .speech_recognition import SpeechRecognitionTask


class SpeechTranslationMultiTask(SpeechRecognitionTask):
    @staticmethod
    def add_args(parser):
        SpeechRecognitionTask.add_args(parser)
        parser.add_argument("--auxiliary-suffix", default=None, metavar="SUFFIX",
                            help="Suffix to append to target dataset to get the auxiliary targets")

    def load_dataset(self, split, combine=False, **kwargs):
        super().load_dataset(split, combine=combine, **kwargs)
        suffix = "." + self.args.target_lang + "." + self.args.auxiliary_suffix
        labels = [ds for ds in (load_indexed_dataset(os.path.join(path, split) + suffix, None,
                                                     getattr(self.args, "dataset_impl", None))
                                for path in self.paths) if ds is not None]
        if not labels:
            raise FileNotFoundError(f"no auxiliary targets {split}{suffix} found")
        auxiliary_dataset = ConcatDataset(labels) if len(labels) > 1 else labels[0]
        if len(self.datasets[split]) != len(auxiliary_dataset):
            raise ValueError(f"{split}: {len(self.datasets[split])} utterances, {len(auxiliary_dataset)} labels")
        self.datasets[split] = MultiTaskDataset(self.datasets[split], auxiliary_dataset)
