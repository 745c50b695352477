"""speech_translation_with_transcription: fbank -> text, with transcripts.

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_translation_ctc.py``
(``SpeechTranslationCTCTask`` :25): the task also holds the source-language
dictionary (``dict.<src>.txt``), and ``<ctc_blank>`` is added after its
symbols when the criterion is ``ctc_multi_loss`` (:48-49), so
``build_model`` sizes the model's CTC head ``len(src_dict)``.
``load_dataset`` wraps the filterbank dataset with the transcripts'
indexed dataset (``<split>.<src>``), so batches carry
``transcript_target``, ``transcript_target_lengths`` and
``net_input.transcript_prev_output_tokens`` beside the translation's
fields.
"""

from __future__ import annotations

import os

from ..data.datasets import ConcatDataset, TranscriptionWrapperDataset
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import load_indexed_dataset
from .speech_recognition import SpeechRecognitionTask


class SpeechTranslationCTCTask(SpeechRecognitionTask):
    @staticmethod
    def add_args(parser):
        SpeechRecognitionTask.add_args(parser)
        parser.add_argument("-s", "--source-lang", default=None, metavar="TARGET", help="source language")

    def __init__(self, args, tgt_dict, src_dict):
        super().__init__(args, tgt_dict)
        if getattr(args, "criterion", None) == "ctc_multi_loss" and "<ctc_blank>" not in src_dict:
            src_dict.add_symbol("<ctc_blank>")
        self.src_dict = src_dict

    @classmethod
    def setup_task(cls, args, **kwargs):
        path = os.path.join(args.data.split(os.pathsep)[0], "dict.{}.txt".format(args.source_lang))
        if not os.path.isfile(path):
            raise FileNotFoundError("Dict not found: {}".format(path))
        return super().setup_task(args, src_dict=Dictionary.load(path))

    def load_dataset(self, split, combine=False, **kwargs):
        super().load_dataset(split, combine=combine, **kwargs)
        transcripts = [ds for ds in (load_indexed_dataset(os.path.join(path, split) + "." + self.args.source_lang,
                                                          self.src_dict, getattr(self.args, "dataset_impl", None))
                                     for path in self.paths) if ds is not None]
        if not transcripts:
            raise FileNotFoundError(f"no transcripts found for split {split}")
        transcript_dataset = ConcatDataset(transcripts) if len(transcripts) > 1 else transcripts[0]
        if len(self.datasets[split]) != len(transcript_dataset):
            raise ValueError(f"{split}: {len(self.datasets[split])} utterances, {len(transcript_dataset)} transcripts")
        self.datasets[split] = TranscriptionWrapperDataset(self.datasets[split], transcript_dataset, self.src_dict)

    @property
    def source_dictionary(self):
        return self.src_dict
