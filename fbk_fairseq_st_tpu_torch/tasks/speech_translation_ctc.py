"""speech_translation_with_transcription: fbank -> text, with transcripts.

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_translation_ctc.py``
(``SpeechTranslationCTCTask`` :25) as far as the train step needs it: the
task holds the source-language dictionary, and ``<ctc_blank>`` is added
after its symbols when the criterion is ``ctc_multi_loss`` (:48-49), so
``build_model`` sizes the model's CTC head ``len(src_dict)``. Batches carry
``transcript_target``, ``transcript_target_lengths`` and
``net_input.transcript_prev_output_tokens`` beside the translation's
fields. Reading the transcripts' indexed dataset
(``TranscriptionWrapperDataset``) comes with the wiring (ROADMAP Queue A9).
"""

from __future__ import annotations

from .speech_recognition import SpeechRecognitionTask


class SpeechTranslationCTCTask(SpeechRecognitionTask):
    def __init__(self, args, tgt_dict, src_dict):
        super().__init__(args, tgt_dict)
        if getattr(args, "criterion", None) == "ctc_multi_loss" and "<ctc_blank>" not in src_dict:
            src_dict.add_symbol("<ctc_blank>")
        self.src_dict = src_dict

    @property
    def source_dictionary(self):
        return self.src_dict
