"""speech_translation_dualdecoding: the transcript-and-translation task.

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_translation_dualdecoding.py``:
the data of ``speech_translation_with_transcription`` (batches with
``transcript_target``, ``transcript_target_lengths`` and
``net_input.transcript_prev_output_tokens``), a multi-decoder model and
``cross_entropy_dualdecoder``; ``build_generator`` gives the two-phase
generator, its options read from ``args`` under the CLI's names
(``_GEN_ARG_MAP``).
"""

from __future__ import annotations

from ..generation.twophase_sequence_generator import TwoPhaseSequenceGenerator
from .speech_translation_ctc import SpeechTranslationCTCTask

# generator kwarg <- (args attribute, default)
_GEN_ARG_MAP = {
    "beam_size": ("beam", 5),
    "max_len_a": ("max_len_a", 0),
    "max_len_b": ("max_len_b", 200),
    "min_len": ("min_len", 1),
    "len_penalty": ("lenpen", 1),
    "unk_penalty": ("unkpen", 0),
    "temperature": ("temperature", 1.0),
    "match_source_len": ("match_source_len", False),
    "no_repeat_ngram_size": ("no_repeat_ngram_size", 0),
}


class SpeechTranslationDualDecodingTask(SpeechTranslationCTCTask):
    def build_generator(self, models, args) -> TwoPhaseSequenceGenerator:
        kwargs = {name: getattr(args, attr, default) for name, (attr, default) in _GEN_ARG_MAP.items()}
        kwargs["normalize_scores"] = not getattr(args, "unnormalized", False)
        return TwoPhaseSequenceGenerator(self.source_dictionary, self.target_dictionary, **kwargs)
