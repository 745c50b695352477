"""speech_recognition task: fbank -> text (ASR or direct ST).

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_recognition.py`` as far
as the train step needs it. ``augment_batch`` is the identity: SpecAugment
and TimeStretch (``--specaugment``, ``--time-stretch``) raise until
``ops/specaugment.py`` is ported (ROADMAP Queue A10). Reading the indexed
fbank datasets comes with the wiring (ROADMAP Queue A9).
"""

from __future__ import annotations

from .base import Task


class SpeechRecognitionTask(Task):
    def __init__(self, args, tgt_dict):
        super().__init__(args)
        for flag in ("specaugment", "time_stretch"):
            if getattr(args, flag, False):
                raise NotImplementedError(
                    f"--{flag.replace('_', '-')}: SpecAugment/TimeStretch need "
                    "ops/specaugment.py (ROADMAP Queue A10)")
        self.tgt_dict = tgt_dict

    @property
    def target_dictionary(self):
        return self.tgt_dict
