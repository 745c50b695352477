"""translation task: source tokens -> target tokens.

Counterpart of ``fbk_fairseq_st_tpu/tasks/translation.py``
(``TranslationTask`` :170) as far as the train step and serving need it:
the source and target dictionaries, ``build_model`` (:290),
``build_criterion`` and ``max_positions`` (:285). Reading the binarized
corpus, with ``--left-pad-source`` / ``--left-pad-target``, comes with the
wiring (ROADMAP Queue A9); build a ``data.LanguagePairDataset`` from token
arrays meanwhile (sources padded on the left by default, as there).
``--eval-bleu`` raises: it needs scoring and the detokenizers (Queue A9).
"""

from __future__ import annotations

from .base import Task


class TranslationTask(Task):
    def __init__(self, args, src_dict, tgt_dict):
        super().__init__(args)
        if getattr(args, "eval_bleu", False):
            raise NotImplementedError("--eval-bleu needs scoring and detokenizers (ROADMAP Queue A9)")
        if src_dict.pad() != tgt_dict.pad() or src_dict.eos() != tgt_dict.eos() or src_dict.unk() != tgt_dict.unk():
            raise ValueError("source and target dictionaries must share pad, eos and unk")
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict

    @property
    def source_dictionary(self):
        return self.src_dict

    @property
    def target_dictionary(self):
        return self.tgt_dict

    def max_positions(self):
        return (getattr(self.args, "max_source_positions", 1024),
                getattr(self.args, "max_target_positions", 1024))
