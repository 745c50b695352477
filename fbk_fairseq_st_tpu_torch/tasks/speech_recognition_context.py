"""speech_recognition_context: context-aware speech translation (INTERSPEECH 2020).

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_recognition_context.py``
(reference examples/speech_recognition/tasks/speech_recognition_context.py):
``--context-type tgt`` (the previous target text, ``<split>.context.<tgt>``
as indexed text over the target dictionary) or ``src`` (the previous
audio, ``<split>.context.npz`` as indexed filterbanks). For training each
split is wrapped in a ``ContextAwareDataset``; at inference (a namespace
with ``beam``, which only the generation parser gives) it is not, and the
batches stay in corpus order (the dataset's ``arange`` order,
``cli/generate``'s unshuffled iterator), so the stateful generator of
``build_generator`` chains each utterance's output into the next one's
context.
"""

from __future__ import annotations

import logging
import os

from ..data.datasets import ConcatDataset, ContextAwareDataset
from ..data.indexed_dataset import FilterBanksDataset, load_indexed_dataset
from .speech_recognition import SpeechRecognitionTask, get_datasets_from_indexed_filterbanks

logger = logging.getLogger(__name__)


class ContextAwareSpeechRecognitionTask(SpeechRecognitionTask):
    @staticmethod
    def add_args(parser):
        SpeechRecognitionTask.add_args(parser)
        parser.add_argument("--context-type", default="tgt", choices=["tgt", "src"],
                            help="if src, the context is considered to be the previous audio, otherwise it is "
                            "assumed to be the previous text")

    def __init__(self, args, tgt_dict):
        super().__init__(args, tgt_dict)
        self.training = not hasattr(args, "beam")

    def load_dataset(self, split, combine=False, **kwargs):
        # --dataset-from-json is not read here: JAX's context task takes
        # the indexed filterbanks whatever it says
        audio_context = getattr(self.args, "context_type", "tgt") == "src"
        legacy = getattr(self.args, "legacy_audio_fix_lua_indexing", False)
        datasets = []
        for path in self.paths:
            try:
                ds = get_datasets_from_indexed_filterbanks(
                    path, self.args.target_lang, self.tgt_dict, split, getattr(self.args, "dataset_impl", None),
                    getattr(self.args, "skip_normalization", False), legacy)
                if self.training:
                    prefix = os.path.join(path, split) + ".context."
                    if audio_context:
                        context_ds = FilterBanksDataset(prefix + "npz", legacy_audio_fix_lua_indexing=legacy)
                    else:
                        context_ds = load_indexed_dataset(prefix + self.args.target_lang, self.tgt_dict,
                                                          getattr(self.args, "dataset_impl", None))
                        if context_ds is None:
                            raise FileNotFoundError(prefix + self.args.target_lang)
                    ds = ContextAwareDataset(ds, context_ds, self.tgt_dict, audio_context)
                datasets.append(ds)
            except (FileNotFoundError, AssertionError):
                logger.warning("Split {} not found in {}. Skipping...".format(split, path))
        if not datasets:
            raise FileNotFoundError(f"no data found for split {split}")
        self.datasets[split] = ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]

    def build_generator(self, models, args):
        """The Target or the Audio context generator of ``--context-type``
        (JAX :96-118): beam search, the length and score options; the
        search-strategy flags are not read, as in JAX."""
        from ..generation.sequence_generator_with_context import (AudioContextAwareSequenceGenerator,
                                                                  TargetContextAwareSequenceGenerator)

        cls = (AudioContextAwareSequenceGenerator if getattr(self.args, "context_type", "tgt") == "src"
               else TargetContextAwareSequenceGenerator)
        return cls(
            self.target_dictionary,
            beam_size=getattr(args, "beam", 5),
            max_len_a=getattr(args, "max_len_a", 0),
            max_len_b=getattr(args, "max_len_b", 200),
            min_len=getattr(args, "min_len", 1),
            normalize_scores=not getattr(args, "unnormalized", False),
            len_penalty=getattr(args, "lenpen", 1),
            unk_penalty=getattr(args, "unkpen", 0),
            temperature=getattr(args, "temperature", 1.0),
            no_repeat_ngram_size=getattr(args, "no_repeat_ngram_size", 0),
        )
