"""Multilingual ST tasks (COLING 2020): ``multilingual_speech_translation``
and ``multilingual_speech_translation_with_transcr``.

Counterpart of ``fbk_fairseq_st_tpu/tasks/multilingual_speech_translation.py``
(reference examples/speech_recognition/tasks/
multilingual_speech_translation.py:25-240):

  * ``prepare`` (:140-176) loads ``dict.<lang>.txt`` for every language of
    ``--lang-pairs`` that has one on disk (a target language's is
    required; the audio source has none), holds their pad, eos and unk
    equal, and appends ``__<lang>__`` for every language, in sorted order,
    to each when a langtok flag is set;
  * training mode (neither ``-s`` nor ``-t``): each split is a
    ``RoundRobinZipDatasets`` of the pairs' datasets, so a batch is a dict
    of per-pair sub-batches, and the criterion is wrapped in
    ``_MultilingualCriterion`` (:44-80): the inner criterion over each
    pair present, through the model's pair view, summed into one loss
    (one backward an update), each logged key summed and also kept as
    ``"<pair>:<key>"``;
  * inference mode (``-s`` and ``-t``): the one pair's dataset, decoded
    through the pair view with ``__<tgt>__`` as bos under
    ``--decoder-langtok`` (``inference_step`` :253-265);
  * ``augment_batch`` (:267-278) runs SpecAugment / TimeStretch on each
    pair's sub-batch;
  * ``_with_transcr`` (:290-316) wraps each pair's data in
    ``TranscriptionWrapperDataset`` over ``<split>.<src>``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

from ..data.datasets import (ConcatDataset, LangtokFilterBanksToTextDataset, RoundRobinZipDatasets,
                             TranscriptionWrapperDataset)
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import load_indexed_dataset
from ..device import DeviceLike
from ..models import arch_defaults
from ..models import multilingual_conv_transformer as mct
from ..train.trainer import is_nested
from .speech_recognition import SpeechRecognitionTask, get_datasets_from_indexed_filterbanks

logger = logging.getLogger(__name__)


class _MultilingualCriterion:
    """The inner criterion summed over the language pairs of a batch."""

    def __init__(self, inner, task):
        self.inner = inner
        self.task = task
        self.padding_idx = inner.padding_idx
        self.sentence_avg = inner.sentence_avg

    def __call__(self, model, batch, generator=None, training: bool = False):
        total_loss, total_size = 0.0, 0
        logging_output: Dict[str, torch.Tensor] = {}
        for pair in self.task.lang_pairs:
            if not batch.get(pair):
                continue
            loss, size, log = self.inner(model.pair_view(pair), batch[pair], generator, training)
            total_loss, total_size = total_loss + loss, total_size + size
            for key, value in log.items():
                logging_output[key] = logging_output[key] + value if key in logging_output else value
                logging_output[f"{pair}:{key}"] = value
        logging_output["loss"] = total_loss.detach()
        logging_output["sample_size"] = total_size
        return total_loss, total_size, logging_output

    def reduce_metrics(self, logging_outputs, metrics=None):
        return self.inner.reduce_metrics(logging_outputs, metrics)


class MultilingualSpeechTranslationTask(SpeechRecognitionTask):
    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="path to data directory; pathsep-joined")
        parser.add_argument("--lang-pairs", default=None, metavar="PAIRS",
                            help="comma-separated list of language pairs: en-de,en-fr")
        parser.add_argument("-s", "--source-lang", default=None, metavar="SRC",
                            help="source language (only needed for inference)")
        parser.add_argument("-t", "--target-lang", default=None, metavar="TARGET",
                            help="target language (only needed for inference)")
        parser.add_argument("--encoder-langtok", default=None, type=str, choices=["src", "tgt"],
                            help="prepend/sum an encoder language token")
        parser.add_argument("--decoder-langtok", action="store_true",
                            help="replace beginning-of-sentence in target sentence with target language token")
        parser.add_argument("--langtok-merge-strategy", default="concat", type=str, choices=["concat", "sum"],
                            metavar="MRG", help="strategy to merge the language token with the input")
        parser.add_argument("--max-source-positions", default=1024, type=int, metavar="N")
        parser.add_argument("--max-target-positions", default=1024, type=int, metavar="N")
        parser.add_argument("--skip-normalization", action="store_true", default=False)
        parser.add_argument("--legacy-audio-fix-lua-indexing", action="store_true", default=False)
        parser.add_argument("--dataset-from-json", default=False)
        parser.add_argument("--specaugment", action="store_true", default=False)
        parser.add_argument("--frequency-masking-pars", type=int, default=13)
        parser.add_argument("--time-masking-pars", type=int, default=13)
        parser.add_argument("--frequency-masking-num", type=int, default=2)
        parser.add_argument("--time-masking-num", type=int, default=2)
        parser.add_argument("--specaugment-rate", type=float, default=1.0)
        parser.add_argument("--time-stretch", action="store_true")
        parser.add_argument("--time-stretch-rate", type=float, default=1.0)
        parser.add_argument("--time-stretch-w", type=int, default=1)
        parser.add_argument("--time-stretch-low", type=float, default=0.8)
        parser.add_argument("--time-stretch-high", type=float, default=1.25)

    def __init__(self, args, dicts: Dict[str, Dictionary], training: bool):
        super().__init__(args, dicts[args.lang_pairs[0].split("-")[1]])
        self.dicts = dicts
        self.training_mode = training
        self.lang_pairs = list(args.lang_pairs) if training else [f"{args.source_lang}-{args.target_lang}"]
        self.eval_lang_pairs = self.lang_pairs
        self.langs = sorted({x for p in args.lang_pairs for x in p.split("-")})

    @classmethod
    def setup_task(cls, args, **kwargs):
        dicts, training = cls.prepare(args)
        return cls(args, dicts, training)

    @classmethod
    def prepare(cls, args):
        """The dictionaries and the mode (reference
        multilingual_translation.py:121-155)."""
        if args.lang_pairs is None:
            raise ValueError("--lang-pairs is required. List all the language pairs in the training data.")
        if isinstance(args.lang_pairs, str):
            args.lang_pairs = args.lang_pairs.split(",")
        sorted_langs = sorted({x for pair in args.lang_pairs for x in pair.split("-")})
        training = args.source_lang is None and args.target_lang is None
        path = args.data.split(os.pathsep)[0]
        tgt_langs = {p.split("-")[1] for p in args.lang_pairs}
        dicts: Dict[str, Dictionary] = {}
        for lang in sorted_langs:
            dict_path = os.path.join(path, f"dict.{lang}.txt")
            if not os.path.isfile(dict_path):
                if lang in tgt_langs:
                    raise FileNotFoundError(f"Dict not found: {dict_path}")
                continue
            dicts[lang] = Dictionary.load(dict_path)
            first = dicts[next(iter(dicts))]
            if (dicts[lang].pad(), dicts[lang].eos(), dicts[lang].unk()) != (first.pad(), first.eos(), first.unk()):
                raise ValueError(f"{dict_path}: pad, eos and unk differ from the first dictionary's")
            if getattr(args, "encoder_langtok", None) is not None or getattr(args, "decoder_langtok", False):
                for lang_to_add in sorted_langs:
                    dicts[lang].add_symbol(mct.lang_token(lang_to_add))
            logger.info("[{}] dictionary: {} types".format(lang, len(dicts[lang])))
        return dicts, training

    def _load_pair_dataset(self, split, lang_pair):
        src, tgt = lang_pair.split("-")
        datasets = []
        for path in self.paths:
            try:
                datasets.append(get_datasets_from_indexed_filterbanks(
                    path, tgt, self.dicts[tgt], split, getattr(self.args, "dataset_impl", None),
                    getattr(self.args, "skip_normalization", False),
                    getattr(self.args, "legacy_audio_fix_lua_indexing", False)))
            except FileNotFoundError:
                logger.warning(f"Split {split} not found in {path} for {lang_pair}")
        if not datasets:
            raise FileNotFoundError(f"no data for {lang_pair} {split}")
        ds = ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]
        return self.alter_dataset_langtok(ds, src_lang=src, tgt_eos=self.dicts[tgt].eos(), tgt_lang=tgt)

    def alter_dataset_langtok(self, ds, src_lang=None, tgt_eos=None, tgt_lang=None):
        """Reference multilingual_speech_translation.py:112-130."""
        encoder_langtok = getattr(self.args, "encoder_langtok", None)
        decoder_langtok = getattr(self.args, "decoder_langtok", False)
        if encoder_langtok is None and not decoder_langtok:
            return ds
        lang_for_token = None
        if encoder_langtok is not None:
            lang_for_token = src_lang if encoder_langtok == "src" else tgt_lang
        tgt_langtok = None
        if decoder_langtok and tgt_eos is not None and tgt_lang is not None:
            tgt_langtok = mct.lang_token_index(self.dicts[tgt_lang], tgt_lang)
        else:
            tgt_eos = None
        return LangtokFilterBanksToTextDataset(ds, lang_for_token=lang_for_token, tgt_bos=tgt_eos,
                                               tgt_langtok=tgt_langtok)

    def load_dataset(self, split, combine=False, **kwargs):
        if self.training_mode:
            self.datasets[split] = RoundRobinZipDatasets({pair: self._load_pair_dataset(split, pair)
                                                          for pair in self.lang_pairs})
        else:
            self.datasets[split] = self._load_pair_dataset(split, self.lang_pairs[0])

    def build_criterion(self, args):
        inner = super().build_criterion(args)
        return _MultilingualCriterion(inner, self) if self.training_mode else inner

    def build_model(self, args, device: DeviceLike = None):
        """The multilingual model of ``args`` over this task's dictionaries
        for all of ``args.lang_pairs`` (also in inference mode, where the
        task decodes one of them); another arch as the base task builds it."""
        arch = args.arch
        if arch not in mct.ARCHITECTURES:
            return super().build_model(args, device=device)
        options = {k: getattr(args, k) for k in arch_defaults(arch) if hasattr(args, k)}
        return mct.build_model(arch, self.dicts, device=device, seed=getattr(args, "seed", 1), train=True,
                               lang_pairs=args.lang_pairs, encoder_langtok=getattr(args, "encoder_langtok", None),
                               langtok_merge_strategy=getattr(args, "langtok_merge_strategy", "concat"),
                               allow_partial_restore=getattr(args, "allow_partial_restore", False), **options)

    def inference_step(self, generator, models, sample, prefix_tokens=None):
        pair = self.lang_pairs[0]
        views = [m.pair_view(pair) if hasattr(m, "pair_view") else m for m in models]
        bos_token = None
        if getattr(self.args, "decoder_langtok", False):
            tgt = pair.split("-")[1]
            bos_token = mct.lang_token_index(self.dicts[tgt], tgt)
        return generator.generate(views, sample, prefix_tokens=prefix_tokens, bos_token=bos_token)

    def augment_batch(self, batch, generator):
        if is_nested(batch):
            return {pair: super(MultilingualSpeechTranslationTask, self).augment_batch(sub, generator)
                    for pair, sub in batch.items()}
        return super().augment_batch(batch, generator)

    @property
    def source_dictionary(self):
        return None

    @property
    def target_dictionary(self):
        if self.training_mode:
            return self.dicts[self.lang_pairs[0].split("-")[1]]
        return self.dicts[self.args.target_lang]


class MultilingualSpeechTranslationWithTranscriptionTask(MultilingualSpeechTranslationTask):
    """Each pair's data with its source-language transcripts
    (``<split>.<src>``, over ``dict.<src>.txt``)."""

    def _load_pair_dataset(self, split, lang_pair):
        src, _ = lang_pair.split("-")
        ds = super()._load_pair_dataset(split, lang_pair)
        transcripts = [t for t in (load_indexed_dataset(os.path.join(path, split) + "." + src, self.dicts.get(src),
                                                        getattr(self.args, "dataset_impl", None))
                                   for path in self.paths) if t is not None]
        if not transcripts:
            return ds
        if src not in self.dicts:
            raise FileNotFoundError(f"Dict not found: dict.{src}.txt, for the transcripts of {lang_pair}")
        transcripts = ConcatDataset(transcripts) if len(transcripts) > 1 else transcripts[0]
        return TranscriptionWrapperDataset(ds, transcripts, self.dicts[src])
