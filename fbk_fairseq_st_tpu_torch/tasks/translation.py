"""translation task: source tokens -> target tokens.

Counterpart of ``fbk_fairseq_st_tpu/tasks/translation.py``
(``TranslationTask`` :170, ``load_langpair_dataset`` :27; reference
fairseq/tasks/translation.py): ``setup_task`` loads ``dict.<src>.txt``
and ``dict.<tgt>.txt`` (the pair inferred from the file names when not
given), ``load_dataset`` the binarized pairs ``<split>.<src>-<tgt>.<lang>``
(either direction's prefix; ``train``, ``train1``, ... with ``combine``)
into a ``data.LanguagePairDataset`` with ``--left-pad-source`` /
``--left-pad-target``; ``build_model`` (:290) and ``max_positions``
(:285). ``--eval-bleu`` (:292-403) decodes each validation batch with the
model being trained (``--eval-bleu-args`` set the generator), detokenises
hypotheses and references (``--eval-bleu-detok``, ``-detok-args``,
``--eval-bleu-remove-bpe``) and scores them with ``sacrebleu``, whose
sufficient statistics join the batch's logging outputs
(``valid_step_extra``) and give the epoch's ``bleu``
(``reduce_metrics``); without ``sacrebleu`` the task raises when it is
set up. ``--load-alignments`` (JAX :121-140) reads each split's
binarized ``<split>.align.<src>-<tgt>`` written by ``cli/preprocess
--align-suffix`` (flat s0, t0, s1, t1, ... rows), or else the text file
``<split>.<src>-<tgt>.align`` of Pharaoh ``s-t`` pairs, for the
collater's ``align_weights``; ``--truncate-source`` (JAX :51-62) cuts a
source to ``--max-source-positions`` with its eos kept.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from argparse import Namespace

import numpy as np

from ..data import encoders
from ..data.encoders import require_package
from ..data.datasets import ConcatDataset
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import dataset_exists, infer_dataset_impl, load_indexed_dataset, make_dataset
from ..data.language_pair_dataset import LanguagePairDataset
from ..data.wrappers import AppendTokenDataset, StripTokenDataset, TruncateDataset
from .base import Task

logger = logging.getLogger(__name__)
EVAL_BLEU_ORDER = 4


def infer_language_pair(path):
    """(src, tgt) from file names like train.de-en.de.idx (reference
    data_utils.infer_language_pair)."""
    for filename in os.listdir(path):
        parts = filename.split(".")
        if len(parts) >= 3 and len(parts[1].split("-")) == 2:
            return parts[1].split("-")
    return None, None


def load_alignments(data_path, split, src, tgt, n):
    """The (n_links, 2) arrays of the split's alignments (JAX :121-140), or
    None when it has none."""
    bin_prefix = os.path.join(data_path, f"{split}.align.{src}-{tgt}")
    impl = infer_dataset_impl(bin_prefix)
    if impl is not None:
        ds = make_dataset(bin_prefix, impl)
        aligns = [np.asarray(ds[i], np.int64).reshape(-1, 2) for i in range(len(ds))]
    else:
        path = os.path.join(data_path, f"{split}.{src}-{tgt}.align")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            aligns = [np.array([tuple(map(int, p.split("-"))) for p in line.split()], np.int64).reshape(-1, 2)
                      for line in f]
    if len(aligns) != n:
        raise ValueError(f"{split}: {len(aligns)} alignments for {n} pairs")
    return aligns


def load_langpair_dataset(data_path, split, src, src_dict, tgt, tgt_dict, combine, dataset_impl,
                          left_pad_source, left_pad_target, max_source_positions=1024, with_alignments=False,
                          truncate_source=False):
    def split_exists(split_k, src_l, tgt_l, lang):
        filename = os.path.join(data_path, f"{split_k}.{src_l}-{tgt_l}.{lang}")
        if dataset_impl is not None:
            return dataset_exists(filename, impl=dataset_impl)
        return infer_dataset_impl(filename) is not None

    src_datasets, tgt_datasets = [], []
    for k in itertools.count():
        split_k = split + (str(k) if k > 0 else "")
        if split_exists(split_k, src, tgt, src):
            prefix = os.path.join(data_path, f"{split_k}.{src}-{tgt}.")
        elif split_exists(split_k, tgt, src, src):
            prefix = os.path.join(data_path, f"{split_k}.{tgt}-{src}.")
        elif k > 0:
            break
        else:
            raise FileNotFoundError(f"Dataset not found: {split} ({data_path})")
        src_dataset = load_indexed_dataset(prefix + src, src_dict, dataset_impl)
        if truncate_source:  # strip eos, cut, append it again (JAX :51-62)
            src_dataset = AppendTokenDataset(TruncateDataset(StripTokenDataset(src_dataset, src_dict.eos()),
                                                             max_source_positions - 1), src_dict.eos())
        src_datasets.append(src_dataset)
        tgt_datasets.append(load_indexed_dataset(prefix + tgt, tgt_dict, dataset_impl))
        logger.info("{} {} {}-{} {} examples".format(data_path, split_k, src, tgt, len(src_datasets[-1])))
        if not combine:
            break
    if len(src_datasets) == 1:
        src_dataset, tgt_dataset = src_datasets[0], tgt_datasets[0]
    else:
        src_dataset, tgt_dataset = ConcatDataset(src_datasets), ConcatDataset(tgt_datasets)
    align_dataset = load_alignments(data_path, split, src, tgt, len(src_dataset)) if with_alignments else None
    return LanguagePairDataset(src_dataset, src_dataset.sizes, src_dict, tgt_dataset, tgt_dataset.sizes, tgt_dict,
                               left_pad_source=left_pad_source, left_pad_target=left_pad_target,
                               align_dataset=align_dataset)


class TranslationTask(Task):
    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="binarized corpus director(ies), os.pathsep-joined")
        parser.add_argument("-s", "--source-lang", default=None, metavar="SRC",
                            help="language code of the input side (inferred from the file names when omitted)")
        parser.add_argument("-t", "--target-lang", default=None, metavar="TARGET",
                            help="language code of the output side (inferred from the file names when omitted)")
        parser.add_argument("--left-pad-source", default="True", type=str, metavar="BOOL",
                            help="put source padding before the tokens rather than after")
        parser.add_argument("--left-pad-target", default="False", type=str, metavar="BOOL",
                            help="put target padding before the tokens rather than after")
        parser.add_argument("--max-source-positions", default=1024, type=int, metavar="N")
        parser.add_argument("--max-target-positions", default=1024, type=int, metavar="N")
        parser.add_argument("--upsample-primary", default=1, type=int)
        parser.add_argument("--load-alignments", action="store_true")
        parser.add_argument("--truncate-source", action="store_true", default=False)
        parser.add_argument("--eval-bleu", action="store_true",
                            help="score each validation pass with BLEU (drives --best-checkpoint-metric bleu)")
        parser.add_argument("--eval-bleu-detok", type=str, default="space")
        parser.add_argument("--eval-bleu-detok-args", type=str, metavar="JSON")
        parser.add_argument("--eval-tokenized-bleu", action="store_true", default=False)
        parser.add_argument("--eval-bleu-remove-bpe", nargs="?", const="@@ ", default=None)
        parser.add_argument("--eval-bleu-args", type=str, metavar="JSON")
        parser.add_argument("--eval-bleu-print-samples", action="store_true")

    def __init__(self, args, src_dict, tgt_dict):
        super().__init__(args)
        if src_dict.pad() != tgt_dict.pad() or src_dict.eos() != tgt_dict.eos() or src_dict.unk() != tgt_dict.unk():
            raise ValueError("source and target dictionaries must share pad, eos and unk")
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.paths = getattr(args, "data", "").split(os.pathsep)
        self.tokenizer = None
        self._bleu_generator = None
        # --eval-bleu needs sacrebleu: asked for without it, the task raises here
        self._sacrebleu = require_package("sacrebleu", "--eval-bleu") if getattr(args, "eval_bleu", False) else None

    @classmethod
    def setup_task(cls, args, **kwargs):
        args.left_pad_source = str(args.left_pad_source).lower() == "true"
        args.left_pad_target = str(args.left_pad_target).lower() == "true"
        paths = args.data.split(os.pathsep)
        if args.source_lang is None or args.target_lang is None:
            args.source_lang, args.target_lang = infer_language_pair(paths[0])
        if args.source_lang is None or args.target_lang is None:
            raise ValueError("Could not infer language pair, please provide it explicitly")
        src_dict = Dictionary.load(os.path.join(paths[0], f"dict.{args.source_lang}.txt"))
        tgt_dict = Dictionary.load(os.path.join(paths[0], f"dict.{args.target_lang}.txt"))
        return cls(args, src_dict, tgt_dict)

    def load_dataset(self, split, combine=False, **kwargs):
        self.datasets[split] = load_langpair_dataset(
            self.paths[0], split, self.args.source_lang, self.src_dict, self.args.target_lang, self.tgt_dict,
            combine=combine, dataset_impl=getattr(self.args, "dataset_impl", None),
            left_pad_source=getattr(self.args, "left_pad_source", True),
            left_pad_target=getattr(self.args, "left_pad_target", False),
            max_source_positions=getattr(self.args, "max_source_positions", 1024),
            with_alignments=getattr(self.args, "load_alignments", False),
            truncate_source=getattr(self.args, "truncate_source", False))

    @property
    def source_dictionary(self):
        return self.src_dict

    @property
    def target_dictionary(self):
        return self.tgt_dict

    # validation BLEU (JAX :292-403, reference translation.py:264-381)

    def build_model(self, args, device=None):
        model = super().build_model(args, device=device)
        if getattr(args, "eval_bleu", False):
            detok = getattr(args, "eval_bleu_detok", None)
            if detok is None:
                raise ValueError("--eval-bleu-detok is required if using --eval-bleu; try --eval-bleu-detok=moses "
                                 "(or --eval-bleu-detok=space to disable detokenization, e.g., when using "
                                 "sentencepiece)")
            detok_args = json.loads(getattr(args, "eval_bleu_detok_args", "{}") or "{}")
            self.tokenizer = encoders.build_tokenizer(Namespace(tokenizer=detok, **detok_args))
            gen_args = json.loads(getattr(args, "eval_bleu_args", "{}") or "{}")
            self._bleu_generator = self.build_generator([model], Namespace(**gen_args))
        return model

    def valid_step_extra(self, sample, trainer) -> dict:
        """sacrebleu's sufficient statistics of the batch decoded with the
        trainer's current weights, as scalar entries that sum over batches."""
        if not getattr(self.args, "eval_bleu", False):
            return {}
        model = trainer.model
        was_training = model.training
        model.eval()
        try:
            bleu = self._inference_with_bleu(self._bleu_generator, sample, [model])
        finally:
            model.train(was_training)
        out = {"_bleu_sys_len": bleu.sys_len, "_bleu_ref_len": bleu.ref_len}
        for i in range(EVAL_BLEU_ORDER):
            out[f"_bleu_counts_{i}"] = bleu.counts[i]
            out[f"_bleu_totals_{i}"] = bleu.totals[i]
        return out

    def reduce_metrics(self, logging_outputs, criterion, metrics) -> None:
        super().reduce_metrics(logging_outputs, criterion, metrics)
        if not getattr(self.args, "eval_bleu", False):
            return

        def sum_logs(key):
            return sum(log.get(key, 0) for log in logging_outputs)

        counts = [sum_logs(f"_bleu_counts_{i}") for i in range(EVAL_BLEU_ORDER)]
        totals = [sum_logs(f"_bleu_totals_{i}") for i in range(EVAL_BLEU_ORDER)]
        if max(totals) > 0:
            metrics.log_scalar("_bleu_counts", np.array(counts))
            metrics.log_scalar("_bleu_totals", np.array(totals))
            metrics.log_scalar("_bleu_sys_len", sum_logs("_bleu_sys_len"))
            metrics.log_scalar("_bleu_ref_len", sum_logs("_bleu_ref_len"))
            sacrebleu = self._sacrebleu

            def compute_bleu(meters):
                bleu = sacrebleu.metrics.BLEU.compute_bleu(
                    correct=[int(c) for c in np.asarray(meters["_bleu_counts"].sum)],
                    total=[int(t) for t in np.asarray(meters["_bleu_totals"].sum)],
                    sys_len=int(meters["_bleu_sys_len"].sum), ref_len=int(meters["_bleu_ref_len"].sum),
                    smooth_method="exp")
                return round(bleu.score, 2)

            metrics.log_derived("bleu", compute_bleu)

    def _inference_with_bleu(self, generator, sample, models):
        def decode(toks, escape_unk=False):
            # an <unk> would count as '< unk >' words: sentinels that cannot
            # match each other (reference translation.py:351-361)
            s = self.tgt_dict.string(np.asarray(toks), getattr(self.args, "eval_bleu_remove_bpe", None),
                                     unk_string="UNKNOWNTOKENINREF" if escape_unk else "UNKNOWNTOKENINHYP")
            return self.tokenizer.decode(s) if self.tokenizer else s

        gen_out = self.inference_step(generator, models, sample, None)
        hyps, refs = [], []
        pad = self.tgt_dict.pad()
        for i in range(len(gen_out)):
            hyps.append(decode(gen_out[i][0]["tokens"]))
            target = np.asarray(sample["target"][i])
            refs.append(decode(target[target != pad], escape_unk=True))
        if getattr(self.args, "eval_bleu_print_samples", False):
            logger.info("example hypothesis: " + hyps[0])
            logger.info("example reference: " + refs[0])
        tokenize = "none" if getattr(self.args, "eval_tokenized_bleu", False) else self._sacrebleu.BLEU.TOKENIZER_DEFAULT
        return self._sacrebleu.corpus_bleu(hyps, [refs], tokenize=tokenize)
