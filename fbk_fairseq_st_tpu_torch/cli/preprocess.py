"""Text preprocessing: the dictionaries and the binarized splits.

The port's copy of ``fbk_fairseq_st_tpu/cli/preprocess.py`` (reference
fairseq_cli/preprocess.py): builds ``dict.<lang>.txt`` (``--thresholdsrc``
/ ``--thresholdtgt``, ``--nwordssrc`` / ``--nwordstgt``,
``--padding-factor``; one dictionary over both sides with
``--joined-dictionary``) or loads ``--srcdict`` / ``--tgtdict``, and
binarizes ``<pref>.<lang>`` into ``<split>.<src>-<tgt>.<lang>`` (a pair),
``<split>.<lang>`` (one language) or ``<split>`` (``--only-source``
without a language), the files the tasks load, in any ``--dataset-impl``
the readers take (``raw``, ``lazy`` and ``cached`` write the TNT format,
``mmap`` the mmap one). ``--align-suffix`` binarizes Pharaoh alignments
into ``<split>.align.<src>-<tgt>``; ``--alignfile`` writes the
``alignment.<src>-<tgt>.txt`` dictionary of ``--replace-unk``. The files
are byte for byte JAX's. ``--workers`` is parsed and, as in JAX, one
process writes everything. No device is used:

    python -m fbk_fairseq_st_tpu_torch.cli.preprocess --target-lang de --trainpref raw/train \\
        --validpref raw/valid --destdir data-bin --dataset-impl cached
"""

from __future__ import annotations

import logging
import os
import sys
from itertools import zip_longest

import numpy as np

from .. import options
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import make_builder

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.preprocess")


def _dictionary_hooks(args):
    """The task's dictionary class and loader (the ``--task`` mechanism of
    fairseq-preprocess), else ``Dictionary`` and ``Dictionary.load``."""
    from ..registry import TASKS

    task_name = getattr(args, "task", None)
    if task_name and task_name in TASKS:
        task_cls = TASKS[task_name]
        dict_cls = getattr(task_cls, "dictionary_class", None)
        dict_cls = dict_cls() if callable(dict_cls) else Dictionary
        loader = getattr(task_cls, "load_dictionary", Dictionary.load)
        return dict_cls, loader
    return Dictionary, Dictionary.load


def build_dictionary(filenames, threshold=-1, nwords=-1, padding_factor=8, dict_cls=Dictionary):
    d = dict_cls()
    for filename in filenames:
        with open(filename, "r", encoding="utf-8") as f:
            for line in f:
                for word in line.split():
                    d.add_symbol(word)
                d.add_symbol(d.eos_word)
    d.finalize(threshold=threshold, nwords=nwords, padding_factor=padding_factor)
    return d


def binarize(input_file, dictionary, output_prefix, impl="mmap", append_eos=True):
    builder = make_builder(output_prefix + ".bin", impl=impl, vocab_size=len(dictionary))
    nseq, ntok, nunk = 0, 0, 0
    with open(input_file, "r", encoding="utf-8") as f:
        for line in f:
            ids = dictionary.encode_line(line, add_if_not_exist=False, append_eos=append_eos)
            nseq += 1
            ntok += len(ids)
            nunk += int((ids == dictionary.unk()).sum())
            builder.add_item(ids)
    builder.finalize(output_prefix + ".idx")
    return nseq, ntok, nunk


def binarize_alignments(input_file, output_prefix, impl="mmap"):
    """Pharaoh 'si-ti si-ti ...' lines -> one flat [s0, t0, s1, t1, ...]
    item a line (reference make_binary_alignment_dataset)."""
    builder = make_builder(output_prefix + ".bin", impl=impl)
    nseq = 0
    with open(input_file, "r", encoding="utf-8") as f:
        for line in f:
            flat = []
            for pair in line.split():
                s, t = pair.split("-")
                flat += [int(s), int(t)]
            builder.add_item(np.asarray(flat, dtype=np.int64))
            nseq += 1
    builder.finalize(output_prefix + ".idx")
    return nseq


def build_unk_align_dict(args, src_dict, tgt_dict):
    """``--alignfile`` (reference preprocess.py:267-307): each source word's
    most frequently aligned target word, written to
    ``alignment.<src>-<tgt>.txt``."""
    assert args.trainpref, "--trainpref must be set if --alignfile is specified"
    src_file = f"{args.trainpref}.{args.source_lang}"
    tgt_file = f"{args.trainpref}.{args.target_lang}"
    freq_map = {}
    with open(args.alignfile, encoding="utf-8") as af, open(src_file, encoding="utf-8") as sf, \
            open(tgt_file, encoding="utf-8") as tf:
        for a, s, t in zip_longest(af, sf, tf):
            si = src_dict.encode_line(s, add_if_not_exist=False)
            ti = tgt_dict.encode_line(t, add_if_not_exist=False)
            for pair in a.split():
                sai, tai = pair.split("-")
                srcidx, tgtidx = int(si[int(sai)]), int(ti[int(tai)])
                if srcidx != src_dict.unk() and tgtidx != tgt_dict.unk():
                    counts = freq_map.setdefault(srcidx, {})
                    counts[tgtidx] = counts.get(tgtidx, 0) + 1
    out = os.path.join(args.destdir, "alignment.{}-{}.txt".format(args.source_lang, args.target_lang))
    with open(out, "w", encoding="utf-8") as f:
        for srcidx, counts in freq_map.items():
            best = max(counts, key=counts.get)
            print("{} {}".format(src_dict[srcidx], tgt_dict[best]), file=f)
    return out


def _splits(args):
    return [(pref, split) for pref, split in ((args.trainpref, "train"), (args.validpref, "valid"),
                                              (args.testpref, "test")) if pref is not None]


def main(args):
    os.makedirs(args.destdir, exist_ok=True)
    if args.only_source:
        langs = [args.source_lang]  # None: the unnamed {split}.{bin,idx} + dict.txt layout
    else:
        langs = [lang for lang in (args.source_lang, args.target_lang) if lang is not None]
        assert langs, "specify --source-lang and/or --target-lang"
    paired = args.source_lang is not None and args.target_lang is not None

    dict_cls, dict_loader = _dictionary_hooks(args)
    joined_dict = None
    if args.joined_dictionary and len(langs) > 1:
        assert args.trainpref, "--trainpref required to build a dictionary"
        joined_dict = build_dictionary([f"{args.trainpref}.{lang}" for lang in langs], threshold=args.thresholdsrc,
                                       nwords=args.nwordssrc, padding_factor=args.padding_factor, dict_cls=dict_cls)

    dicts = {}
    for lang in langs:
        is_src = lang == args.source_lang
        existing = args.srcdict if is_src else args.tgtdict
        if joined_dict is not None:
            d = joined_dict
        elif existing:
            d = dict_loader(existing)
        else:
            assert args.trainpref, "--trainpref required to build a dictionary"
            d = build_dictionary([f"{args.trainpref}.{lang}" if lang else args.trainpref],
                                 threshold=args.thresholdsrc if is_src else args.thresholdtgt,
                                 nwords=args.nwordssrc if is_src else args.nwordstgt,
                                 padding_factor=args.padding_factor, dict_cls=dict_cls)
        d.save(os.path.join(args.destdir, f"dict.{lang}.txt" if lang else "dict.txt"))
        dicts[lang] = d
        logger.info(f"[{lang}] dictionary: {len(d)} types")

        for pref, split in _splits(args):
            if paired:
                name = f"{split}.{args.source_lang}-{args.target_lang}.{lang}"
            else:
                name = f"{split}.{lang}" if lang else split
            nseq, ntok, nunk = binarize(f"{pref}.{lang}" if lang else pref, d, os.path.join(args.destdir, name),
                                        impl=args.dataset_impl)
            logger.info("[{}] {}: {} sents, {} tokens, {:.3}% replaced by {}".format(
                lang, f"{pref}.{lang}", nseq, ntok, 100.0 * nunk / max(ntok, 1), d.unk_word))
    if paired and args.align_suffix:
        for pref, split in _splits(args):
            path = f"{pref}.{args.align_suffix}"
            if os.path.exists(path):
                out_prefix = os.path.join(args.destdir, f"{split}.align.{args.source_lang}-{args.target_lang}")
                n = binarize_alignments(path, out_prefix, impl=args.dataset_impl)
                logger.info(f"[alignments] {path}: {n} pairs -> {out_prefix}")
    if paired and args.alignfile:
        out = build_unk_align_dict(args, dicts[args.source_lang], dicts[args.target_lang])
        logger.info(f"[alignments] wrote {out}")
    logger.info(f"Wrote preprocessed data to {args.destdir}")


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    args = options.get_preprocessing_parser().parse_args(input_args)
    options.check_ported(args)
    main(args)


if __name__ == "__main__":
    cli_main()
