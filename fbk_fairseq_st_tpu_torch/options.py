"""The argument groups that ``cli/generate`` reads, and the two-pass parse.

Counterpart of ``fbk_fairseq_st_tpu/options.py`` (``get_generation_parser``
:35, ``get_parser`` :77, ``add_dataset_args`` :220,
``add_common_eval_args`` :456, ``add_generation_args`` :490,
``parse_args_and_arch`` :593), under the same flag names and defaults.
``parse_args_and_arch`` parses once to learn ``--task`` and
``--criterion``, adds their flags, parses again and fills in the arch
preset's defaults.

An option whose feature the port lacks raises ``NotImplementedError``
naming its ROADMAP item when it is set (``NOT_PORTED``); flags of the JAX
parser that only steer XLA or the TPU have no counterpart here.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from . import registry

# option -> (its value when off, what it needs): set to anything else, it raises
NOT_PORTED = {
    "sacrebleu": (False, "sacrebleu scoring: no sacrebleu on the card's machine (ROADMAP Queue A item 3)"),
    "replace_unk": (None, "unk replacement needs the alignments (ROADMAP Queue A item 3)"),
    "print_alignment": (False, "alignments (ROADMAP Queue A item 3)"),
    "quantize_weights": ("none", "weight-only quantisation (ROADMAP Queue A item 9)"),
    "bpe": (None, "the BPE codecs (ROADMAP Queue A item 3)"),
    "tokenizer": (None, "the tokenizers (ROADMAP Queue A item 3)"),
    "num_shards": (1, "sharded generation (ROADMAP Queue A item 3)"),
    "score_reference": (False, "the sequence scorer (ROADMAP Queue A item 3)"),
    "user_dir": (None, "user extension modules (ROADMAP Queue A item 3)"),
}


def get_generation_parser(default_task: str = "speech_recognition") -> argparse.ArgumentParser:
    parser = get_parser("Generation", default_task)
    add_dataset_args(parser, gen=True)
    add_generation_args(parser)
    return parser


def get_parser(desc: str, default_task: str = "speech_recognition") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(allow_abbrev=False, description=desc)
    parser.add_argument("--no-progress-bar", action="store_true", help="disable progress bar")
    parser.add_argument("--log-interval", type=int, default=100, metavar="N",
                        help="log progress every N batches")
    parser.add_argument("--log-format", default=None, choices=["json", "none", "simple", "tqdm"])
    parser.add_argument("--seed", default=1, type=int, metavar="N", help="pseudo random number generator seed")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    parser.add_argument("--user-dir", default=None,
                        help="path to a python module containing custom extensions (tasks and/or architectures)")
    parser.add_argument("--tokenizer", default=None, help="tokenizer applied to raw text before BPE")
    parser.add_argument("--bpe", default=None, help="subword codec applied after the tokenizer")
    parser.add_argument("--task", metavar="TASK", default=default_task, help="task")
    parser.add_argument("--criterion", default="cross_entropy", metavar="CRIT")
    parser.add_argument("--optimizer", default="nag", metavar="OPT")
    parser.add_argument("--lr-scheduler", default="fixed", metavar="SCHED")
    return parser


def add_dataset_args(parser, train: bool = False, gen: bool = False):
    group = parser.add_argument_group("Dataset and data loading")
    group.add_argument("--num-workers", default=1, type=int, metavar="N",
                       help="how many subprocesses to use for data loading")
    group.add_argument("--skip-invalid-size-inputs-valid-test", action="store_true",
                       help="ignore too-long or too-short lines in valid and test set")
    group.add_argument("--max-tokens", type=int, metavar="N", help="maximum number of tokens in a batch")
    group.add_argument("--max-sentences", "--batch-size", type=int, metavar="N",
                       help="maximum number of sentences in a batch")
    group.add_argument("--required-batch-size-multiple", default=8, type=int, metavar="N",
                       help="batch size will be a multiplier of this value")
    group.add_argument("--dataset-impl", metavar="FORMAT", choices=["raw", "lazy", "cached", "mmap"],
                       help="output dataset implementation")
    group.add_argument("--data-buffer-size", default=2, type=int, help="number of batches to preload")
    if gen:
        group.add_argument("--gen-subset", default="test", metavar="SPLIT",
                           help="data subset to generate (train, valid, test)")
        group.add_argument("--num-shards", default=1, type=int, metavar="N")
        group.add_argument("--shard-id", default=0, type=int, metavar="ID")
    return group


def add_common_eval_args(group) -> None:
    group.add_argument("--path", metavar="FILE", help="path(s) to model file(s), colon separated")
    group.add_argument("--remove-bpe", "--post-process", nargs="?", const="@@ ", default=None,
                       help="remove BPE tokens before scoring")
    group.add_argument("--quiet", action="store_true", help="only print final scores")
    group.add_argument("--model-overrides", default="{}", type=str, metavar="DICT")
    group.add_argument("--results-path", metavar="RESDIR", type=str, default=None)


def add_generation_args(parser):
    group = parser.add_argument_group("Generation")
    add_common_eval_args(group)
    group.add_argument("--quantize-weights", choices=["none", "int8"], default="none",
                       help="weight-only quantization of linear layers for serving")
    group.add_argument("--beam", default=5, type=int, metavar="N", help="beam size")
    group.add_argument("--nbest", default=1, type=int, metavar="N", help="number of hypotheses to output")
    group.add_argument("--max-len-a", default=0, type=float, metavar="N")
    group.add_argument("--max-len-b", default=200, type=int, metavar="N",
                       help="generate sequences of maximum length ax + b")
    group.add_argument("--min-len", default=1, type=float, metavar="N")
    group.add_argument("--match-source-len", default=False, action="store_true")
    group.add_argument("--no-early-stop", action="store_true")
    group.add_argument("--unnormalized", action="store_true", help="compare unnormalized hypothesis scores")
    group.add_argument("--no-beamable-mm", action="store_true")
    group.add_argument("--lenpen", default=1, type=float, help="length penalty: >1.0 favors longer sentences")
    group.add_argument("--unkpen", default=0, type=float, help="unknown word penalty")
    group.add_argument("--replace-unk", nargs="?", const=True, default=None)
    group.add_argument("--sacrebleu", action="store_true", help="score with sacrebleu")
    group.add_argument("--score-reference", action="store_true", help="just score the reference translation")
    group.add_argument("--prefix-size", default=0, type=int, metavar="PS",
                       help="initialize generation by target prefix of given length")
    group.add_argument("--no-repeat-ngram-size", default=0, type=int, metavar="N",
                       help="ngram blocking such that this size ngram cannot be repeated")
    group.add_argument("--sampling", action="store_true", help="sample hypotheses instead of using beam search")
    group.add_argument("--sampling-topk", default=-1, type=int, metavar="PS",
                       help="sample from top K likely next words")
    group.add_argument("--sampling-topp", default=-1.0, type=float, metavar="PS",
                       help="sample from the smallest set of words whose cumulative probability mass exceeds p")
    group.add_argument("--temperature", default=1.0, type=float, metavar="N", help="temperature for generation")
    group.add_argument("--diverse-beam-groups", default=-1, type=int, metavar="N")
    group.add_argument("--diverse-beam-strength", default=0.5, type=float, metavar="N")
    group.add_argument("--diversity-rate", default=-1.0, type=float, metavar="N")
    group.add_argument("--print-alignment", action="store_true")
    return group


def check_ported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for a set option the port lacks."""
    for name, (off, what) in NOT_PORTED.items():
        if getattr(args, name, off) != off:
            raise NotImplementedError(f"--{name.replace('_', '-')}: {what} is not ported")


def parse_args_and_arch(parser: argparse.ArgumentParser, input_args: Optional[List[str]] = None,
                        parse_known: bool = False):
    """The two-pass parse (reference options.py:81-196): the task's and
    the criterion's flags join the parser, then the arch preset's defaults
    the namespace (``registry.apply_architecture``)."""
    args, _ = parser.parse_known_args(input_args)
    for reg, attr in ((registry.TASKS, "task"), (registry.CRITERIONS, "criterion")):
        name = getattr(args, attr, None)
        if name is not None and name in reg:
            reg.add_args(name, parser)
    if parse_known:
        args, extra = parser.parse_known_args(input_args)
    else:
        args, extra = parser.parse_args(input_args), None
    check_ported(args)
    if getattr(args, "arch", None) is not None:
        registry.apply_architecture(args)
    return (args, extra) if parse_known else args
