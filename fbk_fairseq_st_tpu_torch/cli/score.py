"""BLEU of a system output file against a reference file.

The port's copy of ``fbk_fairseq_st_tpu/cli/score.py`` (reference
fairseq_cli/score.py): both files' lines are encoded with one throwaway
dictionary and scored by the port's ``scoring/bleu.py`` (corpus BLEU, or
``--sentence-bleu`` line by line); ``--sacrebleu`` scores the raw strings
with ``sacrebleu``, imported only then (it raises ``ImportError`` where
the package is missing). No device is used:

    python -m fbk_fairseq_st_tpu_torch.cli.score --sys hyp.txt --ref ref.txt
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.dictionary import Dictionary
from ..scoring import bleu


def _sacrebleu():
    try:
        import sacrebleu
    except ImportError as e:
        raise ImportError("--sacrebleu needs the sacrebleu package, which is not installed; "
                          "score without --sacrebleu for the built-in corpus BLEU") from e
    return sacrebleu


def cli_main(input_args=None):
    parser = argparse.ArgumentParser(description="Command-line script for BLEU scoring.")
    parser.add_argument("-s", "--sys", default="-", help="system output")
    parser.add_argument("-r", "--ref", default="", help="references")
    parser.add_argument("-o", "--order", default=4, metavar="N", type=int, help="consider ngrams up to this order")
    parser.add_argument("--ignore-case", action="store_true")
    parser.add_argument("--sacrebleu", action="store_true")
    parser.add_argument("--sentence-bleu", action="store_true")
    args = parser.parse_args(input_args)

    assert args.sys == "-" or os.path.exists(args.sys), f"not found: {args.sys}"
    assert os.path.exists(args.ref), f"not found: {args.ref}"

    def readlines(fd):
        for line in fd.readlines():
            yield line.lower() if args.ignore_case else line

    if args.sacrebleu:
        sacrebleu = _sacrebleu()

        def score(fdsys):
            with open(args.ref) as fdref:
                print(sacrebleu.corpus_bleu(list(readlines(fdsys)), [list(readlines(fdref))]))

    elif args.sentence_bleu:

        def score(fdsys):
            with open(args.ref) as fdref:
                scorer = bleu.Scorer(Dictionary().pad(), Dictionary().eos(), Dictionary().unk())
                d = Dictionary()
                for i, (sys_tok, ref_tok) in enumerate(zip(readlines(fdsys), readlines(fdref))):
                    scorer.reset(one_init=True)
                    s = d.encode_line(sys_tok, add_if_not_exist=True)
                    r = d.encode_line(ref_tok, add_if_not_exist=True)
                    scorer.add(np.asarray(r, np.int32), np.asarray(s, np.int32))
                    print(i, scorer.result_string(args.order))

    else:

        def score(fdsys):
            with open(args.ref) as fdref:
                d = Dictionary()
                scorer = bleu.Scorer(d.pad(), d.eos(), d.unk())
                for sys_tok, ref_tok in zip(readlines(fdsys), readlines(fdref)):
                    s = d.encode_line(sys_tok, add_if_not_exist=True)
                    r = d.encode_line(ref_tok, add_if_not_exist=True)
                    scorer.add(np.asarray(r, np.int32), np.asarray(s, np.int32))
                print(scorer.result_string(args.order))

    if args.sys == "-":
        score(sys.stdin)
    else:
        with open(args.sys, "r") as f:
            score(f)


if __name__ == "__main__":
    cli_main()
