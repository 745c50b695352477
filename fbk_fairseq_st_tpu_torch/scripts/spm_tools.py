#!/usr/bin/python3
"""SentencePiece train/encode/decode wrappers (reference scripts/spm_train.py,
spm_encode.py, spm_decode.py). Requires the optional sentencepiece package,
imported when a command runs: without it the command raises
``ImportError`` naming it.

The port's copy of ``fbk_fairseq_st_tpu/scripts/spm_tools.py``:

    python -m fbk_fairseq_st_tpu_torch.scripts.spm_tools encode --model m.model --inputs in.txt
"""

from __future__ import annotations

import argparse
import contextlib
import sys


def _spm():
    try:
        import sentencepiece as spm

        return spm
    except ImportError as e:
        raise ImportError(
            "spm_tools needs the 'sentencepiece' package, which is not "
            f"installed (optional, as in the reference): {e}"
        ) from e


def spm_train(argv=None):
    spm = _spm()
    spm.SentencePieceTrainer.Train(" ".join(argv or sys.argv[1:]))


def spm_encode(input_args=None):
    spm = _spm()
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--inputs", nargs="+", default=["-"])
    parser.add_argument("--outputs", nargs="+", default=["-"])
    parser.add_argument("--output_format", choices=["piece", "id"], default="piece")
    parser.add_argument("--min-len", type=int, metavar="N", default=None)
    parser.add_argument("--max-len", type=int, metavar="N", default=None)
    args = parser.parse_args(input_args)

    sp = spm.SentencePieceProcessor()
    sp.Load(args.model)

    if args.output_format == "piece":
        encode = lambda l: sp.EncodeAsPieces(l)
    else:
        encode = lambda l: list(map(str, sp.EncodeAsIds(l)))

    def valid(line):
        return (args.min_len is None or len(line) >= args.min_len) and (
            args.max_len is None or len(line) <= args.max_len
        )

    with contextlib.ExitStack() as stack:
        inputs = [
            stack.enter_context(open(i, "r", encoding="utf-8"))
            if i != "-" else sys.stdin
            for i in args.inputs
        ]
        outputs = [
            stack.enter_context(open(o, "w", encoding="utf-8"))
            if o != "-" else sys.stdout
            for o in args.outputs
        ]
        for lines in zip(*inputs):
            enc_lines = [encode(l.strip()) for l in lines]
            if all(valid(e) for e in enc_lines):
                for e, out in zip(enc_lines, outputs):
                    print(" ".join(e), file=out)


def spm_decode(input_args=None):
    spm = _spm()
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--input", default="-")
    parser.add_argument("--input_format", choices=["piece", "id"], default="piece")
    args = parser.parse_args(input_args)

    sp = spm.SentencePieceProcessor()
    sp.Load(args.model)
    if args.input_format == "piece":
        decode = lambda l: "".join(sp.DecodePieces(l))
    else:
        decode = lambda l: "".join(sp.DecodeIds(list(map(int, l))))

    h = sys.stdin if args.input == "-" else open(args.input, encoding="utf-8")
    for line in h:
        print(decode(line.rstrip().split(" ")))


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "encode"
    sys.argv = [sys.argv[0]] + sys.argv[2:]
    {"train": spm_train, "encode": spm_encode, "decode": spm_decode}[cmd]()
