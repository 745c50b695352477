#!/usr/bin/python3
"""Merge NER and terminology IOB annotation streams (EMNLP 2021 data prep).

Counterpart of reference scripts/combine_ne_terms.py: two token-aligned IOB
files (idx<TAB>token<TAB>tag[<TAB>id]) over the same text with possibly
different tokenizations; terminology annotations win over 'O', NER types
fill the rest. Where tokenizations diverge, tokens are merged by surface
concatenation (the majority/last-type vote of the reference's select_type).

The port's copy of ``fbk_fairseq_st_tpu/scripts/combine_ne_terms.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.combine_ne_terms NER TERMS > OUT
"""

from __future__ import annotations

import argparse
import sys


def select_type(types):
    """Reference combine_ne_terms.py select_type: last non-O, else mode."""
    if types and types[-1] != "O":
        return types[-1]
    return sorted(types, key=types.count, reverse=True)[0]


def _read_sentence(fp):
    rows = []
    for line in fp:
        line = line.rstrip("\n")
        if line.strip() == "":
            return rows, True
        items = line.split("\t")
        rows.append(items)
    return rows, False


def _merge_sentence(ner_rows, term_rows):
    """Greedy surface alignment of the two token streams; term tags
    override 'O' NER tags."""
    out = []
    i = j = 0
    while i < len(ner_rows) and j < len(term_rows):
        ner_tok = ner_rows[i][1]
        term_tok = term_rows[j][1]
        if ner_tok == term_tok:
            tag = term_rows[j][2] if term_rows[j][2] != "O" else ner_rows[i][2]
            out.append([str(len(out) + 1), ner_tok, tag] + term_rows[j][3:])
            i += 1
            j += 1
            continue
        # different tokenizations: accumulate until surfaces match
        ner_buf, ner_tags = ner_tok, [ner_rows[i][2]]
        term_buf, term_tags = term_tok, [term_rows[j][2]]
        ii, jj = i + 1, j + 1
        while ner_buf != term_buf and ii <= len(ner_rows) and jj <= len(term_rows):
            if len(ner_buf) < len(term_buf) and ii < len(ner_rows):
                ner_buf += ner_rows[ii][1]
                ner_tags.append(ner_rows[ii][2])
                ii += 1
            elif jj < len(term_rows):
                term_buf += term_rows[jj][1]
                term_tags.append(term_rows[jj][2])
                jj += 1
            else:
                break
        tags = [t.split("-")[-1] for t in term_tags + ner_tags]
        merged_type = select_type(tags)
        if merged_type != "O":
            prefix = "B" if any(
                t.split("-")[0] == "B" for t in term_tags + ner_tags
            ) else "I"
            tag = f"{prefix}-{merged_type}"
        else:
            tag = "O"
        out.append([str(len(out) + 1), ner_buf, tag])
        i, j = ii, jj
    return out


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("ner_file", help="IOB file with NER annotations")
    parser.add_argument("term_file", help="IOB file with terminology annotations")
    args = parser.parse_args(input_args)

    with open(args.ner_file) as ner_f, open(args.term_file) as term_f:
        while True:
            ner_rows, more_n = _read_sentence(ner_f)
            term_rows, more_t = _read_sentence(term_f)
            if not ner_rows and not (more_n or more_t):
                break
            for row in _merge_sentence(ner_rows, term_rows):
                sys.stdout.write("\t".join(row) + "\n")
            sys.stdout.write("\n")
            if not (more_n or more_t):
                break


if __name__ == "__main__":
    cli_main()
