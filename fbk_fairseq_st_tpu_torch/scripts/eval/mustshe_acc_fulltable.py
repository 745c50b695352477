#!/usr/bin/python3
"""MuST-SHE sentence-level gender statistics with POS/class dimensions
(ACL 2022 "Under the Morphosyntactic Lens").

Counterpart of reference scripts/eval/mustshe_acc_fulltable.py: for every
system-output file matching --input-prefix*, each annotated (correct wrong)
term pair is matched at most once per hypothesis; per-term rows carry the
POS tag, open/closed class, speaker gender, category and per-system
found/found_correct/found_wrong flags, written as one TSV consumed by
accuracy_from_fulltable.

The port's copy of ``fbk_fairseq_st_tpu/scripts/eval/mustshe_acc_fulltable.py``: the standard
library only, the same printed lines and written files, byte for byte,
where JAX's runs: JAX's raises ``KeyError`` on a table of more than one
term (ROADMAP Queue C), where the port writes each row: its term's
columns, then each system's.

    python -m fbk_fairseq_st_tpu_torch.scripts.eval.mustshe_acc_fulltable --input-prefix HYP --tsv-definition MUSTSHE.tsv --pos-definition POS.tsv --output T.tsv
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

CLOSED_CLASS_POS = {"art/prep", "pronoun", "adj-determiner"}


def read_pos_definition(tsv_pos_f):
    with open(tsv_pos_f) as tf:
        return {
            line["ID"]: line["POS"].strip()
            for line in csv.DictReader(tf, delimiter="\t")
        }


def sentence_level_scores(in_f, tsv_f, pos_definitions):
    terms_stats = []
    with open(in_f) as i_f, open(tsv_f) as t_f:
        tsv_reader = csv.DictReader(t_f, delimiter="\t")
        for (i_line, terms_f) in zip(i_f, tsv_reader):
            gender_marked_terms = terms_f["GENDERTERMS"].strip().lower().split(";")
            terms_pos = pos_definitions[terms_f["ID"]].lower().split(";")
            generated_terms = i_line.strip().lower().split()
            for t, pos in zip(gender_marked_terms, terms_pos):
                correct_term, wrong_term = t.split(" ")[:2]
                found_correct = found_wrong = False
                if correct_term in generated_terms:
                    generated_terms.remove(correct_term)  # match at most once
                    found_correct = True
                if wrong_term in generated_terms:
                    generated_terms.remove(wrong_term)
                    found_wrong = True
                terms_stats.append(
                    {
                        "found": int(found_wrong or found_correct),
                        "sentence_id": terms_f["ID"],
                        "found_correct": int(found_correct),
                        "found_wrong": int(found_wrong),
                        "pos": pos,
                        "class": "closed" if pos.lower() in CLOSED_CLASS_POS else "open",
                        "speaker_gender": terms_f["GENDER"],
                        "gender": terms_f["CATEGORY"][1],
                        "category": terms_f["CATEGORY"],
                        "correct": correct_term,
                        "wrong": wrong_term,
                    }
                )
    return terms_stats


def write_sentence_acc(out_f, all_stats):
    headers = [
        "sentence_id", "correct", "wrong", "speaker_gender",
        "category", "pos", "class", "gender",
    ]
    rows = []
    for system_name, stats_terms in all_stats:
        for i, stats in enumerate(stats_terms):
            if len(rows) <= i:
                # the term's own columns only: JAX takes every header here,
                # the systems' columns that the first row added included,
                # and raises KeyError from the second term on
                rows.append({h: stats[h] for h in headers[:8]})
            for h in ("found", "found_correct", "found_wrong"):
                col = f"{system_name}_{h}"
                if i == 0:
                    headers.append(col)
                rows[i][col] = stats[h]
    with open(out_f, "w") as f_w:
        writer = csv.DictWriter(f_w, headers, delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input-prefix", required=True, type=str, metavar="FILE",
                        help="Input prefix of tokenized system outputs.")
    parser.add_argument("--tsv-definition", required=True, type=str, metavar="FILE",
                        help="TSV MuST-SHE definitions file.")
    parser.add_argument("--pos-definition", required=True, type=str, metavar="FILE",
                        help="TSV file containing the POS definitions.")
    parser.add_argument("--output", required=True, type=str, metavar="FILE")
    args = parser.parse_args(input_args)

    pos_definitions = read_pos_definition(args.pos_definition)
    all_stats = []
    for input_f in sorted(glob.glob(args.input_prefix + "*")):
        all_stats.append(
            (
                os.path.basename(input_f),
                sentence_level_scores(input_f, args.tsv_definition, pos_definitions),
            )
        )
    write_sentence_acc(args.output, all_stats)


if __name__ == "__main__":
    cli_main()
