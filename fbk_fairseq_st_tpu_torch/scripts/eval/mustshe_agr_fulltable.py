#!/usr/bin/python3
"""MuST-SHE gender-agreement sentence statistics (ACL 2022).

Counterpart of reference scripts/eval/mustshe_agr_fulltable.py: per
agreement group (AGR_TERMS), every member term is matched in the hypothesis
(correct form, wrong form, both, or absent); terms found in BOTH forms are
disambiguated by token-distance to uniquely-located terms; the group is
agreement_correct if all covered members resolve to the correct gender,
agreement_wrong if all resolve wrong, out_of_coverage if any member is
missing/undecidable, else no_agreement.

The port's copy of ``fbk_fairseq_st_tpu/scripts/eval/mustshe_agr_fulltable.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.eval.mustshe_agr_fulltable --input-prefix HYP --tsv-definition MUSTSHE.tsv --agr-definition AGR.tsv --output T.tsv
"""

from __future__ import annotations

import argparse
import csv
import glob
import os


def sentences_by_id(tsv_f, in_f):
    sentences = {}
    with open(in_f) as i_f, open(tsv_f) as t_f:
        for (i_line, terms_f) in zip(i_f, csv.DictReader(t_f, delimiter="\t")):
            sentences[terms_f["ID"]] = {
                "sys_out": i_line.strip(),
                "CATEGORY": terms_f["CATEGORY"],
            }
    return sentences


def agreement_stats(agr_definition, sentences):
    with open(agr_definition) as tsv_f:
        for agr_line in csv.DictReader(tsv_f, delimiter="\t"):
            sent = sentences[agr_line["ID"]]
            generated = sent["sys_out"].strip().lower().split()
            terms_found = []
            for t in agr_line["AGR_TERMS"].strip().lower().split(";"):
                correct_term, wrong_term = t.split(" ")[:2]
                terms_found.append(
                    {
                        "correct": [
                            i for i, x in enumerate(generated) if x == correct_term
                        ],
                        "wrong": [
                            i for i, x in enumerate(generated) if x == wrong_term
                        ],
                    }
                )

            stats = {"correct": 0, "wrong": 0, "both": 0, "not_found": 0}
            to_disambiguate = []
            fixed_items = []
            for t in terms_found:
                has_c, has_w = len(t["correct"]) > 0, len(t["wrong"]) > 0
                if has_c and has_w:
                    stats["both"] += 1
                    to_disambiguate.append(t)
                elif has_c:
                    stats["correct"] += 1
                    if len(t["correct"]) == 1:
                        fixed_items.append(t["correct"][0])
                elif has_w:
                    stats["wrong"] += 1
                    if len(t["wrong"]) == 1:
                        fixed_items.append(t["wrong"][0])
                else:
                    stats["not_found"] += 1

            stats["correct_disambiguated"] = stats["correct"]
            stats["wrong_disambiguated"] = stats["wrong"]
            stats["not_disambiguated"] = 0
            if to_disambiguate:
                if not fixed_items:
                    stats["not_disambiguated"] = len(to_disambiguate)
                else:
                    for t in to_disambiguate:
                        c_dist = min(
                            sum(abs(tc - fp) for fp in fixed_items)
                            for tc in t["correct"]
                        )
                        w_dist = min(
                            sum(abs(tw - fp) for fp in fixed_items)
                            for tw in t["wrong"]
                        )
                        if c_dist <= w_dist:
                            stats["correct_disambiguated"] += 1
                        else:
                            stats["wrong_disambiguated"] += 1

            uncovered = stats["not_found"] + stats["not_disambiguated"]
            stats["agreement_correct"] = (
                stats["wrong_disambiguated"] == 0 and uncovered == 0
            )
            stats["agreement_wrong"] = (
                stats["correct_disambiguated"] == 0 and uncovered == 0
            )
            stats["out_of_coverage"] = uncovered > 0
            stats["no_agreement"] = not (
                stats["out_of_coverage"]
                or stats["agreement_correct"]
                or stats["agreement_wrong"]
            )
            for f in ("ID", "AGR_KIND", "AGR_TERMS", "AGR_IDS"):
                stats[f] = agr_line[f]
            stats["CATEGORY_TYPE"] = sent["CATEGORY"][0]
            stats["CATEGORY_GENDER"] = sent["CATEGORY"][1]
            yield stats


def write_sentence_acc(out_f, all_stats):
    headers = [
        "ID", "AGR_KIND", "AGR_TERMS", "AGR_IDS",
        "CATEGORY_TYPE", "CATEGORY_GENDER",
    ]
    stat_cols = [
        "not_found", "correct_disambiguated", "wrong_disambiguated",
        "not_disambiguated", "agreement_correct", "agreement_wrong",
        "out_of_coverage", "no_agreement",
    ]
    rows = []
    for system_name, stats_terms in all_stats:
        for i, stats in enumerate(stats_terms):
            if len(rows) <= i:
                rows.append({h: stats[h] for h in headers[:6]})
            for h in stat_cols:
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
    parser.add_argument("--input-prefix", required=True, type=str, metavar="FILE")
    parser.add_argument("--tsv-definition", required=True, type=str, metavar="FILE")
    parser.add_argument("--agr-definition", required=True, type=str, metavar="FILE",
                        help="TSV with agreement groups (ID, AGR_KIND, AGR_TERMS, AGR_IDS).")
    parser.add_argument("--output", required=True, type=str, metavar="FILE")
    args = parser.parse_args(input_args)

    all_stats = []
    for input_f in sorted(glob.glob(args.input_prefix + "*")):
        sentences = sentences_by_id(args.tsv_definition, input_f)
        all_stats.append(
            (
                os.path.basename(input_f),
                list(agreement_stats(args.agr_definition, sentences)),
            )
        )
    write_sentence_acc(args.output, all_stats)


if __name__ == "__main__":
    cli_main()
