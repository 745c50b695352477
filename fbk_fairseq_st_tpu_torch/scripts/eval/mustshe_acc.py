#!/usr/bin/python3
"""MuST-SHE gender term-coverage / accuracy evaluation.

Behavior-identical counterpart of reference scripts/eval/mustshe_acc.py
(COLING 2020 "Breeding Gender-aware Direct Speech Translation Systems"):
per sentence, each annotated gender-marked (correct, wrong) term pair is
matched at most once against the tokenized hypothesis; per-category and
global term coverage and gender accuracy are reported. Same CLI flags, same
TSV columns, same output table.

The port's copy of ``fbk_fairseq_st_tpu/scripts/eval/mustshe_acc.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.eval.mustshe_acc --input HYP --tsv-definition MUSTSHE.tsv
"""

from __future__ import annotations

import argparse
import csv
from dataclasses import dataclass, asdict
from typing import Dict, Iterable, List


@dataclass
class SentenceStats:
    num_terms: int = 0
    num_terms_found: int = 0
    num_correct: int = 0
    num_wrong: int = 0

    def add(self, other: "SentenceStats") -> None:
        self.num_terms += other.num_terms
        self.num_terms_found += other.num_terms_found
        self.num_correct += other.num_correct
        self.num_wrong += other.num_wrong

    @property
    def term_coverage(self) -> float:
        return self.num_terms_found / self.num_terms if self.num_terms else 0.0

    @property
    def gender_accuracy(self) -> float:
        matched = self.num_correct + self.num_wrong
        return self.num_correct / matched if matched else 0.0


def _consume_once(tokens: List[str], word: str) -> bool:
    """Remove the first occurrence of *word* from *tokens*; True if found.
    The single-consumption rule prevents one generated token from matching
    two annotated terms (reference :27-40)."""
    try:
        tokens.remove(word)
        return True
    except ValueError:
        return False


def _score_sentence(hypothesis: str, gender_terms: Iterable[str]) -> SentenceStats:
    tokens = hypothesis.strip().lower().split()
    stats = SentenceStats()
    for pair in gender_terms:
        parts = pair.split(" ")
        correct, wrong = parts[0], parts[1]
        stats.num_terms += 1
        got_correct = _consume_once(tokens, correct)
        got_wrong = _consume_once(tokens, wrong)
        stats.num_correct += int(got_correct)
        stats.num_wrong += int(got_wrong)
        stats.num_terms_found += int(got_correct or got_wrong)
    return stats


def sentence_level_scores(in_f: str, tsv_f: str) -> List[SentenceStats]:
    out = []
    with open(in_f) as hyp_file, open(tsv_f) as def_file:
        definitions = csv.DictReader(def_file, delimiter="\t")
        for hyp_line, definition in zip(hyp_file, definitions):
            pairs = definition["GENDERTERMS"].strip().lower().split(";")
            out.append(_score_sentence(hyp_line, pairs))
    return out


def write_sentence_acc(out_f: str, sentence_scores: List[SentenceStats]) -> None:
    fields = ["num_terms", "num_terms_found", "num_correct", "num_wrong"]
    with open(out_f, "w") as fh:
        writer = csv.DictWriter(fh, fields, delimiter="\t")
        writer.writeheader()
        writer.writerows(asdict(s) for s in sentence_scores)


def global_scores(
    sentence_scores: List[SentenceStats], tsv_f: str, debug: bool = False
) -> Dict[str, Dict[str, float]]:
    per_category: Dict[str, SentenceStats] = {}
    with open(tsv_f) as fh:
        for i, row in enumerate(csv.DictReader(fh, delimiter="\t")):
            per_category.setdefault(row["CATEGORY"], SentenceStats()).add(
                sentence_scores[i]
            )
    if debug:
        print("Evaluated {} sentences...".format(len(sentence_scores)))

    totals = SentenceStats()
    table = {}
    for category, stats in per_category.items():
        table[category] = {
            "term_coverage": stats.term_coverage,
            "gender_accuracy": stats.gender_accuracy,
        }
        totals.add(stats)
    table["Global"] = {
        "term_coverage": totals.num_terms_found / totals.num_terms,
        "gender_accuracy": totals.num_correct
        / max(totals.num_correct + totals.num_wrong, 1),
    }
    return table


def print_scores(table: Dict[str, Dict[str, float]]) -> None:
    print("Category\tTerm Coverage\tGender Accuracy")
    print("-------------------------------------------------")
    for category in sorted(table):
        if category == "Global":
            print("-------------------------------------------------")
        row = table[category]
        print(f"{category}\t{row['term_coverage']}\t{row['gender_accuracy']}")
        if category == "Global":
            print("-------------------------------------------------")


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, type=str, metavar="FILE",
                        help="Input file to be used to compute accuracies "
                        "(it must be tokenized).")
    parser.add_argument("--tsv-definition", required=True, type=str, metavar="FILE",
                        help="TSV MuST-SHE definitions file.")
    parser.add_argument("--sentence-acc", type=str, default=None, metavar="FILE",
                        help="If set, sentence-level accuracies are written "
                        "to this file.")
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(input_args)

    sentence_scores = sentence_level_scores(args.input, args.tsv_definition)
    if args.sentence_acc is not None:
        write_sentence_acc(args.sentence_acc, sentence_scores)
    table = global_scores(sentence_scores, args.tsv_definition, args.debug)
    print_scores(table)
    return table


if __name__ == "__main__":
    cli_main()
