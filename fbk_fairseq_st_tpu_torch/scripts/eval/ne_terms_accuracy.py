#!/usr/bin/python3
"""Named-entity / terminology accuracy evaluation (EMNLP 2021).

Algorithm-identical counterpart of reference scripts/eval/
ne_terms_accuracy.py: per-sentence IOB-annotated reference entities are
matched (case-sensitive and case-insensitive, token-level and full-entity)
against the tokenized hypothesis, each at most once; accuracies reported per
entity type. Uses spacy tokenization when available (as the reference does),
else whitespace tokenization.

The port's copy of ``fbk_fairseq_st_tpu/scripts/eval/ne_terms_accuracy.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.eval.ne_terms_accuracy --input HYP --ne-reference REF.iob
"""

from __future__ import annotations

import argparse


def _get_tokenizer(lang: str):
    try:
        import spacy

        nlp = spacy.blank(lang)
        return lambda s: [str(t) for t in nlp(s)]
    except Exception:
        return lambda s: s.strip().split()


def ne_and_terms(fp):
    tokens = []
    full_entities = []
    while True:
        ln = fp.readline().strip()
        if ln == "":
            break
        items = ln.split("\t")
        if items[2] != "O":
            entity_type = items[2].split("-")[1]
            entity_pos = items[2].split("-")[0]
            tokens.append((items[1], entity_type))
            if entity_pos == "B":
                full_entities.append(([items[1]], entity_type))
            elif entity_pos == "I":
                full_entities[-1][0].append(items[1])
            else:
                raise ValueError(
                    'Unrecognized position {} in "{}"'.format(entity_pos, ln)
                )
    return tokens, full_entities


def full_entity_index(full_entity, hypothesis):
    tokens_to_match = len(full_entity)
    for i in range(len(hypothesis) - tokens_to_match + 1):
        if hypothesis[i: i + tokens_to_match] == full_entity:
            return i
    return -1


def scores_by_type(in_f, tsv_reference, tokenizer):
    entity_items_scores = {}
    full_entities_scores = {}
    with open(in_f) as i_f, open(tsv_reference) as r_f:
        for i_line in i_f:
            reference_tokens, reference_entities = ne_and_terms(r_f)
            tokenized = tokenizer(i_line)
            lowercase_tokenized = [tok.lower() for tok in tokenized]
            tokenized_clone = tokenized.copy()
            lowercase_tokenized_clone = lowercase_tokenized.copy()

            for token, entity_type in reference_tokens:
                scores = entity_items_scores.setdefault(
                    entity_type, {"found": 0, "total": 0, "ci_found": 0}
                )
                scores["total"] += 1
                if token in tokenized:
                    tokenized.remove(token)
                    scores["found"] += 1
                if token.lower() in lowercase_tokenized:
                    lowercase_tokenized.remove(token.lower())
                    scores["ci_found"] += 1

            for entity, entity_type in reference_entities:
                scores = full_entities_scores.setdefault(
                    entity_type, {"found": 0, "total": 0, "ci_found": 0}
                )
                scores["total"] += 1
                idx = full_entity_index(entity, tokenized_clone)
                if idx >= 0:
                    del tokenized_clone[idx: idx + len(entity)]
                    scores["found"] += 1
                idx_lower = full_entity_index(
                    [t.lower() for t in entity], lowercase_tokenized_clone
                )
                if idx_lower >= 0:
                    del lowercase_tokenized_clone[idx_lower: idx_lower + len(entity)]
                    scores["ci_found"] += 1
    return entity_items_scores, full_entities_scores


def print_scores(scores, title):
    print(title)
    print("Type\tAccuracy\tCase-insensitive Accuracy\tTotal")
    for t in sorted(scores):
        s = scores[t]
        print(
            "{}\t{:.4f}\t{:.4f}\t{}".format(
                t,
                s["found"] / max(s["total"], 1),
                s["ci_found"] / max(s["total"], 1),
                s["total"],
            )
        )


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, type=str, metavar="FILE",
                        help="Generated translations to score.")
    parser.add_argument("--ne-reference", required=True, type=str, metavar="FILE",
                        help="IOB-annotated reference (NEuRoparl-ST format: "
                        "blank-line separated sentences, idx\\ttoken\\tIOB-tag).")
    parser.add_argument("--lang", default="en", type=str)
    args = parser.parse_args(input_args)

    tokenizer = _get_tokenizer(args.lang)
    item_scores, entity_scores = scores_by_type(
        args.input, args.ne_reference, tokenizer
    )
    print_scores(item_scores, "== Token-level scores ==")
    print_scores(entity_scores, "== Full-entity scores ==")
    return item_scores, entity_scores


if __name__ == "__main__":
    cli_main()
