#!/usr/bin/python3
"""Aggregate agreement fulltable statistics into metric rows (ACL 2022).

Counterpart of reference scripts/eval/agreement_from_fulltable.py: per
configured metric, counts agreement_correct/wrong, coverage and their
percentages over covered agreement groups.

The port's copy of ``fbk_fairseq_st_tpu/scripts/eval/agreement_from_fulltable.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.eval.agreement_from_fulltable --fulltable T.tsv --config C.json --output OUT.tsv
"""

from __future__ import annotations

import argparse
import csv
import json
from collections import defaultdict

from .accuracy_from_fulltable import check_filters, read_configs

_BOOLS = {"True": 1, "False": 0, "1": 1, "0": 0}


def agr_scores(in_f, metrics):
    results = {}
    with open(in_f) as i_f:
        for term in csv.DictReader(i_f, delimiter="\t"):
            systems = [
                h[: -len("_no_agreement")]
                for h in term.keys()
                if h.endswith("_no_agreement")
            ]
            for m_i, m in enumerate(metrics):
                if "filters" in m and not check_filters(term, m["filters"]):
                    continue
                key = "-".join(term[d] for d in m["dimensions"])
                if key not in results:
                    results[key] = defaultdict(lambda: 0)
                    results[key]["order"] = m_i
                results[key]["num_agrs"] += 1
                for h in (
                    "agreement_correct", "agreement_wrong",
                    "out_of_coverage", "no_agreement",
                ):
                    for s in systems:
                        results[key][f"{s}_{h}"] += _BOOLS[term[f"{s}_{h}"]]
    return results


def write_metric_rows(out_f, all_stats):
    headers = ["metric", "num_agrs"]
    metrics = sorted(all_stats.keys(), key=lambda x: (all_stats[x]["order"], x))
    systems = [
        h[: -len("_no_agreement")]
        for h in all_stats[metrics[0]].keys()
        if h.endswith("_no_agreement")
    ]
    for s in systems:
        for col in (
            "agreement_correct", "agreement_wrong", "out_of_coverage",
            "no_agreement", "in_coverage",
        ):
            headers.append(f"{s}_{col}")
            headers.append(f"{s}_{col}_percent")
    rows = []
    for m in metrics:
        r = dict(all_stats[m])
        r["metric"] = m
        del r["order"]
        for s in systems:
            n = r["num_agrs"]
            r[f"{s}_out_of_coverage_percent"] = float(r[f"{s}_out_of_coverage"]) / n
            r[f"{s}_in_coverage"] = float(n - r[f"{s}_out_of_coverage"])
            r[f"{s}_in_coverage_percent"] = r[f"{s}_in_coverage"] / n
            covered = n - r[f"{s}_out_of_coverage"]
            for col in ("agreement_correct", "agreement_wrong", "no_agreement"):
                r[f"{s}_{col}_percent"] = (
                    float(r[f"{s}_{col}"]) / covered if covered > 0 else 0.0
                )
        rows.append(r)
    with open(out_f, "w") as f_w:
        writer = csv.DictWriter(f_w, headers, delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fulltable", required=True, type=str, metavar="FILE")
    parser.add_argument("--config", required=True, type=str, metavar="FILE")
    parser.add_argument("--output", required=True, type=str, metavar="FILE")
    args = parser.parse_args(input_args)

    metrics = read_configs(args.config)
    write_metric_rows(args.output, agr_scores(args.fulltable, metrics))


if __name__ == "__main__":
    cli_main()
