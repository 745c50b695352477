#!/usr/bin/python3
"""Aggregate MuST-SHE fulltable statistics into metric rows (ACL 2022).

Counterpart of reference scripts/eval/accuracy_from_fulltable.py: a JSON
config defines metrics as (dimensions, optional filters); per metric key,
term counts and per-system found/correct/wrong sums produce term_coverage
and gender_accuracy columns.

The port's copy of ``fbk_fairseq_st_tpu/scripts/eval/accuracy_from_fulltable.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.eval.accuracy_from_fulltable --fulltable T.tsv --config C.json --output OUT.tsv
"""

from __future__ import annotations

import argparse
import csv
import json
from collections import defaultdict


def read_configs(config_file):
    with open(config_file) as f:
        return json.load(f)["metrics"]


def check_filters(term, filters) -> bool:
    return all(
        f["max_val"] >= term[f["dimension"]] >= f["min_val"] for f in filters
    )


def accuracy_scores(in_f, metrics):
    results = {}
    with open(in_f) as i_f:
        for term in csv.DictReader(i_f, delimiter="\t"):
            systems = [h[:-6] for h in term.keys() if h.endswith("_found")]
            for m_i, m in enumerate(metrics):
                if "filters" in m and not check_filters(term, m["filters"]):
                    continue
                key = "-".join(term[d] for d in m["dimensions"])
                if key not in results:
                    results[key] = defaultdict(lambda: 0)
                    results[key]["order"] = m_i
                results[key]["num_terms"] += 1
                for h in ("found", "found_correct", "found_wrong"):
                    for s in systems:
                        results[key][f"{s}_{h}"] += int(term[f"{s}_{h}"])
    return results


def write_metric_rows(out_f, all_stats):
    headers = ["metric", "num_terms"]
    metrics = sorted(all_stats.keys(), key=lambda x: (all_stats[x]["order"], x))
    systems = [
        h[:-6] for h in all_stats[metrics[0]].keys() if h.endswith("_found")
    ]
    for s in systems:
        for col in (
            "found", "found_correct", "found_wrong",
            "term_coverage", "gender_accuracy",
        ):
            headers.append(f"{s}_{col}")
    rows = []
    for m in metrics:
        r = dict(all_stats[m])
        r["metric"] = m
        del r["order"]
        for s in systems:
            r[f"{s}_term_coverage"] = float(r[f"{s}_found"]) / r["num_terms"]
            denom = r[f"{s}_found_correct"] + r[f"{s}_found_wrong"]
            r[f"{s}_gender_accuracy"] = (
                float(r[f"{s}_found_correct"]) / denom if denom > 0 else 0.0
            )
        rows.append(r)
    with open(out_f, "w") as f_w:
        writer = csv.DictWriter(f_w, headers, delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fulltable", required=True, type=str, metavar="FILE")
    parser.add_argument("--config", required=True, type=str, metavar="FILE",
                        help="JSON file with metric definitions.")
    parser.add_argument("--output", required=True, type=str, metavar="FILE")
    args = parser.parse_args(input_args)

    metrics = read_configs(args.config)
    write_metric_rows(args.output, accuracy_scores(args.fulltable, metrics))


if __name__ == "__main__":
    cli_main()
