"""Host-side conversion of the finalized beam buffers into hypothesis lists.

The port's own copy of ``fbk_fairseq_st_tpu/generation/postprocess.py``:
the hypothesis dict contract of the reference's finalize_hypos
(fairseq/sequence_generator.py:483-545), {tokens, score, positional_scores,
alignment}.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def collect_hypotheses(fin: Dict[str, np.ndarray], bsz: int,
                       beam_size: int) -> List[List[dict]]:
    """fin: the fixed-shape finalized buffers as numpy arrays (fin_tokens
    (B, K, T) incl. the leading eos/bos, fin_cum cumulative scores,
    fin_score normalized score, fin_len, fin_origin, fin_count). Returns,
    per sentence, up to ``beam_size`` hypo dicts sorted by score
    descending."""
    results: List[List[dict]] = []
    for b in range(bsz):
        count = int(fin["fin_count"][b])
        hypos = []
        for k in range(min(count, beam_size)):
            length = int(fin["fin_len"][b, k])
            toks = fin["fin_tokens"][b, k, 1:length]  # drop initial eos
            cum = fin["fin_cum"][b, k, : length - 1]
            pos_scores = np.diff(np.concatenate([[0.0], cum]))
            hypo = {
                "tokens": np.asarray(toks),
                "score": float(fin["fin_score"][b, k]),
                "positional_scores": pos_scores.astype(np.float32),
                "alignment": None,
                "attention": None,
            }
            if "fin_origin" in fin:
                hypo["origin"] = int(fin["fin_origin"][b, k])
            hypos.append(hypo)
        hypos.sort(key=lambda h: -h["score"])
        results.append(hypos)
    return results
