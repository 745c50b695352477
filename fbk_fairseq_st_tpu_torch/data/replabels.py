"""Replabel packing for the ASG criterion.

Counterpart of ``fbk_fairseq_st_tpu/data/replabels.py`` (reference
examples/speech_recognition/data/replabels.py): runs of a repeated symbol
are rewritten as the symbol followed by a repetition-count token ("1",
"2", ... up to max_reps), since ASG has no blank to separate repeats."""

from __future__ import annotations

from typing import List


def replabel_symbol(i: int) -> str:
    return str(i)


def pack_replabels(tokens: List[int], dictionary, max_reps: int) -> List[int]:
    if len(tokens) == 0 or max_reps <= 0:
        return list(tokens)
    rep_idx = [0] * (max_reps + 1)
    for i in range(1, max_reps + 1):
        sym = replabel_symbol(i)
        if sym not in dictionary.indices:
            # Dictionary.index would silently return <unk>, corrupting
            # every packed repetition; the task adds these symbols when
            # --criterion asg_loss is set
            raise ValueError(
                f"replabel symbol {sym!r} is not in the dictionary; use "
                "the speech_recognition task with --criterion asg_loss"
            )
        rep_idx[i] = dictionary.index(sym)

    out: List[int] = []
    prev = -1
    reps = 0
    for tok in tokens:
        if tok == prev and reps < max_reps:
            reps += 1
        else:
            if reps > 0:
                out.append(rep_idx[reps])
                reps = 0
            out.append(tok)
            prev = tok
    if reps > 0:
        out.append(rep_idx[reps])
    return out


def unpack_replabels(tokens: List[int], dictionary, max_reps: int) -> List[int]:
    if len(tokens) == 0 or max_reps <= 0:
        return list(tokens)
    idx_to_value = {}
    for i in range(1, max_reps + 1):
        idx_to_value[dictionary.index(replabel_symbol(i))] = i

    out: List[int] = []
    prev = -1
    for tok in tokens:
        reps = idx_to_value.get(tok)
        if reps is not None:
            # reference semantics: emit prev reps times, then reset it (a
            # replabel cannot itself be repeated)
            out.extend([prev] * reps)
            prev = -1
        else:
            out.append(tok)
            prev = tok
    return out
