"""Corpus BLEU over token ids, numpy only.

The port's own copy of ``fbk_fairseq_st_tpu/scoring/bleu.py`` (``BleuStat``
:29, ``Scorer`` :83), the semantics of the reference's libbleu
(fairseq/clib/libbleu/libbleu.cpp) and fairseq/bleu.py:

  * references have unk replaced by -999 before counting, so an unknown
    word never matches;
  * both sides are trimmed of leading pad and of trailing eos/pad;
  * clipped n-gram matches for n = 1..4: each predicted n-gram counts at
    most as often as it occurs in the reference;
  * BLEU = brevity * exp(mean log precision) * 100, brevity =
    min(1, e^(1 - r/p));
  * ``reset(one_init=True)`` seeds the counts and matches of orders 2-4
    with 1 (sentence-level smoothing).

Integer counting, so the statistics and the score equal JAX's whichever
of its two cores ran. ``SacrebleuScorer`` (JAX :193, reference
fairseq/bleu.py:36-59) scores strings through ``sacrebleu``, imported when
it is built: without the package it raises ``ImportError`` naming it.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np

from ..data.encoders import require_package


class BleuStat:
    __slots__ = ("reflen", "predlen", "match1", "count1", "match2", "count2", "match3", "count3", "match4",
                 "count4")

    def __init__(self):
        for f in self.__slots__:
            setattr(self, f, 0)


def _trim(sent: np.ndarray, pad: int, eos: int) -> np.ndarray:
    start = 0
    while start < len(sent) and sent[start] == pad:
        start += 1
    sent = sent[start:]
    end = len(sent) - 1
    while end > 0 and (sent[end] == eos or sent[end] == pad):
        end -= 1
    return sent[: end + 1]


def _ngrams(tokens: Sequence[int], n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


class Scorer:
    """fairseq/bleu.py:62-140."""

    def __init__(self, pad: int, eos: int, unk: int):
        self.pad = pad
        self.eos = eos
        self.unk = unk
        self.reset()

    def reset(self, one_init: bool = False) -> None:
        self.stat = BleuStat()
        if one_init:
            for f in ("count2", "count3", "count4", "match2", "match3", "match4"):
                setattr(self.stat, f, 1)

    def add(self, ref, pred) -> None:
        ref = np.asarray(ref).reshape(-1).astype(np.int64)
        pred = np.asarray(pred).reshape(-1).astype(np.int64)
        if (ref < 0).any():
            raise ValueError("reference token ids must be >= 0")
        ref = _trim(np.where(ref == self.unk, -999, ref), self.pad, self.eos)
        pred = _trim(pred, self.pad, self.eos)
        self.stat.reflen += len(ref)
        self.stat.predlen += len(pred)
        rl, pl = [int(x) for x in ref], [int(x) for x in pred]
        for n in range(1, 5):
            if len(pl) < n:
                continue
            setattr(self.stat, f"count{n}", getattr(self.stat, f"count{n}") + len(pl) - n + 1)
            if len(rl) < n:
                continue
            ref_counts = _ngrams(rl, n)
            match = sum(min(c, ref_counts[g]) for g, c in _ngrams(pl, n).items())
            setattr(self.stat, f"match{n}", getattr(self.stat, f"match{n}") + match)

    def precision(self) -> List[float]:
        def ratio(a, b):
            return a / b if b > 0 else 0

        return [ratio(getattr(self.stat, f"match{n}"), getattr(self.stat, f"count{n}")) for n in range(1, 5)]

    def brevity(self) -> float:
        r = self.stat.reflen / self.stat.predlen
        return min(1, math.exp(1 - r))

    def score(self, order: int = 4) -> float:
        psum = sum(math.log(p) if p > 0 else float("-Inf") for p in self.precision()[:order])
        return self.brevity() * math.exp(psum / order) * 100

    def result_string(self, order: int = 4) -> str:
        if order > 4:
            raise ValueError("BLEU scores for order > 4 aren't supported")
        fmt = "BLEU{} = {:2.2f}, {:2.1f}"
        for _ in range(1, order):
            fmt += "/{:2.1f}"
        fmt += " (BP={:.3f}, ratio={:.3f}, syslen={}, reflen={})"
        bleup = [p * 100 for p in self.precision()[:order]]
        return fmt.format(order, self.score(order=order), *bleup, self.brevity(),
                          self.stat.predlen / self.stat.reflen, self.stat.predlen, self.stat.reflen)


class SacrebleuScorer:
    """String-level corpus BLEU through ``sacrebleu.corpus_bleu``; its
    ``result_string`` is sacrebleu's score object, as JAX's."""

    def __init__(self):
        self.sacrebleu = require_package("sacrebleu", "--sacrebleu")
        self.reset()

    def reset(self, one_init: bool = False):
        if one_init:
            raise NotImplementedError
        self.ref = []
        self.sys = []

    def add_string(self, ref: str, pred: str):
        self.ref.append(ref)
        self.sys.append(pred)

    def score(self, order: int = 4) -> float:
        return self.result_string(order).score

    def result_string(self, order: int = 4):
        if order != 4:
            raise NotImplementedError
        return self.sacrebleu.corpus_bleu(self.sys, [self.ref])
