"""CTC decoders: prefix beam search with optional lexicon + language model.

Counterpart of ``fbk_fairseq_st_tpu/generation/ctc_decoder.py``, the same
numpy code on the host: the decoders read the emissions as a numpy array,
whichever device computed them. Native replacement for the reference's
wav2letter decoder wrappers (examples/speech_recognition/w2l_decoder.py:84
W2lViterbiDecoder, :112 W2lKenLMDecoder — there the search kernel itself
is the external wav2letter C++ library; here it is implemented in-repo).
The emission computation (encoder forward + log-softmax) runs on the card;
the per-utterance search runs on the host over the (T, V) emission matrix,
like the reference's CPU decoder.

Algorithm: CTC prefix beam search (Hannun et al. 2014): each beam is a
label prefix carrying two log-probabilities — ending in blank (``p_b``) and
ending in its last label (``p_nb``) — updated per frame, so repeats are
collapsed and all alignments of a prefix are summed, unlike best-path
(greedy/Viterbi) decoding which scores single alignments.

Lexicon constraint: beams additionally carry a position in a token trie
built from a wav2letter-format lexicon ("word<TAB>unit unit ..."); only
extensions along trie edges are allowed, and a word terminates at the
word-boundary unit (or sentencepiece-style "▁"-initial next unit), at which
point the (optional, e.g. KenLM) word LM scores it:
``score += lm_weight * lm(word | history) + word_score``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

LOG0 = -math.inf


def _logaddexp(a: float, b: float) -> float:
    if a == LOG0:
        return b
    if b == LOG0:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


# ---------------------------------------------------------------------------
# lexicon trie
# ---------------------------------------------------------------------------


class TrieNode:
    __slots__ = ("children", "words")

    def __init__(self):
        self.children: Dict[int, "TrieNode"] = {}
        self.words: List[str] = []  # words completed at this node


class LexiconTrie:
    """Token-id trie over the unit spellings of every lexicon word."""

    def __init__(self):
        self.root = TrieNode()

    def insert(self, unit_ids: Sequence[int], word: str) -> None:
        node = self.root
        for u in unit_ids:
            node = node.children.setdefault(u, TrieNode())
        node.words.append(word)

    @classmethod
    def from_lexicon_file(cls, path: str, dictionary) -> "LexiconTrie":
        """wav2letter lexicon format: ``word<TAB>unit unit unit ...``."""
        trie = cls()
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                word, _, units = line.partition("\t")
                if not units:
                    parts = line.split()
                    word, units = parts[0], " ".join(parts[1:])
                ids = []
                for u in units.split():
                    if u not in dictionary.indices:
                        # Dictionary.index would silently return unk,
                        # collapsing every OOV-unit word onto shared unk
                        # edges; fail loudly like wav2letter does
                        raise ValueError(
                            f"lexicon unit {u!r} (word {word!r}) is not in "
                            "the dictionary"
                        )
                    ids.append(dictionary.index(u))
                trie.insert(ids, word)
        return trie


# ---------------------------------------------------------------------------
# language-model hooks
# ---------------------------------------------------------------------------


class WordLM:
    """Interface the decoder drives; adapt any word-level LM to it."""

    def start(self):
        return None

    def score(self, state, word: str) -> Tuple[object, float]:
        raise NotImplementedError

    def finish(self, state) -> float:
        return 0.0


class KenLMWordLM(WordLM):
    """KenLM hook (optional dependency, as the reference treats kenlm —
    w2l_decoder.py:112)."""

    def __init__(self, model_path: str):
        try:
            import kenlm
        except ImportError as e:
            raise ImportError(
                "kenlm python bindings not installed; pass a custom WordLM "
                "or decode without a language model"
            ) from e
        self.model = kenlm.Model(model_path)
        self._kenlm = kenlm

    def start(self):
        state = self._kenlm.State()
        self.model.BeginSentenceWrite(state)
        return state

    def score(self, state, word: str):
        out = self._kenlm.State()
        # kenlm returns log10; convert to ln like wav2letter
        logp = self.model.BaseScore(state, word, out) * math.log(10)
        return out, logp

    def finish(self, state) -> float:
        out = self._kenlm.State()
        return self.model.BaseScore(state, "</s>", out) * math.log(10)


class CallableWordLM(WordLM):
    """Wrap a plain ``fn(history_tuple, word) -> logprob`` callable."""

    def __init__(self, fn: Callable[[Tuple[str, ...], str], float]):
        self.fn = fn

    def start(self):
        return ()

    def score(self, state, word: str):
        return state + (word,), float(self.fn(state, word))


# ---------------------------------------------------------------------------
# prefix beam search
# ---------------------------------------------------------------------------


@dataclass
class _Beam:
    prefix: Tuple[int, ...] = ()
    p_b: float = 0.0  # log P(prefix, last symbol blank)
    p_nb: float = LOG0  # log P(prefix, last symbol = prefix[-1])
    # lexicon/LM bookkeeping (None when unconstrained)
    node: Optional[TrieNode] = None
    lm_state: object = None
    lm_score: float = 0.0  # accumulated weighted LM + word scores
    words: Tuple[str, ...] = ()

    @property
    def p_total(self) -> float:
        return _logaddexp(self.p_b, self.p_nb)

    def score(self) -> float:
        return self.p_total + self.lm_score


class CTCPrefixBeamDecoder:
    """Prefix beam search over CTC emissions.

    Args:
        blank: blank token id.
        beam_size: beams kept per frame.
        token_top_k: per-frame emission pruning (0 = no pruning).
        trie: optional LexiconTrie constraining label sequences to lexicon
            words. With a trie, ``word_boundary`` (e.g. the "|" unit id) or
            sentencepiece-style "▁"-prefixed units delimit words.
        lm: optional WordLM scored at each word completion.
        lm_weight / word_score / beam_threshold / unk_weight / sil_weight:
            wav2letter decoder-options semantics (reference
            w2l_decoder.py:130-152 DecoderOptions): beam_threshold prunes
            beams scoring below best-in-frame minus threshold; unk_weight
            scores emitting <unk> for an out-of-lexicon word at a boundary
            (-inf forbids, the flashlight default); sil_weight is added on
            every silence (word-boundary) transition.
    """

    def __init__(
        self,
        blank: int,
        beam_size: int = 32,
        token_top_k: int = 0,
        trie: Optional[LexiconTrie] = None,
        lm: Optional[WordLM] = None,
        lm_weight: float = 2.0,
        word_score: float = -1.0,
        word_boundary: Optional[int] = None,
        beam_threshold: float = 25.0,
        unk_weight: float = LOG0,
        sil_weight: float = 0.0,
    ):
        self.blank = blank
        self.beam_size = beam_size
        self.token_top_k = token_top_k
        self.trie = trie
        self.lm = lm
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.word_boundary = word_boundary
        self.beam_threshold = beam_threshold
        self.unk_weight = unk_weight
        self.sil_weight = sil_weight

    # -- word completion ----------------------------------------------------

    def _complete_word(self, beam: _Beam, node: TrieNode) -> Tuple[object, float, Tuple[str, ...]]:
        """Score the word(s) ending at *node*; best-scoring word wins."""
        best = None
        for word in node.words:
            if self.lm is not None:
                state, logp = self.lm.score(beam.lm_state, word)
                cand = (state, self.lm_weight * logp + self.word_score,
                        beam.words + (word,))
            else:
                cand = (None, self.word_score, beam.words + (word,))
            if best is None or cand[1] > best[1]:
                best = cand
        assert best is not None
        return best

    # -- main loop ------------------------------------------------------------

    def decode(
        self, log_probs: np.ndarray, length: Optional[int] = None, n_best: int = 1
    ) -> List[dict]:
        """log_probs: (T, V) log-softmax emissions for ONE utterance.
        Returns n_best hypo dicts {tokens, score, words}."""
        lp = np.asarray(log_probs, np.float32)
        T = int(length) if length is not None else lp.shape[0]
        root = self.trie.root if self.trie is not None else None
        lm_start = self.lm.start() if self.lm is not None else None
        beams: Dict[Tuple, _Beam] = {
            (): _Beam(node=root, lm_state=lm_start)
        }

        for t in range(T):
            frame = lp[t]
            if self.token_top_k > 0:
                cand_tokens = np.argpartition(
                    -frame, min(self.token_top_k, len(frame) - 1)
                )[: self.token_top_k]
            else:
                cand_tokens = range(len(frame))
            next_beams: Dict[Tuple, _Beam] = {}

            for beam in beams.values():
                p_tot = beam.p_total
                # 1. blank extension: prefix unchanged, ends in blank
                self._accumulate(
                    next_beams, beam, beam.prefix, beam.node,
                    p_b=p_tot + float(frame[self.blank]), p_nb=LOG0,
                )
                for c in cand_tokens:
                    c = int(c)
                    if c == self.blank:
                        continue
                    p_c = float(frame[c])
                    last = beam.prefix[-1] if beam.prefix else None
                    if c == last:
                        # repeat absorbed into the same prefix
                        self._accumulate(
                            next_beams, beam, beam.prefix, beam.node,
                            p_b=LOG0, p_nb=beam.p_nb + p_c,
                        )
                        # blank-separated repeat extends the prefix
                        self._extend(
                            next_beams, beam, c, beam.p_b + p_c
                        )
                    else:
                        self._extend(next_beams, beam, c, p_tot + p_c)

            # prune: top beam_size AND within beam_threshold of the best
            # (flashlight's score-window pruning)
            ranked = sorted(
                next_beams.values(), key=_Beam.score, reverse=True
            )
            if ranked and self.beam_threshold != float("inf"):
                floor = ranked[0].score() - self.beam_threshold
                ranked = [b for b in ranked if b.score() >= floor]
            beams = {
                (b.prefix, self._beam_tag(b)): b
                for b in ranked[: self.beam_size]
            }

        out = []
        finals = []
        root = self.trie.root if self.trie is not None else None
        for b in beams.values():
            # a beam ending exactly at a word end without a trailing
            # boundary token still completes (and scores) that word
            if (
                self.trie is not None
                and b.node is not None
                and b.node is not root
                and b.node.words
            ):
                lm_state, delta, words = self._complete_word(b, b.node)
                b = _Beam(
                    prefix=b.prefix, p_b=b.p_b, p_nb=b.p_nb, node=root,
                    lm_state=lm_state, lm_score=b.lm_score + delta,
                    words=words,
                )
            score = b.score()
            if self.lm is not None:
                score += self.lm_weight * self.lm.finish(b.lm_state)
            # word-boundary finalization (flashlight LexiconDecoder
            # semantics): a beam stuck mid-trie carries an incomplete word
            complete = self.trie is None or b.node is root
            finals.append((score, complete, b))
        finals.sort(key=lambda x: x[0], reverse=True)
        finished = [f for f in finals if f[1]]
        if finished:
            finals = finished
        for score, _, b in finals[:n_best]:
            out.append(
                {
                    "tokens": np.asarray(b.prefix, np.int64),
                    "score": float(score),
                    "words": list(b.words),
                }
            )
        return out

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _beam_tag(b: _Beam):
        # distinct lexicon/LM continuations of the same prefix stay separate
        return (id(b.node) if b.node is not None else 0, b.words)

    def _accumulate(self, next_beams, src: _Beam, prefix, node, p_b, p_nb):
        key = (prefix, (id(node) if node is not None else 0, src.words))
        b = next_beams.get(key)
        if b is None:
            b = _Beam(
                prefix=prefix, p_b=LOG0, p_nb=LOG0, node=node,
                lm_state=src.lm_state, lm_score=src.lm_score, words=src.words,
            )
            next_beams[key] = b
        b.p_b = _logaddexp(b.p_b, p_b)
        b.p_nb = _logaddexp(b.p_nb, p_nb)

    def _extend(self, next_beams, beam: _Beam, c: int, logp: float):
        """Extend *beam* with label c (prefix grows)."""
        if logp == LOG0:
            return
        new_prefix = beam.prefix + (c,)
        if self.trie is None:
            key = (new_prefix, (0, beam.words))
            b = next_beams.get(key)
            if b is None:
                b = _Beam(
                    prefix=new_prefix, p_b=LOG0, p_nb=LOG0,
                    lm_state=beam.lm_state, lm_score=beam.lm_score,
                    words=beam.words,
                )
                next_beams[key] = b
            b.p_nb = _logaddexp(b.p_nb, logp)
            return

        # lexicon-constrained
        node = beam.node
        lm_state, lm_score, words = beam.lm_state, beam.lm_score, beam.words
        if self.word_boundary is not None and c == self.word_boundary:
            # boundary token: legal when a word just completed, or — with a
            # finite --unk-weight — as an out-of-lexicon <unk> emission
            if node is None or node is self.trie.root:
                return
            if node.words:
                lm_state, delta, words = self._complete_word(beam, node)
                lm_score = lm_score + delta
            elif self.unk_weight > LOG0:
                if self.lm is not None:
                    lm_state, logp = self.lm.score(lm_state, "<unk>")
                    lm_score = lm_score + self.lm_weight * logp
                lm_score = lm_score + self.unk_weight
                words = words + ("<unk>",)
            else:
                return
            lm_score = lm_score + self.sil_weight
            new_node = self.trie.root
        else:
            if node is None:
                return
            new_node = node.children.get(c)
            if new_node is None:
                return
        key = (new_prefix, (id(new_node), words))
        b = next_beams.get(key)
        if b is None:
            b = _Beam(
                prefix=new_prefix, p_b=LOG0, p_nb=LOG0, node=new_node,
                lm_state=lm_state, lm_score=lm_score, words=words,
            )
            next_beams[key] = b
        b.p_nb = _logaddexp(b.p_nb, logp)


def ctc_beam_decode_batch(
    log_probs: np.ndarray,
    lengths: np.ndarray,
    decoder: CTCPrefixBeamDecoder,
    n_best: int = 1,
) -> List[List[dict]]:
    """Decode a (B, T, V) emission batch utterance by utterance."""
    return [
        decoder.decode(log_probs[i], int(lengths[i]), n_best=n_best)
        for i in range(log_probs.shape[0])
    ]


# ---------------------------------------------------------------------------
# ASG beam search (best path over emissions + transitions; no blank)
# ---------------------------------------------------------------------------


@dataclass
class _ASGBeam:
    prefix: Tuple[int, ...] = ()
    score: float = 0.0  # best-path score (max semiring, as wav2letter)
    node: Optional[TrieNode] = None
    lm_state: object = None
    lm_score: float = 0.0
    words: Tuple[str, ...] = ()

    def total(self) -> float:
        return self.score + self.lm_score


class ASGBeamDecoder:
    """Lexicon/LM beam search over ASG emissions (the last piece of the
    reference's W2lKenLMDecoder surface, w2l_decoder.py:112, for
    ASG-trained models).

    ASG has no blank: at every frame a beam either STAYS on its last label
    (``em[t, l] + trans[l, l]``, repeats collapse into one output token) or
    EXTENDS with a new label (``em[t, c] + trans[c, l]``). Scoring is the
    max semiring (best path), matching wav2letter's ASG decoder, unlike
    the CTC prefix decoder's summed marginals. The lexicon trie, word
    boundary and word-LM semantics are shared with CTCPrefixBeamDecoder.
    Replabels are NOT unpacked here — they are dictionary units like any
    other; unpack with data/replabels.py downstream.
    """

    def __init__(
        self,
        transitions: np.ndarray,
        beam_size: int = 32,
        token_top_k: int = 0,
        trie: Optional[LexiconTrie] = None,
        lm: Optional[WordLM] = None,
        lm_weight: float = 2.0,
        word_score: float = -1.0,
        word_boundary: Optional[int] = None,
    ):
        self.transitions = np.asarray(transitions, np.float32)
        self.beam_size = beam_size
        self.token_top_k = token_top_k
        self.trie = trie
        self.lm = lm
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.word_boundary = word_boundary

    def _complete(self, beam: _ASGBeam, node: TrieNode):
        best = None
        for word in node.words:
            if self.lm is not None:
                state, logp = self.lm.score(beam.lm_state, word)
                cand = (state, self.lm_weight * logp + self.word_score,
                        beam.words + (word,))
            else:
                cand = (None, self.word_score, beam.words + (word,))
            if best is None or cand[1] > best[1]:
                best = cand
        return best

    def decode(
        self, emissions: np.ndarray, length: Optional[int] = None,
        n_best: int = 1,
    ) -> List[dict]:
        em = np.asarray(emissions, np.float32)
        T = int(length) if length is not None else em.shape[0]
        V = em.shape[1]
        trans = self.transitions
        root = self.trie.root if self.trie is not None else None
        lm_start = self.lm.start() if self.lm is not None else None

        beams: List[_ASGBeam] = [_ASGBeam(node=root, lm_state=lm_start)]
        for t in range(T):
            frame = em[t]
            if self.token_top_k > 0:
                cand_tokens = np.argpartition(
                    -frame, min(self.token_top_k, V - 1)
                )[: self.token_top_k]
            else:
                cand_tokens = range(V)
            nxt: Dict[Tuple, _ASGBeam] = {}

            def upsert(b: _ASGBeam):
                key = (
                    b.prefix,
                    id(b.node) if b.node is not None else 0,
                    b.words,
                )
                cur = nxt.get(key)
                if cur is None or b.total() > cur.total():
                    nxt[key] = b

            for beam in beams:
                last = beam.prefix[-1] if beam.prefix else None
                if last is not None:
                    # stay on the current label (no new output token)
                    upsert(
                        _ASGBeam(
                            prefix=beam.prefix,
                            score=beam.score + float(frame[last])
                            + float(trans[last, last]),
                            node=beam.node, lm_state=beam.lm_state,
                            lm_score=beam.lm_score, words=beam.words,
                        )
                    )
                for c in cand_tokens:
                    c = int(c)
                    if c == last:
                        continue  # a repeat is the stay move
                    base = beam.score + float(frame[c]) + (
                        float(trans[c, last]) if last is not None else 0.0
                    )
                    if self.trie is None:
                        upsert(
                            _ASGBeam(
                                prefix=beam.prefix + (c,), score=base,
                                lm_state=beam.lm_state,
                                lm_score=beam.lm_score, words=beam.words,
                            )
                        )
                        continue
                    node = beam.node
                    if (
                        self.word_boundary is not None
                        and c == self.word_boundary
                    ):
                        if (
                            node is None or node is self.trie.root
                            or not node.words
                        ):
                            continue
                        lm_state, delta, words = self._complete(beam, node)
                        upsert(
                            _ASGBeam(
                                prefix=beam.prefix + (c,), score=base,
                                node=self.trie.root, lm_state=lm_state,
                                lm_score=beam.lm_score + delta, words=words,
                            )
                        )
                    else:
                        child = node.children.get(c) if node else None
                        if child is None:
                            continue
                        upsert(
                            _ASGBeam(
                                prefix=beam.prefix + (c,), score=base,
                                node=child, lm_state=beam.lm_state,
                                lm_score=beam.lm_score, words=beam.words,
                            )
                        )
            beams = sorted(nxt.values(), key=_ASGBeam.total, reverse=True)[
                : self.beam_size
            ]

        finals = []
        for b in beams:
            if (
                self.trie is not None
                and b.node is not None
                and b.node is not (self.trie.root)
                and b.node.words
            ):
                lm_state, delta, words = self._complete(b, b.node)
                b = _ASGBeam(
                    prefix=b.prefix, score=b.score, node=self.trie.root,
                    lm_state=lm_state, lm_score=b.lm_score + delta,
                    words=words,
                )
            score = b.total()
            if self.lm is not None:
                score += self.lm_weight * self.lm.finish(b.lm_state)
            finals.append((score, b))
        finals.sort(key=lambda x: x[0], reverse=True)
        return [
            {
                "tokens": np.asarray(b.prefix, np.int64),
                "score": float(score),
                "words": list(b.words),
            }
            for score, b in finals[:n_best]
        ]
