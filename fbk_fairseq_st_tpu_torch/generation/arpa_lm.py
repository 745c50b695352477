"""Native ARPA n-gram language model with Katz back-off scoring.

Counterpart of ``fbk_fairseq_st_tpu/generation/arpa_lm.py`` (the same
host code). Drop-in replacement for the KenLM *word LM* hook that the
lexicon beam decoders accept (generation/ctc_decoder.py): the reference
delegates all LM scoring to the external ``kenlm`` binding (w2l_decoder.py:112 builds
``KenLMDecoder(... kenlm.Model ...)``), which makes its KenLM decode path
unusable without that native library. Here the standard ARPA text format
(Stolcke, SRILM; also what KenLM's ``lmplz`` emits before binarization) is
parsed and scored natively, so ``--w2l-decoder kenlm`` works out of the box
with any ``.arpa``/``.arpa.gz`` model; the optional kenlm binding is only
needed for KenLM *binary* files (see ``load_word_lm``).

Scoring follows the ARPA back-off convention exactly (same quantity KenLM's
``BaseScore`` returns, up to log-base):

    P(w | c_1..c_k) = p(c_1..c_k w)                       if the (k+1)-gram
                                                          is listed
                    = b(c_1..c_k) * P(w | c_2..c_k)       otherwise

with b() = 1 for unlisted back-off contexts. Probabilities and back-off
weights are log10 in the file; they are converted to natural log at load
time, matching the ln-domain the decoders accumulate in (w2l convention).

Out-of-vocabulary words score as ``<unk>`` when the model has one (the
KenLM behaviour); otherwise a fixed floor is returned so lexicon words
missing from a small LM do not -inf an entire beam.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, Optional, Tuple

from .ctc_decoder import WordLM

LN10 = math.log(10.0)

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


class ArpaLanguageModel:
    """Parsed ARPA model: per-order hash tables of (log-prob, back-off).

    Keys are tuples of word strings (the n-gram, oldest word first); values
    are ``(ln_prob, ln_backoff)``. The unigram table doubles as the
    vocabulary.
    """

    def __init__(self, path: str, oov_penalty: float = -1000.0 * LN10):
        # tables[n] maps an n-word tuple -> (ln p, ln backoff)
        self.tables: Tuple[Dict[Tuple[str, ...], Tuple[float, float]], ...] = ()
        self.order = 0
        self.oov_penalty = oov_penalty
        self._parse(path)
        self.has_unk = (UNK,) in self.tables[0] if self.tables else False

    # -- parsing ----------------------------------------------------------

    def _parse(self, path: str) -> None:
        tables = []
        with _open_text(path) as f:
            it = iter(f)
            for line in it:
                if line.strip() == "\\data\\":
                    break
            else:
                raise ValueError(f"{path}: not an ARPA file (no \\data\\ header)")
            counts = []
            for line in it:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("ngram "):
                    # "ngram N=count"
                    counts.append(int(line.split("=", 1)[0].split()[1]))
                    continue
                break  # first "\N-grams:" section marker already consumed
            self.order = max(counts) if counts else 0
            tables = [dict() for _ in range(self.order)]

            # `line` currently holds the first section marker
            while True:
                if line.startswith("\\end\\"):
                    break
                if not (line.startswith("\\") and line.endswith("-grams:")):
                    raise ValueError(f"{path}: unexpected ARPA section {line!r}")
                n = int(line[1:].split("-", 1)[0])
                line = self._parse_section(it, n, tables[n - 1])
        self.tables = tuple(tables)

    @staticmethod
    def _parse_section(it, n: int, table) -> str:
        """Read one \\n-grams: section; return the next section marker."""
        for line in it:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\"):
                return line
            parts = line.split()
            # "logp w1 ... wn [backoff]"
            if len(parts) == n + 2:
                logp, words, backoff = parts[0], parts[1 : n + 1], parts[-1]
            elif len(parts) == n + 1:
                logp, words, backoff = parts[0], parts[1:], "0.0"
            else:
                raise ValueError(f"malformed {n}-gram line: {line!r}")
            table[tuple(words)] = (float(logp) * LN10, float(backoff) * LN10)
        return "\\end\\"

    # -- scoring ----------------------------------------------------------

    def vocab_contains(self, word: str) -> bool:
        return (word,) in self.tables[0]

    def logprob(self, context: Tuple[str, ...], word: str) -> float:
        """ln P(word | context) under Katz back-off (context oldest-first)."""
        if not self.vocab_contains(word):
            if self.has_unk:
                word = UNK
            else:
                return self.oov_penalty
        if len(context) > self.order - 1:
            context = context[len(context) - (self.order - 1) :]
        backoff_sum = 0.0
        while True:
            ngram = context + (word,)
            hit = self.tables[len(ngram) - 1].get(ngram)
            if hit is not None:
                return backoff_sum + hit[0]
            if not context:
                # word is in vocab, so the unigram must exist; only
                # reachable if word == UNK fell through vocab check
                return backoff_sum + self.oov_penalty
            bo = self.tables[len(context) - 1].get(context)
            if bo is not None:
                backoff_sum += bo[1]
            context = context[1:]

    def next_state(self, context: Tuple[str, ...], word: str) -> Tuple[str, ...]:
        """Truncate the new context to the longest usable history.

        Keeping at most order-1 words bounds state size; additionally (as
        KenLM does) the state is shortened to the longest suffix that
        actually appears as a listed n-gram, so states that can never match
        longer n-grams compare equal and beams merge properly.
        """
        ctx = context + (word,)
        if len(ctx) > self.order - 1:
            ctx = ctx[len(ctx) - (self.order - 1) :]
        while ctx and ctx not in self.tables[len(ctx) - 1]:
            ctx = ctx[1:]
        return ctx

    def score_sentence(self, words, bos: bool = True, eos: bool = True) -> float:
        """ln P(sentence) — convenience for tests and rescoring."""
        ctx: Tuple[str, ...] = (BOS,) if bos else ()
        total = 0.0
        for w in words:
            total += self.logprob(ctx, w)
            ctx = self.next_state(ctx, w)
        if eos:
            total += self.logprob(ctx, EOS)
        return total


class ArpaWordLM(WordLM):
    """WordLM adapter driving ArpaLanguageModel in the beam decoders.

    State is the back-off context tuple; scores are ln-domain, the same
    convention KenLMWordLM converts to.
    """

    def __init__(self, model_or_path):
        if isinstance(model_or_path, str):
            self.model = ArpaLanguageModel(model_or_path)
        else:
            self.model = model_or_path

    def start(self):
        return (BOS,)

    def score(self, state, word: str):
        logp = self.model.logprob(state, word)
        return self.model.next_state(state, word), logp

    def finish(self, state) -> float:
        return self.model.logprob(state, EOS)


def _is_arpa_text(path: str) -> bool:
    """Peek for the \\data\\ header (ARPA is text; KenLM binary is not)."""
    try:
        with _open_text(path) as f:
            for _ in range(16):  # header may be preceded by comment lines
                line = f.readline()
                if not line:
                    return False
                if line.strip() == "\\data\\":
                    return True
                if "\x00" in line:
                    return False
        return False
    except (OSError, UnicodeDecodeError):
        return False


def load_word_lm(path: str) -> WordLM:
    """Open an n-gram model for the beam decoders.

    ARPA text (optionally gzipped) loads natively; anything else is assumed
    to be a KenLM binary and needs the optional kenlm binding (the only
    remaining external component on this path, used for its mmap'd binary
    format — the scoring semantics are identical).
    """
    if _is_arpa_text(path):
        return ArpaWordLM(path)
    from .ctc_decoder import KenLMWordLM

    return KenLMWordLM(path)
