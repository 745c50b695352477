"""PyTorch port, the host-side ASR decoders: the CTC prefix beam search,
the lexicon trie, the word-LM hooks and the ASG beam
(``generation/ctc_decoder.py``), and the native ARPA n-gram LM
(``generation/arpa_lm.py``), against the JAX package's modules on the same
seeded emissions and on a small ``.arpa`` that the test writes.

Both sides are numpy code over the same float32 emissions, so hypotheses,
word sequences and scores must be identical (exact float equality)."""

import gzip
import math
import sys

import numpy as np
import pytest

from fbk_fairseq_st_tpu.generation import arpa_lm as jarpa
from fbk_fairseq_st_tpu.generation import ctc_decoder as jdec
from fbk_fairseq_st_tpu_torch.data import Dictionary
from fbk_fairseq_st_tpu_torch.generation import arpa_lm as tarpa
from fbk_fairseq_st_tpu_torch.generation import ctc_decoder as tdec

UNITS = ("a", "b", "c", "d", "|")
WORDS = {"ab": "a b", "abc": "a b c", "ba": "b a", "cad": "c a d", "d": "d", "dab": "d a b"}
ARPA = """\
\\data\\
ngram 1=9
ngram 2=6
ngram 3=2

\\1-grams:
-1.0\t<s>\t-0.5
-1.2\t</s>
-0.8\tab\t-0.3
-0.9\tabc\t-0.2
-0.7\tba\t-0.25
-1.1\tcad\t-0.1
-0.6\td\t-0.35
-1.3\tdab
-2.0\t<unk>

\\2-grams:
-0.3\t<s> ab\t-0.2
-0.5\tab ba\t-0.1
-0.4\tba d
-0.6\td </s>
-0.45\t<s> d\t-0.15
-0.55\td ab

\\3-grams:
-0.2\t<s> ab ba
-0.25\t<s> d ab

\\end\\
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ctc_decoder")
    arpa, gz, lexicon = root / "lm.arpa", root / "lm.arpa.gz", root / "lexicon.txt"
    arpa.write_text(ARPA)
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write(ARPA)
    lexicon.write_text("".join(f"{w}\t{u}\n" for w, u in WORDS.items()))
    return str(arpa), str(gz), str(lexicon)


def _dictionary():
    d = Dictionary()
    for u in UNITS:
        d.add_symbol(u)
    d.add_symbol("<ctc_blank>")
    return d


def _emissions(seed, t=14, asg=False):
    """(B, T, V) emissions: log-softmaxed for CTC, raw for ASG; the blank
    column favoured every other frame."""
    rng = np.random.RandomState(seed)
    v = len(_dictionary())
    x = 1.5 * rng.randn(3, t, v).astype(np.float32)
    if asg:
        return x
    x[:, ::2, -1] += 2.0
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _same(got, want):
    assert len(got) == len(want)
    for hyps_t, hyps_j in zip(got, want):
        assert len(hyps_t) == len(hyps_j)
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], hj["tokens"])
            assert ht["words"] == hj["words"]
            assert ht["score"] == hj["score"]


def _decoders(mod, arpa_mod, case, files, transitions=None):
    d = _dictionary()
    trie = mod.LexiconTrie.from_lexicon_file(files[2], d) if "lexicon" in case else None
    lm = None
    if case.endswith("arpa"):
        lm = arpa_mod.load_word_lm(files[0])
    elif case.endswith("callable"):
        lm = mod.CallableWordLM(lambda history, word: -0.5 * len(word) - 0.1 * len(history))
    boundary = d.index("|") if trie is not None else None
    if transitions is not None:
        return mod.ASGBeamDecoder(transitions, beam_size=6, trie=trie, lm=lm, lm_weight=1.5, word_score=-0.5,
                                  word_boundary=boundary)
    extra = dict(unk_weight=-4.0, sil_weight=-0.25) if case == "lexicon_unk" else {}
    return mod.CTCPrefixBeamDecoder(blank=d.index("<ctc_blank>"), beam_size=6, token_top_k=4 if case == "topk" else 0,
                                    trie=trie, lm=lm, lm_weight=1.5, word_score=-0.5, word_boundary=boundary,
                                    beam_threshold=12.0, **extra)


@pytest.mark.parametrize("case", ["plain", "topk", "lexicon", "lexicon_unk", "lexicon_arpa", "lexicon_callable"])
def test_prefix_beam_search_matches_jax(files, case):
    """The prefix beam search, unconstrained (all tokens, or the top 4 a
    frame), with the lexicon (boundary "|"; an out-of-lexicon word as
    <unk> at a finite --unk-weight, with --sil-weight), and with the
    lexicon and a word LM (the ARPA file, a callable): the 3-best of three
    utterances of different lengths identical to JAX's."""
    lengths = np.array([14, 11, 6])
    em = _emissions(0)
    got = tdec.ctc_beam_decode_batch(em, lengths, _decoders(tdec, tarpa, case, files), n_best=3)
    want = jdec.ctc_beam_decode_batch(em, lengths, _decoders(jdec, jarpa, case, files), n_best=3)
    _same(got, want)
    if "lexicon" in case:
        assert any(h["words"] for hyps in got for h in hyps)


@pytest.mark.parametrize("case", ["plain", "lexicon", "lexicon_arpa"])
def test_asg_beam_matches_jax(files, case):
    """The ASG beam (best path over emissions + transitions, no blank),
    unconstrained, with the lexicon, and with the lexicon and the ARPA LM:
    identical 3-best to JAX's."""
    rng = np.random.RandomState(5)
    v = len(_dictionary())
    transitions = (0.5 * rng.randn(v, v)).astype(np.float32)
    lengths = np.array([14, 9, 5])
    em = _emissions(1, asg=True)
    got = tdec.ctc_beam_decode_batch(em, lengths, _decoders(tdec, tarpa, case, files, transitions), n_best=3)
    want = jdec.ctc_beam_decode_batch(em, lengths, _decoders(jdec, jarpa, case, files, transitions), n_best=3)
    _same(got, want)


def test_lexicon_trie_matches_jax(files, tmp_path):
    """The trie's edges and words equal JAX's; a unit missing from the
    dictionary raises in both; a space-separated lexicon reads as one
    with tabs."""
    d = _dictionary()

    def walk(node):
        return sorted((u, tuple(child.words), walk(child)) for u, child in node.children.items())

    tt = tdec.LexiconTrie.from_lexicon_file(files[2], d)
    jt = jdec.LexiconTrie.from_lexicon_file(files[2], d)
    assert walk(tt.root) == walk(jt.root)
    spaced = tmp_path / "spaced.txt"
    spaced.write_text("".join(f"{w} {u}\n" for w, u in WORDS.items()))
    assert walk(tdec.LexiconTrie.from_lexicon_file(str(spaced), d).root) == walk(tt.root)
    bad = tmp_path / "bad.txt"
    bad.write_text("zed\tz e d\n")
    for mod in (tdec, jdec):
        with pytest.raises(ValueError, match="not in the dictionary"):
            mod.LexiconTrie.from_lexicon_file(str(bad), d)


def test_arpa_scores_match_jax(files):
    """Katz back-off scores of every word after every history of up to two
    words of the vocabulary (OOV words as <unk>), the next states and the
    sentence scores equal JAX's, from the text and the gzipped file; a
    model without <unk> gives the floor to OOV words in both."""
    vocab = ["ab", "abc", "ba", "cad", "d", "dab", "zzz", "</s>"]
    for path in files[:2]:
        tm, jm = tarpa.ArpaLanguageModel(path), jarpa.ArpaLanguageModel(path)
        assert tm.order == jm.order == 3 and tm.has_unk
        for h1 in ["<s>"] + vocab[:6]:
            for h2 in [None] + vocab[:6]:
                ctx = (h1,) if h2 is None else (h1, h2)
                for w in vocab:
                    assert tm.logprob(ctx, w) == jm.logprob(ctx, w), (ctx, w)
                    assert tm.next_state(ctx, w) == jm.next_state(ctx, w), (ctx, w)
        for sent in (["ab", "ba", "d"], ["d", "ab"], ["zzz", "cad"], []):
            assert tm.score_sentence(sent) == jm.score_sentence(sent)
    want = (-0.3 + -0.2) * math.log(10)  # <s> ab, then the listed trigram <s> ab ba
    assert tarpa.ArpaLanguageModel(files[0]).score_sentence(["ab", "ba"], eos=False) == pytest.approx(want)
    wlm = tarpa.load_word_lm(files[1])
    assert isinstance(wlm, tarpa.ArpaWordLM) and isinstance(wlm, tdec.WordLM)


def test_arpa_without_unk_floor(tmp_path):
    text = ARPA.replace("-2.0\t<unk>\n", "").replace("ngram 1=9", "ngram 1=8")
    path = tmp_path / "nounk.arpa"
    path.write_text(text)
    tm, jm = tarpa.ArpaLanguageModel(str(path)), jarpa.ArpaLanguageModel(str(path))
    assert not tm.has_unk
    assert tm.logprob(("<s>",), "zzz") == jm.logprob(("<s>",), "zzz") == tm.oov_penalty


def test_kenlm_binary_raises_naming_kenlm(tmp_path, monkeypatch):
    """A file that is not ARPA text is taken for a KenLM binary: without
    the ``kenlm`` package the loader raises ImportError naming it (the
    import is lazy, inside the call); a non-ARPA file handed to the ARPA
    parser raises ValueError."""
    binary = tmp_path / "model.bin"
    binary.write_bytes(b"mmap lm http://kheafield.com/code format version 5\x00\x01\x02")
    monkeypatch.setitem(sys.modules, "kenlm", None)
    with pytest.raises(ImportError, match="kenlm"):
        tarpa.load_word_lm(str(binary))
    with pytest.raises(ImportError, match="kenlm"):
        tdec.KenLMWordLM(str(binary))
    text = tmp_path / "not_arpa.txt"
    text.write_text("hello\n")
    with pytest.raises(ValueError, match="not an ARPA file"):
        tarpa.ArpaLanguageModel(str(text))
