"""PyTorch port, the ``--tokenizer`` / ``--bpe`` codecs
(``fbk_fairseq_st_tpu_torch/data/encoders.py``) against JAX's
(``fbk_fairseq_st_tpu/data/encoders.py``).

Every codec whose library is installed here encodes and decodes the same
strings to the same strings as JAX's (exact): ``space``, ``moses``
(``sacremoses``), ``bytes``, ``characters``, ``gpt2`` and ``bert``
(``transformers``) and ``hf_byte_bpe`` (``tokenizers``), the last three
from tiny vocabulary files written in ``tmp_path``, and the byte-level
helpers of ``byte_bpe``. ``nltk`` is installed without its ``punkt_tab``
data: both packages raise the same ``LookupError``. The codecs whose
library is absent (``sentencepiece``, ``byte_bpe``, ``subword_nmt``,
``fastbpe``) raise ``ImportError`` naming it; the GPT-2 and BERT codecs
without local files raise instead of downloading. Then ``cli/interactive``
with ``--tokenizer space --bpe characters`` on a character-level model
equals JAX's."""

import argparse
import io
import json
import os
import sys

import numpy as np
import pytest

from fbk_fairseq_st_tpu.data import encoders as jenc
from fbk_fairseq_st_tpu_torch import registry as tregistry
from fbk_fairseq_st_tpu_torch.data import encoders as tenc

TEXTS = ["Hello,  world!  It's a \"test\" -- of the well-known codecs.", "  Grüße aus Trient: 3.5 km & <b>ok</b>  ",
         "naïve café — 日本語 テキスト", ""]


def _ns(**kw):
    return argparse.Namespace(**kw)


def _both(kind, name, **kw):
    build = {"tokenizer": ("build_tokenizer", "tokenizer"), "bpe": ("build_bpe", "bpe")}[kind]
    args = _ns(**{build[1]: name}, **kw)
    return getattr(jenc, build[0])(args), getattr(tenc, build[0])(args)


def _check_same(j, t, texts=TEXTS):
    for text in texts:
        enc = j.encode(text)
        assert t.encode(text) == enc, text
        assert t.decode(enc) == j.decode(enc), text


def test_registries_hold_jax_names():
    from fbk_fairseq_st_tpu import registry as jregistry

    assert sorted(tenc.TOKENIZERS) == sorted(jregistry.TOKENIZERS.keys()) == ["moses", "nltk", "space"]
    assert sorted(tenc.BPES) == sorted(jregistry.BPES.keys())
    assert len(tenc.TOKENIZERS) + len(tenc.BPES) == 12
    assert "characters" in tregistry.BPES and "moses" in tregistry.TOKENIZERS
    assert tenc.build_tokenizer(_ns(tokenizer=None)) is None and tenc.build_bpe(_ns()) is None


@pytest.mark.parametrize("kind,name,kw", [
    ("tokenizer", "space", {}),
    ("tokenizer", "moses", {"source_lang": "en", "target_lang": "de"}),
    ("tokenizer", "moses", {"moses_source_lang": "de", "moses_no_dash_splits": True, "moses_no_escape": True}),
    ("bpe", "bytes", {}),
    ("bpe", "characters", {}),
], ids=["space", "moses", "moses-flags", "bytes", "characters"])
def test_codec_matches_jax(kind, name, kw):
    _check_same(*_both(kind, name, **kw))


def test_nltk_raises_as_jax_without_its_data():
    j, t = _both("tokenizer", "nltk")
    with pytest.raises(LookupError) as jerr:
        j.encode(TEXTS[0])
    with pytest.raises(LookupError) as terr:
        t.encode(TEXTS[0])
    assert type(jerr.value) is type(terr.value)
    assert t.decode("a b") == j.decode("a b") == "a b"


def _gpt2_files(tmp_path):
    """A byte-level BPE vocabulary of GPT-2's format: every byte char, a
    few merges."""
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    chars = sorted(set(bytes_to_unicode().values()))
    merges = ["Ġ t", "h e", "Ġt he", "e l", "el l", "l o", "Ġ w", "o r"]
    vocab = {c: i for i, c in enumerate(chars)}
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    enc, bpe = tmp_path / "encoder.json", tmp_path / "vocab.bpe"
    enc.write_text(json.dumps(vocab), encoding="utf-8")
    bpe.write_text("#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")
    return str(enc), str(bpe)


def test_gpt2_from_local_files_matches_jax(tmp_path):
    enc, bpe = _gpt2_files(tmp_path)
    _check_same(*_both("bpe", "gpt2", gpt2_encoder_json=enc, gpt2_vocab_bpe=bpe), TEXTS[:3])


def test_gpt2_ids_of_the_chip_check(tmp_path):
    """``chip_smoke.py``'s phase 31 holds ``--bpe gpt2`` on the card to
    ``GPT2_IDS``: the ids that the port's codec and JAX's give here for
    ``GPT2_TEXT`` from the files of its ``write_gpt2_files`` (the same
    vocabulary as ``_gpt2_files``'), not empty."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    (tmp_path / "chip").mkdir()
    (tmp_path / "cpu").mkdir()
    enc, bpe = chip_smoke.write_gpt2_files(str(tmp_path / "chip"))
    with open(enc, encoding="utf-8") as f:
        assert json.load(f) == json.loads(Path(_gpt2_files(tmp_path / "cpu")[0]).read_text(encoding="utf-8"))
    j, t = _both("bpe", "gpt2", gpt2_encoder_json=enc, gpt2_vocab_bpe=bpe)
    assert t.encode(chip_smoke.GPT2_TEXT) == j.encode(chip_smoke.GPT2_TEXT) == chip_smoke.GPT2_IDS != ""
    assert t.decode(chip_smoke.GPT2_IDS) == chip_smoke.GPT2_TEXT


def test_hf_byte_bpe_from_local_files_matches_jax(tmp_path):
    enc, bpe = _gpt2_files(tmp_path)
    for prefix in (False, True):
        _check_same(*_both("bpe", "hf_byte_bpe", bpe_vocab=enc, bpe_merges=bpe, bpe_add_prefix_space=prefix),
                    TEXTS[:3])


def test_bert_from_a_local_vocab_matches_jax(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "it", "'", "s", "a", "test", ",", "!",
             "the", "well", "-", "known", "code", "##cs", "of", "\"", "."]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(words) + "\n", encoding="utf-8")
    for cased in (False, True):
        _check_same(*_both("bpe", "bert", bpe_vocab_file=str(vocab), bpe_cased=cased), TEXTS[:1])


def test_byte_level_helpers_match_jax():
    for text in TEXTS:
        enc = tenc.byte_encode(text)
        assert enc == jenc.byte_encode(text)
        assert tenc.byte_decode(enc) == jenc.byte_decode(enc)
        broken = enc[:-1] if enc else enc
        assert tenc.smart_byte_decode(broken) == jenc.smart_byte_decode(broken)
        pieces = " ".join(enc.replace(" ", "▁"))
        assert tenc.ByteBPE.decode(pieces) == jenc.ByteBPE.decode(pieces)


@pytest.mark.parametrize("name,kw,package", [
    ("sentencepiece", {"sentencepiece_vocab": "m.model"}, "sentencepiece"),
    ("byte_bpe", {"sentencepiece_model_path": "m.model"}, "sentencepiece"),
    ("subword_nmt", {"bpe_codes": "codes"}, "subword_nmt"),
    ("fastbpe", {"bpe_codes": "codes"}, "fastBPE"),
])
def test_absent_libraries_raise_by_name(name, kw, package):
    with pytest.raises(ImportError, match=package):
        tenc.build_bpe(_ns(bpe=name, **kw))


def test_missing_packages_raise_by_name(monkeypatch):
    for module, (kind, name) in {"sacremoses": ("tokenizer", "moses"), "transformers": ("bpe", "bert"),
                                 "tokenizers": ("bpe", "hf_byte_bpe")}.items():
        monkeypatch.setitem(sys.modules, module, None)
        args = _ns(**{kind: name}, bpe_vocab_file="v.txt", bpe_vocab="v.json", bpe_merges="m.txt")
        with pytest.raises(ImportError, match=module):
            (tenc.build_tokenizer if kind == "tokenizer" else tenc.build_bpe)(args)


def test_gpt2_and_bert_never_download():
    with pytest.raises(ValueError, match="nothing is downloaded"):
        tenc.build_bpe(_ns(bpe="gpt2"))
    with pytest.raises(ValueError, match="nothing is downloaded"):
        tenc.build_bpe(_ns(bpe="bert"))


def test_codec_chain_order():
    encode, decode = tenc.codec_chain(_ns(tokenizer="space", bpe="characters"))
    assert encode("  ab  c ") == "a b _ c"
    assert decode("a b _ c") == "ab c"


def test_interactive_with_codecs_matches_jax(tmp_path, capsys):
    """``cli/interactive --tokenizer space --bpe characters`` on a tiny
    character-level dynamicconv (seeded JAX weights, saved with
    ``save_state``): the port's S-/H-/D- records equal JAX's, the D- line
    the hypothesis back through both codecs."""
    import jax

    from fbk_fairseq_st_tpu import registry as jregistry
    from fbk_fairseq_st_tpu.cli import interactive as jinteractive
    from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
    from fbk_fairseq_st_tpu.train.checkpoint import save_state
    from fbk_fairseq_st_tpu_torch.cli import interactive as tinteractive

    from .test_torch_interactive import ARCH
    from .utils import DummyTask

    rng = np.random.RandomState(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    letters = "abcdefgh"
    lines = {lang: [" ".join("".join(rng.choice(list(letters), rng.randint(1, 4))) for _ in range(rng.randint(1, 4)))
                    for _ in range(6)] for lang in ("en", "de")}
    for lang, text in lines.items():
        (raw / f"train.{lang}").write_text("\n".join(" ".join(l.replace(" ", "_")) for l in text) + "\n")
    data_dir = str(tmp_path / "data")
    jpreprocess.cli_main(["--source-lang", "en", "--target-lang", "de", "--trainpref", str(raw / "train"),
                          "--destdir", data_dir, "--dataset-impl", "mmap"])
    from fbk_fairseq_st_tpu import options as joptions
    from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary

    args = joptions.parse_args_and_arch(joptions.get_training_parser(), [
        data_dir, "--task", "translation", "-s", "en", "-t", "de", *ARCH, "--max-tokens", "100"])
    src = JaxDictionary.load(os.path.join(data_dir, "dict.en.txt"))
    tgt = JaxDictionary.load(os.path.join(data_dir, "dict.de.txt"))
    model = jregistry.build_model(args, DummyTask(tgt, src))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1)))
    ckpt = str(tmp_path / "ckpt.pt")
    save_state(ckpt, {"args": vars(args), "model": variables["params"], "model_state": variables["state"]})
    inputs = tmp_path / "input.txt"
    inputs.write_text("\n".join(lines["en"]) + "\n")
    argv = [data_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", ckpt, "--beam", "2",
            "--max-len-b", "6", "--buffer-size", "3", "--input", str(inputs), "--cpu", "--tokenizer", "space",
            "--bpe", "characters"]

    def records(out):
        return [l.split("\t") for l in out.splitlines() if l[:2] in ("S-", "H-", "D-")]

    capture = io.StringIO()
    stdout, sys.stdout = sys.stdout, capture
    try:
        jinteractive.cli_main(argv)
    finally:
        sys.stdout = stdout
    want = records(capture.getvalue())
    capsys.readouterr()
    tinteractive.cli_main(argv)
    got = records(capsys.readouterr().out)
    assert len(got) == len(want) == 3 * len(lines["en"])
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[-1] == w[-1], (g, w)
        if g[0][0] in "HD":
            assert abs(float(g[1]) - float(w[1])) <= 1e-5
    d_lines = [g[-1] for g in got if g[0].startswith("D-")]
    h_lines = [g[-1] for g in got if g[0].startswith("H-")]
    assert d_lines == [tenc.Characters().decode(h) for h in h_lines]


@pytest.mark.parametrize("command", ["spm_train", "spm_encode", "spm_decode"])
def test_spm_tools_raise_by_name_without_sentencepiece(command, monkeypatch):
    """``scripts/spm_tools.py`` (JAX's copy) needs ``sentencepiece``,
    installed nowhere here: each command raises naming it, as JAX's does."""
    from fbk_fairseq_st_tpu.scripts import spm_tools as jspm
    from fbk_fairseq_st_tpu_torch.scripts import spm_tools as tspm

    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    argv = [] if command == "spm_train" else ["--model", "m.model"]
    with pytest.raises(ImportError, match="sentencepiece"):
        getattr(tspm, command)(argv)
    with pytest.raises(ImportError, match="sentencepiece"):
        getattr(jspm, command)(argv)
