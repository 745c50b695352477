"""The ``--tokenizer`` and ``--bpe`` codecs: string -> string on the way
in (``encode``) and out (``decode``); ids stay ``Dictionary.encode_line``'s.

The port's copy of ``fbk_fairseq_st_tpu/data/encoders.py`` (reference
fairseq/data/encoders/*): ``build_tokenizer`` / ``build_bpe`` and the 12
registered codecs, under the same names and flags. A codec's library is
imported when the codec is built, never at import, and a missing one
raises ``ImportError`` naming it: ``sacremoses`` (moses), ``nltk``,
``sentencepiece`` (sentencepiece, byte_bpe), ``subword_nmt``,
``transformers`` (gpt2, bert), ``fastBPE`` and ``tokenizers``
(hf_byte_bpe). Nothing is downloaded: the GPT-2 and BERT codecs take
local vocabulary files only, and raise where JAX would fall back to
``from_pretrained``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

TOKENIZERS: Dict[str, Any] = {}
BPES: Dict[str, Any] = {}


def _register(table: Dict[str, Any], name: str):
    def wrap(cls):
        table[name] = cls
        return cls

    return wrap


def build_tokenizer(args):
    name = getattr(args, "tokenizer", None)
    if name is None:
        return None
    return _lookup(TOKENIZERS, "tokenizer", name).build_tokenizer(args)


def build_bpe(args):
    name = getattr(args, "bpe", None)
    if name is None:
        return None
    return _lookup(BPES, "bpe", name).build_bpe(args)


def _lookup(table, kind: str, name: str):
    if name not in table:
        raise KeyError(f"Unknown {kind}: {name!r}. Available: {sorted(table)}")
    return table[name]


def require_package(module: str, what: str):
    """``import module``, or ``ImportError`` naming it for ``what``: how
    the port imports an optional library where a feature asks for it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {module!r} package, which is not installed: {e}") from e


class _Codec:
    @classmethod
    def build_tokenizer(cls, args):
        return cls(args)

    @classmethod
    def build_bpe(cls, args):
        return cls(args)


@_register(TOKENIZERS, "space")
class SpaceTokenizer(_Codec):
    """reference encoders/space_tokenizer.py."""

    def __init__(self, args=None):
        self.space_tok = re.compile(r"\s+")

    def encode(self, x: str) -> str:
        return self.space_tok.sub(" ", x).strip()

    def decode(self, x: str) -> str:
        return x


@_register(TOKENIZERS, "moses")
class MosesTokenizer(_Codec):
    """reference encoders/moses_tokenizer.py, through ``sacremoses``."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--moses-source-lang", metavar="SRC", help="source language")
        parser.add_argument("--moses-target-lang", metavar="TARGET", help="target language")
        parser.add_argument("--moses-no-dash-splits", action="store_true", default=False,
                            help="don't apply dash split rules")
        parser.add_argument("--moses-no-escape", action="store_true", default=False,
                            help="don't perform HTML escaping on apostrophy, quotes, etc.")

    def __init__(self, args):
        sacremoses = require_package("sacremoses", "--tokenizer moses")
        # --moses-{source,target}-lang win over the task's languages
        src = getattr(args, "moses_source_lang", None) or getattr(args, "source_lang", "en") or "en"
        tgt = getattr(args, "moses_target_lang", None) or getattr(args, "target_lang", "en") or "en"
        self.dash_splits = not getattr(args, "moses_no_dash_splits", False)
        self.escape = not getattr(args, "moses_no_escape", False)
        self.tok = sacremoses.MosesTokenizer(lang=src)
        self.detok = sacremoses.MosesDetokenizer(lang=tgt)

    def encode(self, x: str) -> str:
        return self.tok.tokenize(x, aggressive_dash_splits=self.dash_splits, return_str=True, escape=self.escape)

    def decode(self, x: str) -> str:
        return self.detok.detokenize(x.split())


@_register(TOKENIZERS, "nltk")
class NLTKTokenizer(_Codec):
    def __init__(self, args):
        self.word_tokenize = require_package("nltk.tokenize", "--tokenizer nltk").word_tokenize

    def encode(self, x: str) -> str:
        return " ".join(self.word_tokenize(x))

    def decode(self, x: str) -> str:
        return x


@_register(BPES, "bytes")
class Bytes(_Codec):
    """reference encoders/bytes.py: UTF-8 bytes as decimal tokens."""

    def __init__(self, args=None):
        pass

    def encode(self, x: str) -> str:
        return " ".join(map(str, x.encode("utf-8")))

    def decode(self, x: str) -> str:
        return bytes(int(b) for b in x.split()).decode("utf-8", errors="replace")


@_register(BPES, "characters")
class Characters(_Codec):
    """reference encoders/characters.py."""

    WORD_SEP = "_"

    def __init__(self, args=None):
        pass

    def encode(self, x: str) -> str:
        return " ".join(list(x.replace(" ", self.WORD_SEP)))

    def decode(self, x: str) -> str:
        return x.replace(" ", "").replace(self.WORD_SEP, " ")


@_register(BPES, "sentencepiece")
class SentencepieceBPE(_Codec):
    """reference encoders/sentencepiece_bpe.py."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--sentencepiece-vocab", type=str, help="path to sentencepiece vocab")

    def __init__(self, args):
        spm = require_package("sentencepiece", "--bpe sentencepiece")
        model = getattr(args, "sentencepiece_vocab", None) or getattr(args, "sentencepiece_model", None)
        self.sp = spm.SentencePieceProcessor()
        self.sp.Load(model)

    def encode(self, x: str) -> str:
        return " ".join(self.sp.EncodeAsPieces(x))

    def decode(self, x: str) -> str:
        return x.replace(" ", "").replace("▁", " ").strip()


@_register(BPES, "subword_nmt")
class SubwordNMTBPE(_Codec):
    @staticmethod
    def add_args(parser):
        parser.add_argument("--bpe-codes", type=str, help="path to subword NMT BPE")
        parser.add_argument("--bpe-separator", default="@@", help="BPE separator")

    def __init__(self, args):
        apply_bpe = require_package("subword_nmt.apply_bpe", "--bpe subword_nmt")
        separator = getattr(args, "bpe_separator", "@@")
        with open(args.bpe_codes, encoding="utf-8") as codes:
            self.bpe = apply_bpe.BPE(codes, separator)
        self.sep = separator + " "

    def encode(self, x: str) -> str:
        return self.bpe.process_line(x)

    def decode(self, x: str) -> str:
        return (x + " ").replace(self.sep, "").rstrip()


@_register(BPES, "gpt2")
class GPT2BPE(_Codec):
    """GPT-2 byte-level BPE through ``transformers.GPT2Tokenizer`` from a
    local ``encoder.json`` and ``vocab.bpe``. The two paths go by position:
    ``transformers`` 4.x names them ``vocab_file`` / ``merges_file`` and 5.x
    ``vocab`` / ``merges`` (and ignores the 4.x keywords, leaving an empty
    vocabulary); both read the same files to the same ids."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--gpt2-encoder-json", type=str, default=None, help="path to encoder.json")
        parser.add_argument("--gpt2-vocab-bpe", type=str, default=None, help="path to vocab.bpe")

    def __init__(self, args):
        encoder_json = getattr(args, "gpt2_encoder_json", None)
        vocab_bpe = getattr(args, "gpt2_vocab_bpe", None)
        if not (encoder_json and vocab_bpe):
            raise ValueError("--bpe gpt2 needs local --gpt2-encoder-json and --gpt2-vocab-bpe files "
                             "(nothing is downloaded)")
        transformers = require_package("transformers", "--bpe gpt2")
        self.bpe = transformers.GPT2Tokenizer(encoder_json, vocab_bpe)

    def encode(self, x: str) -> str:
        return " ".join(map(str, self.bpe.encode(x)))

    def decode(self, x: str) -> str:
        return self.bpe.decode([int(t) for t in x.split()])


@_register(BPES, "bert")
class BertBPE(_Codec):
    """WordPiece through ``transformers.BertTokenizer`` from a local vocab."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--bpe-cased", action="store_true", default=False, help="set for cased BPE")
        parser.add_argument("--bpe-vocab-file", type=str, help="bpe vocab file.")

    def __init__(self, args):
        vocab_file = getattr(args, "bpe_vocab_file", None)
        if not vocab_file:
            raise ValueError("--bpe bert needs a local --bpe-vocab-file (nothing is downloaded)")
        transformers = require_package("transformers", "--bpe bert")
        self.bpe = transformers.BertTokenizer(vocab_file, do_lower_case=not getattr(args, "bpe_cased", False))

    def encode(self, x: str) -> str:
        return " ".join(self.bpe.tokenize(x))

    def decode(self, x: str) -> str:
        return self.bpe.convert_tokens_to_string(x.split())


@_register(BPES, "fastbpe")
class FastBPE(_Codec):
    @staticmethod
    def add_args(parser):
        # the --bpe-codes spelling of subword_nmt (one --bpe is active a run)
        parser.add_argument("--bpe-codes", type=str, help="path to fastBPE BPE")

    def __init__(self, args):
        self.bpe = require_package("fastBPE", "--bpe fastbpe").fastBPE(args.bpe_codes)
        self.sep = "@@ "

    def encode(self, x: str) -> str:
        return self.bpe.apply([x])[0]

    def decode(self, x: str) -> str:
        return (x + " ").replace(self.sep, "").rstrip()


# byte-level helpers (reference encoders/byte_utils.py)
_WHITESPACE_NORMALIZER = re.compile(r"\s+")
_SPACE = chr(32)
_SPACE_ESCAPE = chr(9601)
_PRINTABLE_LATIN = set(list(range(32, 126 + 1)) + list(range(161, 172 + 1)) + list(range(174, 255 + 1)))
_BYTE_TO_BCHAR = {b: chr(b) if b in _PRINTABLE_LATIN else chr(256 + b) for b in range(256)}
_BCHAR_TO_BYTE = {bc: b for b, bc in _BYTE_TO_BCHAR.items()}


def byte_encode(x: str) -> str:
    normalized = _WHITESPACE_NORMALIZER.sub(_SPACE, x)
    return "".join(_BYTE_TO_BCHAR[b] for b in normalized.encode("utf-8"))


def byte_decode(x: str) -> str:
    try:
        return bytes(_BCHAR_TO_BYTE[bc] for bc in x).decode("utf-8")
    except (ValueError, KeyError):
        return ""


def smart_byte_decode(x: str) -> str:
    """The most valid characters of a broken byte-char string, by the
    dynamic program of reference byte_utils.py:34-51."""
    output = byte_decode(x)
    if output == "":
        n = len(x)
        f = [0] * (n + 1)
        pt = [0] * (n + 1)
        for i in range(1, n + 1):
            f[i], pt[i] = f[i - 1], i - 1
            for j in range(1, min(4, i) + 1):
                if f[i - j] + 1 > f[i] and len(byte_decode(x[i - j:i])) > 0:
                    f[i], pt[i] = f[i - j] + 1, i - j
        cur = n
        while cur > 0:
            if f[cur] == f[pt[cur]] + 1:
                output = byte_decode(x[pt[cur]:cur]) + output
            cur = pt[cur]
    return output


@_register(BPES, "byte_bpe")
class ByteBPE(_Codec):
    """Byte-level BPE: sentencepiece over byte-chars (reference
    encoders/byte_bpe.py)."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--sentencepiece-model-path", type=str, help="path to sentencepiece model")

    def __init__(self, args):
        spm = require_package("sentencepiece", "--bpe byte_bpe")
        self.sp = spm.SentencePieceProcessor()
        self.sp.Load(args.sentencepiece_model_path)

    def encode(self, x: str) -> str:
        return _SPACE.join(self.sp.EncodeAsPieces(byte_encode(x)))

    @staticmethod
    def decode(x: str) -> str:
        return smart_byte_decode(x.replace(_SPACE, "").replace(_SPACE_ESCAPE, _SPACE))


@_register(BPES, "hf_byte_bpe")
class HuggingFaceByteLevelBPE(_Codec):
    """GPT-2-style byte-level BPE from vocab.json + merges.txt (reference
    encoders/hf_byte_bpe.py), through ``tokenizers``."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--bpe-merges", help="path to merges.txt")
        parser.add_argument("--bpe-vocab", help="path to vocab.json")
        parser.add_argument("--bpe-add-prefix-space", action="store_true", default=False,
                            help="add prefix space before encoding")

    def __init__(self, args):
        tokenizers = require_package("tokenizers", "--bpe hf_byte_bpe")
        self.bpe = tokenizers.ByteLevelBPETokenizer(args.bpe_vocab, args.bpe_merges,
                                                    add_prefix_space=getattr(args, "bpe_add_prefix_space", False))

    def encode(self, x: str) -> str:
        return " ".join(map(str, self.bpe.encode(x).ids))

    def decode(self, x: str) -> str:
        return self.bpe.decode([int(tok) if tok not in {"<unk>", "<mask>"} else tok for tok in x.split()])

    def is_beginning_of_word(self, x: str) -> bool:
        return self.decode(x).startswith(" ")


def codec_chain(args):
    """(encode_fn, decode_fn) of the command line's tokenizer and BPE: the
    tokenizer then the BPE on the way in, the reverse on the way out
    (reference fairseq_cli/interactive.py)."""
    tokenizer, bpe = build_tokenizer(args), build_bpe(args)

    def encode_fn(x):
        if tokenizer is not None:
            x = tokenizer.encode(x)
        if bpe is not None:
            x = bpe.encode(x)
        return x

    def decode_fn(x):
        if bpe is not None:
            x = bpe.decode(x)
        if tokenizer is not None:
            x = tokenizer.decode(x)
        return x

    return encode_fn, decode_fn
