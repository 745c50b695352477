"""Token <-> id mapping with fairseq-compatible special symbols and files.

The port's own copy of ``fbk_fairseq_st_tpu/data/dictionary.py`` (reference
fairseq/data/dictionary.py):

  * construction order fixes the special ids: bos=0 '<s>', pad=1 '<pad>',
    eos=2 '</s>', unk=3 '<unk>';
  * ``finalize(threshold, nwords, padding_factor=8)`` sorts by (count desc,
    symbol) and pads the vocab to a multiple of ``padding_factor`` with
    ``madeupword{i}`` fillers;
  * the file format, one "symbol count" line per non-special symbol
    (``load``, ``save``);
  * ``encode_line`` whitespace-tokenizes, maps OOV to unk and appends eos;
  * ``string`` strips pad/eos/bos and undoes BPE.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Callable, List, Optional

import numpy as np


def tokenize_line(line: str) -> List[str]:
    return line.split()


class Dictionary:
    """A mapping from symbols to consecutive integers."""

    def __init__(
        self,
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
        bos: str = "<s>",
        extra_special_symbols=None,
    ):
        self.unk_word, self.pad_word, self.eos_word = unk, pad, eos
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices = {}
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        for s in extra_special_symbols or ():
            self.add_symbol(s)
        self.nspecial = len(self.symbols)

    def __eq__(self, other) -> bool:
        return isinstance(other, Dictionary) and self.indices == other.indices

    def __getitem__(self, idx: int) -> str:
        if idx < len(self.symbols):
            return self.symbols[idx]
        return self.unk_word

    def __len__(self) -> int:
        return len(self.symbols)

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def add_symbol(self, word: str, n: int = 1, overwrite: bool = False) -> int:
        if word in self.indices and not overwrite:
            idx = self.indices[word]
            self.count[idx] = self.count[idx] + n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def unk_string(self, escape: bool = False) -> str:
        return "<{}>".format(self.unk_word) if escape else self.unk_word

    def finalize(self, threshold: int = -1, nwords: int = -1, padding_factor: int = 8):
        """Sort symbols by frequency in descending order, ignoring specials."""
        if nwords <= 0:
            nwords = len(self)
        new_indices = dict(zip(self.symbols[: self.nspecial], range(self.nspecial)))
        new_symbols = self.symbols[: self.nspecial]
        new_count = self.count[: self.nspecial]
        c = Counter(
            dict(sorted(zip(self.symbols[self.nspecial:], self.count[self.nspecial:])))
        )
        for symbol, count in c.most_common(nwords - self.nspecial):
            if count < threshold:
                break
            new_indices[symbol] = len(new_symbols)
            new_symbols.append(symbol)
            new_count.append(count)
        self.count = list(new_count)
        self.symbols = list(new_symbols)
        self.indices = new_indices
        self.pad_to_multiple_(padding_factor)

    def pad_to_multiple_(self, padding_factor: int) -> None:
        if padding_factor > 1:
            i = 0
            while len(self) % padding_factor != 0:
                self.add_symbol("madeupword{:04d}".format(i), n=0)
                i += 1

    @classmethod
    def load(cls, f) -> "Dictionary":
        d = cls()
        d.add_from_file(f)
        return d

    def add_from_file(self, f) -> None:
        if isinstance(f, str):
            with open(f, "r", encoding="utf-8") as fd:
                self.add_from_file(fd)
            return
        for line in f.readlines():
            line = line.rstrip()
            idx = line.rfind(" ")
            if idx == -1:
                raise ValueError("Incorrect dictionary format, expected '<token> <cnt>'")
            word = line[:idx]
            self.indices[word] = len(self.symbols)
            self.symbols.append(word)
            self.count.append(int(line[idx + 1:]))

    def save(self, f) -> None:
        if isinstance(f, str):
            os.makedirs(os.path.dirname(os.path.abspath(f)), exist_ok=True)
            with open(f, "w", encoding="utf-8") as fd:
                self.save(fd)
            return
        for symbol, count in zip(self.symbols[self.nspecial:], self.count[self.nspecial:]):
            print("{} {}".format(symbol, count), file=f)

    def encode_line(self, line: str, line_tokenizer: Callable[[str], List[str]] = tokenize_line,
                    add_if_not_exist: bool = True, consumer=None, append_eos: bool = True,
                    reverse_order: bool = False) -> np.ndarray:
        words = line_tokenizer(line)
        if reverse_order:
            words = list(reversed(words))
        ids = np.empty(len(words) + 1 if append_eos else len(words), dtype=np.int64)
        for i, word in enumerate(words):
            idx = self.add_symbol(word) if add_if_not_exist else self.index(word)
            if consumer is not None:
                consumer(word, idx)
            ids[i] = idx
        if append_eos:
            ids[len(words)] = self.eos_index
        return ids

    def string(
        self,
        tensor,
        bpe_symbol: Optional[str] = None,
        escape_unk: bool = False,
        extra_symbols_to_ignore=None,
        unk_string: Optional[str] = None,
    ) -> str:
        """Convert an id array (1-D, or 2-D for one line per row) to a string,
        stripping pad/eos/bos."""
        tensor = np.asarray(tensor)
        if tensor.ndim == 2:
            return "\n".join(
                self.string(t, bpe_symbol, escape_unk, extra_symbols_to_ignore, unk_string)
                for t in tensor
            )
        ignore = set(extra_symbols_to_ignore or [])
        ignore.update((self.eos_index, self.bos_index, self.pad_index))

        def token_string(i):
            if i == self.unk_index:
                return unk_string if unk_string is not None else self.unk_string(escape_unk)
            return self[i]

        sent = " ".join(token_string(int(i)) for i in tensor if int(i) not in ignore)
        return post_process(sent, bpe_symbol)


def post_process(sentence: str, bpe_symbol: Optional[str]) -> str:
    """BPE de-segmentation (reference fairseq/utils.py post-processing)."""
    if bpe_symbol == "sentencepiece":
        sentence = sentence.replace(" ", "").replace("▁", " ").strip()
    elif bpe_symbol == "_EOW":
        sentence = sentence.replace(" ", "").replace("_EOW", " ").strip()
    elif bpe_symbol is not None:
        sentence = (sentence + " ").replace(bpe_symbol, "").rstrip()
    return sentence


class TruncatedDictionary:
    """A Dictionary's first ``length`` types (``--output-dictionary-size``,
    JAX ``data/dictionary.py:262``): ``len()`` is the truncated size, a
    lookup past it gives unk, and everything else is the wrapped
    dictionary's."""

    def __init__(self, wrapped_dict, length: int):
        self.wrapped_dict = wrapped_dict
        self.length = min(len(wrapped_dict), length)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> str:
        return self.wrapped_dict[idx] if idx < self.length else self.wrapped_dict[self.wrapped_dict.unk()]

    def __getattr__(self, name):
        if name == "wrapped_dict":  # unpickling: no recursion
            raise AttributeError(name)
        return getattr(self.wrapped_dict, name)
