"""Character-aware word embeddings (Kim et al. 2015: a char-CNN with
highway layers), ``--character-embeddings`` of ``transformer_lm``.

Counterpart of ``fbk_fairseq_st_tpu/ops/character_embedder.py``
(``build_word_to_char`` :42, ``init_character_embedder`` :61,
``character_embed`` :100), under the fork's names
(fairseq/modules/character_token_embedder.py): ``char_embeddings``
(257 byte ids, 0 the char pad), ``symbol_embeddings`` (eos, unk),
``convolutions.{i}`` (``Conv1d`` of each filter width, max-pooled over
the word, ReLU), ``highway.layers.{i}`` (carry gate bias 1) and
``projection``. The word -> char-id table is built from the dictionary on
the host and kept as a buffer; pad tokens embed to zero, eos and unk to
their symbol rows. The embedder computes in fp32 (its tables are fp32, as
in JAX); the decoder casts its output to the compute type.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .core import Linear, xavier_uniform_

CHAR_PAD_IDX = 0
NUM_CHAR_EMBEDDINGS = 257  # 256 byte values (+1 shift) + pad


class CharEmbedderConfig(NamedTuple):
    filters: Tuple[Tuple[int, int], ...]  # (width, out_channels) per conv
    char_embed_dim: int = 4
    word_embed_dim: int = 512
    highway_layers: int = 2
    max_char_len: int = 50

    @property
    def conv_out_dim(self) -> int:
        return sum(f[1] for f in self.filters)


def build_word_to_char(dictionary, max_char_len: int = 50) -> np.ndarray:
    """(V, max_char_len) char ids: special symbols all pad, other words
    their UTF-8 bytes + 1."""
    table = np.zeros((len(dictionary), max_char_len), np.int32)
    nspecial = getattr(dictionary, "nspecial", 0)
    for i in range(nspecial, len(dictionary)):
        chars = dictionary[i].encode()[:max_char_len]
        table[i, :len(chars)] = np.frombuffer(chars, np.uint8).astype(np.int32) + 1
    return table


class Highway(nn.Module):
    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(Linear(dim, 2 * dim) for _ in range(layers))

    def forward(self, x):
        for layer in self.layers:
            proj_x, gate = layer(x).chunk(2, dim=-1)
            gate = torch.sigmoid(gate)
            x = gate * x + (1.0 - gate) * F.relu(proj_x)
        return x


class CharacterTokenEmbedder(nn.Module):
    def __init__(self, cfg: CharEmbedderConfig, word_to_char: np.ndarray, pad_idx: int, eos_idx: int,
                 unk_idx: int):
        super().__init__()
        self.cfg = cfg
        self.pad_idx, self.eos_idx, self.unk_idx = pad_idx, eos_idx, unk_idx
        self.char_embeddings = nn.Embedding(NUM_CHAR_EMBEDDINGS, cfg.char_embed_dim)
        self.symbol_embeddings = nn.Parameter(torch.zeros(2, cfg.word_embed_dim))
        self.convolutions = nn.ModuleList(nn.Conv1d(cfg.char_embed_dim, out_c, width)
                                          for width, out_c in cfg.filters)
        self.highway = Highway(cfg.conv_out_dim, cfg.highway_layers)
        self.projection = Linear(cfg.conv_out_dim, cfg.word_embed_dim)
        self.register_buffer("word_to_char", torch.as_tensor(np.asarray(word_to_char, np.int64)), persistent=False)

    def init(self, generator: torch.Generator) -> None:
        """JAX's distributions: glorot-normal tables, glorot-uniform convs
        and highway layers (carry-gate bias 1)."""
        c, d = self.cfg.char_embed_dim, self.cfg.word_embed_dim
        with torch.no_grad():
            table = torch.randn(NUM_CHAR_EMBEDDINGS, c, generator=generator) * (2.0 / (NUM_CHAR_EMBEDDINGS + c)) ** 0.5
            table[CHAR_PAD_IDX] = 0.0
            self.char_embeddings.weight.copy_(table)
            self.symbol_embeddings.copy_(torch.randn(2, d, generator=generator) * (2.0 / (2 + d)) ** 0.5)
        for conv, (width, out_c) in zip(self.convolutions, self.cfg.filters):
            xavier_uniform_(conv.weight, generator, width * c, width * out_c)
            nn.init.zeros_(conv.bias)
        for layer in self.highway.layers:
            layer.init(generator)
            with torch.no_grad():
                layer.bias[self.cfg.conv_out_dim:] = 1.0
        self.projection.init(generator)

    def forward(self, tokens):
        """tokens (B, T) word ids -> (B, T, word_embed_dim), fp32."""
        b, t = tokens.shape
        flat = tokens.reshape(-1)
        chars = self.word_to_char[flat]  # (BT, L)
        embs = F.embedding(chars, self.char_embeddings.weight).transpose(1, 2)  # (BT, C, L)
        x = torch.cat([F.relu(conv(embs).amax(dim=-1)) for conv in self.convolutions], dim=-1)
        x = self.projection(self.highway(x))
        sym = self.symbol_embeddings.to(x.dtype)
        x = torch.where((flat == self.pad_idx)[:, None], torch.zeros((), dtype=x.dtype, device=x.device), x)
        x = torch.where((flat == self.eos_idx)[:, None], sym[0][None, :], x)
        x = torch.where((flat == self.unk_idx)[:, None], sym[1][None, :], x)
        return x.reshape(b, t, -1)
