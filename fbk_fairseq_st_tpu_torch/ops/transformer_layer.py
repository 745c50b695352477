"""Transformer encoder/decoder layers (pre- or post-norm).

Counterpart of ``fbk_fairseq_st_tpu/ops/transformer_layer.py``
(``encoder_layer`` :119, ``decoder_layer`` :351,
``init_decoder_layer_cache`` :189): residual -> [LN] -> attention ->
dropout -> add -> [LN], then the same around fc1/activation/fc2, with the
LayerNorm placement set by ``normalize_before``. Decoder layers carry two
caches: ``self`` (written in place each step) and ``cross`` (encoder K/V,
precomputed once).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from .attention import MHAConfig, MultiheadAttention, init_cache
from .core import GeneratorLike, LayerNorm, Linear, dropout, get_activation


class TransformerLayerConfig(NamedTuple):
    embed_dim: int
    ffn_dim: int
    num_heads: int
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation: str = "relu"
    normalize_before: bool = True
    # encoder self-attention distance penalty ('log' | 'gauss' | None)
    distance_penalty: Optional[str] = None
    init_variance: float = 1.0

    @property
    def self_attn_cfg(self) -> MHAConfig:
        return MHAConfig(
            self.embed_dim, self.num_heads, dropout=self.attention_dropout,
            penalty=self.distance_penalty, init_variance=self.init_variance,
        )

    @property
    def cross_attn_cfg(self) -> MHAConfig:
        return MHAConfig(self.embed_dim, self.num_heads, dropout=self.attention_dropout)


class _FFNMixin:
    def _ffn(self, x, generator):
        cfg = self.cfg
        residual = x
        if cfg.normalize_before:
            x = self.final_layer_norm(x)
        x = get_activation(cfg.activation)(self.fc1(x))
        x = dropout(x, cfg.activation_dropout, generator, self.training)
        x = self.fc2(x)
        x = dropout(x, cfg.dropout, generator, self.training)
        x = residual + x
        if not cfg.normalize_before:
            x = self.final_layer_norm(x)
        return x


class TransformerEncoderLayer(_FFNMixin, nn.Module):
    """``encoder_layer``: x (B, T, D) -> (B, T, D)."""

    def __init__(self, cfg: TransformerLayerConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MultiheadAttention(cfg.self_attn_cfg)
        self.self_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.fc1 = Linear(cfg.embed_dim, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.embed_dim)
        self.final_layer_norm = LayerNorm(cfg.embed_dim)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.self_attn, self.self_attn_layer_norm, self.fc1, self.fc2, self.final_layer_norm):
            m.init(generator)

    def forward(self, x, key_padding_mask=None, attn_mask=None,
                generator: GeneratorLike = None):
        cfg = self.cfg
        residual = x
        if cfg.normalize_before:
            x = self.self_attn_layer_norm(x)
        x, _, _ = self.self_attn(
            x, key_padding_mask=key_padding_mask, attn_mask=attn_mask, generator=generator
        )
        x = dropout(x, cfg.dropout, generator, self.training)
        x = residual + x
        if not cfg.normalize_before:
            x = self.self_attn_layer_norm(x)
        return self._ffn(x, generator)


class TransformerDecoderLayer(_FFNMixin, nn.Module):
    """``decoder_layer``: causal self-attention, cross-attention, FFN."""

    def __init__(self, cfg: TransformerLayerConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MultiheadAttention(cfg.self_attn_cfg)
        self.self_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.encoder_attn = MultiheadAttention(cfg.cross_attn_cfg)
        self.encoder_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.fc1 = Linear(cfg.embed_dim, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.embed_dim)
        self.final_layer_norm = LayerNorm(cfg.embed_dim)

    def init(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.init(generator)

    def forward(
        self,
        x,
        encoder_out=None,
        encoder_padding_mask=None,
        self_attn_mask=None,
        self_attn_padding_mask=None,
        generator: GeneratorLike = None,
        cache: Optional[Dict[str, Any]] = None,
        cache_index: Optional[int] = None,
    ):
        """x: (B, T, D) -> (B, T, D). With ``cache`` ({"self", "cross"})
        the step attends over the caches, writing ``self`` in place."""
        cfg = self.cfg
        residual = x
        if cfg.normalize_before:
            x = self.self_attn_layer_norm(x)
        x, _, _ = self.self_attn(
            x,
            key_padding_mask=self_attn_padding_mask,
            attn_mask=self_attn_mask,
            generator=generator,
            cache=cache["self"] if cache is not None else None,
            cache_index=cache_index,
        )
        x = dropout(x, cfg.dropout, generator, self.training)
        x = residual + x
        if not cfg.normalize_before:
            x = self.self_attn_layer_norm(x)

        residual = x
        if cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        if cache is not None:
            x, _, _ = self.encoder_attn(
                x, key_padding_mask=encoder_padding_mask, generator=generator,
                cache=cache["cross"], static_kv=True,
            )
        else:
            x, _, _ = self.encoder_attn(
                x, key=encoder_out, key_padding_mask=encoder_padding_mask, generator=generator,
            )
        x = dropout(x, cfg.dropout, generator, self.training)
        x = residual + x
        if not cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        return self._ffn(x, generator)


def init_decoder_layer_cache(layer: TransformerDecoderLayer, batch: int, max_len: int,
                             encoder_out, dtype=torch.float32) -> Dict[str, Any]:
    """Preallocated self-attention K/V and the encoder output's
    cross-attention K/V, projected once."""
    return {
        "self": init_cache(batch, max_len, layer.cfg.self_attn_cfg, dtype, encoder_out.device),
        "cross": layer.encoder_attn.precompute_cross_cache(encoder_out),
    }
