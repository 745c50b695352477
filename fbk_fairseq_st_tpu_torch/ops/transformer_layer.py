"""Transformer encoder/decoder layers (pre- or post-norm).

Counterpart of ``fbk_fairseq_st_tpu/ops/transformer_layer.py``
(``encoder_layer`` :119, ``decoder_layer`` :351,
``init_decoder_layer_cache`` :189, ``triangle_decoder_layer`` :249):
residual -> [LN] -> attention -> dropout -> add -> [LN], then the same
around fc1/activation/fc2, with the LayerNorm placement set by
``normalize_before``. Decoder layers carry two caches: ``self`` (written in
place each step) and ``cross`` (encoder K/V, precomputed once); the
triangle layer a third, ``aux`` (the auxiliary decoder's K/V). A decoder
layer may have no encoder attention (``no_encoder_attn``: the language
model's), and with ``cross_self_attention`` its self-attention keys are
the encoder states followed by its own (JAX :371-412): teacher-forced, the
keys are cat(encoder_out, x) under an additive mask (the dense route);
stepping, the ``self`` cache holds the projected encoder rows first and
each step writes at S + step. Quant-noise is ROADMAP Queue A item 9(c)
(``options.NOT_PORTED``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from .attention import MHAConfig, MultiheadAttention, _split_heads, causal_mask, init_cache
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
    # decoder self-attention keys include the encoder states
    cross_self_attention: bool = False

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
        return self._ffn(self._self_block(x, key_padding_mask, attn_mask, generator), generator)

    def _self_block(self, x, key_padding_mask, attn_mask, generator):
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
        return x


class TransformerDecoderLayer(_FFNMixin, nn.Module):
    """``decoder_layer``: causal self-attention, cross-attention (none
    with ``no_encoder_attn``), FFN."""

    def __init__(self, cfg: TransformerLayerConfig, no_encoder_attn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MultiheadAttention(cfg.self_attn_cfg)
        self.self_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.encoder_attn = None if no_encoder_attn else MultiheadAttention(cfg.cross_attn_cfg)
        self.encoder_attn_layer_norm = None if no_encoder_attn else LayerNorm(cfg.embed_dim)
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
        need_attn: bool = False,
    ):
        """x: (B, T, D) -> (B, T, D). With ``cache`` ({"self", "cross"})
        the step attends over the caches, writing ``self`` in place. With
        ``need_attn`` -> (x, the cross-attention's head-averaged weights
        (B, T, S)): that attention takes the dense route (JAX
        ``decoder_layer``'s ``need_attn``)."""
        cfg = self.cfg
        x = self._self_block(x, self_attn_mask, self_attn_padding_mask, generator, cache, cache_index,
                             encoder_out, encoder_padding_mask)
        attn = None
        if self.encoder_attn is not None:
            residual = x
            if cfg.normalize_before:
                x = self.encoder_attn_layer_norm(x)
            x = self._cross(self.encoder_attn, x, encoder_out, encoder_padding_mask, generator, cache, "cross",
                            need_weights=need_attn)
            if need_attn:
                x, attn = x
            x = residual + x
            if not cfg.normalize_before:
                x = self.encoder_attn_layer_norm(x)
        x = self._ffn(x, generator)
        return (x, attn) if need_attn else x

    def _self_block(self, x, attn_mask, padding_mask, generator, cache, cache_index, encoder_out=None,
                    encoder_padding_mask=None):
        cfg = self.cfg
        residual = x
        if cfg.normalize_before:
            x = self.self_attn_layer_norm(x)
        key = None
        if cfg.cross_self_attention and cache is None and encoder_out is not None:
            # keys cat(encoder_out, x): every encoder row, causal over the
            # decoder's own (JAX :374-396)
            b, t, s = x.shape[0], x.shape[1], encoder_out.shape[1]
            key = torch.cat([encoder_out.to(x.dtype), x], dim=1)
            if isinstance(attn_mask, str) and attn_mask == "causal":
                attn_mask = torch.cat([torch.zeros((t, s), device=x.device), causal_mask(t, device=x.device)], 1)
            epm = encoder_padding_mask if encoder_padding_mask is not None else torch.zeros(
                (b, s), dtype=torch.bool, device=x.device)
            spm = padding_mask if padding_mask is not None else torch.zeros(
                (b, t), dtype=torch.bool, device=x.device)
            padding_mask = torch.cat([epm, spm], dim=1)
        elif cfg.cross_self_attention and cache is not None and encoder_padding_mask is not None:
            # the buffer's first S rows are the encoder's (init_decoder_layer_cache)
            s = encoder_padding_mask.shape[1]
            buf_len = cache["self"]["k"].shape[2]
            cache_index = cache_index + s
            padding_mask = torch.cat([encoder_padding_mask, torch.zeros(
                (x.shape[0], buf_len - s), dtype=torch.bool, device=x.device)], dim=1)
        x, _, _ = self.self_attn(
            x,
            key=key,
            key_padding_mask=padding_mask,
            attn_mask=attn_mask,
            generator=generator,
            cache=cache["self"] if cache is not None else None,
            cache_index=cache_index,
        )
        x = dropout(x, cfg.dropout, generator, self.training)
        x = residual + x
        if not cfg.normalize_before:
            x = self.self_attn_layer_norm(x)
        return x

    def _cross(self, attn, x, memory, padding_mask, generator, cache, slot: str, need_weights: bool = False):
        """A cross-attention over ``memory`` (B, S, D), or over its K/V in
        ``cache[slot]`` when stepping, then dropout; with ``need_weights``
        -> (x, the head-averaged weights)."""
        if cache is not None:
            x, weights, _ = attn(x, key_padding_mask=padding_mask, generator=generator, cache=cache[slot],
                                 static_kv=True, need_weights=need_weights)
        else:
            x, weights, _ = attn(x, key=memory, key_padding_mask=padding_mask, generator=generator,
                                 need_weights=need_weights)
        x = dropout(x, self.cfg.dropout, generator, self.training)
        return (x, weights) if need_weights else x


class TriangleDecoderLayer(TransformerDecoderLayer):
    """``triangle_decoder_layer`` (reference modules/triangle_transformer_layer.py):
    self-attention; then the encoder and the auxiliary-decoder
    cross-attentions side by side, each with its own dropout, concatenated
    and fused by ``fc_concat`` into one residual (pre-norm: the encoder's
    LayerNorm before the pair; post-norm: ``aux_decoder_attn_layer_norm``
    after the fused residual); then the FFN."""

    def __init__(self, cfg: TransformerLayerConfig):
        super().__init__(cfg)
        self.aux_decoder_attn = MultiheadAttention(cfg.cross_attn_cfg)
        self.aux_decoder_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.fc_concat = Linear(2 * cfg.embed_dim, cfg.embed_dim)

    def forward(
        self,
        x,
        encoder_out=None,
        encoder_padding_mask=None,
        aux_decoder_out=None,
        aux_decoder_padding_mask=None,
        self_attn_mask=None,
        self_attn_padding_mask=None,
        generator: GeneratorLike = None,
        cache: Optional[Dict[str, Any]] = None,
        cache_index: Optional[int] = None,
    ):
        """As ``TransformerDecoderLayer.forward``, with the auxiliary
        decoder's states ``aux_decoder_out`` (B, S_aux, D) and their pad
        mask; a step's ``cache`` also holds ``aux``."""
        cfg = self.cfg
        x = self._self_block(x, self_attn_mask, self_attn_padding_mask, generator, cache, cache_index)
        residual = x
        if cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        x1 = self._cross(self.encoder_attn, x, encoder_out, encoder_padding_mask, generator, cache, "cross")
        x2 = self._cross(self.aux_decoder_attn, x, aux_decoder_out, aux_decoder_padding_mask, generator, cache, "aux")
        x = residual + self.fc_concat(torch.cat([x1, x2], dim=-1))
        if not cfg.normalize_before:
            x = self.aux_decoder_attn_layer_norm(x)
        return self._ffn(x, generator)


def init_decoder_layer_cache(layer: TransformerDecoderLayer, batch: int, max_len: int,
                             encoder_out, dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Preallocated self-attention K/V and the encoder output's
    cross-attention K/V, projected once (no encoder output: the self
    cache alone, on ``device``). With ``cross_self_attention`` the self
    buffer is S + max_len long, its first S rows the encoder output's
    projected K/V (JAX :189-226)."""
    cfg = layer.cfg
    if encoder_out is None:
        return {"self": init_cache(batch, max_len, cfg.self_attn_cfg, dtype, device)}
    if cfg.cross_self_attention:
        s = encoder_out.shape[1]
        self_cache = init_cache(batch, s + max_len, cfg.self_attn_cfg, dtype, encoder_out.device)
        self_cache["k"][:, :, :s] = _split_heads(layer.self_attn.k_proj(encoder_out), cfg.num_heads)
        self_cache["v"][:, :, :s] = _split_heads(layer.self_attn.v_proj(encoder_out), cfg.num_heads)
    else:
        self_cache = init_cache(batch, max_len, cfg.self_attn_cfg, dtype, encoder_out.device)
    cache = {"self": self_cache}
    if layer.encoder_attn is not None:
        cache["cross"] = layer.encoder_attn.precompute_cross_cache(encoder_out)
    return cache


def init_triangle_decoder_layer_cache(layer: TriangleDecoderLayer, batch: int, max_len: int, encoder_out,
                                      aux_out, dtype=torch.float32) -> Dict[str, Any]:
    """``init_decoder_layer_cache`` plus the auxiliary decoder's states'
    K/V under ``aux``, projected once."""
    cache = init_decoder_layer_cache(layer, batch, max_len, encoder_out, dtype)
    cache["aux"] = layer.aux_decoder_attn.precompute_cross_cache(aux_out)
    return cache
