"""Context-aware transformer layers with sigmoid gating (INTERSPEECH 2020).

Counterpart of ``fbk_fairseq_st_tpu/ops/context_layer.py`` (reference
examples/speech_recognition/modules/conv_transformer_context_layer.py):
after the self-attention (encoder) or the encoder attention (decoder), a
cross-attention over the encoded context, fused by
``lam = sigmoid(W_i . residual + W_s . c)``:

  * sequential (the encoder, and the decoder's ``sequential`` mode):
    ``x = lam * residual + (1 - lam) * c``, between the context block's
    LayerNorm placements;
  * parallel (decoder only): the context attention queries the same
    normalised input as the encoder attention and gates against the
    encoder attention's output, with no LayerNorm after; the layer returns
    ``ctx_gate = 1 - lam`` for the ctxreg criterion.

The context block is ``context_attn``, ``context_gating_wi``,
``context_gating_ws`` and a LayerNorm, under the fork's names:
``context_layer_norm`` in the encoder, ``context_attn_layer_norm`` in the
decoder. A layer built without context has no such block and ignores a
context given to it. A decoder step attends the context's K/V, projected
once into the cache under ``ctx`` (``init_context_decoder_layer_cache``),
the way the triangle layer's ``aux`` is.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .attention import MultiheadAttention
from .core import GeneratorLike, LayerNorm, Linear, dropout
from .transformer_layer import (TransformerDecoderLayer, TransformerEncoderLayer, TransformerLayerConfig,
                                init_decoder_layer_cache)

ATTENTION_TYPES = ("sequential", "parallel")


class _ContextBlock:
    """The context block's modules and its gate, shared by both layers."""

    def _add_context_block(self, cfg: TransformerLayerConfig, norm_name: str) -> None:
        self.context_attn = MultiheadAttention(cfg.cross_attn_cfg)
        self.context_gating_wi = Linear(cfg.embed_dim, cfg.embed_dim)
        self.context_gating_ws = Linear(cfg.embed_dim, cfg.embed_dim)
        setattr(self, norm_name, LayerNorm(cfg.embed_dim))
        self.context_norm_name = norm_name

    @property
    def has_context(self) -> bool:
        return self.context_norm_name is not None

    def _context_modules(self):
        if not self.has_context:
            return ()
        return (self.context_attn, self.context_gating_wi, self.context_gating_ws,
                getattr(self, self.context_norm_name))

    def _gate(self, residual, c):
        """(lam * residual + (1 - lam) * c, lam)."""
        lam = torch.sigmoid(self.context_gating_wi(residual) + self.context_gating_ws(c))
        return lam * residual + (1.0 - lam) * c, lam

    def _sequential(self, x, attend):
        """The sequential block: [LN] -> ``attend`` -> gate -> [LN]."""
        norm = getattr(self, self.context_norm_name)
        residual = x
        if self.cfg.normalize_before:
            x = norm(x)
        x, _ = self._gate(residual, attend(x))
        if not self.cfg.normalize_before:
            x = norm(x)
        return x


class ContextEncoderLayer(_ContextBlock, TransformerEncoderLayer):
    """``context_encoder_layer``: self-attention, the sequential context
    block, FFN."""

    def __init__(self, cfg: TransformerLayerConfig, add_context: bool):
        super().__init__(cfg)
        self.context_norm_name = None
        if add_context:
            self._add_context_block(cfg, "context_layer_norm")

    def init(self, generator: torch.Generator) -> None:
        super().init(generator)
        for m in self._context_modules():
            m.init(generator)

    def forward(self, x, key_padding_mask=None, context=None, context_padding_mask=None,
                generator: GeneratorLike = None):
        x = self._self_block(x, key_padding_mask, None, generator)
        if self.has_context and context is not None:
            x = self._sequential(x, lambda q: self._attend(q, context, context_padding_mask, generator))
        return self._ffn(x, generator)

    def _attend(self, query, context, context_padding_mask, generator):
        c, _, _ = self.context_attn(query, key=context, key_padding_mask=context_padding_mask, generator=generator)
        return dropout(c, self.cfg.dropout, generator, self.training)


class ContextDecoderLayer(_ContextBlock, TransformerDecoderLayer):
    """``context_decoder_layer``: causal self-attention, encoder attention,
    the context block in ``attention_type`` mode, FFN. Returns (x,
    ctx_gate or None)."""

    def __init__(self, cfg: TransformerLayerConfig, add_context: bool, attention_type: str = "sequential"):
        super().__init__(cfg)
        self.attention_type = attention_type
        self.context_norm_name = None
        if add_context:
            self._add_context_block(cfg, "context_attn_layer_norm")

    def forward(
        self,
        x,
        encoder_out=None,
        encoder_padding_mask=None,
        context=None,
        context_padding_mask=None,
        self_attn_mask=None,
        self_attn_padding_mask=None,
        generator: GeneratorLike = None,
        cache: Optional[Dict[str, Any]] = None,
        cache_index: Optional[int] = None,
    ):
        """x (B, T, D) -> (x, ctx_gate (B, T, D) in parallel mode, else
        None). A step's ``cache`` holds ``self``, ``cross`` and, with a
        context, ``ctx``."""
        cfg = self.cfg
        x = self._self_block(x, self_attn_mask, self_attn_padding_mask, generator, cache, cache_index)
        residual = x
        if cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        query_ctx = x  # parallel mode queries the same normalised input
        x = self._cross(self.encoder_attn, x, encoder_out, encoder_padding_mask, generator, cache, "cross")
        x = residual + x
        if not cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)

        ctx_gate = None
        if self.has_context and (context is not None or (cache is not None and "ctx" in cache)):
            def attend(query):
                return self._cross(self.context_attn, query, context, context_padding_mask, generator, cache, "ctx")

            if self.attention_type == "sequential":
                x = self._sequential(x, attend)
            elif self.attention_type == "parallel":
                x, lam = self._gate(x, attend(query_ctx))
                ctx_gate = 1.0 - lam
            else:
                raise RuntimeError(f"Invalid decoder context attention type {self.attention_type}")
        return self._ffn(x, generator), ctx_gate


def init_context_decoder_layer_cache(layer: ContextDecoderLayer, batch: int, max_len: int, encoder_out,
                                     context_out=None, dtype=torch.float32) -> Dict[str, Any]:
    """``init_decoder_layer_cache`` plus, for a layer with a context block
    and a context, the context's K/V under ``ctx``, projected once."""
    cache = init_decoder_layer_cache(layer, batch, max_len, encoder_out, dtype)
    if context_out is not None and layer.has_context:
        cache["ctx"] = layer.context_attn.precompute_cross_cache(context_out)
    return cache
