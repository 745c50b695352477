"""TransformerDecoder — the decoder shared by the FBK ST models.

Counterpart of ``fbk_fairseq_st_tpu/models/transformer_decoder.py``: scaled
token embedding + positional embedding -> dropout -> N decoder layers ->
optional final LayerNorm -> output projection (tied to the input embedding
or a separate ``output_projection``). Two modes: ``forward`` (teacher
forcing with the ``"causal"`` sentinel and the self key-padding mask;
``features_only`` stops before the output projection) and ``step`` (one
token against the per-layer caches). ``TriangleTransformerDecoder`` (JAX
:399-506) is the same decoder over triangle layers, which also attend the
auxiliary decoder's states.

The config holds the options ``conv_transformer`` sets. Those of other
model families (adaptive input/softmax, the character embedder,
cross-self-attention, quant-noise, LayerDrop, decoders without encoder
attention) come with those families (ROADMAP Queue A item 9).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from ..ops.core import GeneratorLike, LayerNorm, dropout, embedding, normal_
from ..ops.positional import PositionalEmbedding
from ..ops.transformer_layer import (
    TransformerDecoderLayer,
    TransformerLayerConfig,
    TriangleDecoderLayer,
    init_decoder_layer_cache,
    init_triangle_decoder_layer_cache,
)


class TransformerDecoderConfig(NamedTuple):
    vocab_size: int
    embed_dim: int = 256
    ffn_dim: int = 768
    layers: int = 6
    heads: int = 4
    dropout: float = 0.3
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = True
    learned_pos: bool = False
    max_positions: int = 1024
    padding_idx: int = 1
    share_input_output_embed: bool = False
    no_scale_embedding: bool = False
    layernorm_embedding: bool = False
    no_token_positional_embeddings: bool = False

    @property
    def layer_cfg(self) -> TransformerLayerConfig:
        return TransformerLayerConfig(
            embed_dim=self.embed_dim,
            ffn_dim=self.ffn_dim,
            num_heads=self.heads,
            dropout=self.dropout,
            attention_dropout=self.attention_dropout,
            activation_dropout=self.activation_dropout,
            activation=self.activation,
            normalize_before=self.normalize_before,
        )


class TransformerDecoder(nn.Module):
    layer_class = TransformerDecoderLayer

    def __init__(self, cfg: TransformerDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_scale = 1.0 if cfg.no_scale_embedding else cfg.embed_dim ** 0.5
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embed_dim, cfg.padding_idx)
        self.embed_positions = (
            None if cfg.no_token_positional_embeddings
            else PositionalEmbedding(cfg.max_positions, cfg.embed_dim, cfg.padding_idx, cfg.learned_pos)
        )
        self.layers = nn.ModuleList(self.layer_class(cfg.layer_cfg) for _ in range(cfg.layers))
        self.layer_norm = LayerNorm(cfg.embed_dim) if cfg.normalize_before else None
        self.layernorm_embedding = LayerNorm(cfg.embed_dim) if cfg.layernorm_embedding else None
        self.output_projection = (
            None if cfg.share_input_output_embed
            else nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False)
        )
        # tensor parallelism's embedding and logits over this rank's rows of
        # the vocabulary (parallel/tensor_parallel.py::VocabParallel)
        self.vocab_parallel = None

    def init(self, generator: torch.Generator) -> None:
        std = self.cfg.embed_dim ** -0.5
        normal_(self.embed_tokens.weight, generator, std)
        with torch.no_grad():
            self.embed_tokens.weight[self.cfg.padding_idx] = 0.0
        for layer in self.layers:
            layer.init(generator)
        for m in (self.embed_positions, self.layer_norm, self.layernorm_embedding):
            if m is not None:
                m.init(generator)
        if self.output_projection is not None:
            normal_(self.output_projection.weight, generator, std)

    def _embed(self, tokens, dtype, generator, step: Optional[int] = None):
        if self.vocab_parallel is not None:
            x = self.embed_scale * self.vocab_parallel.embed(self.embed_tokens.weight, tokens, dtype)
        else:
            x = self.embed_scale * embedding(self.embed_tokens.weight, tokens, dtype)
        if self.embed_positions is not None:
            x = x + self.embed_positions.from_ids(tokens, dtype, step=step)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        return dropout(x, self.cfg.dropout, generator, self.training)

    def output_layer(self, x):
        w = self.embed_tokens.weight if self.output_projection is None else self.output_projection.weight
        if self.vocab_parallel is not None:
            return self.vocab_parallel.logits(x, w)
        return torch.matmul(x, w.t().to(x.dtype))

    def forward(self, prev_output_tokens, encoder_out, encoder_padding_mask=None,
                generator: GeneratorLike = None, features_only: bool = False, need_attn: bool = False,
                **layer_kwargs):
        """Teacher forcing: prev_output_tokens (B, T) -> (logits (B, T, V),
        {"attn": None}), or the final states (B, T, D) with
        ``features_only``. With ``need_attn`` ``attn`` is the last layer's
        head-averaged cross-attention (B, T, S), which alone leaves the
        flash route (JAX :293-326). Self-attention is causal with pad keys
        masked; ``layer_kwargs`` go to every layer."""
        x = self._embed(prev_output_tokens, encoder_out.dtype, generator)
        self_kpm = prev_output_tokens == self.cfg.padding_idx
        attn = None
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(
                x,
                encoder_out=encoder_out,
                encoder_padding_mask=encoder_padding_mask,
                self_attn_mask="causal",
                self_attn_padding_mask=self_kpm,
                generator=generator,
                **layer_kwargs,
                **({"need_attn": True} if need_attn and i == last else {}),
            )
            if need_attn and i == last:
                x, attn = x
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return (x if features_only else self.output_layer(x)), {"attn": attn}

    def init_cache(self, batch: int, max_len: int, encoder_out,
                   dtype=torch.float32) -> List[Dict[str, Any]]:
        return [
            init_decoder_layer_cache(layer, batch, max_len, encoder_out, dtype)
            for layer in self.layers
        ]

    def reorder_cache(self, cache: List[Dict[str, Any]], order, slots=("self",)) -> None:
        """Gather every layer's K/V of each of ``slots`` by ``order`` (B*K
        rows). The cross K/V may stay when the memory is the encoder's: a
        beam reorder only permutes rows within a sentence, whose encoder
        rows are identical. Memory that differs from beam to beam (the
        two-phase search's transcripts) is gathered with the beams."""
        for layer_cache in cache:
            for slot in slots:
                kv = layer_cache[slot]
                kv["k"] = kv["k"].index_select(0, order)
                kv["v"] = kv["v"].index_select(0, order)

    def step(self, tokens, cache, step_index: int, encoder_padding_mask=None, **layer_kwargs):
        """tokens (B, 1) -> logits (B, V); the caches are written in place."""
        x = self._embed(tokens, cache[0]["self"]["k"].dtype, None, step=step_index)
        for layer, lc in zip(self.layers, cache):
            x = layer(x, encoder_padding_mask=encoder_padding_mask, cache=lc, cache_index=step_index,
                      **layer_kwargs)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return self.output_layer(x)[:, 0, :]


class TriangleTransformerDecoder(TransformerDecoder):
    """The decoder over ``TriangleDecoderLayer``s: ``forward`` takes
    ``aux_decoder_out`` / ``aux_decoder_padding_mask``, ``step`` the
    latter, and the caches hold the auxiliary states' K/V under ``aux``
    (JAX ``TriangleTransformerDecoder``)."""

    layer_class = TriangleDecoderLayer

    def init_cache(self, batch: int, max_len: int, encoder_out, dtype=torch.float32,
                   aux_out=None) -> List[Dict[str, Any]]:
        return [
            init_triangle_decoder_layer_cache(layer, batch, max_len, encoder_out, aux_out, dtype)
            for layer in self.layers
        ]
