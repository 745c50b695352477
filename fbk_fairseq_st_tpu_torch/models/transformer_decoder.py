"""TransformerDecoder — the decoder shared by the FBK ST models, the text
transformer and its language model.

Counterpart of ``fbk_fairseq_st_tpu/models/transformer_decoder.py``: scaled
token embedding + positional embedding -> dropout -> N decoder layers ->
optional final LayerNorm -> output projection (tied to the input embedding
or a separate ``output_projection``). Two modes: ``forward`` (teacher
forcing with the ``"causal"`` sentinel and the self key-padding mask;
``features_only`` stops before the output projection) and ``step`` (one
token against the per-layer caches). ``TriangleTransformerDecoder`` (JAX
:399-506) is the same decoder over triangle layers, which also attend the
auxiliary decoder's states.

The options of the text transformer family (JAX :123-283): decoders
without encoder attention (``no_encoder_attn``, the language model's),
``cross_self_attention``, LayerDrop (a dropped layer is skipped, drawn on
the run's CPU generator; JAX computes it and masks it out, the same
function), ``input_vocab_size`` (``--output-dictionary-size``: the input
embedding covers the whole dictionary), ``no_decoder_final_norm``, and the
embedding and output hooks: ``embed_tokens`` is an ``nn.Embedding``, an
``AdaptiveInput`` (``ops/adaptive_softmax.py``) or a
``CharacterTokenEmbedder`` (``ops/character_embedder.py``); the output is
the dense projection or ``adaptive_softmax`` (free, or tied to the
adaptive input), whose output is fp32 log-probabilities (the dense
projection's logits take the activations' type). Adaptive input tied to a
dense projection raises ``ValueError`` (JAX :242-252). Quant-noise is
ROADMAP Queue A item 9(c).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from ..ops.adaptive_softmax import AdaptiveInput, AdaptiveSoftmax
from ..ops.character_embedder import CharacterTokenEmbedder
from ..ops.core import Generators, GeneratorLike, LayerNorm, dropout, embedding, normal_
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
    no_encoder_attn: bool = False
    cross_self_attention: bool = False
    quant_noise_pq: float = 0.0
    quant_noise_block: int = 8
    input_vocab_size: Optional[int] = None
    adaptive_softmax_cutoff: Optional[tuple] = None
    adaptive_softmax_factor: float = 4.0
    layerdrop: float = 0.0
    adaptive_input_cutoff: Optional[tuple] = None
    adaptive_input_factor: float = 4.0
    no_decoder_final_norm: bool = False
    tie_adaptive_weights: bool = False
    tie_adaptive_proj: bool = False
    char_embedder: Optional[tuple] = None  # ops.character_embedder.CharEmbedderConfig
    eos_idx: int = 2
    unk_idx: int = 3

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
            cross_self_attention=self.cross_self_attention,
        )


def layer_dropped(rate: float, generator: GeneratorLike, training: bool) -> bool:
    """LayerDrop's draw for one layer, on the run's CPU generator (no sync)."""
    if not training or rate <= 0.0 or generator is None:
        return False
    host = generator.host if isinstance(generator, Generators) else generator
    return bool(torch.rand((), generator=host) < rate)


class TransformerDecoder(nn.Module):
    layer_class = TransformerDecoderLayer

    def __init__(self, cfg: TransformerDecoderConfig, char_table=None):
        super().__init__()
        self.cfg = cfg
        in_vocab = cfg.input_vocab_size or cfg.vocab_size
        if cfg.share_input_output_embed and in_vocab != cfg.vocab_size:
            raise ValueError("--output-dictionary-size is incompatible with --share-decoder-input-output-embed")
        if (cfg.adaptive_input_cutoff is not None and cfg.share_input_output_embed
                and cfg.adaptive_softmax_cutoff is None):
            raise ValueError("adaptive input embeddings cannot be tied to a dense output projection; use "
                             "--adaptive-softmax-cutoff or disable --share-decoder-input-output-embed")
        self.embed_scale = 1.0 if cfg.no_scale_embedding else cfg.embed_dim ** 0.5
        if cfg.char_embedder is not None:
            self.embed_tokens = CharacterTokenEmbedder(cfg.char_embedder, char_table, cfg.padding_idx,
                                                       cfg.eos_idx, cfg.unk_idx)
        elif cfg.adaptive_input_cutoff is not None:
            self.embed_tokens = AdaptiveInput(in_vocab, cfg.padding_idx, cfg.embed_dim, cfg.adaptive_input_factor,
                                              cfg.embed_dim, cfg.adaptive_input_cutoff)
        else:
            self.embed_tokens = nn.Embedding(in_vocab, cfg.embed_dim, cfg.padding_idx)
        self.embed_positions = (
            None if cfg.no_token_positional_embeddings
            else PositionalEmbedding(cfg.max_positions, cfg.embed_dim, cfg.padding_idx, cfg.learned_pos)
        )
        self.layers = nn.ModuleList(self._make_layer(cfg) for _ in range(cfg.layers))
        self.layer_norm = (LayerNorm(cfg.embed_dim) if cfg.normalize_before and not cfg.no_decoder_final_norm
                           else None)
        self.layernorm_embedding = LayerNorm(cfg.embed_dim) if cfg.layernorm_embedding else None
        self.adaptive_softmax = None
        self.output_projection = None
        if cfg.adaptive_softmax_cutoff is not None:
            tied = None
            if cfg.tie_adaptive_weights:
                if cfg.adaptive_input_cutoff is None:
                    raise ValueError("--tie-adaptive-weights requires --adaptive-input")
                if tuple(cfg.adaptive_input_cutoff) != tuple(cfg.adaptive_softmax_cutoff):
                    raise ValueError("tied adaptive softmax needs matching input/softmax cutoffs")
                tied = self.embed_tokens
            self.adaptive_softmax = AdaptiveSoftmax(cfg.vocab_size, cfg.embed_dim, cfg.adaptive_softmax_cutoff,
                                                    cfg.adaptive_softmax_factor, tied, cfg.tie_adaptive_proj)
        elif not cfg.share_input_output_embed:
            self.output_projection = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False)
        # tensor parallelism's embedding and logits over this rank's rows of
        # the vocabulary (parallel/tensor_parallel.py::VocabParallel)
        self.vocab_parallel = None

    def _make_layer(self, cfg: TransformerDecoderConfig):
        if cfg.no_encoder_attn:
            return self.layer_class(cfg.layer_cfg, no_encoder_attn=True)
        return self.layer_class(cfg.layer_cfg)

    def init(self, generator: torch.Generator) -> None:
        std = self.cfg.embed_dim ** -0.5
        if isinstance(self.embed_tokens, nn.Embedding):
            normal_(self.embed_tokens.weight, generator, std)
            with torch.no_grad():
                self.embed_tokens.weight[self.cfg.padding_idx] = 0.0
        else:
            self.embed_tokens.init(generator)
        for layer in self.layers:
            layer.init(generator)
        for m in (self.embed_positions, self.layer_norm, self.layernorm_embedding, self.adaptive_softmax):
            if m is not None:
                m.init(generator)
        if self.output_projection is not None:
            normal_(self.output_projection.weight, generator, std)

    def _embed(self, tokens, dtype, generator, step: Optional[int] = None):
        if isinstance(self.embed_tokens, nn.Embedding):
            if self.vocab_parallel is not None:
                x = self.vocab_parallel.embed(self.embed_tokens.weight, tokens, dtype)
            else:
                x = embedding(self.embed_tokens.weight, tokens, dtype)
        elif isinstance(self.embed_tokens, AdaptiveInput):
            x = self.embed_tokens(tokens, dtype)
        else:
            x = self.embed_tokens(tokens).to(dtype)
        x = self.embed_scale * x
        if self.embed_positions is not None:
            x = x + self.embed_positions.from_ids(tokens, dtype, step=step)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        return dropout(x, self.cfg.dropout, generator, self.training)

    def output_layer(self, x):
        """Logits (..., V) in the activations' type, or with the adaptive
        softmax fp32 log-probabilities (their log-softmax is themselves)."""
        if self.adaptive_softmax is not None:
            return self.adaptive_softmax.log_probs(x)
        w = self.embed_tokens.weight if self.output_projection is None else self.output_projection.weight
        if self.vocab_parallel is not None:
            return self.vocab_parallel.logits(x, w)
        return torch.matmul(x, w.t().to(x.dtype))

    def forward(self, prev_output_tokens, encoder_out, encoder_padding_mask=None,
                generator: GeneratorLike = None, features_only: bool = False, need_attn: bool = False,
                causal: bool = True, dtype: Optional[torch.dtype] = None, **layer_kwargs):
        """Teacher forcing: prev_output_tokens (B, T) -> (logits (B, T, V),
        {"attn": None}), or the final states (B, T, D) with
        ``features_only``. With ``need_attn`` ``attn`` is the last layer's
        head-averaged cross-attention (B, T, S), which alone leaves the
        flash route (JAX :293-326). Self-attention is causal (full context
        with ``causal`` False) with pad keys masked; ``layer_kwargs`` go to
        every layer. Without an encoder (``encoder_out`` None) the
        activations take ``dtype`` (fp32 when None)."""
        if dtype is None:
            dtype = encoder_out.dtype if encoder_out is not None else torch.float32
        x = self._embed(prev_output_tokens, dtype, generator)
        self_kpm = prev_output_tokens == self.cfg.padding_idx
        attn = None
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if layer_dropped(self.cfg.layerdrop, generator, self.training):
                continue
            x = layer(
                x,
                encoder_out=encoder_out,
                encoder_padding_mask=encoder_padding_mask,
                self_attn_mask="causal" if causal else None,
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
                   dtype=torch.float32, device=None) -> List[Dict[str, Any]]:
        return [
            init_decoder_layer_cache(layer, batch, max_len, encoder_out, dtype, device)
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
