"""The text Transformer (Vaswani et al. 2017), the core translation model.

Counterpart of ``fbk_fairseq_st_tpu/models/transformer.py``: a token
encoder (scaled embedding + sinusoidal or learned positions -> optional
``layernorm_embedding`` -> dropout -> N encoder layers, post-norm by
default -> a final LayerNorm only when pre-norm; LayerDrop skips a layer,
drawn on the run's CPU generator) and the shared ``TransformerDecoder``,
with ``--share-all-embeddings`` (one table for the encoder, the decoder
and the output, which needs a joined dictionary and equal widths) and
``--share-decoder-input-output-embed``. The presets are JAX's seven
(:303-401): ``transformer``, ``_iwslt_de_en``, ``_wmt_en_de``,
``_vaswani_wmt_en_de_big``, ``_vaswani_wmt_en_fr_big``, ``_wmt_en_de_big``
and ``_wmt_en_de_big_t2t``, applied to an args namespace as JAX's are.

The module names are the fork's (``encoder.embed_tokens``,
``encoder.layers.{i}``, ``encoder.layernorm_embedding``,
``encoder.layer_norm``, ``decoder.*``); tied tables are one
``Parameter``, so one gradient reaches every use. The activations start in
fp32 at the tables, or in the type a batch names under ``compute_dtype``
(the Trainer's bf16 under ``--bf16``), as the lightconv family's do.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.core import GeneratorLike, LayerNorm, dropout, embedding, normal_
from ..ops.positional import PositionalEmbedding
from ..ops.transformer_layer import TransformerEncoderLayer, TransformerLayerConfig
from .base import EncoderOut
from .transformer_decoder import TransformerDecoder, TransformerDecoderConfig, layer_dropped


class TransformerEncoderConfig(NamedTuple):
    vocab_size: int
    embed_dim: int = 512
    ffn_dim: int = 2048
    layers: int = 6
    heads: int = 8
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation: str = "relu"
    normalize_before: bool = False
    learned_pos: bool = False
    max_positions: int = 1024
    padding_idx: int = 1
    no_scale_embedding: bool = False
    layernorm_embedding: bool = False
    no_token_positional_embeddings: bool = False
    layerdrop: float = 0.0
    quant_noise_pq: float = 0.0
    quant_noise_block: int = 8

    @property
    def layer_cfg(self) -> TransformerLayerConfig:
        return TransformerLayerConfig(
            embed_dim=self.embed_dim, ffn_dim=self.ffn_dim, num_heads=self.heads, dropout=self.dropout,
            attention_dropout=self.attention_dropout, activation_dropout=self.activation_dropout,
            activation=self.activation, normalize_before=self.normalize_before,
            quant_noise_pq=self.quant_noise_pq, quant_noise_block=self.quant_noise_block,
        )


class TransformerEncoder(nn.Module):
    """JAX ``TransformerEncoder`` (:79-155)."""

    def __init__(self, cfg: TransformerEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_scale = 1.0 if cfg.no_scale_embedding else cfg.embed_dim ** 0.5
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embed_dim, cfg.padding_idx)
        self.embed_positions = (
            None if cfg.no_token_positional_embeddings
            else PositionalEmbedding(cfg.max_positions, cfg.embed_dim, cfg.padding_idx, cfg.learned_pos))
        self.layers = nn.ModuleList(TransformerEncoderLayer(cfg.layer_cfg) for _ in range(cfg.layers))
        self.layer_norm = LayerNorm(cfg.embed_dim) if cfg.normalize_before else None
        self.layernorm_embedding = LayerNorm(cfg.embed_dim) if cfg.layernorm_embedding else None
        # tensor parallelism's embedding over this rank's rows of the vocabulary
        self.vocab_parallel = None

    def init(self, generator: torch.Generator) -> None:
        normal_(self.embed_tokens.weight, generator, self.cfg.embed_dim ** -0.5)
        with torch.no_grad():
            self.embed_tokens.weight[self.cfg.padding_idx] = 0.0
        for m in [*self.layers, self.embed_positions, self.layer_norm, self.layernorm_embedding]:
            if m is not None:
                m.init(generator)

    def forward(self, src_tokens, src_lengths=None, generator: GeneratorLike = None,
                dtype: torch.dtype = torch.float32) -> EncoderOut:
        """src_tokens (B, S) token ids, padded on either side."""
        cfg = self.cfg
        if self.vocab_parallel is not None:
            x = self.vocab_parallel.embed(self.embed_tokens.weight, src_tokens, dtype)
        else:
            x = embedding(self.embed_tokens.weight, src_tokens, dtype)
        x = self.embed_scale * x
        if self.embed_positions is not None:
            x = x + self.embed_positions.from_ids(src_tokens, dtype)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = dropout(x, cfg.dropout, generator, self.training)
        padding_mask = src_tokens == cfg.padding_idx
        for layer in self.layers:
            if layer_dropped(cfg.layerdrop, generator, self.training):
                continue
            x = layer(x, key_padding_mask=padding_mask, generator=generator)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return EncoderOut(encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=src_lengths)


class TransformerModel(nn.Module):
    def __init__(self, encoder_cfg: TransformerEncoderConfig, decoder_cfg: TransformerDecoderConfig,
                 share_all_embeddings: bool = False, encoder: nn.Module = None, decoder: nn.Module = None):
        """``encoder`` / ``decoder``: a subclass's own, built on the configs."""
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.decoder_cfg = decoder_cfg
        self.share_all_embeddings = share_all_embeddings
        self.encoder = TransformerEncoder(encoder_cfg) if encoder is None else encoder
        self.decoder = TransformerDecoder(decoder_cfg) if decoder is None else decoder
        if share_all_embeddings:
            self.decoder.embed_tokens.weight = self.encoder.embed_tokens.weight
        self.max_source_positions = encoder_cfg.max_positions
        self.max_target_positions = decoder_cfg.max_positions

    def init(self, generator: torch.Generator) -> "TransformerModel":
        """Seeded re-initialisation with the JAX model's distributions
        (draws on ``generator``, a CPU generator)."""
        self.encoder.init(generator)
        self.decoder.init(generator)
        return self

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None,
               dtype: torch.dtype = torch.float32) -> EncoderOut:
        return self.encoder(src_tokens, src_lengths, generator, dtype)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens (B, S), src_lengths, prev_output_tokens (B, T)
        and optionally ``compute_dtype``. Returns (logits (B, T, V), extra)
        with the EncoderOut in extra."""
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator,
                                  batch.get("compute_dtype", torch.float32))
        logits, extra = self.decoder(batch["prev_output_tokens"], encoder_out=encoder_out.encoder_out,
                                     encoder_padding_mask=encoder_out.encoder_padding_mask, generator=generator)
        extra["encoder_out"] = encoder_out
        return logits, extra

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32):
        return self.decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        return self.decoder.step(tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask)

    def reorder_cache(self, cache, order) -> None:
        self.decoder.reorder_cache(cache, order)


# ---------------------------------------------------------------------------
# Arch presets (the JAX package's, which set each option only where the
# caller left it unset) and construction
# ---------------------------------------------------------------------------

def base_architecture(args):
    """Reference transformer.py:883-923 defaults (JAX :303-346)."""
    args.encoder_embed_path = getattr(args, "encoder_embed_path", None)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 512)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 2048)
    args.encoder_layers = getattr(args, "encoder_layers", 6)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 8)
    args.encoder_normalize_before = getattr(args, "encoder_normalize_before", False)
    args.encoder_learned_pos = getattr(args, "encoder_learned_pos", False)
    args.decoder_embed_path = getattr(args, "decoder_embed_path", None)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", args.encoder_embed_dim)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", args.encoder_ffn_embed_dim)
    args.decoder_layers = getattr(args, "decoder_layers", 6)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 8)
    args.decoder_normalize_before = getattr(args, "decoder_normalize_before", False)
    args.decoder_learned_pos = getattr(args, "decoder_learned_pos", False)
    args.attention_dropout = getattr(args, "attention_dropout", 0.0)
    args.relu_dropout = getattr(args, "relu_dropout", 0.0)
    args.dropout = getattr(args, "dropout", 0.1)
    args.share_decoder_input_output_embed = getattr(args, "share_decoder_input_output_embed", False)
    args.share_all_embeddings = getattr(args, "share_all_embeddings", False)
    args.no_token_positional_embeddings = getattr(args, "no_token_positional_embeddings", False)
    args.adaptive_input = getattr(args, "adaptive_input", False)
    args.decoder_output_dim = getattr(args, "decoder_output_dim", args.decoder_embed_dim)
    args.decoder_input_dim = getattr(args, "decoder_input_dim", args.decoder_embed_dim)
    args.no_scale_embedding = getattr(args, "no_scale_embedding", False)
    args.layernorm_embedding = getattr(args, "layernorm_embedding", False)
    args.adaptive_softmax_cutoff = getattr(args, "adaptive_softmax_cutoff", None)
    args.adaptive_softmax_dropout = getattr(args, "adaptive_softmax_dropout", 0)
    args.no_cross_attention = getattr(args, "no_cross_attention", False)
    args.cross_self_attention = getattr(args, "cross_self_attention", False)
    args.quant_noise_pq = getattr(args, "quant_noise_pq", 0)
    args.quant_noise_pq_block_size = getattr(args, "quant_noise_pq_block_size", 8)
    args.quant_noise_scalar = getattr(args, "quant_noise_scalar", 0)


def transformer_iwslt_de_en(args):
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 512)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 1024)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 4)
    args.encoder_layers = getattr(args, "encoder_layers", 6)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 512)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 1024)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 4)
    args.decoder_layers = getattr(args, "decoder_layers", 6)
    base_architecture(args)


def transformer_vaswani_wmt_en_de_big(args):
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 1024)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 4096)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 16)
    args.encoder_normalize_before = getattr(args, "encoder_normalize_before", False)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 1024)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 4096)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 16)
    args.dropout = getattr(args, "dropout", 0.3)
    base_architecture(args)


def transformer_vaswani_wmt_en_fr_big(args):
    args.dropout = getattr(args, "dropout", 0.1)
    transformer_vaswani_wmt_en_de_big(args)


def transformer_wmt_en_de_big(args):
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    transformer_vaswani_wmt_en_de_big(args)


def transformer_wmt_en_de_big_t2t(args):
    args.encoder_normalize_before = getattr(args, "encoder_normalize_before", True)
    args.decoder_normalize_before = getattr(args, "decoder_normalize_before", True)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.relu_dropout = getattr(args, "relu_dropout", 0.1)
    transformer_vaswani_wmt_en_de_big(args)


ARCHITECTURES = {
    "transformer": base_architecture,
    "transformer_iwslt_de_en": transformer_iwslt_de_en,
    "transformer_wmt_en_de": base_architecture,
    "transformer_vaswani_wmt_en_de_big": transformer_vaswani_wmt_en_de_big,
    "transformer_vaswani_wmt_en_fr_big": transformer_vaswani_wmt_en_fr_big,
    "transformer_wmt_en_de_big": transformer_wmt_en_de_big,
    "transformer_wmt_en_de_big_t2t": transformer_wmt_en_de_big_t2t,
}

# read by the build beside the preset's options (the task's flags in JAX),
# with JAX's getattr fallbacks
_EXTRA = {"max_source_positions": 1024, "max_target_positions": 1024, "encoder_layerdrop": 0.0,
          "decoder_layerdrop": 0.0, "activation_fn": "relu"}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return {**_EXTRA, **vars(args)}


def apply_preset(arch: str, args) -> None:
    """``arch``'s preset on a parsed namespace, as JAX's registry applies it
    (the decoder's widths follow the given encoder's)."""
    ARCHITECTURES[arch](args)


def configs_from_args(args, tgt_dict, src_dict=None
                      ) -> Tuple[TransformerEncoderConfig, TransformerDecoderConfig, bool]:
    """JAX ``TransformerModel.build_model`` (:175-253) on a namespace the
    preset has filled: the two configs and ``share_all_embeddings``."""
    src_dict = tgt_dict if src_dict is None else src_dict
    share_all = getattr(args, "share_all_embeddings", False)
    if share_all:
        if src_dict is not tgt_dict and getattr(src_dict, "symbols", None) != getattr(tgt_dict, "symbols", None):
            raise ValueError("--share-all-embeddings requires a joined dictionary")
        if args.encoder_embed_dim != args.decoder_embed_dim:
            raise ValueError("--share-all-embeddings requires --encoder-embed-dim to match --decoder-embed-dim")
    common = dict(dropout=args.dropout, attention_dropout=args.attention_dropout,
                  activation_dropout=getattr(args, "relu_dropout", 0.0),
                  activation=getattr(args, "activation_fn", "relu"),
                  no_scale_embedding=getattr(args, "no_scale_embedding", False),
                  layernorm_embedding=getattr(args, "layernorm_embedding", False),
                  no_token_positional_embeddings=args.no_token_positional_embeddings,
                  quant_noise_pq=getattr(args, "quant_noise_pq", 0) or 0.0,
                  quant_noise_block=getattr(args, "quant_noise_pq_block_size", 8) or 8)
    encoder_cfg = TransformerEncoderConfig(
        vocab_size=len(src_dict), embed_dim=args.encoder_embed_dim, ffn_dim=args.encoder_ffn_embed_dim,
        layers=args.encoder_layers, heads=args.encoder_attention_heads,
        normalize_before=args.encoder_normalize_before, learned_pos=args.encoder_learned_pos,
        max_positions=getattr(args, "max_source_positions", 1024), padding_idx=src_dict.pad(),
        layerdrop=getattr(args, "encoder_layerdrop", 0.0) or 0.0, **common)
    decoder_cfg = TransformerDecoderConfig(
        vocab_size=len(tgt_dict), embed_dim=args.decoder_embed_dim, ffn_dim=args.decoder_ffn_embed_dim,
        layers=args.decoder_layers, heads=args.decoder_attention_heads,
        normalize_before=args.decoder_normalize_before, learned_pos=args.decoder_learned_pos,
        max_positions=getattr(args, "max_target_positions", 1024), padding_idx=tgt_dict.pad(),
        share_input_output_embed=share_all or getattr(args, "share_decoder_input_output_embed", False),
        layerdrop=getattr(args, "decoder_layerdrop", 0.0) or 0.0,
        no_encoder_attn=getattr(args, "no_cross_attention", False),
        cross_self_attention=getattr(args, "cross_self_attention", False), **common)
    return encoder_cfg, decoder_cfg, share_all


def namespace(arch: str, preset, known: Dict[str, Any], overrides: Dict[str, Any]) -> SimpleNamespace:
    """``overrides`` (options among ``known``) with ``preset`` applied; the
    build reads what neither sets at JAX's fallbacks."""
    unknown = set(overrides) - set(known)
    if unknown:
        raise TypeError(f"unknown {arch} options: {sorted(unknown)}")
    args = SimpleNamespace(**overrides)
    preset(args)
    return args


def configs(arch: str, tgt_dict, src_dict=None, **overrides):
    """The encoder and decoder configs of ``arch`` with ``overrides`` and
    ``share_all_embeddings``."""
    return configs_from_args(namespace(arch, ARCHITECTURES[arch], defaults(arch), overrides), tgt_dict, src_dict)


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> TransformerModel:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``."""
    device = resolve_device(device)
    model = TransformerModel(*configs(arch, tgt_dict, src_dict, **overrides))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
