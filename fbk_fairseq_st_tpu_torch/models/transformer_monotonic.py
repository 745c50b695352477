"""Simultaneous translation: the monotonic-attention transformers.

Counterpart of ``fbk_fairseq_st_tpu/models/transformer_monotonic.py``
(reference examples/simultaneous_translation/models/
transformer_monotonic_attention.py:35-360, modules/
monotonic_transformer_layer.py:16-57):

  * ``transformer_unidirectional``: the text transformer whose encoder
    self-attention is causal (a source position sees its prefix only),
    the streaming encoder's baseline;
  * ``transformer_monotonic`` (MMA): that encoder, and a decoder whose
    cross-attention is monotonic multihead attention
    (``ops/monotonic_attention.py``; ``--simul-type hard_aligned`` /
    ``infinite_lookback`` / ``waitk``). Its forward returns each layer's
    {alpha, beta, p_choose} in ``extra["attn_list"]`` for the
    latency-augmented criterion, and the source pad mask under
    ``encoder_padding_mask``.

Both self-attentions are causal and take the flash route of
``ops/attention.py`` (the kernels on the card); the monotonic
cross-attention is plain tensor ops. Neither stack takes LayerDrop and the
decoder layers no quant-noise, as in JAX. A source row whose causal prefix
is all padding (a left-padded batch) has no key: the flash route averages
the prefix's values, JAX's dense route all S (ROADMAP Queue C); such rows
reach the decoder only through beta, which is 0 at padded keys. The
monotonic models decode with the agent of
``generation/simultaneous_decoder.py`` (``cli/simul_eval``), not the beam
generator; the unidirectional one decodes with either.

Presets: ``transformer_monotonic``, ``transformer_monotonic_iwslt_de_en``,
``transformer_monotonic_vaswani_wmt_en_de_big``,
``transformer_monotonic_vaswani_wmt_en_fr_big``,
``transformer_unidirectional_iwslt_de_en``, and the bare
``transformer_unidirectional`` (JAX builds the model name with the base
preset). The reference's en_fr preset calls itself (an infinite recursion
upstream); as in JAX it means the core ``transformer_vaswani_wmt_en_fr_big``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import MultiheadAttention
from ..ops.core import GeneratorLike, LayerNorm, Linear, dropout, embedding, get_activation
from ..ops.monotonic_attention import MonotonicAttentionConfig, MonotonicMultiheadAttention
from ..ops.transformer_layer import TransformerLayerConfig
from . import transformer as tr
from .base import EncoderOut
from .transformer_decoder import TransformerDecoder


class MonotonicTransformerEncoder(tr.TransformerEncoder):
    """The encoder with causal self-attention (reference
    TransformerMonotonicEncoderLayer :16-22; JAX :59-96)."""

    def forward(self, src_tokens, src_lengths=None, generator: GeneratorLike = None,
                dtype: torch.dtype = torch.float32) -> EncoderOut:
        cfg = self.cfg
        x = self.embed_scale * embedding(self.embed_tokens.weight, src_tokens, dtype)
        if self.embed_positions is not None:
            x = x + self.embed_positions.from_ids(src_tokens, dtype)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = dropout(x, cfg.dropout, generator, self.training)
        padding_mask = src_tokens == cfg.padding_idx
        for layer in self.layers:
            x = layer(x, key_padding_mask=padding_mask, attn_mask="causal", generator=generator)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return EncoderOut(encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=src_lengths)


class MonotonicDecoderLayer(nn.Module):
    """A decoder layer whose cross-attention is MMA (reference
    TransformerMonotonicDecoderLayer :25-38; JAX ``monotonic_decoder_layer``
    :99-153): causal self-attention, MMA, FFN, each in its residual."""

    def __init__(self, cfg: TransformerLayerConfig, mono_cfg: MonotonicAttentionConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MultiheadAttention(cfg.self_attn_cfg)
        self.self_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.encoder_attn = MonotonicMultiheadAttention(mono_cfg)
        self.encoder_attn_layer_norm = LayerNorm(cfg.embed_dim)
        self.fc1 = Linear(cfg.embed_dim, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.embed_dim)
        self.final_layer_norm = LayerNorm(cfg.embed_dim)

    def init(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.init(generator)

    def _residual(self, ln, fn, x):
        residual = x
        if self.cfg.normalize_before:
            x = ln(x)
        x = residual + fn(x)
        return x if self.cfg.normalize_before else ln(x)

    def forward(self, x, encoder_out, encoder_padding_mask=None, self_attn_padding_mask=None,
                generator: GeneratorLike = None):
        """x (B, T, D) -> (x, {"alpha", "beta", "p_choose"})."""
        cfg = self.cfg
        training = self.training

        def self_block(h):
            h, _, _ = self.self_attn(h, key_padding_mask=self_attn_padding_mask, attn_mask="causal",
                                     generator=generator)
            return dropout(h, cfg.dropout, generator, training)

        extra = {}

        def cross_block(h):
            h, mma = self.encoder_attn(h, encoder_out, encoder_out, key_padding_mask=encoder_padding_mask,
                                       generator=generator)
            extra.update(mma)
            return dropout(h, cfg.dropout, generator, training)

        def ffn(h):
            h = get_activation(cfg.activation)(self.fc1(h))
            h = dropout(h, cfg.activation_dropout, generator, training)
            return dropout(self.fc2(h), cfg.dropout, generator, training)

        x = self._residual(self.self_attn_layer_norm, self_block, x)
        x = self._residual(self.encoder_attn_layer_norm, cross_block, x)
        x = self._residual(self.final_layer_norm, ffn, x)
        return x, extra


class MonotonicTransformerDecoder(TransformerDecoder):
    """The decoder over MMA layers; its ``extra`` carries ``attn_list``."""

    def __init__(self, cfg, mono_cfg: MonotonicAttentionConfig):
        self.mono_cfg = mono_cfg
        super().__init__(cfg)

    def _make_layer(self, cfg):
        return MonotonicDecoderLayer(cfg.layer_cfg, self.mono_cfg)

    def forward(self, prev_output_tokens, encoder_out, encoder_padding_mask=None, generator: GeneratorLike = None,
                features_only: bool = False, need_attn: bool = False, **unused):
        x = self._embed(prev_output_tokens, encoder_out.dtype, generator)
        self_kpm = prev_output_tokens == self.cfg.padding_idx
        attn_list = []
        for layer in self.layers:
            x, mma = layer(x, encoder_out, encoder_padding_mask, self_kpm, generator)
            attn_list.append(mma)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        extra = {"attn": None, "attn_list": attn_list, "encoder_padding_mask": encoder_padding_mask}
        return (x if features_only else self.output_layer(x)), extra

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError("a monotonic-attention model decodes with the simultaneous agent "
                                  "(cli/simul_eval, generation/simultaneous_decoder.py), not the beam generator")


class TransformerUnidirectionalModel(tr.TransformerModel):
    """The causal-encoder transformer (reference :35-39)."""

    def __init__(self, encoder_cfg, decoder_cfg, share_all_embeddings=False):
        super().__init__(encoder_cfg, decoder_cfg, share_all_embeddings,
                         encoder=MonotonicTransformerEncoder(encoder_cfg))


class TransformerMonotonicModel(tr.TransformerModel):
    """The MMA transformer (reference :42-135)."""

    def __init__(self, encoder_cfg, decoder_cfg, mono_cfg: MonotonicAttentionConfig, share_all_embeddings=False):
        super().__init__(encoder_cfg, decoder_cfg, share_all_embeddings,
                         encoder=MonotonicTransformerEncoder(encoder_cfg),
                         decoder=MonotonicTransformerDecoder(decoder_cfg, mono_cfg))
        self.mono_cfg = mono_cfg


def mono_cfg_from_args(args) -> MonotonicAttentionConfig:
    return MonotonicAttentionConfig(
        embed_dim=args.decoder_embed_dim, num_heads=args.decoder_attention_heads,
        simul_type=getattr(args, "simul_type", None) or "hard_aligned", dropout=args.attention_dropout,
        mass_preservation=getattr(args, "mass_preservation", True), noise_mean=getattr(args, "noise_mean", 0.0),
        noise_var=getattr(args, "noise_var", 1.0), energy_bias=getattr(args, "energy_bias", False),
        energy_bias_init=getattr(args, "energy_bias_init", -2.0), eps=getattr(args, "attention_eps", 1e-6),
        waitk_lagging=getattr(args, "waitk_lagging", 0) or 0)


def base_monotonic_architecture(args):
    tr.base_architecture(args)
    args.encoder_unidirectional = getattr(args, "encoder_unidirectional", False)


def transformer_monotonic_iwslt_de_en(args):
    tr.transformer_iwslt_de_en(args)
    base_monotonic_architecture(args)


ARCHITECTURES = {
    "transformer_monotonic": base_monotonic_architecture,
    "transformer_monotonic_iwslt_de_en": transformer_monotonic_iwslt_de_en,
    "transformer_monotonic_vaswani_wmt_en_de_big": tr.transformer_vaswani_wmt_en_de_big,
    "transformer_monotonic_vaswani_wmt_en_fr_big": tr.transformer_vaswani_wmt_en_fr_big,
    "transformer_unidirectional": tr.base_architecture,
    "transformer_unidirectional_iwslt_de_en": tr.transformer_iwslt_de_en,
}
# the monotonic attention's flags (JAX ``add_monotonic_args``) with their
# parser defaults, which the monotonic presets read
MONOTONIC_DEFAULTS = {"simul_type": None, "mass_preservation": True, "noise_var": 1.0, "noise_mean": 0.0,
                      "energy_bias": False, "energy_bias_init": -2.0, "attention_eps": 1e-6, "waitk_lagging": 0}


def is_monotonic(arch: str) -> bool:
    return arch.startswith("transformer_monotonic")


def defaults(arch: str) -> Dict[str, Any]:
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return {**tr._EXTRA, **(MONOTONIC_DEFAULTS if is_monotonic(arch) else {}), **vars(args)}


def apply_preset(arch: str, args) -> None:
    ARCHITECTURES[arch](args)


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None, seed: int = 0, train: bool = False,
                **overrides):
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None), in eval mode unless ``train``."""
    device = resolve_device(device)
    args = tr.namespace(arch, ARCHITECTURES[arch], defaults(arch), overrides)
    if is_monotonic(arch):
        # JAX's build_model applies the base monotonic preset over any
        base_monotonic_architecture(args)
        model = TransformerMonotonicModel(*tr.configs_from_args(args, tgt_dict, src_dict)[:2], mono_cfg_from_args(args),
                                          getattr(args, "share_all_embeddings", False))
    else:
        model = TransformerUnidirectionalModel(*tr.configs_from_args(args, tgt_dict, src_dict))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
