"""VGG-Transformer ASR models (the fork's examples/speech_recognition).

Counterpart of ``fbk_fairseq_st_tpu/models/vggtransformer.py``:

  * ``asr_vggtransformer`` (``VGGTransformerModel``): VGG blocks (conv x N
    + ReLU, with an optional LayerNorm over the frequency axis, then a
    ceil-mode max pool) -> transformer encoder layers configured one by
    one, a ``proj`` Linear wherever the widths change, an optional
    (left, right) context mask (``--transformer-context``) and per-layer
    frame subsampling (``--transformer-sampling``) -> ``fc_out`` +
    ``ln_out`` to ``--enc-output-dim``; the decoder embeds the tokens (no
    scale, no positions), runs a causal conv stack (left pad K - 1, the
    fork's ``LinearizedConvolution`` with its (K, C_in, C_out) kernel), then
    the transformer decoder layers and ``fc_out``;
  * ``asr_vggtransformer_encoder`` (``VGGTransformerEncoderModel``): the
    encoder and a vocabulary ``fc_out``, whose logits are both
    ``encoder_out`` and ``ctc_out`` (CTC training).

The port works in NCHW: a VGG block's map is (B, C, T, F), so its
LayerNorm normalises the last axis directly and the pool is
``F.max_pool2d(..., ceil_mode=True)`` (JAX pads with ``NEG_INF`` to a
multiple of the pool). A call with a context mask takes the dense
attention route, as JAX's ``mha`` does with an additive mask; the rest
take the flash route on the card.

Incremental decoding keeps each conv's last K - 1 input frames next to the
layers' KV caches; ``reorder_cache`` gathers both with the beams.

The five presets are JAX's (:609-702). The ``asr_vggtransformer`` preset
itself gives a 512-wide encoder output and 256-wide decoder layers: JAX's
``TransformerLayerConfig`` has no key dim for the cross-attention, so JAX
cannot run it, and the port raises on any such width mismatch (ROADMAP
Queue C, JAX side).
"""

from __future__ import annotations

import ast
import math
import re
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.core import NEG_INF, ConvTBC, GeneratorLike, LayerNorm, Linear, embedding, lengths_to_padding_mask, normal_
from ..ops.transformer_layer import (TransformerDecoderLayer, TransformerEncoderLayer, TransformerLayerConfig,
                                     init_decoder_layer_cache)
from .base import EncoderOut

DEFAULT_ENC_VGGBLOCK_CONFIG = ((32, 3, 2, 2, False),) * 2
DEFAULT_ENC_TRANSFORMER_CONFIG = ((256, 4, 1024, True, 0.2, 0.2, 0.2),) * 2
DEFAULT_DEC_TRANSFORMER_CONFIG = ((256, 2, 1024, True, 0.2, 0.2, 0.2),) * 2
DEFAULT_DEC_CONV_CONFIG = ((256, 3, True),) * 2


def parse_config(expr, default):
    """An EXPR option ('[(...), ...]', '((...),) * N') -> a tuple; None ->
    ``default``; a tuple or list as it is."""
    if expr is None:
        return default
    if not isinstance(expr, str):
        return tuple(expr)
    try:
        return tuple(ast.literal_eval(expr))
    except ValueError:
        m = re.match(r"^\s*(\[.*\]|\(.*\))\s*\*\s*(\d+)\s*$", expr)
        if not m:
            raise
        return tuple(ast.literal_eval(m.group(1)) * int(m.group(2)))


def layer_cfg(cfg_tuple) -> TransformerLayerConfig:
    """'(dim, heads, ffn, normalize_before, dropout, attention_dropout,
    relu_dropout)' -> the layer's config."""
    d, heads, ffn, norm_before, drop, attn_drop, relu_drop = cfg_tuple
    return TransformerLayerConfig(embed_dim=d, ffn_dim=ffn, num_heads=heads, dropout=drop,
                                  attention_dropout=attn_drop, activation_dropout=relu_drop,
                                  normalize_before=norm_before)


def _ceil_div(t: int, k: int) -> int:
    return -(-t // k)


# ---------------------------------------------------------------------------
# VGG block
# ---------------------------------------------------------------------------

class VGGBlockSpec(NamedTuple):
    out_channels: int
    conv_kernel_size: int
    pooling_kernel_size: int
    num_conv_layers: int
    layer_norm: bool


class VGGBlock(nn.Module):
    """(B, C_in, T, F) -> (B, C_out, ceil(T / pool), ceil(F / pool))."""

    def __init__(self, spec: VGGBlockSpec, in_channels: int, input_dim: int):
        super().__init__()
        self.spec = spec
        k = spec.conv_kernel_size
        chans = [in_channels] + [spec.out_channels] * spec.num_conv_layers
        self.convolutions = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], k, padding=k // 2)
                                          for i in range(spec.num_conv_layers))
        if spec.layer_norm:
            self.lns = nn.ModuleList(LayerNorm(input_dim) for _ in range(spec.num_conv_layers))

    def init(self, generator: torch.Generator) -> None:
        for conv in self.convolutions:
            k = self.spec.conv_kernel_size
            normal_(conv.weight, generator, math.sqrt(2.0 / (k * k * conv.in_channels)))
            nn.init.zeros_(conv.bias)

    def forward(self, x):
        for i, conv in enumerate(self.convolutions):
            x = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=conv.padding)
            if self.spec.layer_norm:
                x = self.lns[i](x)  # over F, the last axis
            x = F.relu(x)
        pk = self.spec.pooling_kernel_size
        if pk > 1:
            x = F.max_pool2d(x, pk, stride=pk, ceil_mode=True)
        return x


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class VGGTransformerEncoderConfig(NamedTuple):
    input_feat_per_channel: int = 40
    vggblock_config: Tuple = DEFAULT_ENC_VGGBLOCK_CONFIG
    transformer_config: Tuple = DEFAULT_ENC_TRANSFORMER_CONFIG
    encoder_output_dim: int = 512
    in_channels: int = 1
    transformer_context: Optional[Tuple[int, int]] = None
    transformer_sampling: Optional[Tuple[int, ...]] = None


class VGGTransformerEncoder(nn.Module):
    def __init__(self, cfg: VGGTransformerEncoderConfig):
        super().__init__()
        self.cfg = cfg
        blocks, c, f = [], cfg.in_channels, cfg.input_feat_per_channel
        for spec in (VGGBlockSpec(*b) for b in cfg.vggblock_config or ()):
            blocks.append(VGGBlock(spec, c, f))
            c, f = spec.out_channels, _ceil_div(f, spec.pooling_kernel_size)
        self.vgg = nn.ModuleList(blocks)
        self.conv_out_dim = f * c
        self.sampling = cfg.transformer_sampling or tuple(1 for _ in cfg.transformer_config)
        if len(self.sampling) != len(cfg.transformer_config):
            raise ValueError("--transformer-sampling needs one factor per encoder layer")
        proj, layers, prev = {}, [], self.conv_out_dim
        for i, tc in enumerate(cfg.transformer_config):
            if prev != tc[0]:
                proj[str(i)] = Linear(prev, tc[0])
            layers.append(TransformerEncoderLayer(layer_cfg(tc)))
            prev = tc[0]
        self.proj = nn.ModuleDict(proj)
        self.layers = nn.ModuleList(layers)
        self.fc_out = Linear(prev, cfg.encoder_output_dim)
        self.ln_out = LayerNorm(cfg.encoder_output_dim)

    def init(self, generator: torch.Generator) -> None:
        for m in (*self.vgg, *self.proj.values(), *self.layers, self.fc_out, self.ln_out):
            m.init(generator)

    def context_mask(self, t: int, subsampling_factor: int, device):
        """The (left, right) context mask (T, T), additive: contexts count
        input frames, divided by the conv subsampling and ceil'd; the right
        edge's start is clamped to the last column (JAX :210-229)."""
        ctx = self.cfg.transformer_context
        if ctx is None:
            return None
        left, right = ctx
        q = torch.arange(t, device=device)[:, None]
        k = torch.arange(t, device=device)[None, :]
        mask = torch.zeros((t, t), dtype=torch.float32, device=device)
        if left is not None and left >= 0:
            mask = torch.where(k < q - math.ceil(left / subsampling_factor), NEG_INF, mask)
        if right is not None and right >= 0:
            start = torch.clamp(q + math.ceil(right / subsampling_factor) + 1, max=t - 1)
            mask = torch.where(k >= start, NEG_INF, mask)
        return mask

    def forward(self, src_tokens, src_lengths, generator: GeneratorLike = None) -> EncoderOut:
        """src_tokens (B, T, C_in * F) -> EncoderOut (batch-first)."""
        cfg = self.cfg
        b, t_in, _ = src_tokens.shape
        x = src_tokens.reshape(b, t_in, cfg.in_channels, cfg.input_feat_per_channel).transpose(1, 2)
        for block in self.vgg:
            x = block(x)
        _, c, t, f = x.shape
        x = x.transpose(1, 2).reshape(b, t, c * f)  # channels-major, the reference's view order
        subsampling_factor = int(t_in * 1.0 / t + 0.5)
        lengths = torch.ceil(src_lengths.float() / subsampling_factor).long()
        padding_mask = lengths_to_padding_mask(lengths, t)
        attn_mask = self.context_mask(t, subsampling_factor, x.device)
        for i, layer in enumerate(self.layers):
            if str(i) in self.proj:
                x = self.proj[str(i)](x)
            x = layer(x, key_padding_mask=padding_mask, attn_mask=attn_mask, generator=generator)
            k = self.sampling[i]
            if k != 1:
                x = x[:, ::k]
                lengths = torch.ceil(lengths.float() / k).long()
                padding_mask = lengths_to_padding_mask(lengths, x.shape[1])
                if attn_mask is not None:
                    attn_mask = attn_mask[::k, ::k]
        x = self.ln_out(self.fc_out(x))
        return EncoderOut(encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=lengths)


# ---------------------------------------------------------------------------
# Conv + transformer decoder
# ---------------------------------------------------------------------------

class VGGTransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, padding_idx: int, embed_dim: int, transformer_config: Tuple,
                 conv_config: Tuple, max_positions: int = 1024):
        super().__init__()
        self.padding_idx = padding_idx
        self.transformer_config = transformer_config
        self.conv_config = conv_config
        self.max_positions = max_positions
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim, padding_idx)
        convs, lns, c_in = [], {}, embed_dim
        for i, (c_out, k, ln) in enumerate(conv_config):
            convs.append(ConvTBC(c_in, c_out, k))
            if ln:
                lns[str(i)] = LayerNorm(c_out)
            c_in = c_out
        self.convolutions = nn.ModuleList(convs)
        self.conv_lns = nn.ModuleDict(lns)
        proj, layers, prev = {}, [], c_in
        for i, tc in enumerate(transformer_config):
            if prev != tc[0]:
                proj[str(i)] = Linear(prev, tc[0])
            layers.append(TransformerDecoderLayer(layer_cfg(tc)))
            prev = tc[0]
        self.proj = nn.ModuleDict(proj)
        self.layers = nn.ModuleList(layers)
        self.fc_out = Linear(prev, vocab_size)

    def init(self, generator: torch.Generator) -> None:
        dim = self.embed_tokens.embedding_dim
        normal_(self.embed_tokens.weight, generator, dim ** -0.5)
        with torch.no_grad():
            self.embed_tokens.weight[self.padding_idx] = 0.0
        c_in = dim
        for conv, (c_out, k, _) in zip(self.convolutions, self.conv_config):
            conv.init(generator, math.sqrt(4.0 / (k * c_in)))
            c_in = c_out
        for m in (*self.conv_lns.values(), *self.proj.values(), *self.layers, self.fc_out):
            m.init(generator)

    def _post_conv(self, i: int, x):
        if str(i) in self.conv_lns:
            x = self.conv_lns[str(i)](x)
        return F.relu(x)

    def forward(self, prev_output_tokens, encoder_out=None, encoder_padding_mask=None,
                generator: GeneratorLike = None, features_only: bool = False):
        """Teacher forcing: (B, T) -> (logits (B, T, V), {"attn": None})."""
        dtype = encoder_out.dtype if encoder_out is not None else torch.float32
        x = embedding(self.embed_tokens.weight, prev_output_tokens, dtype)
        for i, (conv, (_, k, _)) in enumerate(zip(self.convolutions, self.conv_config)):
            x = self._post_conv(i, conv(x, (k - 1, 0)))
        self_kpm = prev_output_tokens == self.padding_idx
        for i, layer in enumerate(self.layers):
            if str(i) in self.proj:
                x = self.proj[str(i)](x)
            x = layer(x, encoder_out=encoder_out, encoder_padding_mask=encoder_padding_mask,
                      self_attn_mask="causal", self_attn_padding_mask=self_kpm, generator=generator)
        return (x if features_only else self.fc_out(x)), {"attn": None}

    def init_cache(self, batch: int, max_len: int, encoder_out, dtype=torch.float32) -> Dict[str, List[Any]]:
        """Each conv's last K - 1 input frames (zeros: the causal padding)
        and each layer's self and cross K/V."""
        convs, c_in = [], self.embed_tokens.embedding_dim
        for c_out, k, _ in self.conv_config:
            convs.append(torch.zeros((batch, k - 1, c_in), dtype=dtype, device=encoder_out.device))
            c_in = c_out
        layers = [init_decoder_layer_cache(layer, batch, max_len, encoder_out, dtype) for layer in self.layers]
        return {"convs": convs, "layers": layers}

    def step(self, tokens, cache, step_index: int, encoder_padding_mask=None):
        """tokens (B, 1) -> logits (B, V); the caches are updated in place."""
        x = embedding(self.embed_tokens.weight, tokens, cache["layers"][0]["self"]["k"].dtype)
        for i, conv in enumerate(self.convolutions):
            window = torch.cat([cache["convs"][i], x], dim=1)
            cache["convs"][i] = window[:, 1:]
            x = self._post_conv(i, conv.step(window)[:, None, :])
        for i, (layer, lc) in enumerate(zip(self.layers, cache["layers"])):
            if str(i) in self.proj:
                x = self.proj[str(i)](x)
            x = layer(x, encoder_padding_mask=encoder_padding_mask, cache=lc, cache_index=step_index)
        return self.fc_out(x)[:, 0, :]

    def reorder_cache(self, cache, order) -> None:
        """Gather the conv frames and the self K/V by ``order``; the cross
        K/V stay (a beam reorder permutes rows within a sentence)."""
        cache["convs"] = [buf.index_select(0, order) for buf in cache["convs"]]
        for lc in cache["layers"]:
            lc["self"]["k"] = lc["self"]["k"].index_select(0, order)
            lc["self"]["v"] = lc["self"]["v"].index_select(0, order)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

class VGGTransformerModel(nn.Module):
    def __init__(self, enc_cfg: VGGTransformerEncoderConfig, decoder: VGGTransformerDecoder):
        super().__init__()
        self.encoder_cfg = enc_cfg
        self.encoder = VGGTransformerEncoder(enc_cfg)
        self.decoder = decoder
        self.max_source_positions = 6000
        self.max_target_positions = decoder.max_positions

    def init(self, generator: torch.Generator) -> "VGGTransformerModel":
        self.encoder.init(generator)
        self.decoder.init(generator)
        return self

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None) -> EncoderOut:
        return self.encoder(src_tokens, src_lengths, generator)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator)
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


class VGGTransformerEncoderModel(nn.Module):
    """The encoder-only CTC model (reference :714-880)."""

    def __init__(self, enc_cfg: VGGTransformerEncoderConfig, vocab_size: int):
        super().__init__()
        self.encoder_cfg = enc_cfg
        self.encoder = VGGTransformerEncoder(enc_cfg)
        # the vocabulary projection on the encoder output (reference
        # VGGTransformerEncoderOnly.fc_out, :826)
        self.fc_out = Linear(enc_cfg.encoder_output_dim, vocab_size)
        self.max_source_positions = 6000
        self.max_target_positions = 1024

    def init(self, generator: torch.Generator) -> "VGGTransformerEncoderModel":
        self.encoder.init(generator)
        self.fc_out.init(generator)
        return self

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None) -> EncoderOut:
        enc = self.encoder(src_tokens, src_lengths, generator)
        logits = self.fc_out(enc.encoder_out)
        # the vocabulary logits ARE the CTC stream and the encoder output
        return enc._replace(encoder_out=logits, ctc_out=logits, ctc_padding_mask=enc.encoder_padding_mask,
                            ctc_lengths=enc.src_lengths)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        enc = self.encode(batch["src_tokens"], batch["src_lengths"], generator)
        return enc.encoder_out, {"encoder_out": enc}


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

def base_architecture(args):
    """``asr_vggtransformer`` (JAX :609-624)."""
    args.input_feat_per_channel = getattr(args, "input_feat_per_channel", 40)
    args.vggblock_enc_config = getattr(args, "vggblock_enc_config", DEFAULT_ENC_VGGBLOCK_CONFIG)
    args.transformer_enc_config = getattr(args, "transformer_enc_config", DEFAULT_ENC_TRANSFORMER_CONFIG)
    args.enc_output_dim = getattr(args, "enc_output_dim", 512)
    args.in_channels = getattr(args, "in_channels", 1)
    args.tgt_embed_dim = getattr(args, "tgt_embed_dim", 128)
    args.transformer_dec_config = getattr(args, "transformer_dec_config", DEFAULT_ENC_TRANSFORMER_CONFIG)
    args.conv_dec_config = getattr(args, "conv_dec_config", DEFAULT_DEC_CONV_CONFIG)
    args.transformer_context = getattr(args, "transformer_context", None)
    args.transformer_sampling = getattr(args, "transformer_sampling", None)


def _preset(feat, enc_layers, enc_dim, tgt_embed, dec_layers):
    layer = "(({0}, {1}, {2}, True, 0.15, 0.15, 0.15),) * {3}"
    heads, ffn = (16, 4096) if enc_dim == 1024 else (8, 2048)

    def arch(args):
        args.input_feat_per_channel = getattr(args, "input_feat_per_channel", feat)
        args.vggblock_enc_config = getattr(args, "vggblock_enc_config",
                                           "[(64, 3, 2, 2, True), (128, 3, 2, 2, True)]")
        args.transformer_enc_config = getattr(args, "transformer_enc_config",
                                              layer.format(enc_dim, heads, ffn, enc_layers))
        args.enc_output_dim = getattr(args, "enc_output_dim", enc_dim)
        args.tgt_embed_dim = getattr(args, "tgt_embed_dim", tgt_embed)
        args.conv_dec_config = getattr(args, "conv_dec_config", "((256, 3, True),) * 4")
        args.transformer_dec_config = getattr(args, "transformer_dec_config",
                                              layer.format(enc_dim, heads, ffn, dec_layers))
        base_architecture(args)

    return arch


def vggtransformer_enc_1(args):
    """``vggtransformer_enc_1`` (JAX :688-702)."""
    args.input_feat_per_channel = getattr(args, "input_feat_per_channel", 80)
    args.vggblock_enc_config = getattr(args, "vggblock_enc_config", "[(64, 3, 2, 2, True), (128, 3, 2, 2, True)]")
    args.transformer_enc_config = getattr(args, "transformer_enc_config",
                                          "((1024, 16, 4096, True, 0.15, 0.15, 0.15),) * 16")
    args.enc_output_dim = getattr(args, "enc_output_dim", 1024)
    args.in_channels = getattr(args, "in_channels", 1)
    args.transformer_context = getattr(args, "transformer_context", None)
    args.transformer_sampling = getattr(args, "transformer_sampling", None)


ARCHITECTURES = {
    "asr_vggtransformer": base_architecture,
    "vggtransformer_1": _preset(80, 14, 1024, 128, 4),  # JAX :627-644
    "vggtransformer_2": _preset(80, 16, 1024, 512, 6),  # JAX :647-664
    "vggtransformer_base": _preset(80, 12, 512, 512, 6),  # JAX :667-685
    "vggtransformer_enc_1": vggtransformer_enc_1,
    # JAX takes a bare model name as --arch: the model's build applies its preset
    "asr_vggtransformer_encoder": vggtransformer_enc_1,
}
ENCODER_ONLY = ("vggtransformer_enc_1", "asr_vggtransformer_encoder")


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return vars(args)


def apply_preset(arch: str, args) -> None:
    ARCHITECTURES[arch](args)


def encoder_config(args) -> VGGTransformerEncoderConfig:
    return VGGTransformerEncoderConfig(
        input_feat_per_channel=args.input_feat_per_channel,
        vggblock_config=parse_config(args.vggblock_enc_config, DEFAULT_ENC_VGGBLOCK_CONFIG),
        transformer_config=parse_config(args.transformer_enc_config, DEFAULT_ENC_TRANSFORMER_CONFIG),
        encoder_output_dim=args.enc_output_dim,
        in_channels=args.in_channels,
        transformer_context=parse_config(args.transformer_context, None),
        transformer_sampling=parse_config(args.transformer_sampling, None),
    )


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None, seed: int = 0,
                train: bool = False, **overrides) -> nn.Module:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``."""
    unknown = set(overrides) - set(defaults(arch))
    if unknown:
        raise TypeError(f"unknown vggtransformer options: {sorted(unknown)}")
    device = resolve_device(device)
    args = SimpleNamespace(**overrides)
    ARCHITECTURES[arch](args)
    enc_cfg = encoder_config(args)
    if arch in ENCODER_ONLY:
        model = VGGTransformerEncoderModel(enc_cfg, len(tgt_dict))
    else:
        dec_cfg = parse_config(args.transformer_dec_config, DEFAULT_DEC_TRANSFORMER_CONFIG)
        widths = sorted({tc[0] for tc in dec_cfg} - {enc_cfg.encoder_output_dim})
        if widths:
            raise ValueError(
                f"--arch {arch}: the encoder output is {enc_cfg.encoder_output_dim} wide and decoder layers are "
                f"{widths} wide; the cross-attention has no key dim, so JAX cannot run this configuration "
                "either (ROADMAP Queue C, JAX side): give --enc-output-dim the decoder layers' width")
        decoder = VGGTransformerDecoder(len(tgt_dict), tgt_dict.pad(), args.tgt_embed_dim, dec_cfg,
                                        parse_config(args.conv_dec_config, DEFAULT_DEC_CONV_CONFIG))
        model = VGGTransformerModel(enc_cfg, decoder)
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
