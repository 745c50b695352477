"""conv_transformer — the speech-translation backbone.

Counterpart of ``fbk_fairseq_st_tpu/models/conv_transformer.py``: fbank
(B, T, F) -> strided Conv2d stack (+BatchNorm, activation before BN,
dropout >= .1) -> two ConvAttention2D residual blocks -> channels-major
flatten -> fc3 + activation -> audio positions (padding_idx 0) -> N
transformer encoder layers (optional distance penalties) -> final LayerNorm,
with the CTC head (``ctc_fc``) and the EACL-2021 CTC compression after encoder
layer ``ctc_encoder_layer`` (``ops/ctc.py``); the decoder is the shared
TransformerDecoder.

The arch presets ``conv_transformer`` / ``_big`` / ``_big2`` / ``_giant``
are plain functions returning the reference defaults; ``build_model`` takes
an arch name, the target dictionary and overrides named as the JAX
package's command-line args (``encoder_layers=2``, ...).

With ``ctc_compress_out`` the layers after the CTC layer run on the
compressed states: the row count stays T' and the key padding mask is
rebuilt from the compressed lengths (JAX :166-175), so no length is read
on the host.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.conv_frontend import ConvFrontend, ConvFrontendConfig, conv_frontend
from ..ops.core import GeneratorLike, LayerNorm, Linear, dropout, get_activation, lengths_to_padding_mask
from ..ops.ctc import ctc_compress
from ..ops.positional import PositionalEmbedding
from ..ops.transformer_layer import TransformerEncoderLayer, TransformerLayerConfig
from .base import EncoderOut
from .transformer_decoder import TransformerDecoder, TransformerDecoderConfig


class ConvTransformerEncoderConfig(NamedTuple):
    frontend: ConvFrontendConfig
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
    max_positions: int = 2048
    no_token_positional_embeddings: bool = False
    layernorm_embedding: bool = False
    distance_penalty: Optional[str] = None  # 'log' | 'gauss'
    init_variance: float = 1.0
    ctc_out_enabled: bool = False
    ctc_compress_out: bool = False
    ctc_encoder_layer: int = 4
    ctc_compress_strategy: str = "avg"
    ctc_vocab_size: int = 0

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
            distance_penalty=self.distance_penalty,
            init_variance=self.init_variance,
        )


class ConvTransformerEncoder(ConvFrontend):
    """The frontend's modules (``convolutions``, ``bn``, ``attn_2d``) sit at
    the encoder's root, as in the fork's state_dict."""

    def __init__(self, cfg: ConvTransformerEncoderConfig):
        super().__init__(cfg.frontend)
        self.cfg = cfg
        self.fc3 = Linear(cfg.frontend.flat_dim, cfg.embed_dim)
        # audio positions use padding_idx=0 (reference conv_transformer.py:229)
        self.embed_positions = (
            None if cfg.no_token_positional_embeddings
            else PositionalEmbedding(cfg.max_positions, cfg.embed_dim, 0, cfg.learned_pos)
        )
        self.layers = nn.ModuleList(TransformerEncoderLayer(cfg.layer_cfg) for _ in range(cfg.layers))
        self.layer_norm = LayerNorm(cfg.embed_dim) if cfg.normalize_before else None
        self.layernorm_embedding = LayerNorm(cfg.embed_dim) if cfg.layernorm_embedding else None
        self.ctc_fc = Linear(cfg.embed_dim, cfg.ctc_vocab_size) if cfg.ctc_out_enabled else None

    def init(self, generator: torch.Generator) -> None:
        super().init(generator)
        self.fc3.init(generator)
        for layer in self.layers:
            layer.init(generator)
        for m in (self.embed_positions, self.layer_norm, self.layernorm_embedding, self.ctc_fc):
            if m is not None:
                m.init(generator)

    def forward(self, src_tokens, src_lengths, generator: GeneratorLike = None
                ) -> EncoderOut:
        """src_tokens: (B, T, F) fbank frames; src_lengths: (B,)."""
        cfg = self.cfg
        x, lengths, padding_mask = self.embed(src_tokens, src_lengths, generator)
        ctc_out = ctc_padding_mask = ctc_lengths = None
        for i, layer in enumerate(self.layers):
            x = layer(x, key_padding_mask=padding_mask, generator=generator)
            if self.ctc_fc is not None and cfg.ctc_encoder_layer == i + 1:
                ctc_out = self.ctc_fc(x)
                ctc_padding_mask, ctc_lengths = padding_mask, lengths
                if cfg.ctc_compress_out:
                    x, lengths = ctc_compress(x, ctc_out, lengths, cfg.ctc_compress_strategy)
                    padding_mask = lengths_to_padding_mask(lengths, x.shape[1])
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return EncoderOut(
            encoder_out=x,
            encoder_padding_mask=padding_mask,
            src_lengths=lengths,
            ctc_out=ctc_out,
            ctc_padding_mask=ctc_padding_mask,
            ctc_lengths=ctc_lengths,
        )

    def embed(self, src_tokens, src_lengths, generator: GeneratorLike = None):
        """The layers' input: the conv front end, fc3 and its activation,
        the audio positions and dropout. Returns (x (B, T', D), the
        lengths, the key padding mask)."""
        cfg = self.cfg
        x, lengths = conv_frontend(self, src_tokens, src_lengths, generator)
        x = get_activation(cfg.activation)(self.fc3(x))
        if self.embed_positions is not None:
            x = x + self.embed_positions.from_lengths(lengths, x.shape[1], x.dtype)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = dropout(x, cfg.dropout, generator, self.training)
        return x, lengths, lengths_to_padding_mask(lengths, x.shape[1])

    def ctc_features(self, encoder_states_at_layer):
        """CTC logits from layer-k states (JAX :192)."""
        return self.ctc_fc(encoder_states_at_layer)


class ConvolutionalTransformerModel(nn.Module):
    decoder_class = TransformerDecoder

    def __init__(self, encoder_cfg: ConvTransformerEncoderConfig,
                 decoder_cfg: TransformerDecoderConfig):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.decoder_cfg = decoder_cfg
        self.encoder = ConvTransformerEncoder(encoder_cfg)
        self.decoder = self.decoder_class(decoder_cfg)
        self.max_source_positions = encoder_cfg.max_positions
        self.max_target_positions = decoder_cfg.max_positions

    def init(self, generator: torch.Generator) -> "ConvolutionalTransformerModel":
        """Seeded re-initialisation with the reference's distributions
        (draws on ``generator``, a CPU generator)."""
        self.encoder.init(generator)
        self.decoder.init(generator)
        return self

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None
               ) -> EncoderOut:
        return self.encoder(src_tokens, src_lengths, generator)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens (B, T, F), src_lengths, prev_output_tokens.
        Returns (logits (B, T_tgt, V), extra) with the EncoderOut in extra."""
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator)
        logits, extra = self.decoder(
            batch["prev_output_tokens"],
            encoder_out=encoder_out.encoder_out,
            encoder_padding_mask=encoder_out.encoder_padding_mask,
            generator=generator,
        )
        extra["encoder_out"] = encoder_out
        return logits, extra

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32):
        return self.decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        return self.decoder.step(
            tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask
        )

    def reorder_cache(self, cache, order) -> None:
        self.decoder.reorder_cache(cache, order)


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

def _base_defaults(enc_dim: int, ffn_dim: int, heads: int) -> Dict[str, Any]:
    """Reference conv_transformer.py:429-466 defaults, plus the JAX
    ``configs_from_args`` fallbacks, under the JAX package's arg names."""
    return dict(
        dropout=0.3,
        attention_dropout=0.1,
        relu_dropout=0.1,
        activation_fn="relu",
        no_attn_2d=False,
        no_token_positional_embeddings=False,
        share_decoder_input_output_embed=False,
        encoder_embed_dim=enc_dim,
        encoder_convolutions="[(64, 3, 3)] * 2",
        encoder_layers=6,
        encoder_ffn_embed_dim=ffn_dim,
        encoder_attention_heads=heads,
        encoder_learned_pos=False,
        encoder_normalize_before=True,
        distance_penalty=False,
        init_variance=1.0,
        decoder_embed_dim=enc_dim,
        decoder_layers=6,
        decoder_ffn_embed_dim=ffn_dim,
        decoder_attention_heads=heads,
        decoder_learned_pos=False,
        decoder_normalize_before=True,
        no_scale_embedding=False,
        layernorm_embedding=False,
        input_feat_per_channel=40,
        max_source_positions=2048,
        max_target_positions=1024,
        ctc_compress_out=False,
        ctc_encoder_layer=4,
        ctc_compress_strategy="avg",
        criterion=None,
        adaptive_softmax_cutoff=None,
        adaptive_input=False,
    )


# The reference arch's --adaptive-softmax-cutoff and --adaptive-input are
# options of the preset that JAX's conv_transformer never reads (ROADMAP
# Queue C, JAX side): taken and ignored here too.


def conv_transformer() -> Dict[str, Any]:
    """reference conv_transformer.py:429-466 (256/768/4)."""
    return _base_defaults(256, 768, 4)


def conv_transformer_big() -> Dict[str, Any]:
    """reference conv_transformer.py:469-505 (512/1024/8)."""
    return _base_defaults(512, 1024, 8)


def conv_transformer_big2() -> Dict[str, Any]:
    """reference conv_transformer.py:508-529 (512/2048/8)."""
    return _base_defaults(512, 2048, 8)


def conv_transformer_giant() -> Dict[str, Any]:
    """reference conv_transformer.py:532-553 (1024/4096/16)."""
    return _base_defaults(1024, 4096, 16)


ARCHITECTURES = {
    "conv_transformer": conv_transformer,
    "conv_transformer_big": conv_transformer_big,
    "conv_transformer_big2": conv_transformer_big2,
    "conv_transformer_giant": conv_transformer_giant,
}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    return ARCHITECTURES[arch]()


def _parse_convolutions(expr: Optional[str]) -> Tuple[Tuple[int, int, int], ...]:
    """Parse the reference's '[(64, 3, 3)] * 2' EXPR ((dim, k) -> (dim, k, k))."""
    if expr is None:
        return ((512, 3, 3), (512, 3, 3))
    try:
        spec = ast.literal_eval(expr)
    except ValueError:
        m = re.match(r"^\s*(\[.*\])\s*\*\s*(\d+)\s*$", expr)
        if not m:
            raise ValueError(f"cannot parse --encoder-convolutions {expr!r}")
        spec = ast.literal_eval(m.group(1)) * int(m.group(2))
    out = []
    for item in spec:
        if len(item) == 2:
            out.append((item[0], item[1], item[1]))
        elif len(item) == 3:
            out.append(tuple(item))
        else:
            raise ValueError(f"invalid conv spec: {item}")
    return tuple(out)


def configs(arch: str, tgt_dict, src_dict=None, **overrides
            ) -> Tuple[ConvTransformerEncoderConfig, TransformerDecoderConfig]:
    """Encoder and decoder configs of ``arch`` with ``overrides`` applied
    (the JAX ``configs_from_args`` mapping)."""
    return configs_from(ARCHITECTURES[arch](), tgt_dict, src_dict, **overrides)


def configs_from(args: Dict[str, Any], tgt_dict, src_dict=None, **overrides
                 ) -> Tuple[ConvTransformerEncoderConfig, TransformerDecoderConfig]:
    """``configs`` from a preset's options ``args`` (which it updates)."""
    unknown = set(overrides) - set(args)
    if unknown:
        raise TypeError(f"unknown conv_transformer options: {sorted(unknown)}")
    args.update(overrides)
    frontend = ConvFrontendConfig(
        convolutions=_parse_convolutions(args["encoder_convolutions"]),
        audio_features=args["input_feat_per_channel"],
        dropout=args["dropout"],
        activation=args["activation_fn"],
        attn_2d=not args["no_attn_2d"],
    )
    distance_penalty = args["distance_penalty"] or None
    if distance_penalty is True:
        distance_penalty = "log"
    encoder_cfg = ConvTransformerEncoderConfig(
        frontend=frontend,
        embed_dim=args["encoder_embed_dim"],
        ffn_dim=args["encoder_ffn_embed_dim"],
        layers=args["encoder_layers"],
        heads=args["encoder_attention_heads"],
        dropout=args["dropout"],
        attention_dropout=args["attention_dropout"],
        activation_dropout=args["relu_dropout"],
        activation=args["activation_fn"],
        normalize_before=args["encoder_normalize_before"],
        learned_pos=args["encoder_learned_pos"],
        max_positions=args["max_source_positions"],
        no_token_positional_embeddings=args["no_token_positional_embeddings"],
        layernorm_embedding=args["layernorm_embedding"],
        distance_penalty=distance_penalty,
        init_variance=args["init_variance"],
        ctc_out_enabled=args["ctc_compress_out"] or args["criterion"] == "ctc_multi_loss",
        ctc_compress_out=args["ctc_compress_out"],
        ctc_encoder_layer=args["ctc_encoder_layer"],
        ctc_compress_strategy=args["ctc_compress_strategy"],
        ctc_vocab_size=len(src_dict) if src_dict is not None else len(tgt_dict),
    )
    decoder_cfg = TransformerDecoderConfig(
        vocab_size=len(tgt_dict),
        embed_dim=args["decoder_embed_dim"],
        ffn_dim=args["decoder_ffn_embed_dim"],
        layers=args["decoder_layers"],
        heads=args["decoder_attention_heads"],
        dropout=args["dropout"],
        attention_dropout=args["attention_dropout"],
        activation_dropout=args["relu_dropout"],
        activation=args["activation_fn"],
        normalize_before=args["decoder_normalize_before"],
        learned_pos=args["decoder_learned_pos"],
        max_positions=args["max_target_positions"],
        padding_idx=tgt_dict.pad(),
        share_input_output_embed=args["share_decoder_input_output_embed"],
        no_scale_embedding=args["no_scale_embedding"],
        layernorm_embedding=args["layernorm_embedding"],
        no_token_positional_embeddings=args["no_token_positional_embeddings"],
    )
    return encoder_cfg, decoder_cfg


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> ConvolutionalTransformerModel:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``."""
    device = resolve_device(device)
    encoder_cfg, decoder_cfg = configs(arch, tgt_dict, src_dict, **overrides)
    model = ConvolutionalTransformerModel(encoder_cfg, decoder_cfg)
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
