"""LightConv / DynamicConv translation models (Wu et al. 2019).

Counterpart of ``fbk_fairseq_st_tpu/models/lightconv.py``: token embeddings
(scaled by sqrt(D)) + one shared positional table sized max(src, tgt)
positions -> encoder layers that replace self-attention with a
(dynamic) lightweight convolution -> decoder layers with a causal conv,
encoder attention and an FFN -> an output projection (separate, or tied to
the decoder embedding). A layer is: [LN] -> input dropout -> linear1 ->
GLU -> (encoder: zero the pad positions) -> conv -> linear2 -> dropout ->
add -> [LN], then the FFN block; the encoder's conv is centred
(padding_l = K // 2, (K - 1) // 2 for even K), the decoder's causal
(K - 1). Incremental decoding keeps each decoder layer's last K conv
inputs in a ``window`` cache, shifted by one each step, beside the
precomputed encoder K/V (``cross``).

The full-sequence dynamic conv runs ``ops/kernels/dynamic_conv.py`` while
``use_kernel`` is True (JAX's ``use_pallas``), as it is from construction:
the wrapper launches the CUDA kernels for CUDA tensors and runs their plain
versions for CPU ones, so a model built on the CPU and moved to the card
takes the kernels there. False (the plain unfold + einsum on any device)
serves only to cross-check the two routes. The incremental step, the
lightweight conv and everything else are plain PyTorch, as in JAX.

The activations start in fp32 at the embedding tables, or in the type a
batch names under ``compute_dtype`` (the Trainer's bf16 under ``--bf16``,
since a text model has no float input to cast); the model keeps no type of
its own. Each op casts its fp32 weight at use.

Module names are those ``state_dict_from_jax`` derives from the JAX tree
(``encoder_embed``, ``decoder_embed``, ``encoder_layers.{i}.linear1``,
``conv``, ``conv_ln``, ``final_layer_norm``, ``encoder_attn``,
``encoder_attn_layer_norm``, ``output_projection``, ``embed_positions``),
so a JAX tree loads strictly. Like the JAX model it has no final
LayerNorm, keeps one positional table (learned when the encoder's is) and
ignores ``--share-all-embeddings`` (ROADMAP Queue C).
"""

from __future__ import annotations

import ast
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import MHAConfig, MultiheadAttention
from ..ops.core import GeneratorLike, LayerNorm, Linear, dropout, embedding, normal_
from ..ops.lightconv import (
    DynamicConv,
    LightweightConv,
    dynamic_conv,
    dynamic_conv_step,
    lightweight_conv,
    lightweight_conv_step,
)
from ..ops.positional import PositionalEmbedding
from .base import EncoderOut


class LightConvLayerConfig(NamedTuple):
    embed_dim: int
    conv_dim: int
    ffn_dim: int
    heads: int
    kernel_size: int
    conv_type: str  # 'lightweight' | 'dynamic'
    glu: bool
    weight_softmax: bool
    dropout: float
    weight_dropout: float
    relu_dropout: float
    input_dropout: float
    normalize_before: bool
    attention_dropout: float = 0.0


class LightConvModelConfig(NamedTuple):
    src_vocab: int
    tgt_vocab: int
    embed_dim: int
    ffn_dim: int
    encoder_layers: tuple
    decoder_layers: tuple  # per-layer LightConvLayerConfig
    padding_idx: int
    max_source_positions: int
    max_target_positions: int
    dropout: float
    share_input_output_embed: bool
    learned_pos: bool


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class LightConvEncoderLayer(nn.Module):
    """``lightconv_encoder_layer``: x (B, T, D) -> (B, T, D)."""

    def __init__(self, cfg: LightConvLayerConfig):
        super().__init__()
        if cfg.conv_type not in ("lightweight", "dynamic"):
            raise NotImplementedError(cfg.conv_type)
        self.cfg = cfg
        self.linear1 = Linear(cfg.embed_dim, 2 * cfg.conv_dim if cfg.glu else cfg.conv_dim)
        conv = LightweightConv if cfg.conv_type == "lightweight" else DynamicConv
        self.conv = conv(cfg.conv_dim, cfg.kernel_size, cfg.heads)
        self.linear2 = Linear(cfg.conv_dim, cfg.embed_dim)
        self.conv_ln = LayerNorm(cfg.embed_dim)
        self.fc1 = Linear(cfg.embed_dim, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.embed_dim)
        self.final_layer_norm = LayerNorm(cfg.embed_dim)

    def init(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.init(generator)

    def _conv_input(self, x, generator):
        """[LN] -> input dropout -> linear1 -> GLU; returns (residual, x)."""
        cfg = self.cfg
        residual = x
        if cfg.normalize_before:
            x = self.conv_ln(x)
        x = dropout(x, cfg.input_dropout, generator, self.training)
        x = self.linear1(x)
        if cfg.glu:
            x = F.glu(x, dim=-1)  # first half * sigmoid(second half), as jax.nn.glu
        return residual, x

    def _conv(self, x, padding_l: int, generator, use_kernel: bool):
        cfg = self.cfg
        args = (self.conv, x, cfg.kernel_size, cfg.heads, padding_l)
        kwargs = dict(weight_softmax=cfg.weight_softmax, weight_dropout=cfg.weight_dropout,
                      generator=generator, training=self.training)
        if cfg.conv_type == "lightweight":
            return lightweight_conv(*args, **kwargs)
        return dynamic_conv(*args, **kwargs, use_kernel=use_kernel)

    def _conv_step(self, window):
        cfg = self.cfg
        step = lightweight_conv_step if cfg.conv_type == "lightweight" else dynamic_conv_step
        return step(self.conv, window, cfg.kernel_size, cfg.heads, cfg.weight_softmax)

    def _conv_output(self, residual, x, generator):
        """linear2 -> dropout -> add -> [LN]."""
        cfg = self.cfg
        x = dropout(self.linear2(x), cfg.dropout, generator, self.training)
        x = residual + x
        return x if cfg.normalize_before else self.conv_ln(x)

    def _ffn(self, x, generator):
        cfg = self.cfg
        residual = x
        if cfg.normalize_before:
            x = self.final_layer_norm(x)
        x = F.relu(self.fc1(x))
        x = dropout(x, cfg.relu_dropout, generator, self.training)
        x = dropout(self.fc2(x), cfg.dropout, generator, self.training)
        x = residual + x
        return x if cfg.normalize_before else self.final_layer_norm(x)

    def forward(self, x, encoder_padding_mask=None, generator: GeneratorLike = None,
                use_kernel: bool = True):
        k = self.cfg.kernel_size
        padding_l = k // 2 if k % 2 == 1 else (k - 1) // 2  # centred
        residual, x = self._conv_input(x, generator)
        if encoder_padding_mask is not None:
            x = x.masked_fill(encoder_padding_mask[:, :, None], 0.0)
        x = self._conv(x, padding_l, generator, use_kernel)
        x = self._conv_output(residual, x, generator)
        return self._ffn(x, generator)


class LightConvDecoderLayer(LightConvEncoderLayer):
    """``lightconv_decoder_layer``: causal conv (padding_l = K - 1) +
    encoder attention + FFN."""

    def __init__(self, cfg: LightConvLayerConfig):
        super().__init__(cfg)
        self.encoder_attn = MultiheadAttention(
            MHAConfig(cfg.embed_dim, cfg.heads, dropout=cfg.attention_dropout))
        self.encoder_attn_layer_norm = LayerNorm(cfg.embed_dim)

    def forward(self, x, encoder_out=None, encoder_padding_mask=None,
                generator: GeneratorLike = None, cache: Optional[Dict[str, Any]] = None,
                use_kernel: bool = True):
        """x: (B, T, D) -> (B, T, D). With ``cache`` ({"window", "cross"}) x
        is (B, 1, D): the window takes x's conv input in place of its oldest
        row (written into ``cache``) and the encoder attention reads the
        precomputed K/V."""
        cfg = self.cfg
        residual, x = self._conv_input(x, generator)
        if cache is not None:
            cache["window"] = torch.cat([cache["window"][:, 1:], x.to(cache["window"].dtype)], dim=1)
            x = self._conv_step(cache["window"])[:, None, :]
        else:
            x = self._conv(x, cfg.kernel_size - 1, generator, use_kernel)
        x = self._conv_output(residual, x, generator)

        residual = x
        if cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        if cache is not None:
            x, _, _ = self.encoder_attn(x, key_padding_mask=encoder_padding_mask, generator=generator,
                                        cache=cache["cross"], static_kv=True)
        else:
            x, _, _ = self.encoder_attn(x, key=encoder_out, key_padding_mask=encoder_padding_mask,
                                        generator=generator)
        x = dropout(x, cfg.dropout, generator, self.training)
        x = residual + x
        if not cfg.normalize_before:
            x = self.encoder_attn_layer_norm(x)
        return self._ffn(x, generator)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class LightConvModel(nn.Module):
    def __init__(self, cfg: LightConvModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed_scale = d ** 0.5
        self.encoder_embed = nn.Embedding(cfg.src_vocab, d, cfg.padding_idx)
        self.decoder_embed = nn.Embedding(cfg.tgt_vocab, d, cfg.padding_idx)
        self.encoder_layers = nn.ModuleList(LightConvEncoderLayer(lc) for lc in cfg.encoder_layers)
        self.decoder_layers = nn.ModuleList(LightConvDecoderLayer(lc) for lc in cfg.decoder_layers)
        self.output_projection = (
            None if cfg.share_input_output_embed else nn.Linear(d, cfg.tgt_vocab, bias=False))
        self.embed_positions = PositionalEmbedding(
            max(cfg.max_source_positions, cfg.max_target_positions), d, cfg.padding_idx, cfg.learned_pos)
        self.max_source_positions = cfg.max_source_positions
        self.max_target_positions = cfg.max_target_positions
        self.use_kernel = True

    def init(self, generator: torch.Generator) -> "LightConvModel":
        """Seeded re-initialisation with the JAX model's distributions
        (draws on ``generator``, a CPU generator)."""
        std = self.cfg.embed_dim ** -0.5
        for table in (self.encoder_embed, self.decoder_embed):
            normal_(table.weight, generator, std)
            with torch.no_grad():
                table.weight[self.cfg.padding_idx] = 0.0
        for layer in list(self.encoder_layers) + list(self.decoder_layers):
            layer.init(generator)
        if self.output_projection is not None:
            normal_(self.output_projection.weight, generator, std)
        self.embed_positions.init(generator)
        return self

    def _embed(self, table: nn.Embedding, tokens, dtype, generator, step: Optional[int] = None):
        x = self.embed_scale * embedding(table.weight, tokens).to(dtype)
        x = x + self.embed_positions.from_ids(tokens, dtype, step=step)
        return dropout(x, self.cfg.dropout, generator, self.training)

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None,
               dtype: torch.dtype = torch.float32) -> EncoderOut:
        """src_tokens: (B, T) token ids, padded on either side; the
        activations computed in ``dtype``."""
        x = self._embed(self.encoder_embed, src_tokens, dtype, generator)
        padding_mask = src_tokens == self.cfg.padding_idx
        for layer in self.encoder_layers:
            x = layer(x, encoder_padding_mask=padding_mask, generator=generator, use_kernel=self.use_kernel)
        return EncoderOut(encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=src_lengths)

    def _decode(self, prev_tokens, encoder_out: EncoderOut, generator, step=None, cache=None):
        x = self._embed(self.decoder_embed, prev_tokens, encoder_out.encoder_out.dtype, generator, step)
        for i, layer in enumerate(self.decoder_layers):
            x = layer(x, encoder_out=encoder_out.encoder_out,
                      encoder_padding_mask=encoder_out.encoder_padding_mask, generator=generator,
                      cache=None if cache is None else cache[i], use_kernel=self.use_kernel)
        w = self.decoder_embed.weight if self.output_projection is None else self.output_projection.weight
        return torch.matmul(x, w.t().to(x.dtype))

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens (B, S), src_lengths, prev_output_tokens (B, T)
        and optionally the ``compute_dtype`` (fp32 when absent). Returns
        (logits (B, T, V), extra) with the EncoderOut in extra."""
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator,
                                  batch.get("compute_dtype", torch.float32))
        logits = self._decode(batch["prev_output_tokens"], encoder_out, generator)
        return logits, {"attn": None, "encoder_out": encoder_out}

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut,
                   dtype=torch.float32) -> List[Dict[str, Any]]:
        """Per decoder layer: a zero (B, K, conv_dim) window and the encoder
        output's cross-attention K/V, projected once."""
        enc = encoder_out.encoder_out
        return [
            {"window": torch.zeros((batch, layer.cfg.kernel_size, layer.cfg.conv_dim), dtype=dtype,
                                   device=enc.device),
             "cross": layer.encoder_attn.precompute_cross_cache(enc)}
            for layer in self.decoder_layers
        ]

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        """tokens (B, 1) -> logits (B, V); the windows are written into
        ``cache``."""
        return self._decode(tokens, encoder_out, None, step=step, cache=cache)[:, 0, :]

    def reorder_cache(self, cache: List[Dict[str, Any]], order) -> None:
        """Gather every layer's window by ``order`` (B*K rows), in place of
        the old one. The cross K/V stay: a beam reorder only permutes rows
        within a sentence, whose encoder rows are identical."""
        for layer_cache in cache:
            layer_cache["window"] = layer_cache["window"].index_select(0, order)


# ---------------------------------------------------------------------------
# Arch presets (the JAX package's, which set each option only where the
# caller left it unset) and construction
# ---------------------------------------------------------------------------

def base_architecture(args):
    """Reference lightconv.py:692-734 defaults."""
    args.encoder_embed_path = getattr(args, "encoder_embed_path", None)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 512)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 2048)
    args.encoder_layers = getattr(args, "encoder_layers", 7)
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
    args.encoder_conv_dim = getattr(args, "encoder_conv_dim", args.encoder_embed_dim)
    args.decoder_conv_dim = getattr(args, "decoder_conv_dim", args.decoder_embed_dim)
    args.encoder_kernel_size_list = getattr(args, "encoder_kernel_size_list", [3, 7, 15, 31, 31, 31, 31])
    args.decoder_kernel_size_list = getattr(args, "decoder_kernel_size_list", [3, 7, 15, 31, 31, 31])
    if getattr(args, "encoder_glu", None) is None:
        args.encoder_glu = True
    if getattr(args, "decoder_glu", None) is None:
        args.decoder_glu = True
    args.input_dropout = getattr(args, "input_dropout", 0.1)
    wd = getattr(args, "weight_dropout", None)
    args.weight_dropout = wd if wd is not None else args.attention_dropout
    args.weight_softmax = getattr(args, "weight_softmax", True)
    args.encoder_conv_type = getattr(args, "encoder_conv_type", "lightweight")
    args.decoder_conv_type = getattr(args, "decoder_conv_type", "lightweight")
    args.adaptive_softmax_cutoff = getattr(args, "adaptive_softmax_cutoff", None)
    args.adaptive_softmax_dropout = getattr(args, "adaptive_softmax_dropout", 0)


def lightconv_iwslt_de_en(args):
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 512)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 1024)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 4)
    args.encoder_layers = getattr(args, "encoder_layers", 7)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 512)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 1024)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 4)
    args.decoder_layers = getattr(args, "decoder_layers", 6)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.weight_dropout = getattr(args, "weight_dropout", 0.1)
    args.encoder_glu = getattr(args, "encoder_glu", False)
    args.decoder_glu = getattr(args, "decoder_glu", False)
    args.input_dropout = getattr(args, "input_dropout", 0.0)
    base_architecture(args)


def lightconv_wmt_en_de_big(args):
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 1024)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 4096)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 16)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 1024)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 4096)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 16)
    args.dropout = getattr(args, "dropout", 0.3)
    base_architecture(args)


def lightconv_wmt_en_fr_big(args):
    """Reference lightconv.py:774-777 (en_de_big with dropout .1)."""
    args.dropout = getattr(args, "dropout", 0.1)
    lightconv_wmt_en_de_big(args)


def lightconv_wmt_zh_en_big(args):
    """Reference lightconv.py:780-785 (en_de_big with all dropouts .2)."""
    args.dropout = getattr(args, "dropout", 0.2)
    args.attention_dropout = getattr(args, "attention_dropout", 0.2)
    args.weight_dropout = getattr(args, "weight_dropout", 0.2)
    lightconv_wmt_en_de_big(args)


def _dynamic(preset):
    def arch(args):
        args.encoder_conv_type = getattr(args, "encoder_conv_type", "dynamic")
        args.decoder_conv_type = getattr(args, "decoder_conv_type", "dynamic")
        preset(args)
    return arch


ARCHITECTURES = {
    "lightconv": base_architecture,
    "lightconv_iwslt_de_en": lightconv_iwslt_de_en,
    "lightconv_wmt_en_de": base_architecture,
    "lightconv_wmt_en_de_big": lightconv_wmt_en_de_big,
    "lightconv_wmt_en_fr_big": lightconv_wmt_en_fr_big,
    "lightconv_wmt_zh_en_big": lightconv_wmt_zh_en_big,
    "dynamicconv": _dynamic(base_architecture),
    "dynamicconv_iwslt_de_en": _dynamic(lightconv_iwslt_de_en),
    "dynamicconv_wmt_en_de_big": _dynamic(lightconv_wmt_en_de_big),
}

# read by build_model beside the preset's options (the task's in JAX)
_POSITIONS = {"max_source_positions": 1024, "max_target_positions": 1024}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return {**vars(args), **_POSITIONS}


def apply_preset(arch: str, args) -> None:
    """``arch``'s preset on a parsed namespace, as JAX's registry applies it:
    the options it derives from others (the conv dims from the embedding
    dims, the decoder's widths from the encoder's) follow the given ones."""
    ARCHITECTURES[arch](args)


def _kernel_sizes(value, default, layers: int) -> List[int]:
    sizes = default if value is None else (
        list(ast.literal_eval(value)) if isinstance(value, str) else list(value))
    if len(sizes) == 1:
        sizes = sizes * layers
    return sizes[:layers]


def configs(arch: str, tgt_dict, src_dict=None, **overrides) -> LightConvModelConfig:
    """The model config of ``arch`` with ``overrides`` applied, as the JAX
    ``LightConvModel.build_model`` derives it from its args."""
    unknown = set(overrides) - set(defaults(arch))
    if unknown:
        raise TypeError(f"unknown lightconv options: {sorted(unknown)}")
    args = SimpleNamespace(**overrides)
    ARCHITECTURES[arch](args)
    enc_kernels = _kernel_sizes(args.encoder_kernel_size_list, [3, 7, 15, 31, 31, 31, 31], args.encoder_layers)
    dec_kernels = _kernel_sizes(args.decoder_kernel_size_list, [3, 7, 15, 31, 31, 31], args.decoder_layers)

    def layer_cfg(kernel: int, side: str) -> LightConvLayerConfig:
        opt = lambda name: getattr(args, f"{side}_{name}")  # noqa: E731
        return LightConvLayerConfig(
            embed_dim=opt("embed_dim"), conv_dim=opt("conv_dim"), ffn_dim=opt("ffn_embed_dim"),
            heads=opt("attention_heads"), kernel_size=kernel, conv_type=opt("conv_type"), glu=opt("glu"),
            weight_softmax=args.weight_softmax, dropout=args.dropout, weight_dropout=args.weight_dropout,
            relu_dropout=args.relu_dropout, input_dropout=args.input_dropout,
            normalize_before=opt("normalize_before"), attention_dropout=args.attention_dropout,
        )

    return LightConvModelConfig(
        src_vocab=len(src_dict) if src_dict is not None else len(tgt_dict),
        tgt_vocab=len(tgt_dict),
        embed_dim=args.encoder_embed_dim,
        ffn_dim=args.encoder_ffn_embed_dim,
        encoder_layers=tuple(layer_cfg(k, "encoder") for k in enc_kernels),
        decoder_layers=tuple(layer_cfg(k, "decoder") for k in dec_kernels),
        padding_idx=tgt_dict.pad(),
        max_source_positions=getattr(args, "max_source_positions", 1024),
        max_target_positions=getattr(args, "max_target_positions", 1024),
        dropout=args.dropout,
        share_input_output_embed=args.share_decoder_input_output_embed,
        learned_pos=args.encoder_learned_pos,
    )


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> LightConvModel:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``."""
    device = resolve_device(device)
    model = LightConvModel(configs(arch, tgt_dict, src_dict, **overrides))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
