"""The decoder-only transformer language model.

Counterpart of ``fbk_fairseq_st_tpu/models/transformer_lm.py``: the
shared ``TransformerDecoder`` without encoder attention over the batch's
``src_tokens``, with the adaptive input and softmax (tied with
``--tie-adaptive-weights`` / ``--tie-adaptive-proj``, which need matching
cutoffs and factors), the character-CNN embedder
(``--character-embeddings``), ``--no-decoder-final-norm`` and
``--output-dictionary-size`` (the input embedding covers the whole
dictionary, the output the truncated one). The presets are JAX's ten
names (:209-324): ``transformer_lm``, ``_big``, ``_gpt``, ``_gbw`` /
``_baevski_gbw``, ``_wiki103`` / ``_baevski_wiki103``, ``_gpt2_small``,
``_medium`` and ``_big``.

As in JAX the model reads ``--relu-dropout`` (``--activation-dropout`` is
its alias); the wiki103 preset's own ``activation_dropout`` of 0.1 reaches
no layer (ROADMAP Queue C, JAX side). The activations start in fp32 or in
the batch's ``compute_dtype``; with the adaptive softmax the output is fp32
log-probabilities (``ops/adaptive_softmax.py``). Generation sees an
encoder output of zeros and conditions on the self-attention caches alone.
"""

from __future__ import annotations

import ast
from types import SimpleNamespace
from typing import Any, Dict

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.character_embedder import CharEmbedderConfig, build_word_to_char
from ..ops.core import GeneratorLike
from .base import EncoderOut
from .transformer_decoder import TransformerDecoder, TransformerDecoderConfig


class TransformerLanguageModel(nn.Module):
    supported_targets = frozenset({"future"})

    def __init__(self, cfg: TransformerDecoderConfig, char_table=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = TransformerDecoder(cfg, char_table=char_table)
        self.max_source_positions = cfg.max_positions
        self.max_target_positions = cfg.max_positions

    def init(self, generator: torch.Generator) -> "TransformerLanguageModel":
        self.decoder.init(generator)
        return self

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens (B, T) and optionally ``compute_dtype``.
        Returns (logits or log-probabilities (B, T, V), {"attn": None})."""
        return self.decoder(batch["src_tokens"], encoder_out=None, generator=generator,
                            dtype=batch.get("compute_dtype", torch.float32))

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None, dtype=torch.float32) -> EncoderOut:
        """No encoder: zeros of one position (JAX :174-185)."""
        b = src_tokens.shape[0]
        return EncoderOut(
            encoder_out=torch.zeros((b, 1, self.cfg.embed_dim), dtype=dtype, device=src_tokens.device),
            encoder_padding_mask=torch.zeros((b, 1), dtype=torch.bool, device=src_tokens.device))

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32):
        return self.decoder.init_cache(batch, max_len, None, dtype, encoder_out.encoder_out.device)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        return self.decoder.step(tokens, cache, step)

    def reorder_cache(self, cache, order) -> None:
        self.decoder.reorder_cache(cache, order)


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

def base_lm_architecture(args):
    args.dropout = getattr(args, "dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.0)
    args.relu_dropout = getattr(args, "relu_dropout", 0.0)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 512)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 2048)
    args.decoder_layers = getattr(args, "decoder_layers", 6)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 8)
    args.decoder_normalize_before = getattr(args, "decoder_normalize_before", True)
    args.decoder_learned_pos = getattr(args, "decoder_learned_pos", False)
    args.share_decoder_input_output_embed = getattr(args, "share_decoder_input_output_embed", False)
    args.no_token_positional_embeddings = getattr(args, "no_token_positional_embeddings", False)
    args.no_scale_embedding = getattr(args, "no_scale_embedding", False)
    args.adaptive_softmax_cutoff = getattr(args, "adaptive_softmax_cutoff", None)
    args.adaptive_softmax_dropout = getattr(args, "adaptive_softmax_dropout", 0)


def transformer_lm_big(args):
    args.decoder_layers = getattr(args, "decoder_layers", 12)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 1024)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 4096)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 16)
    base_lm_architecture(args)


def _gpt(dim, ffn, layers, heads):
    def preset(args):
        args.decoder_embed_dim = getattr(args, "decoder_embed_dim", dim)
        args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", ffn)
        args.decoder_layers = getattr(args, "decoder_layers", layers)
        args.decoder_attention_heads = getattr(args, "decoder_attention_heads", heads)
        args.dropout = getattr(args, "dropout", 0.1)
        args.attention_dropout = getattr(args, "attention_dropout", 0.1)
        args.activation_fn = getattr(args, "activation_fn", "gelu")
        base_lm_architecture(args)
    return preset


def transformer_lm_baevski_gbw(args):
    """Reference transformer_lm.py:248-256."""
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 512)
    args.dropout = getattr(args, "dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.no_decoder_final_norm = getattr(args, "no_decoder_final_norm", True)
    transformer_lm_big(args)


def transformer_lm_baevski_wiki103(args):
    """Reference transformer_lm.py:230-245 (adaptive input + softmax)."""
    args.decoder_layers = getattr(args, "decoder_layers", 16)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 8)
    args.dropout = getattr(args, "dropout", 0.3)
    args.adaptive_input = getattr(args, "adaptive_input", True)
    args.tie_adaptive_weights = getattr(args, "tie_adaptive_weights", True)
    args.adaptive_input_cutoff = getattr(args, "adaptive_input_cutoff", "20000,60000")
    args.adaptive_softmax_cutoff = getattr(args, "adaptive_softmax_cutoff", "20000,60000")
    args.adaptive_softmax_dropout = getattr(args, "adaptive_softmax_dropout", 0.2)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.activation_dropout = getattr(args, "activation_dropout", 0.1)
    args.no_decoder_final_norm = getattr(args, "no_decoder_final_norm", True)
    args.tie_adaptive_proj = getattr(args, "tie_adaptive_proj", True)
    transformer_lm_big(args)


ARCHITECTURES = {
    "transformer_lm": base_lm_architecture,
    "transformer_lm_big": transformer_lm_big,
    "transformer_lm_gpt": _gpt(768, 3072, 12, 12),
    "transformer_lm_gbw": transformer_lm_baevski_gbw,
    "transformer_lm_baevski_gbw": transformer_lm_baevski_gbw,
    "transformer_lm_wiki103": transformer_lm_baevski_wiki103,
    "transformer_lm_baevski_wiki103": transformer_lm_baevski_wiki103,
    "transformer_lm_gpt2_small": _gpt(1024, 4096, 24, 16),
    "transformer_lm_gpt2_medium": _gpt(1280, 5120, 36, 20),
    "transformer_lm_gpt2_big": _gpt(1600, 6400, 48, 25),
}

CHARACTER_FILTERS = "[(1, 64), (2, 128), (3, 192), (4, 256), (5, 256), (6, 256), (7, 256)]"
# read by the build beside the preset's options, with JAX's getattr
# fallbacks and its parser's explicit defaults
_EXTRA = {"activation_fn": "relu", "max_target_positions": None, "tokens_per_sample": 1024,
          "adaptive_softmax_factor": 4.0, "decoder_layerdrop": 0.0, "adaptive_input": False,
          "adaptive_input_cutoff": None, "adaptive_input_factor": 4.0, "no_decoder_final_norm": False,
          "tie_adaptive_weights": False, "tie_adaptive_proj": False, "character_embeddings": False,
          "character_filters": CHARACTER_FILTERS, "character_embedding_dim": 4, "char_embedder_highway_layers": 2}


def defaults(arch: str) -> Dict[str, Any]:
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return {**_EXTRA, **vars(args)}


def apply_preset(arch: str, args) -> None:
    ARCHITECTURES[arch](args)


def _cutoff(value):
    return tuple(int(x) for x in str(value).split(",")) if value else None


def config_from_args(args, dictionary, input_dictionary=None):
    """JAX ``TransformerLanguageModel.build_model`` (:60-169): the decoder
    config and the word -> char table (None without
    ``--character-embeddings``). ``input_dictionary`` is the task's source
    dictionary, larger than ``dictionary`` under
    ``--output-dictionary-size``."""
    d = dictionary
    src_d = input_dictionary or d
    cfg = TransformerDecoderConfig(
        vocab_size=len(d),
        input_vocab_size=len(src_d) if len(src_d) != len(d) else None,
        embed_dim=args.decoder_embed_dim, ffn_dim=args.decoder_ffn_embed_dim, layers=args.decoder_layers,
        heads=args.decoder_attention_heads, dropout=args.dropout, attention_dropout=args.attention_dropout,
        activation_dropout=getattr(args, "relu_dropout", 0.0), activation=getattr(args, "activation_fn", "relu"),
        normalize_before=args.decoder_normalize_before, learned_pos=args.decoder_learned_pos,
        max_positions=getattr(args, "max_target_positions", None) or getattr(args, "tokens_per_sample", 1024),
        padding_idx=d.pad(), share_input_output_embed=getattr(args, "share_decoder_input_output_embed", False),
        no_scale_embedding=getattr(args, "no_scale_embedding", False),
        no_token_positional_embeddings=getattr(args, "no_token_positional_embeddings", False),
        no_encoder_attn=True,
        adaptive_softmax_cutoff=_cutoff(getattr(args, "adaptive_softmax_cutoff", None)),
        adaptive_softmax_factor=getattr(args, "adaptive_softmax_factor", 4.0),
        layerdrop=getattr(args, "decoder_layerdrop", 0.0) or 0.0,
        quant_noise_pq=getattr(args, "quant_noise_pq", 0) or 0.0,
        quant_noise_block=getattr(args, "quant_noise_pq_block_size", 8) or 8,
        adaptive_input_cutoff=(_cutoff(getattr(args, "adaptive_input_cutoff", None))
                               if getattr(args, "adaptive_input", False) else None),
        adaptive_input_factor=getattr(args, "adaptive_input_factor", 4.0) or 4.0,
        no_decoder_final_norm=getattr(args, "no_decoder_final_norm", False),
        tie_adaptive_weights=getattr(args, "tie_adaptive_weights", False),
        tie_adaptive_proj=getattr(args, "tie_adaptive_proj", False),
    )
    if cfg.tie_adaptive_weights:
        if not getattr(args, "adaptive_input", False):
            raise ValueError("--tie-adaptive-weights requires --adaptive-input")
        if getattr(args, "adaptive_input_factor", 4.0) != getattr(args, "adaptive_softmax_factor", 4.0):
            raise ValueError("--tie-adaptive-weights requires matching --adaptive-input-factor / "
                             "--adaptive-softmax-factor")
    char_table = None
    if getattr(args, "character_embeddings", False):
        char_cfg = CharEmbedderConfig(
            filters=tuple(tuple(f) for f in ast.literal_eval(args.character_filters)),
            char_embed_dim=args.character_embedding_dim, word_embed_dim=args.decoder_embed_dim,
            highway_layers=args.char_embedder_highway_layers)
        if cfg.share_input_output_embed:
            raise ValueError("--character-embeddings has no token embedding matrix to tie; disable "
                             "--share-decoder-input-output-embed")
        cfg = cfg._replace(char_embedder=char_cfg, eos_idx=d.eos(), unk_idx=d.unk())
        char_table = build_word_to_char(d, char_cfg.max_char_len)
    return cfg, char_table


def configs(arch: str, tgt_dict, src_dict=None, **overrides):
    from .transformer import namespace

    parser_defaults = {k: _EXTRA[k] for k in ("character_embeddings", "character_filters", "character_embedding_dim",
                                              "char_embedder_highway_layers")}
    return config_from_args(namespace(arch, ARCHITECTURES[arch], defaults(arch), {**parser_defaults, **overrides}),
                            tgt_dict, src_dict)


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> TransformerLanguageModel:
    """Build ``arch`` over the output dictionary ``tgt_dict`` (and the
    input one ``src_dict``) with weights drawn from ``seed`` on
    ``device`` (the CUDA card when None), in eval mode unless ``train``."""
    device = resolve_device(device)
    model = TransformerLanguageModel(*configs(arch, tgt_dict, src_dict, **overrides))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
