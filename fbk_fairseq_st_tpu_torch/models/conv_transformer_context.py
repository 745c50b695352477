"""conv_transformer_context — context-aware speech translation (INTERSPEECH 2020).

Counterpart of ``fbk_fairseq_st_tpu/models/conv_transformer_context.py``
(reference examples/speech_recognition/models/conv_transformer_context.py):
a context encoder, over the previous target text (``tgt``: the decoder's
token embedding scaled by sqrt(D), its own positions, N encoder layers) or
the previous utterance's audio (``src``: a context-unaware
conv_transformer encoder, then N encoder layers), feeds gated context
cross-attention in the encoder and/or the decoder (``context_position``),
with sequential or parallel decoder gating (``attention_type``); in
parallel mode the decoder returns one ``ctx_gates`` entry a layer for the
ctxreg criterion.

The audio context encoder always runs in eval mode (BatchNorm from its
running statistics, no dropout), in a train step too: ``train()`` leaves
it so. The dropout after it and its N layers follow the model's mode.

The context is computed in the type of the features (``src_tokens``): the
text context's embedding and the audio context are cast to it, so a bf16
step runs every layer in bf16, as the fork does under ``--fp16``. JAX keeps
its context in fp32 there, and its type promotion turns every layer after
the first context block fp32 (ROADMAP Queue C, JAX side); in fp32 both are
the same function.

``pretrained_model`` names a context-unaware checkpoint (any format
``train/checkpoint.py::load_checkpoint_to_cpu`` reads), merged at
``init`` as JAX's ``_load_pretrained`` (:376-421) merges it: each
parameter of the encoder and the decoder (and, with ``src`` context, of
the audio context encoder, from the checkpoint's encoder) whose name and
shape the checkpoint has is copied, the others keep their init; the main
encoder's BatchNorm statistics are not loaded, the audio context
encoder's are when the checkpoint holds them. ``frozen_param_filter``
then names the frozen parameters by ``freeze_pretrained``: ``none``
nothing; ``all`` every loaded parameter; ``encoder`` every loaded one
whose name lacks ``decoder`` (so the shared ``decoder.embed_tokens``
trains); and, but in ``none``, the whole audio context encoder. The
Trainer takes them out of the update.

The four presets are the conv_transformer presets' widths (head dim 64 at
each) plus the context options.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Set, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.context_layer import ATTENTION_TYPES, ContextDecoderLayer, ContextEncoderLayer, \
    init_context_decoder_layer_cache
from ..ops.core import GeneratorLike, dropout, embedding, lengths_to_padding_mask
from ..ops.positional import PositionalEmbedding
from ..ops.transformer_layer import TransformerEncoderLayer, TransformerLayerConfig
from . import conv_transformer
from .base import EncoderOut
from .conv_transformer import ConvTransformerEncoder, ConvTransformerEncoderConfig
from .transformer_decoder import TransformerDecoder, TransformerDecoderConfig

CONTEXT_TYPES = ("tgt", "src")
CONTEXT_POSITIONS = ("both", "encoder", "decoder")
FREEZE_MODES = ("all", "encoder", "none")


class ContextConfig(NamedTuple):
    context_type: str = "tgt"  # 'tgt' | 'src'
    context_encoder_layers: int = 1
    context_position: str = "both"  # 'both' | 'encoder' | 'decoder'
    attention_type: str = "sequential"  # the decoder's gating mode

    @property
    def encoder_has_context(self) -> bool:
        return self.context_position in ("both", "encoder")

    @property
    def decoder_has_context(self) -> bool:
        return self.context_position in ("both", "decoder")


class PreviousTargetContextEncoder(nn.Module):
    """The previous target text through the decoder's token embedding
    (passed in at each call: it is the decoder's parameter), scaled by
    sqrt(D), its own positions and N encoder layers (JAX :72-114)."""

    def __init__(self, decoder_cfg: TransformerDecoderConfig, ctx_cfg: ContextConfig,
                 layer_cfg: TransformerLayerConfig):
        super().__init__()
        self.layer_cfg = layer_cfg
        self.embed_scale = decoder_cfg.embed_dim ** 0.5
        self.embed_positions = PositionalEmbedding(decoder_cfg.max_positions, decoder_cfg.embed_dim,
                                                   decoder_cfg.padding_idx, decoder_cfg.learned_pos)
        self.layers = nn.ModuleList(TransformerEncoderLayer(layer_cfg) for _ in range(ctx_cfg.context_encoder_layers))

    def init(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init(generator)
        self.embed_positions.init(generator)

    def forward(self, embed_weight, context_tokens, context_lengths, dtype, generator: GeneratorLike = None):
        """context_tokens (B, Tc) target ids -> ((B, Tc, D), pad mask)."""
        x = self.embed_scale * embedding(embed_weight, context_tokens, dtype)
        x = x + self.embed_positions.from_ids(context_tokens, dtype)
        x = dropout(x, self.layer_cfg.dropout, generator, self.training)
        padding_mask = lengths_to_padding_mask(context_lengths, x.shape[1])
        for layer in self.layers:
            x = layer(x, key_padding_mask=padding_mask, generator=generator)
        return x, padding_mask


class PreviousAudioContextEncoder(nn.Module):
    """The previous utterance's audio through a context-unaware
    conv_transformer encoder (CTC off), always in eval mode, then dropout
    and N encoder layers (JAX :117-163)."""

    def __init__(self, encoder_cfg: ConvTransformerEncoderConfig, ctx_cfg: ContextConfig):
        super().__init__()
        self.dropout_p = encoder_cfg.dropout
        self.audio_encoder = ConvTransformerEncoder(encoder_cfg._replace(ctc_out_enabled=False,
                                                                         ctc_compress_out=False))
        self.layers = nn.ModuleList(TransformerEncoderLayer(encoder_cfg.layer_cfg)
                                    for _ in range(ctx_cfg.context_encoder_layers))
        self.audio_encoder.train(False)

    def init(self, generator: torch.Generator) -> None:
        self.audio_encoder.init(generator)
        for layer in self.layers:
            layer.init(generator)

    def train(self, mode: bool = True) -> "PreviousAudioContextEncoder":
        super().train(mode)
        self.audio_encoder.train(False)  # the frozen pretrained path: eval-mode BatchNorm, no dropout
        return self

    def forward(self, embed_weight, context_tokens, context_lengths, dtype, generator: GeneratorLike = None):
        """context_tokens (B, Tc, F) previous audio -> ((B, Tc', D), pad mask)."""
        enc = self.audio_encoder(context_tokens.to(dtype), context_lengths, generator)
        x = dropout(enc.encoder_out, self.dropout_p, generator, self.training)
        for layer in self.layers:
            x = layer(x, key_padding_mask=enc.encoder_padding_mask, generator=generator)
        return x, enc.encoder_padding_mask


class ContextAwareConvTransformerEncoder(ConvTransformerEncoder):
    """The conv front end and context-aware encoder layers (JAX :166-225);
    no CTC head runs."""

    def __init__(self, cfg: ConvTransformerEncoderConfig, ctx_cfg: ContextConfig):
        super().__init__(cfg)
        self.layers = nn.ModuleList(ContextEncoderLayer(cfg.layer_cfg, ctx_cfg.encoder_has_context)
                                    for _ in range(cfg.layers))

    def forward(self, src_tokens, src_lengths, context=None, context_padding_mask=None,
                generator: GeneratorLike = None) -> EncoderOut:
        x, lengths, padding_mask = self.embed(src_tokens, src_lengths, generator)
        for layer in self.layers:
            x = layer(x, key_padding_mask=padding_mask, context=context, context_padding_mask=context_padding_mask,
                      generator=generator)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return EncoderOut(encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=lengths,
                          context_out=context, context_padding_mask=context_padding_mask)


class TransformerContextAwareDecoder(TransformerDecoder):
    """The decoder over ``ContextDecoderLayer``s (JAX :228-305): ``forward``
    returns ``ctx_gates`` in its extra dict (one a layer in parallel mode,
    ``[]`` in sequential mode); its self-attention masks no pad keys, as
    JAX's does not; ``step`` attends the caches' ``ctx`` K/V."""

    def __init__(self, cfg: TransformerDecoderConfig, ctx_cfg: ContextConfig):
        super().__init__(cfg)
        self.layers = nn.ModuleList(ContextDecoderLayer(cfg.layer_cfg, ctx_cfg.decoder_has_context,
                                                        ctx_cfg.attention_type) for _ in range(cfg.layers))

    def forward(self, prev_output_tokens, encoder_out, encoder_padding_mask=None, context=None,
                context_padding_mask=None, generator: GeneratorLike = None, features_only: bool = False):
        x = self._embed(prev_output_tokens, encoder_out.dtype, generator)
        ctx_gates = []
        for layer in self.layers:
            x, gate = layer(x, encoder_out=encoder_out, encoder_padding_mask=encoder_padding_mask, context=context,
                            context_padding_mask=context_padding_mask, self_attn_mask="causal", generator=generator)
            if gate is not None:
                ctx_gates.append(gate)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return (x if features_only else self.output_layer(x)), {"ctx_gates": ctx_gates}

    def init_cache(self, batch: int, max_len: int, encoder_out, dtype=torch.float32, context_out=None):
        return [init_context_decoder_layer_cache(layer, batch, max_len, encoder_out, context_out, dtype)
                for layer in self.layers]

    def step(self, tokens, cache, step_index: int, encoder_padding_mask=None, context_padding_mask=None):
        x = self._embed(tokens, cache[0]["self"]["k"].dtype, None, step=step_index)
        for layer, lc in zip(self.layers, cache):
            x, _ = layer(x, encoder_padding_mask=encoder_padding_mask, context_padding_mask=context_padding_mask,
                         cache=lc, cache_index=step_index)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return self.output_layer(x)[:, 0, :]


class ConvolutionalTransformerContextAwareModel(nn.Module):
    def __init__(self, encoder_cfg: ConvTransformerEncoderConfig, decoder_cfg: TransformerDecoderConfig,
                 ctx_cfg: ContextConfig, freeze_pretrained: str = "encoder", pretrained_model: Optional[str] = None):
        super().__init__()
        for name, value, choices in (("context type", ctx_cfg.context_type, CONTEXT_TYPES),
                                     ("context position", ctx_cfg.context_position, CONTEXT_POSITIONS),
                                     ("freeze mode", freeze_pretrained, FREEZE_MODES)):
            if value not in choices:
                raise ValueError(f"{name} {value!r}: one of {choices}")
        self.encoder_cfg = encoder_cfg
        self.decoder_cfg = decoder_cfg
        self.ctx_cfg = ctx_cfg
        self.freeze_pretrained = freeze_pretrained
        self.pretrained_model = pretrained_model
        self.encoder = ContextAwareConvTransformerEncoder(encoder_cfg, ctx_cfg)
        self.decoder = TransformerContextAwareDecoder(decoder_cfg, ctx_cfg)
        if ctx_cfg.context_type == "src":
            self.context_encoder = PreviousAudioContextEncoder(encoder_cfg, ctx_cfg)
        else:
            self.context_encoder = PreviousTargetContextEncoder(decoder_cfg, ctx_cfg, encoder_cfg.layer_cfg)
        self.max_source_positions = encoder_cfg.max_positions
        self.max_target_positions = decoder_cfg.max_positions
        self.pretrained_names: Set[str] = set()

    def init(self, generator: torch.Generator) -> "ConvolutionalTransformerContextAwareModel":
        """Seeded initialisation (draws on ``generator``, a CPU generator),
        then the pretrained merge when a checkpoint is named."""
        self.encoder.init(generator)
        self.decoder.init(generator)
        self.context_encoder.init(generator)
        if self.pretrained_model is not None:
            self._load_pretrained()
        return self

    # -- the pretrained merge and the frozen parameters ---------------------

    def _load_pretrained(self) -> None:
        from ..train.checkpoint import load_checkpoint_to_cpu

        source = load_checkpoint_to_cpu(self.pretrained_model)["model"]
        targets = [("encoder.", self.encoder, "encoder."), ("decoder.", self.decoder, "decoder.")]
        if self.ctx_cfg.context_type == "src":
            audio = self.context_encoder.audio_encoder
            targets.append(("encoder.", audio, "context_encoder.audio_encoder."))
        with torch.no_grad():
            for prefix, module, name_prefix in targets:
                for name, param in module.named_parameters():
                    value = source.get(prefix + name)
                    if value is not None and tuple(value.shape) == tuple(param.shape):
                        param.copy_(value)
                        self.pretrained_names.add(name_prefix + name)
            if self.ctx_cfg.context_type == "src":
                # the checkpoint's BatchNorm statistics (JAX: its model_state)
                for name, buf in audio.named_buffers():
                    value = source.get("encoder." + name)
                    if value is not None:
                        buf.copy_(value)

    def frozen_param_filter(self, name: str) -> bool:
        """True for a parameter (a state-dict name) the update leaves as it
        is (JAX :424-437)."""
        if self.freeze_pretrained == "none":
            return False
        if self.ctx_cfg.context_type == "src" and name.startswith("context_encoder.audio_encoder."):
            return True
        if name not in self.pretrained_names:
            return False
        return self.freeze_pretrained == "all" or "decoder" not in name

    # -- the model's API -----------------------------------------------------

    def encode_context(self, context_tokens, context_lengths, dtype=torch.float32,
                       generator: GeneratorLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.context_encoder(self.decoder.embed_tokens.weight, context_tokens, context_lengths, dtype,
                                    generator)

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None, context_tokens=None,
               context_lengths=None) -> EncoderOut:
        """The encoder over ``src_tokens`` with the context encoded from
        ``context_tokens`` (none without them)."""
        context = context_padding_mask = None
        if context_tokens is not None:
            context, context_padding_mask = self.encode_context(context_tokens, context_lengths, src_tokens.dtype,
                                                                generator)
        return self.encoder(src_tokens, src_lengths, context=context, context_padding_mask=context_padding_mask,
                            generator=generator)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens (B, T, F), src_lengths, prev_output_tokens,
        context_tokens, context_lengths. Returns (logits, extra): extra
        holds ``ctx_gates`` and the EncoderOut."""
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator,
                                  context_tokens=batch.get("context_tokens"),
                                  context_lengths=batch.get("context_lengths"))
        logits, extra = self.decoder(batch["prev_output_tokens"], encoder_out.encoder_out,
                                     encoder_out.encoder_padding_mask, context=encoder_out.context_out,
                                     context_padding_mask=encoder_out.context_padding_mask, generator=generator)
        extra["encoder_out"] = encoder_out
        return logits, extra

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32):
        return self.decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype,
                                       context_out=encoder_out.context_out)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        return self.decoder.step(tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask,
                                 context_padding_mask=encoder_out.context_padding_mask)

    def reorder_cache(self, cache, order) -> None:
        """The self-attention K/V follow the beams; the encoder's and the
        context's K/V are a sentence's on each of its beams."""
        self.decoder.reorder_cache(cache, order)


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

# arch -> (encoder dim, FFN dim, heads), JAX :508-549
ARCHITECTURES = {
    "conv_transformer_context": (256, 768, 4),
    "conv_transformer_context_big": (512, 1024, 8),
    "conv_transformer_context_big2": (512, 2048, 8),
    "conv_transformer_context_giant": (1024, 4096, 16),
}
# the model's own options beside the conv_transformer's (JAX add_args and
# the presets); ``context_type`` is the task's --context-type
MODEL_OPTIONS = dict(context_type="tgt", context_encoder_layers=1, context_position="both",
                     context_decoder_attention_type="sequential", pretrained_model=None, freeze_pretrained="encoder")
# the choices of the model's string flags, as JAX's parser gives them
CHOICES = {"context_position": CONTEXT_POSITIONS, "context_decoder_attention_type": ATTENTION_TYPES,
           "freeze_pretrained": FREEZE_MODES}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    return dict(conv_transformer._base_defaults(*ARCHITECTURES[arch]), **MODEL_OPTIONS)


def configs(arch: str, tgt_dict, src_dict=None, **overrides
            ) -> Tuple[ConvTransformerEncoderConfig, TransformerDecoderConfig, ContextConfig, Dict[str, Any]]:
    """The encoder, decoder and context configs of ``arch`` and the model's
    other options (``freeze_pretrained``, ``pretrained_model``)."""
    unknown = set(overrides) - set(defaults(arch))
    if unknown:
        raise TypeError(f"unknown conv_transformer_context options: {sorted(unknown)}")
    options = dict(MODEL_OPTIONS, **{k: v for k, v in overrides.items() if k in MODEL_OPTIONS})
    encoder_cfg, decoder_cfg = conv_transformer.configs_from(
        conv_transformer._base_defaults(*ARCHITECTURES[arch]), tgt_dict, src_dict,
        **{k: v for k, v in overrides.items() if k not in MODEL_OPTIONS})
    ctx_cfg = ContextConfig(context_type=options["context_type"],
                            context_encoder_layers=options["context_encoder_layers"],
                            context_position=options["context_position"],
                            attention_type=options["context_decoder_attention_type"])
    return encoder_cfg, decoder_cfg, ctx_cfg, {k: options[k] for k in ("freeze_pretrained", "pretrained_model")}


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None, seed: int = 0, train: bool = False,
                **overrides) -> ConvolutionalTransformerContextAwareModel:
    """Build ``arch`` with weights drawn from ``seed`` (then the pretrained
    merge, if named) on ``device`` (the CUDA card when None; raises
    without one), in eval mode unless ``train``."""
    device = resolve_device(device)
    encoder_cfg, decoder_cfg, ctx_cfg, options = configs(arch, tgt_dict, src_dict, **overrides)
    model = ConvolutionalTransformerContextAwareModel(encoder_cfg, decoder_cfg, ctx_cfg, **options)
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
