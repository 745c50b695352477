"""The multi-decoder family: dual-decoder, triangle, 2-stage.

Counterpart of ``fbk_fairseq_st_tpu/models/multi_task.py``: one
conv_transformer encoder, a target decoder and an auxiliary (transcript)
decoder over the source dictionary (``len(src_dict)`` outputs):

  * dual-decoder (``conv_transformer_dualdecoder``): both decoders attend
    the encoder, each on its own;
  * triangle (``conv_transformer_triangle``): the auxiliary decoder runs
    first (features only); each target-decoder layer adds a cross-attention
    over its states, fused with the encoder's by ``fc_concat``;
  * 2-stage (``conv_transformer_2stage``): the target decoder attends only
    the auxiliary decoder's states, as if they were the encoder's.

``forward`` returns ``((logits, extra), (aux_logits, aux_extra))`` for
``cross_entropy_dualdecoder``; the hooks ``init_aux_cache``,
``decode_aux_step``, ``reorder_aux_cache``, ``aux_features`` and
``init_cache(aux_out=)`` / ``decode_step(aux_padding_mask=)`` /
``reorder_cache`` serve ``TwoPhaseSequenceGenerator``. In its second phase
every beam carries its own transcript, so a cache over the auxiliary
states (the triangle's ``aux``, the 2-stage decoder's ``cross``) is
gathered with the beams.

The nine presets (JAX :313-363) are the conv_transformer presets' widths
plus ``auxiliary_decoder_embed_path``, which raises unless None: JAX
declares the option and reads it nowhere, so there is no loading of a
pre-trained embedding to port.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.core import GeneratorLike
from . import conv_transformer
from .base import EncoderOut
from .conv_transformer import ConvolutionalTransformerModel, ConvTransformerEncoderConfig
from .transformer_decoder import TransformerDecoder, TransformerDecoderConfig, TriangleTransformerDecoder


class MultiTaskModel(ConvolutionalTransformerModel):
    """encoder + target decoder + auxiliary decoder; the dual-decoder's
    wiring (both decoders over the encoder)."""

    def __init__(self, encoder_cfg: ConvTransformerEncoderConfig, decoder_cfg: TransformerDecoderConfig,
                 aux_decoder_cfg: TransformerDecoderConfig):
        super().__init__(encoder_cfg, decoder_cfg)
        self.aux_decoder_cfg = aux_decoder_cfg
        self.auxiliary_decoder = TransformerDecoder(aux_decoder_cfg)

    def init(self, generator: torch.Generator) -> "MultiTaskModel":
        super().init(generator)
        self.auxiliary_decoder.init(generator)
        return self

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens, src_lengths, prev_output_tokens,
        transcript_prev_output_tokens. Returns ((logits, extra), (aux_logits,
        aux_extra)) with the EncoderOut in ``extra``."""
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator)
        decoder_out, aux_out = self._forward_decoders(
            batch["prev_output_tokens"], batch["transcript_prev_output_tokens"], encoder_out, generator)
        decoder_out[1]["encoder_out"] = encoder_out
        return decoder_out, aux_out

    def _forward_decoders(self, prev, aux_prev, encoder_out: EncoderOut, generator):
        enc, enc_mask = encoder_out.encoder_out, encoder_out.encoder_padding_mask
        decoder_out = self.decoder(prev, enc, enc_mask, generator=generator)
        aux_out = self.auxiliary_decoder(aux_prev, enc, enc_mask, generator=generator)
        return decoder_out, aux_out

    def _aux_states(self, aux_prev, encoder_out: EncoderOut, generator):
        """The auxiliary decoder's final states (features only) and the pad
        mask of its input."""
        feats, _ = self.auxiliary_decoder(aux_prev, encoder_out.encoder_out, encoder_out.encoder_padding_mask,
                                          generator=generator, features_only=True)
        return feats, aux_prev == self.aux_decoder_cfg.padding_idx

    def get_auxiliary_target(self, batch, auxiliary_output):
        return batch["transcript_target"]

    def get_auxiliary_token_lens(self, batch):
        return batch["transcript_target_lengths"]

    # -- two-phase incremental decoding -------------------------------------

    def init_aux_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32):
        return self.auxiliary_decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype)

    def decode_aux_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        return self.auxiliary_decoder.step(tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask)

    def reorder_aux_cache(self, cache, order) -> None:
        self.auxiliary_decoder.reorder_cache(cache, order)

    def aux_features(self, aux_tokens, encoder_out: EncoderOut):
        """The auxiliary decoder's final states over fixed transcripts
        (B*K, S_aux) — phase 2's preparation, one teacher-forced pass."""
        return self._aux_states(aux_tokens, encoder_out, None)[0]

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32,
                   aux_out=None):
        return self.decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut, aux_padding_mask=None):
        return self.decoder.step(tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask)


class ConvolutionalTransformerDualDecoder(MultiTaskModel):
    pass


class ConvolutionalTransformerTriangle(MultiTaskModel):
    """Target-decoder layers cross-attend the auxiliary decoder's states
    too (reference conv_transformer_triangle.py:79-105)."""

    decoder_class = TriangleTransformerDecoder

    def _forward_decoders(self, prev, aux_prev, encoder_out: EncoderOut, generator):
        aux_feats, aux_mask = self._aux_states(aux_prev, encoder_out, generator)
        decoder_out = self.decoder(prev, encoder_out.encoder_out, encoder_out.encoder_padding_mask,
                                   generator=generator, aux_decoder_out=aux_feats, aux_decoder_padding_mask=aux_mask)
        return decoder_out, (self.auxiliary_decoder.output_layer(aux_feats), {})

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32,
                   aux_out=None):
        return self.decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype, aux_out=aux_out)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut, aux_padding_mask=None):
        return self.decoder.step(tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask,
                                 aux_decoder_padding_mask=aux_padding_mask)

    def reorder_cache(self, cache, order) -> None:
        self.decoder.reorder_cache(cache, order, ("self", "aux"))


class ConvolutionalTransformer2Stage(MultiTaskModel):
    """The target decoder attends only the auxiliary decoder's states
    (reference conv_transformer_2stage.py:75-92)."""

    def _forward_decoders(self, prev, aux_prev, encoder_out: EncoderOut, generator):
        aux_feats, aux_mask = self._aux_states(aux_prev, encoder_out, generator)
        decoder_out = self.decoder(prev, aux_feats, aux_mask, generator=generator)
        return decoder_out, (self.auxiliary_decoder.output_layer(aux_feats), {})

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32,
                   aux_out=None):
        # the synthetic "encoder" is the auxiliary decoder's states
        return self.decoder.init_cache(batch, max_len, aux_out, dtype)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut, aux_padding_mask=None):
        return self.decoder.step(tokens, cache, step, encoder_padding_mask=aux_padding_mask)

    def reorder_cache(self, cache, order) -> None:
        self.decoder.reorder_cache(cache, order, ("self", "cross"))


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

_WIDTHS = {"": (256, 768, 4), "_big": (512, 1024, 8), "_big2": (512, 2048, 8)}
_FAMILIES = {
    "conv_transformer_dualdecoder": ConvolutionalTransformerDualDecoder,
    "conv_transformer_triangle": ConvolutionalTransformerTriangle,
    "conv_transformer_2stage": ConvolutionalTransformer2Stage,
}
# arch -> (model class, (encoder dim, FFN dim, heads))
ARCHITECTURES = {family + suffix: (cls, widths) for family, cls in _FAMILIES.items()
                 for suffix, widths in _WIDTHS.items()}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    return dict(conv_transformer._base_defaults(*ARCHITECTURES[arch][1]), auxiliary_decoder_embed_path=None)


def configs(arch: str, tgt_dict, src_dict, **overrides
            ) -> Tuple[ConvTransformerEncoderConfig, TransformerDecoderConfig, TransformerDecoderConfig]:
    """Encoder, target-decoder and auxiliary-decoder configs of ``arch``
    (JAX ``MultiTaskModel.build_model``): the auxiliary decoder is the
    target decoder's config over the source dictionary."""
    if src_dict is None:
        raise ValueError(f"{arch} needs a source dictionary (the transcripts')")
    if overrides.pop("auxiliary_decoder_embed_path", None) is not None:
        raise NotImplementedError("--auxiliary-decoder-embed-path: the JAX package declares this option and "
                                  "reads it nowhere, so no pre-trained embedding is loaded from it")
    args = conv_transformer._base_defaults(*ARCHITECTURES[arch][1])
    encoder_cfg, decoder_cfg = conv_transformer.configs_from(args, tgt_dict, src_dict, **overrides)
    aux_decoder_cfg = decoder_cfg._replace(vocab_size=len(src_dict), padding_idx=src_dict.pad())
    return encoder_cfg, decoder_cfg, aux_decoder_cfg


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> MultiTaskModel:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``."""
    device = resolve_device(device)
    model = ARCHITECTURES[arch][0](*configs(arch, tgt_dict, src_dict, **overrides))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
