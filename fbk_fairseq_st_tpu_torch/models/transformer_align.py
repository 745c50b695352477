"""transformer_align: jointly learning to align and translate (Garg et al.
2019).

Counterpart of ``fbk_fairseq_st_tpu/models/transformer_align.py``: the
text transformer, whose ``forward`` adds a second pass of the decoder's
first ``alignment_layer + 1`` layers (no final LayerNorm, no dropout,
full context with ``--full-context-alignment``) that returns the last of
them's head-averaged cross-attention as ``extra["attn"]`` (B, T, S),
which ``label_smoothed_cross_entropy_with_alignment`` supervises. As in
JAX every head of that layer is averaged (``--alignment-heads`` is parsed
and kept). The cross-attention that returns weights takes the dense route
(``ops/attention.py::flash_eligible``); the pass's other attentions take
the flash route, so a train step launches the plain model's flash calls
plus ``2 * (alignment_layer + 1) - 1`` forwards (and their backward
pairs). Presets: ``transformer_align`` and
``transformer_wmt_en_de_big_align`` (JAX :81-108).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import torch

from ..device import DeviceLike, resolve_device
from ..ops.core import GeneratorLike
from . import transformer as tr


class TransformerAlignModel(tr.TransformerModel):
    def __init__(self, encoder_cfg, decoder_cfg, share_all_embeddings=False, alignment_heads=1,
                 alignment_layer=4, full_context_alignment=False):
        super().__init__(encoder_cfg, decoder_cfg, share_all_embeddings)
        self.alignment_heads = alignment_heads
        self.alignment_layer = alignment_layer
        self.full_context_alignment = full_context_alignment

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        logits, extra = super().forward(batch, generator)
        extra["attn"] = self.alignment_attention(batch["prev_output_tokens"], extra["encoder_out"])
        return logits, extra

    def alignment_attention(self, prev_output_tokens, encoder_out):
        """The decoder prefix's last cross-attention (JAX :76-97), computed
        in eval mode whatever the model's."""
        dec = self.decoder
        was_training = dec.training
        dec.train(False)
        try:
            x = dec._embed(prev_output_tokens, encoder_out.encoder_out.dtype, None)
            kpm = prev_output_tokens == dec.cfg.padding_idx
            layers = list(dec.layers)[:self.alignment_layer + 1]
            attn = None
            for i, layer in enumerate(layers):
                last = i == len(layers) - 1
                out = layer(x, encoder_out=encoder_out.encoder_out,
                            encoder_padding_mask=encoder_out.encoder_padding_mask,
                            self_attn_mask=None if self.full_context_alignment else "causal",
                            self_attn_padding_mask=kpm, need_attn=last)
                x, attn = out if last else (out, attn)
            return attn
        finally:
            dec.train(was_training)


def transformer_align(args):
    """Reference transformer_align.py:81-86."""
    args.alignment_heads = getattr(args, "alignment_heads", 1)
    args.alignment_layer = getattr(args, "alignment_layer", 4)
    args.full_context_alignment = getattr(args, "full_context_alignment", False)
    tr.base_architecture(args)


def transformer_wmt_en_de_big_align(args):
    args.alignment_heads = getattr(args, "alignment_heads", 1)
    args.alignment_layer = getattr(args, "alignment_layer", 4)
    tr.transformer_wmt_en_de_big(args)


ARCHITECTURES = {
    "transformer_align": transformer_align,
    "transformer_wmt_en_de_big_align": transformer_wmt_en_de_big_align,
}
# JAX's parser default of --full-context-alignment, which the big preset reads
_EXTRA = {**tr._EXTRA, "full_context_alignment": False}


def defaults(arch: str) -> Dict[str, Any]:
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return {**_EXTRA, **vars(args)}


def apply_preset(arch: str, args) -> None:
    ARCHITECTURES[arch](args)


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> TransformerAlignModel:
    device = resolve_device(device)
    args = tr.namespace(arch, ARCHITECTURES[arch], defaults(arch), overrides)
    model = TransformerAlignModel(*tr.configs_from_args(args, tgt_dict, src_dict),
                                  alignment_heads=args.alignment_heads, alignment_layer=args.alignment_layer,
                                  full_context_alignment=getattr(args, "full_context_alignment", False))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
