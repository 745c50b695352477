"""Attention alignments of the best hypotheses (``--print-alignment``,
``--replace-unk``).

The port's copy of ``fbk_fairseq_st_tpu/generation/alignment_utils.py``
(reference SequenceGeneratorWithAlignment, fairseq/sequence_generator.py:
802-908): after the search, one teacher-forced forward of the first model
on each sentence's best hypothesis with ``need_attn``, and for each target
step the source position of the largest weight of the last decoder
layer's head-averaged cross-attention. Only that attention leaves the
flash route; the encoder's and every other layer's stay on it. A model
whose decoder gives no attention (lightconv, as in JAX) leaves the
hypotheses as they are.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.transformer_decoder import TransformerDecoder


def extract_hard_alignment(attn, src_len: int, tgt_len: int) -> List[str]:
    """attn (T_tgt, T_src) -> 'srcidx-tgtidx' pairs."""
    align = np.argmax(np.asarray(attn[:tgt_len, :src_len]), axis=1)
    return [f"{int(s)}-{int(t)}" for t, s in enumerate(align)]


def gives_attention(model) -> bool:
    """Whether ``model``'s decoder returns its cross-attention
    (``TransformerDecoder.forward(need_attn=True)``)."""
    return type(getattr(model, "decoder", None)) is TransformerDecoder and hasattr(model, "encode")


def alignment_attention(model, sample, hypos, pad: int, eos: int):
    """(attn (B, T_tgt, T_src) on the CPU, valid source lengths (B,),
    hypothesis lengths (B,)) of the teacher-forced forward on each
    sentence's best hypothesis; None when the model gives no attention."""
    if not gives_attention(model):
        return None
    device = next(model.parameters()).device
    src_tokens = torch.as_tensor(np.asarray(sample["net_input"]["src_tokens"]), device=device)
    src_lengths = torch.as_tensor(np.asarray(sample["net_input"]["src_lengths"]), device=device)
    bsz = src_tokens.shape[0]
    max_hyp = max((len(h[0]["tokens"]) for h in hypos if h), default=1)
    prev = np.full((bsz, max_hyp), pad, np.int64)
    tgt_lens = np.zeros((bsz,), np.int64)
    for i, sent in enumerate(hypos):
        if not sent:
            continue
        toks = np.asarray(sent[0]["tokens"])
        prev_row = np.concatenate([[eos], toks[:-1]])
        prev[i, : len(prev_row)] = prev_row
        tgt_lens[i] = len(toks)
    with torch.no_grad():
        enc = model.encode(src_tokens, src_lengths)
        _, extra = model.decoder(torch.as_tensor(prev, device=device), enc.encoder_out, enc.encoder_padding_mask,
                                 need_attn=True)
        attn = extra.get("attn")
        if attn is None:
            return None
        mask = enc.encoder_padding_mask
        src_valid = ((~mask).sum(dim=1) if mask is not None
                     else torch.full((bsz,), enc.encoder_out.shape[1], device=device))
    return attn.float().cpu().numpy(), src_valid.cpu().numpy(), tgt_lens


def attach_alignments(model, sample, hypos, pad: int, eos: int):
    """Set ``hypo['alignment']`` of each sentence's best hypothesis."""
    found = alignment_attention(model, sample, hypos, pad, eos)
    if found is None:
        return hypos
    attn, src_valid, tgt_lens = found
    for i, sent in enumerate(hypos):
        if not sent or int(src_valid[i]) == 0 or int(tgt_lens[i]) == 0:
            continue  # padding rows
        sent[0]["alignment"] = extract_hard_alignment(attn[i], int(src_valid[i]), int(tgt_lens[i]))
    return hypos
