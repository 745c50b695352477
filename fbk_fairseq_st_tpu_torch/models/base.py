"""The EncoderOut contract and its beam reorder.

Counterpart of ``fbk_fairseq_st_tpu/models/base.py``: ``EncoderOut`` mirrors
the reference NamedTuple (the CTC and the context-aware fields included);
``reorder_encoder_out`` (beam replication / reorder) is an
``index_select`` on the batch axis of every tensor it holds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class EncoderOut(NamedTuple):
    encoder_out: torch.Tensor  # (B, T, C)
    encoder_padding_mask: Optional[torch.Tensor]  # (B, T) bool, True at pads
    src_lengths: Optional[torch.Tensor] = None  # (B,)
    ctc_out: Optional[torch.Tensor] = None  # (B, T_ctc, V_src)
    ctc_padding_mask: Optional[torch.Tensor] = None  # (B, T_ctc)
    ctc_lengths: Optional[torch.Tensor] = None  # (B,)
    # the context-aware model's encoded context (INTERSPEECH 2020): it rides
    # the EncoderOut, so beam replication carries it with the rest
    context_out: Optional[torch.Tensor] = None  # (B, T_ctx, C)
    context_padding_mask: Optional[torch.Tensor] = None  # (B, T_ctx)


def reorder_encoder_out(encoder_out: EncoderOut, new_order: torch.Tensor) -> EncoderOut:
    """Gather every batch-axis tensor by ``new_order``."""
    return EncoderOut(*(
        None if t is None else t.index_select(0, new_order.to(t.device))
        for t in encoder_out
    ))
