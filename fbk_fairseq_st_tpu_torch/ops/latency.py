"""Latency metrics for simultaneous translation training.

Counterpart of ``fbk_fairseq_st_tpu/ops/latency.py`` (reference
examples/simultaneous_translation/utils/latency.py:9-436): average
proportion, average lagging, differentiable average lagging (DAL: a plain
loop over the target steps, autograd through it, where JAX has a
``lax.scan``), variance delay, and the latency loss of the
latency-augmented criterion from the expected delays of the monotonic
attention's alignments. Batch-first: delays (B, T), source lengths (B, 1).

The expected delays count source positions 1..S, pads included, as JAX's
do: under the translation task's left-padded sources a sentence's delays
are shifted by its pad count (ROADMAP Queue C, JAX side), and the port
keeps that meaning.
"""

from __future__ import annotations

from typing import List

import torch


def _prepare(delays, src_lens, target_padding_mask, start_from_zero=True):
    """delays (B, T); src_lens (B, 1) -> (delays, src_lens, tgt_lens)."""
    if start_from_zero:
        delays = delays + 1
    b, t = delays.shape
    if target_padding_mask is None:
        tgt_lens = torch.full((b, 1), float(t), dtype=delays.dtype, device=delays.device)
    else:
        tgt_lens = (~target_padding_mask).sum(dim=1, keepdim=True).to(delays.dtype)
        delays = torch.where(target_padding_mask, 0.0, delays)
    # all-pad rows (a fixed-shape batch fill) have length 0: clamped, so
    # the 1/gamma and /tgt_lens terms stay finite (their delays are 0)
    tgt_lens = torch.clamp(tgt_lens, min=1.0)
    src_lens = torch.clamp(src_lens.to(delays.dtype), min=1.0)
    return delays, src_lens, tgt_lens


def average_proportion(delays, src_lens, target_padding_mask=None, start_from_zero=True):
    """AP = sum(delays) / (|x| * |y|) (reference :82-100)."""
    delays, src_lens, tgt_lens = _prepare(delays, src_lens, target_padding_mask, start_from_zero)
    return delays.sum(dim=1, keepdim=True) / (src_lens * tgt_lens)


def average_lagging(delays, src_lens, target_padding_mask=None, start_from_zero=True):
    """AL (STACL; reference :103-132): the lag of the steps up to the first
    whose delay reaches |x|."""
    delays, src_lens, tgt_lens = _prepare(delays, src_lens, target_padding_mask, start_from_zero)
    b, t = delays.shape
    reached = delays >= src_lens
    lag_mask = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=delays.device), reached[:, :-1]], dim=1)
    lag_mask = torch.cumsum(lag_mask.to(torch.int64), dim=1) > 0
    gamma = tgt_lens / src_lens
    lagging = delays - torch.arange(t, device=delays.device)[None, :] / gamma
    lagging = torch.where(lag_mask, 0.0, lagging)
    tau = (~lag_mask).sum(dim=1, keepdim=True).to(delays.dtype)
    return lagging.sum(dim=1, keepdim=True) / tau


def differentiable_average_lagging(delays, src_lens, target_padding_mask=None, start_from_zero=True):
    """DAL (the MMA paper; reference :135-180): d'_i = max(d_i, d'_{i-1} +
    1/gamma), then the mean of d'_i - (i - 1)/gamma."""
    delays, src_lens, tgt_lens = _prepare(delays, src_lens, target_padding_mask, start_from_zero)
    b, t = delays.shape
    gamma = (tgt_lens / src_lens)[:, 0]
    new = [delays[:, 0]]
    for i in range(1, t):
        new.append(torch.maximum(delays[:, i], new[-1] + 1.0 / gamma))
    dal = torch.stack(new, dim=1) - torch.arange(t, device=delays.device)[None, :] / gamma[:, None]
    if target_padding_mask is not None:
        dal = torch.where(target_padding_mask, 0.0, dal)
    return dal.sum(dim=1, keepdim=True) / tgt_lens


def variance_delay(delays, src_lens, target_padding_mask=None, start_from_zero=True):
    """The variance over heads x layers at each target step (reference
    :183-233); delays (B, HL, T)."""
    if start_from_zero:
        delays = delays + 1
    b, hl, t = delays.shape
    if hl == 1:
        return torch.zeros((1,), dtype=delays.dtype, device=delays.device)
    if target_padding_mask is None:
        tgt_lens = torch.full((b, 1), float(t), dtype=delays.dtype, device=delays.device)
    else:
        tgt_lens = (~target_padding_mask).sum(dim=1, keepdim=True).to(delays.dtype)
        delays = torch.where(target_padding_mask[:, None, :], 0.0, delays)
    tgt_lens = torch.clamp(tgt_lens, min=1.0)
    var = torch.var(delays, dim=1, correction=1)
    if target_padding_mask is not None:
        var = torch.where(target_padding_mask, 0.0, var)
    return var.sum(dim=1, keepdim=True) / tgt_lens


METRICS = {
    "differentiable_average_lagging": differentiable_average_lagging,
    "average_lagging": average_lagging,
    "average_proportion": average_proportion,
}


def expected_delays_from_attention(attention: List[torch.Tensor], source_padding_mask=None,
                                   target_padding_mask=None, stay_on_last_token: bool = True):
    """attention: the layers' (B, H, T, S) alignments -> the expected delays
    (B, H*L, T) and the source lengths (B*H*L, 1) (reference :304-368)."""
    att = torch.cat(attention, dim=1)
    b, hl, t, s = att.shape
    att = att.reshape(b * hl, t, s)
    if not stay_on_last_token:
        resid = 1.0 - att[:, :, :-1].sum(dim=2, keepdim=True)
        att = torch.cat([att[:, :, :-1], resid], dim=2)
    steps = torch.arange(1, s + 1, dtype=att.dtype, device=att.device)[None, None, :]
    if source_padding_mask is not None:
        src_lens = (~source_padding_mask).sum(dim=1, keepdim=True).to(att.dtype)
        src_lens = src_lens.repeat_interleave(hl, dim=0)
    else:
        src_lens = torch.full((b * hl, 1), float(s), dtype=att.dtype, device=att.device)
    expected = (steps * att).sum(dim=2).reshape(b, hl, t)
    if target_padding_mask is not None:
        expected = torch.where(target_padding_mask[:, None, :], 0.0, expected)
    return expected, src_lens


def latency_training_loss(attention: List[torch.Tensor], source_padding_mask=None,
                          target_padding_mask=None, avg_weight: float = 0.0, var_weight: float = 0.0,
                          avg_type: str = "differentiable_average_lagging", var_type: str = "variance_delay",
                          stay_on_last_token: bool = True, average_method: str = "weighted_average"):
    """``LatencyTraining.loss`` (reference :290-436): the latency penalty
    the latency-augmented criterion adds to the CE loss (a 0-d tensor, or
    the float 0 when both weights are 0). The variance is always
    ``variance_delay``: ``var_type`` is taken and not read, as in JAX."""
    expected, src_lens = expected_delays_from_attention(attention, source_padding_mask, target_padding_mask,
                                                        stay_on_last_token)
    b, hl, _ = expected.shape
    loss = 0.0
    per_sent_src = src_lens.reshape(b, hl)[:, :1]
    if avg_weight > 0.0:
        if average_method == "average":
            avg_delays = expected.mean(dim=1)
        elif average_method == "weighted_average":
            avg_delays = (expected * torch.softmax(expected, dim=1)).sum(dim=1)
        elif average_method == "max":
            avg_delays = expected.max(dim=1).values
        else:
            raise ValueError(f"{average_method} is not supported")
        avg = METRICS[avg_type](avg_delays, per_sent_src, target_padding_mask, start_from_zero=False)
        loss = loss + avg_weight * avg.sum()
    if var_weight > 0.0:
        var = variance_delay(expected, per_sent_src, target_padding_mask, start_from_zero=False)
        loss = loss + var_weight * var.sum()
    return loss
