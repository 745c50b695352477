"""CTC: the loss, greedy decoding and the EACL-2021 CTC compression.

Counterpart of ``fbk_fairseq_st_tpu/ops/ctc.py``, plain PyTorch (the JAX
module has no Pallas kernel). Shapes stay static and nothing is brought to
the host:

  * ``ctc_greedy_predictions`` / ``ctc_segments`` (:30, :40): per-frame
    argmax (the first maximum on ties, as ``jnp.argmax``), frames past the
    length get -1; run-length segment ids ``seg = cumsum(boundary) - 1``;
  * ``ctc_compress`` (:63): collapses runs of equal greedy predictions into
    one vector each, with the ``avg`` / ``weighted`` / ``softmax`` frame
    weights; the output keeps T rows and the new lengths drive the masks
    downstream. The segment sums are a one-hot (B, T, T) product
    (``torch.einsum``), the reference fork's own weight-matrix bmm: a fixed
    summation order, where a float ``scatter_add_`` on the card adds by
    atomics in an order that changes from run to run;
  * ``ctc_loss`` (:122): ``F.ctc_loss(reduction='none', zero_infinity=True)``
    on fp32 log-probs, with the blank the caller names (``<ctc_blank>``
    sits after the source dictionary's symbols, never at 0), and the JAX
    module's structural zero_infinity (:151-162): a row with fewer frames
    than labels plus repeated label pairs contributes 0;
  * ``ctc_greedy_decode`` (:166): collapse repeats, drop blanks, compact.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ctc_greedy_predictions(logits, lengths):
    """Greedy per-frame argmax; frames beyond length return -1.

    logits: (B, T, V); lengths: (B,). Returns (pred (B, T) int64, valid)."""
    pred = torch.argmax(logits, dim=-1)
    valid = torch.arange(logits.shape[1], device=logits.device)[None, :] < lengths[:, None]
    return torch.where(valid, pred, -1), valid


def ctc_segments(pred, valid):
    """Run-length segment ids per row (frames past the length continue the
    last id and are weight-masked by the callers) and the number of runs
    within the valid region."""
    boundary = torch.ones_like(pred)
    boundary[:, 1:] = (pred[:, 1:] != pred[:, :-1]).long()
    boundary = boundary * valid.long()
    seg = torch.clamp(torch.cumsum(boundary, dim=1) - 1, min=0)
    new_lengths = torch.where(valid, seg, -1).amax(dim=1) + 1
    return seg, new_lengths


def ctc_compress(x, ctc_logits, lengths, strategy: str = "avg") -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse consecutive equal-CTC-prediction frames of ``x``.

    x: (B, T, D); ctc_logits: (B, T, V); lengths: (B,); strategy 'avg' |
    'weighted' | 'softmax' (the reference's CTCCompressStrategy).
    Returns (compressed (B, T, D), new_lengths (B,))."""
    prob = torch.softmax(ctc_logits.float(), dim=-1)
    pred, valid = ctc_greedy_predictions(ctc_logits, lengths)
    seg, new_lengths = ctc_segments(pred, valid)
    validf = valid.float()
    p_pred = prob.gather(-1, torch.clamp(pred, min=0)[..., None])[..., 0]
    onehot = F.one_hot(seg, x.shape[1]).float()  # (B, T, T)

    def seg_sum(vals):  # (B, T) -> (B, T)
        return torch.einsum("bt,bts->bs", vals, onehot)

    def per_frame(totals, floor):  # each frame's segment total
        return torch.clamp(totals, min=floor).gather(1, seg)

    if strategy == "avg":
        w = validf / per_frame(seg_sum(validf), 1.0)
    elif strategy == "weighted":
        w = p_pred * validf / per_frame(seg_sum(p_pred * validf), 1e-9)
    elif strategy == "softmax":
        e = torch.exp(p_pred) * validf  # softmax of the predicted-class probs within each run
        w = e / per_frame(seg_sum(e), 1e-9)
    else:
        raise ValueError(f"unknown ctc compress strategy {strategy!r}")

    compressed = torch.einsum("bts,btd->bsd", onehot.to(x.dtype), x * w[..., None].to(x.dtype))
    return compressed, new_lengths


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Summed per-sequence CTC negative log likelihood with zero_infinity
    (the reference's ``F.ctc_loss(reduction='sum', zero_infinity=True)``).

    logits: (B, T, V) unnormalized; labels: (B, L) padded with anything
    (masked by ``label_lengths``)."""
    logit_lengths, label_lengths = logit_lengths.long(), label_lengths.long()
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    per_seq = F.ctc_loss(log_probs, labels.long(), logit_lengths, label_lengths, blank=blank_id,
                         reduction="none", zero_infinity=True)
    l = labels.shape[1]
    valid_lab = torch.arange(l, device=labels.device)[None, :] < label_lengths[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid_lab[:, 1:]).sum(dim=1)
    feasible = logit_lengths >= label_lengths + repeats
    return torch.where(feasible & torch.isfinite(per_seq), per_seq, 0.0).sum()


def ctc_greedy_decode(logits, lengths, blank_id: int = 0):
    """Greedy CTC decode: collapse repeats, then remove blanks.

    Returns (tokens (B, T) padded with -1, token_counts (B,))."""
    pred, valid = ctc_greedy_predictions(logits, lengths)
    first_of_run = torch.ones_like(valid)
    first_of_run[:, 1:] = pred[:, 1:] != pred[:, :-1]
    keep = first_of_run & valid & (pred != blank_id)
    out_pos = torch.cumsum(keep.long(), dim=1) - 1
    b, t = pred.shape
    tokens = torch.full((b, t + 1), -1, dtype=pred.dtype, device=pred.device)
    tokens.scatter_(1, torch.where(keep, out_pos, t), torch.where(keep, pred, -1))
    return tokens[:, :t], keep.sum(dim=1)
