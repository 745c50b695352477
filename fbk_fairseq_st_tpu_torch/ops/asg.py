"""ASG: Auto Segmentation Criterion (Collobert et al. 2016, wav2letter).

Counterpart of ``fbk_fairseq_st_tpu/ops/asg.py``: the loss as two
log-semiring recursions over unnormalized emissions plus a learned (V, V)
transition matrix,

    FCC (full connection): logadd over ALL label paths
        alpha[t, v] = em[t, v] + logadd_u(alpha[t-1, u] + trans[v, u])
    FAL (forced alignment): logadd over alignments of the packed target
        beta[t, l] = em[t, y_l] + logadd(beta[t-1, l]   + trans[y_l, y_l],
                                         beta[t-1, l-1] + trans[y_l, y_l-1])
    loss = FCC - FAL

with ``trans[dest, src]`` (wav2letter's row-destination convention), and
the best-path Viterbi decode under the same scores. JAX runs both as a
``lax.scan`` over time outside any Pallas kernel; here each is a loop over
the frames of (B, V, V) / (B, L) tensor operations, with autograd giving
the gradients in the emissions and the transitions. Frames past an
utterance's length leave its state as it was.
"""

from __future__ import annotations

import torch

NEG = -1e30  # finite -inf: masked lanes stay NaN-free under where()

SCALE_MODES = ("none", "input_sz", "input_sz_sqrt", "target_sz", "target_sz_sqrt")


def _scale(loss, input_lengths, target_lengths, mode: str):
    t = torch.clamp(input_lengths.float(), min=1.0)
    n = torch.clamp(target_lengths.float(), min=1.0)
    if mode == "none":
        return loss
    if mode == "input_sz":
        return loss / t
    if mode == "input_sz_sqrt":
        return loss / torch.sqrt(t)
    if mode == "target_sz":
        return loss / n
    if mode == "target_sz_sqrt":
        return loss / torch.sqrt(n)
    raise ValueError(f"unknown scale mode {mode!r}")


def asg_loss(emissions, transitions, targets, input_lengths, target_lengths,
             scale_mode: str = "target_sz_sqrt"):
    """Per-utterance ASG loss, in fp32.

    emissions (B, T, V) unnormalized scores; transitions (V, V),
    ``transitions[dest, src]``; targets (B, L) replabel-packed ids (pad
    arbitrary); input_lengths / target_lengths (B,). Returns (B,) losses."""
    em = emissions.float()
    trans = transitions.float()
    b, t_max, _ = em.shape
    length = targets.shape[1]
    input_lengths = input_lengths.to(em.device)
    targets = targets.long()

    # FCC: logadd over all paths
    alpha = em[:, 0]
    for t in range(1, t_max):
        new = em[:, t] + torch.logsumexp(alpha[:, None, :] + trans[None], dim=-1)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    fcc = torch.logsumexp(alpha, dim=-1)

    # FAL: logadd over alignments of the target
    tgt_em = torch.gather(em, 2, targets[:, None, :].expand(b, t_max, length))  # (B, T, L)
    stay_trans = trans[targets, targets]  # (B, L)
    move_trans = torch.cat([torch.zeros((b, 1), device=em.device), trans[targets[:, 1:], targets[:, :-1]]], dim=1)
    pos = torch.arange(length, device=em.device)[None, :]
    neg = torch.full((b, 1), NEG, device=em.device)
    beta = torch.where(pos == 0, tgt_em[:, 0], torch.full_like(tgt_em[:, 0], NEG))
    for t in range(1, t_max):
        stay = beta + stay_trans
        move = torch.cat([neg, beta[:, :-1]], dim=1) + move_trans
        new = tgt_em[:, t] + torch.logaddexp(stay, move)
        beta = torch.where((t < input_lengths)[:, None], new, beta)
    last = torch.clamp(target_lengths.to(em.device).long() - 1, min=0)
    fal = torch.gather(beta, 1, last[:, None])[:, 0]
    return _scale(fcc - fal, input_lengths, target_lengths.to(em.device), scale_mode)


def asg_viterbi_decode(emissions, transitions, input_lengths):
    """The best path under ASG scoring (emissions + transitions), the
    counterpart of the reference's W2lViterbiDecoder over ASG models.
    Returns (paths (B, T), scores (B,)); ties go to the lowest index, as
    ``jnp.argmax`` breaks them."""
    em = emissions.float()
    trans = transitions.float()
    b, t_max, v = em.shape
    input_lengths = input_lengths.to(em.device)
    identity = torch.arange(v, device=em.device)[None].expand(b, v)
    score = em[:, 0]
    backptrs = []
    for t in range(1, t_max):
        cand = score[:, None, :] + trans[None]  # (B, V_to, V_from)
        best_prev = torch.argmax(cand, dim=-1)
        new = em[:, t] + torch.amax(cand, dim=-1)
        active = (t < input_lengths)[:, None]
        score = torch.where(active, new, score)
        backptrs.append(torch.where(active, best_prev, identity))
    cur = torch.argmax(score, dim=-1)
    states = [cur]
    for bp in reversed(backptrs):
        cur = torch.gather(bp, 1, cur[:, None])[:, 0]
        states.append(cur)
    paths = torch.stack(states[::-1], dim=1)
    return paths, torch.amax(score, dim=-1)
