"""Ring attention: self-attention with the sequence split over the ranks of
a group, the K/V blocks travelling the ring.

Counterpart of ``fbk_fairseq_st_tpu/ops/ring_attention.py`` (Liu et al.
2023). JAX computes each ring block with ``einsum`` and rotates with
``ppermute`` inside ``shard_map``; here each block is a call of the port's
flash kernels and the rotation is a batch of point-to-point sends
(``parallel.collectives.rotate``). Rank r holds the queries, keys and
values of positions [r * T_l, (r + 1) * T_l).

Forward: each visiting K/V block gives ``out_blk`` and ``lse_blk`` from the
flash forward (``flash_attention._forward_cuda``: the tensor-core forward
of the type, ``csrc/flash_fwd_tc.cu`` or ``flash_fwd_tf32x3.cu``), merged
into the running (out, lse) by the log-sum-exp rescaling, in fp32 plain
tensor ops (plain XLA in JAX). Under a causal mask a block from an earlier
shard is full, the shard's own block is the causal diagonal, and a block
from a later shard is skipped: N(N+1)/2 blocks of N^2.

Backward (an autograd Function): each block's dQ and dK/dV come from the
split backward (``flash_attention_backward``: the dq + dkv pair) given the
merged ``out`` and ``lse``, since w = exp(s - lse) with the global lse is
the block's share of the softmax and delta = rowsum(dO * O) is the row's.
dQ stays; dK/dV travel the ring with their block back to its owner.

Dead rows. A row whose every key of a block is masked (key padding, or
under the diagonal's causal mask) gets its q zeroed for that block, so its
scores there are exactly the mask bias (-1e9: the bias's rounding would
otherwise enter exp), its lse_blk about -1e9, and its weight in the merge
and its w in the backward 0, as JAX's ring floors ``m_blk`` at NEG_INF
(:63-66). A row whose every key of the sequence is masked is handled as
the flash route does (``_uniform_dead_rows``: q and its bias zeroed, the
uniform average of V over the keys the mask leaves), which is JAX's ring
without a causal mask.

Dropout: each block draws its Philox stream from (seed, q shard, k shard),
so the forward and the backward of a block draw the same bits (JAX keys by
``fold_in(key, src)``, :118-123, the same bits for every q shard).

``ring_attention_shards`` runs the same blocks over N shards held in one
process (the rotation is indexing a list), for the card's check on one
device.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .core import NEG_INF
from .kernels.flash_attention import (
    _forward_cuda,
    _uniform_dead_rows,
    flash_attention_backward,
    flash_attention_reference,
    kernel_head_dim,
)


class RingGroup:
    """The ranks a self-attention's sequence is split over
    (``MultiheadAttention.ring``)."""

    def __init__(self, group):
        from ..parallel.collectives import group_rank, group_size

        self.group = group
        self.size = group_size(group)
        self.rank = group_rank(group)


def ring_eligible(t: int, s: int, size: int) -> bool:
    """JAX :206-218: self-attention shapes whose sequence splits evenly
    into shards of at least 2 positions."""
    return t == s and t % size == 0 and t // size >= 2


def visit(q_shard: int, k_shard: int, causal: bool) -> Optional[bool]:
    """How the q shard meets the k shard: None skips it (causal, a later
    shard), True is the causal diagonal, False a full block."""
    if not causal or k_shard < q_shard:
        return False
    return True if k_shard == q_shard else None


_GOLDEN = 0x9E3779B97F4A7C15


def block_seed(seed: int, q_shard: int, k_shard: int, n: int) -> int:
    """The dropout seed of block (q_shard, k_shard)."""
    return (int(seed) + (q_shard * n + k_shard + 1) * _GOLDEN) % (2 ** 63)


def _block_rows(q, bias, diag: bool):
    """q with the rows that see no unmasked key of this block zeroed."""
    live = bias > NEG_INF / 2
    if diag:
        return q * torch.cummax(live.to(torch.int32), dim=1).values.bool()[..., None]
    return q * live.any(dim=1)[:, None, None]


def block_forward(q, k, v, bias, scale: float, diag: bool, rate: float = 0.0, seed: int = 0):
    """(out_blk, lse_blk) of one ring block: the flash forward on CUDA
    tensors, its plain version on CPU ones."""
    q = _block_rows(q, bias, diag)
    if q.is_cuda:
        return _forward_cuda(q, k, v, bias, scale, diag, rate, seed)
    return flash_attention_reference(q, k, v, bias, scale, diag, rate, seed)


def block_backward(q, k, v, bias, out, lse, grad, scale: float, diag: bool, rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of one ring block given the merged out and lse."""
    return flash_attention_backward(_block_rows(q, bias, diag), k, v, bias, out, lse, grad, scale, diag, rate, seed)


def merge(acc, lse, out_blk, lse_blk):
    """Fold a block's (out_blk, lse_blk) into the running fp32 (acc, lse)."""
    if acc is None:
        return out_blk.float(), lse_blk
    new = torch.logaddexp(lse, lse_blk)
    return (acc * torch.exp(lse - new)[..., None] + out_blk.float() * torch.exp(lse_blk - new)[..., None]), new


def ring_attention_shards(qs: List[torch.Tensor], ks, vs, biases, scale: float, causal: bool = False,
                          rate: float = 0.0, seed: int = 0):
    """The ring's forward over N shards held in one process, each visiting
    block in the ring's order (own, then r-1, r-2, ...); returns the
    shards' outputs and lses."""
    n = len(qs)
    outs, lses = [], []
    for r in range(n):
        acc = lse = None
        for step in range(n):
            src = (r - step) % n
            mode = visit(r, src, causal)
            if mode is None:
                continue
            o, l = block_forward(qs[r], ks[src], vs[src], biases[src], scale, mode, rate, block_seed(seed, r, src, n))
            acc, lse = merge(acc, lse, o, l)
        outs.append(acc.to(qs[r].dtype))
        lses.append(lse)
    return outs, lses


def ring_attention_shards_backward(qs, ks, vs, biases, outs, lses, grads, scale: float, causal: bool = False,
                                   rate: float = 0.0, seed: int = 0):
    """The ring's backward over the shards of ``ring_attention_shards``;
    returns (dqs, dks, dvs)."""
    n = len(qs)
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    for r in range(n):
        for step in range(n):
            src = (r - step) % n
            mode = visit(r, src, causal)
            if mode is None:
                continue
            dq, dk, dv = block_backward(qs[r], ks[src], vs[src], biases[src], outs[r], lses[r], grads[r], scale,
                                        mode, rate, block_seed(seed, r, src, n))
            dqs[r] += dq.float()
            dks[src] += dk.float()
            dvs[src] += dv.float()
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)], [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, rate, seed, ring):
        from ..parallel.collectives import rotate

        n, r = ring.size, ring.rank
        acc = lse = None
        kb, vb, bb = k, v, bias
        for step in range(n):
            src = (r - step) % n
            mode = visit(r, src, causal)
            if mode is not None:
                o, l = block_forward(q, kb, vb, bb, scale, mode, rate, block_seed(seed, r, src, n))
                acc, lse = merge(acc, lse, o, l)
            if step < n - 1:
                kb, vb, bb = rotate([kb, vb, bb], ring.group)
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (scale, causal, rate, seed, ring)
        return out

    @staticmethod
    def backward(ctx, grad):
        from ..parallel.collectives import rotate

        q, k, v, bias, out, lse = ctx.saved_tensors
        scale, causal, rate, seed, ring = ctx.args
        n, r = ring.size, ring.rank
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb, bb = k, v, bias
        for step in range(n):
            src = (r - step) % n
            mode = visit(r, src, causal)
            if mode is not None:
                dqb, dkb, dvb = block_backward(q, kb, vb, bb, out, lse, grad, scale, mode, rate,
                                               block_seed(seed, r, src, n))
                dq += dqb.float()
                dk += dkb.float()
                dv += dvb.float()
            if step < n - 1:
                kb, vb, bb, dk, dv = rotate([kb, vb, bb, dk, dv], ring.group)
            else:
                dk, dv = rotate([dk, dv], ring.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None


def ring_self_attention(q, k, v, bias, ring: RingGroup, causal: bool = False, rate: float = 0.0, seed: int = 0):
    """``flash_attention``'s contract (q, k, v (BH, T, D), whole and alike
    on every rank of ``ring``; ``bias`` (BH, T); q pre-scaled) computed by
    the ring: each rank takes its time chunk, the ring runs, and the
    output is gathered whole again (its backward the slice: what follows
    runs alike on every rank)."""
    from ..parallel.collectives import chunk_of, gather_along, scatter_along

    dead = bias.amax(dim=1) <= NEG_INF / 2
    q, bias = _uniform_dead_rows(q, bias)
    d = q.shape[2]
    if q.is_cuda:
        kd = kernel_head_dim(d)
        if kd != d:
            q, k, v = (F.pad(x, (0, kd - d)) for x in (q, k, v))
        bias = bias.to(torch.float32)
    ql, kl, vl = (scatter_along(x, 1, ring.group) for x in (q, k, v))
    out = _RingAttention.apply(ql, kl, vl, chunk_of(bias, 1, ring.group), 1.0, bool(causal), float(rate), int(seed),
                               ring)
    out = gather_along(out, 1, ring.group)
    out = out[..., :d] if out.shape[2] != d else out
    if causal:
        # a row with no unmasked key averages every value, as the dense route
        # and JAX's ring do (the blocks would average the causal prefix)
        out = torch.where(dead[:, None, None], v[..., :d].float().mean(dim=1, keepdim=True).to(out.dtype), out)
    return out
