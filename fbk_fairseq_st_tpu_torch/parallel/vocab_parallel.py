"""Cross entropy over logits split on their vocabulary dim.

Counterpart of ``fbk_fairseq_st_tpu/parallel/vocab_parallel.py``:
``vocab_parallel_cross_entropy`` is JAX's plain form (logsumexp minus the
target's logit, fp32), ``vocab_parallel_cross_entropy_sharded`` its
explicit-collective form (``_shardmap`` there): each rank holds the columns
[rank * V_l, (rank + 1) * V_l) of the logits, and

    m      = the max over the group of the local maxima (a constant for
             autograd: the result does not depend on it)
    sumexp = reduce_from(sum(exp(local - m)))
    pred   = reduce_from(the target's logit where this rank holds it, else 0)
    loss   = log(sumexp) + m - pred

``reduce_from`` (all-reduce forward, identity backward) gives each rank the
gradient of its own columns.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import all_reduce_, group_rank, reduce_from


def vocab_parallel_cross_entropy(logits, target):
    """Per-position CE: logits (..., V), target (...,) ids -> (...,) fp32."""
    logits = logits.float()
    pred = torch.gather(logits, -1, target[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - pred


def vocab_parallel_cross_entropy_sharded(logits, target, group):
    """The same over this rank's columns of logits split on the last dim
    over ``group``."""
    logits = logits.float()
    local_v = logits.shape[-1]
    m = all_reduce_(logits.detach().amax(dim=-1), group, op=dist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    local_t = target.long() - group_rank(group) * local_v
    inside = (local_t >= 0) & (local_t < local_v)
    picked = torch.gather(logits, -1, local_t.clamp(0, local_v - 1)[..., None])[..., 0]
    pred = reduce_from(torch.where(inside, picked, torch.zeros_like(picked)), group)
    return torch.log(sumexp) + m - pred
