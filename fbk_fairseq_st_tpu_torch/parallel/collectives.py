"""The collectives of the port's multi-GPU training, as autograd Functions.

JAX writes no collective: its compiler places them from the shardings it
is given (``fbk_fairseq_st_tpu/parallel/mesh.py:1-15``). The port's ranks
are processes, so each collective is a ``torch.distributed`` call, and each
one that sits on the differentiated path is a Function whose backward is
the collective its forward implies (the Megatron pairs):

  * ``copy_to`` / ``reduce_from``: identity forward with an all-reduce
    backward, and the reverse (the input and the output of a
    tensor-parallel region);
  * ``scatter_along`` / ``gather_along``: this rank's chunk of a dim, or
    the concatenation of every rank's chunk; the gather's backward is the
    slice when what follows is computed alike on every rank, or the
    reduce-scatter when each rank's consumer contributes a partial sum
    (``backward="reduce_scatter"``: sequence parallelism before a
    column-parallel linear, the FSDP weight gather);
  * ``reduce_scatter_along``: the partial sums of every rank, summed and
    split (sequence parallelism after a row-parallel linear);
  * ``all_reduce_sum``: an all-reduce whose backward is an all-reduce too,
    for statistics that every rank's loss reads (the synced BatchNorm).

A group of one rank makes each of them the identity. ``group_size`` and
``group_rank`` take ``None`` for that group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(group_size(group), dim=dim)[group_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.group), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_scatter):
        ctx.dim, ctx.group, ctx.reduce_scatter = dim, group, reduce_scatter
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_scatter:
            return _reduce_scatter(grad, ctx.dim, ctx.group), None, None, None
        return _chunk(grad, ctx.dim, ctx.group), None, None, None


class _ReduceScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ScatterAlong.apply(x, dim % x.dim(), group)


def gather_along(x: torch.Tensor, dim: int, group, backward: str = "slice") -> torch.Tensor:
    if backward not in ("slice", "reduce_scatter"):
        raise ValueError(f"gather_along: backward is 'slice' or 'reduce_scatter', got {backward!r}")
    if group_size(group) == 1:
        return x
    return _GatherAlong.apply(x, dim % x.dim(), group, backward == "reduce_scatter")


def reduce_scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceScatterAlong.apply(x, dim % x.dim(), group)


def all_gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The concatenation of every rank's ``x`` along ``dim``, outside
    autograd (checkpoints, the optimiser state)."""
    return x if group_size(group) == 1 else _all_gather(x.detach(), dim % x.dim(), group)


def chunk_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``, outside autograd."""
    return x if group_size(group) == 1 else _chunk(x.detach(), dim % x.dim(), group)


def rotate(tensors, group, shift: int = 1):
    """Send each of ``tensors`` to the rank ``shift`` ahead in ``group`` and
    receive the one from the rank ``shift`` behind, in one batch of
    point-to-point operations (the ring's step); returns the received."""
    n, r = group_size(group), group_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place all-reduce outside autograd (the gradients, the logging
    sums); a no-op for a group of one rank."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return x


def broadcast_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the group's first rank, in place on every rank."""
    if group_size(group) > 1:
        dist.broadcast(x, dist.get_global_rank(group, 0), group=group)
    return x


def new_groups(rank_lists, backend: Optional[str] = None):
    """One group for each list of ranks (every process of the world calls
    this with the same lists, in the same order, as ``new_group`` asks);
    returns the group this process belongs to, or None."""
    mine = None
    me = dist.get_rank()
    for ranks in rank_lists:
        g = dist.new_group(ranks=list(ranks), backend=backend)
        if me in ranks:
            mine = g
    return mine
