"""Local SGD with BMUF block syncs: the gradient all-reduce suppressed
between syncs.

Counterpart of ``fbk_fairseq_st_tpu/optim/local_sgd.py``
(``LocalSGDBMUF``; reference fairseq/optim/bmuf.py). JAX keeps the replicas
on a leading axis and steps them in one ``vmap``; here a replica is a
data-parallel rank: between syncs each rank's trainer steps on the
gradients of its own rows alone, normalised by its own sample size. At the
warmup update and every ``--global-sync-iter`` updates after it
(``due``), ``sync`` averages the parameters over the ranks (one
all-reduce), applies the block filter (``optim/bmuf.py``), the same on
every rank, and with ``--average-sync`` averages the optimiser's state as
well. BatchNorm's statistics and running stats stay each rank's, as a
replica's in JAX's ``vmap``.
"""

from __future__ import annotations

from typing import List

import torch

from ..parallel.collectives import all_reduce_, group_size
from .bmuf import BMUF


class LocalSGDBMUF:
    def __init__(self, args, group):
        self.group = group
        self.n = group_size(group)
        self.sync_iter = getattr(args, "global_sync_iter", 50)
        self.warmup_iteration = getattr(args, "warmup_iterations", 500)
        self.average_sync = getattr(args, "average_sync", False)
        self.bmuf = BMUF(args)

    def due(self, num_updates: int) -> bool:
        return num_updates == self.warmup_iteration or (
            num_updates > self.warmup_iteration and num_updates % self.sync_iter == 0)

    @torch.no_grad()
    def _average(self, tensors: List[torch.Tensor]) -> None:
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
        all_reduce_(flat, self.group)
        flat /= self.n
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    @torch.no_grad()
    def after_update(self, params: List[torch.Tensor], optimizer, num_updates: int) -> None:
        """The block boundary, where ``due``: average, filter, and with
        ``--average-sync`` average the optimiser's floating state."""
        if not self.due(num_updates):
            return
        self._average(params)
        self.bmuf.step(params, num_updates)
        if self.average_sync:
            self._average([v for state in optimizer.state.values() for v in state.values()
                           if isinstance(v, torch.Tensor) and v.is_floating_point()])

    def state_dict(self):
        return self.bmuf.state_dict()

    def load_state_dict(self, d) -> None:
        self.bmuf.load_state_dict(d)
