"""BMUF: block-wise model update filtering (Chen & Huo, 2016).

Counterpart of ``fbk_fairseq_st_tpu/optim/bmuf.py`` (reference
fairseq/optim/bmuf.py). The filter, applied in place to the parameters
every ``--global-sync-iter`` updates after ``--warmup-iterations``:

    g_t    = global_params - params                 (the block's "gradient")
    s_t    = block_momentum * s_{t-1} + block_lr * g_t
    global = global_params - s_t
    params = global - block_momentum * s_t  with --use-nbm, else global

At the warmup update it adopts the parameters as the block's global model.
With ``block_momentum`` 0 the filter is off. ``optim/local_sgd.py`` runs it
at the sync points of local SGD.
"""

from __future__ import annotations

from typing import List, Optional

import torch


class BMUF:
    def __init__(self, args):
        self.block_lr = getattr(args, "block_lr", 1.0)
        self.block_momentum = getattr(args, "block_momentum", 0.875)
        self.sync_iter = getattr(args, "global_sync_iter", 50)
        self.warmup_iteration = getattr(args, "warmup_iterations", 500)
        self.use_nbm = getattr(args, "use_nbm", False)
        self.global_params: Optional[List[torch.Tensor]] = None
        self.smoothed_grads: Optional[List[torch.Tensor]] = None

    def _reset(self, params: List[torch.Tensor]) -> None:
        self.global_params = [p.detach().clone() for p in params]
        self.smoothed_grads = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], num_updates: int) -> None:
        """After the update that made ``num_updates``: the filter, in place
        (JAX ``BMUF.step`` :79-99)."""
        if num_updates == self.warmup_iteration:
            self._reset(params)
            return
        if num_updates > self.warmup_iteration and num_updates % self.sync_iter == 0 and self.block_momentum != 0:
            if self.global_params is None:
                self._reset(params)
                return
            g = torch._foreach_sub(self.global_params, params)
            torch._foreach_mul_(self.smoothed_grads, self.block_momentum)
            torch._foreach_add_(self.smoothed_grads, g, alpha=self.block_lr)
            torch._foreach_sub_(self.global_params, self.smoothed_grads)
            for p, gp, s in zip(params, self.global_params, self.smoothed_grads):
                p.copy_(gp - self.block_momentum * s if self.use_nbm else gp)

    def state_dict(self):
        return {"global_params": self.global_params, "smoothed_grads": self.smoothed_grads}

    def load_state_dict(self, d) -> None:
        self.global_params = d.get("global_params")
        self.smoothed_grads = d.get("smoothed_grads")
