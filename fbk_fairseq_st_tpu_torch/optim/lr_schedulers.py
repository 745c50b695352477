"""Learning-rate schedulers.

Counterpart of ``fbk_fairseq_st_tpu/optim/lr_schedulers.py``, for
``inverse_sqrt`` (:103-137), the schedule of every FBK ST recipe. Host-side,
the reference contract: ``step_update(num_updates) -> lr``. The
epoch-boundary ``step(epoch, val_loss)`` comes with the epoch loop
(ROADMAP Queue A9).
"""

from __future__ import annotations

from typing import List


def _lr_list(args) -> List[float]:
    lr = args.lr
    if isinstance(lr, (int, float)):
        return [float(lr)]
    return [float(x) for x in lr]


class InverseSquareRootSchedule:
    """Linear warmup from ``warmup_init_lr`` to ``lr`` over
    ``warmup_updates``, then ``lr * sqrt(warmup_updates / num_updates)``.
    A negative ``warmup_init_lr`` means 0 when there is warmup (so the first
    update's lr is 0 and changes no weight) and ``lr`` otherwise."""

    def __init__(self, args):
        lrs = _lr_list(args)
        if len(lrs) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with inverse_sqrt."
                " Consider --lr-scheduler=fixed instead."
            )
        warmup_end_lr = lrs[0]
        self.warmup_updates = getattr(args, "warmup_updates", 4000)
        self.warmup_init_lr = getattr(args, "warmup_init_lr", -1)
        if self.warmup_init_lr < 0:
            self.warmup_init_lr = 0 if self.warmup_updates > 0 else warmup_end_lr
        self.lr_step = (warmup_end_lr - self.warmup_init_lr) / self.warmup_updates
        self.decay_factor = warmup_end_lr * self.warmup_updates ** 0.5
        self.lr = self.warmup_init_lr

    def step_update(self, num_updates: int) -> float:
        if num_updates < self.warmup_updates:
            self.lr = self.warmup_init_lr + num_updates * self.lr_step
        else:
            self.lr = self.decay_factor * num_updates ** -0.5
        return self.lr


LR_SCHEDULERS = {"inverse_sqrt": InverseSquareRootSchedule}


def build_lr_scheduler(args):
    name = getattr(args, "lr_scheduler", "inverse_sqrt")
    if name not in LR_SCHEDULERS:
        raise NotImplementedError(f"--lr-scheduler {name}: only inverse_sqrt is ported (ROADMAP Queue A7)")
    return LR_SCHEDULERS[name](args)
